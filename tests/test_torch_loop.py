"""tests/test_loop.py's descriptor, loop-database and SE(3) pose-graph
checks, run on the port (CPU).

Scenes are rendered, and true depths read, by viso_tpu's synthetic module
(numpy in and out; the port's PlaneScene has no `depth_at`); everything
under test is viso_tpu_torch. Each bound is the JAX test's own. The
Sim(3) checks of that file belong to monocular SLAM, not ported yet.
"""

import numpy as np
import torch
from scipy.ndimage import map_coordinates, rotate

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu_torch.backend import pose_graph
from viso_tpu_torch.data.synthetic import so3_exp
from viso_tpu_torch.geometry import camera, se3
from viso_tpu_torch.ops import descriptors, fast
from viso_tpu_torch.slam import loop_closure

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_descriptors_match_same_image(rng):
    img = _t(j_syn.smooth_texture(rng, 128, 160))
    uv, _, mask = fast.detect_grid(img, threshold=3.0, grid=(4, 4), per_cell=8)
    desc = descriptors.compute(img, uv, mask)
    idx, dist, ok = descriptors.match(desc, mask, desc, mask)
    ok_np = ok.numpy() & mask.numpy()
    assert np.all(idx.numpy()[ok_np] == np.nonzero(ok_np)[0])
    assert np.all(dist.numpy()[ok_np] < 1e-3)
    assert ok_np.sum() > 16


def test_descriptors_match_shifted_image(rng):
    img = j_syn.smooth_texture(rng, 128, 160)
    shift = 20.0
    vs, us = np.meshgrid(np.arange(128), np.arange(160), indexing="ij")
    img2 = map_coordinates(img, [vs, us + shift], order=1, mode="nearest").astype(np.float32)
    uv1, _, m1 = fast.detect_grid(_t(img), threshold=3.0, grid=(4, 4), per_cell=8)
    uv2, _, m2 = fast.detect_grid(_t(img2), threshold=3.0, grid=(4, 4), per_cell=8)
    d1 = descriptors.compute(_t(img), uv1, m1)
    d2 = descriptors.compute(_t(img2), uv2, m2)
    idx, _, ok = descriptors.match(d1, m1, d2, m2)
    ok_np = ok.numpy()
    assert ok_np.sum() > 10
    duv = uv1.numpy()[ok_np] - uv2.numpy()[idx.numpy()[ok_np]]
    assert (np.abs(duv - [shift, 0.0]).max(axis=-1) < 1.5).mean() > 0.8


def test_descriptor_distance_discriminates(rng):
    img1 = _t(j_syn.smooth_texture(rng, 96, 96))
    img2 = _t(j_syn.smooth_texture(rng, 96, 96))
    uv = _t(np.stack([rng.uniform(20, 76, 32), rng.uniform(20, 76, 32)], -1).astype(np.float32))
    m = torch.ones(32, dtype=torch.bool)
    d_same = descriptors.compute(img1, uv, m)
    d_other = descriptors.compute(img2, uv, m)
    assert descriptors.hamming(d_same, d_same).diagonal().max() < 1.0
    assert descriptors.hamming(d_same, d_other).diagonal().mean() > 70.0


def test_descriptors_rotation_invariant(rng):
    """Steered BRIEF matches across a 45-degree in-plane rotation; the
    unoriented variant (the control) does not."""
    img = j_syn.smooth_texture(rng, 160, 160)
    deg = 45.0
    img_rot = rotate(img, -deg, reshape=False, order=1, mode="nearest").astype(np.float32)
    n = 48
    kps = np.stack([rng.uniform(45, 115, n), rng.uniform(45, 115, n)], -1).astype(np.float32)
    c = (160 - 1) / 2.0
    th = np.deg2rad(deg)
    rot_m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    kps_rot = ((kps - c) @ rot_m.T + c).astype(np.float32)
    m = torch.ones(n, dtype=torch.bool)
    correct = {}
    for oriented in (True, False):
        d1 = descriptors.compute(_t(img), _t(kps), m, oriented=oriented)
        d2 = descriptors.compute(_t(img_rot), _t(kps_rot), m, oriented=oriented)
        idx, _, ok = descriptors.match(d1, m, d2, m)
        correct[oriented] = int((ok & (idx == torch.arange(n))).sum())
    assert correct[True] >= 0.5 * n, correct
    assert correct[False] < correct[True] * 0.5, correct


def _keyframe(scene, intr_j, intr, R, t, H, W, threshold, per_cell):
    """Render a view, detect FAST corners with the port and lift them with
    the scene's true depth: (img, uv, mask, camera-frame points, ok)."""
    img, _ = scene.render(intr_j, R, t, H, W)
    uv, _, mask = fast.detect_grid(_t(img), threshold=threshold, grid=(4, 4), per_cell=per_cell)
    depths = scene.depth_at(intr_j, R, t, uv.numpy()).astype(np.float32)
    ok = np.isfinite(depths) & mask.numpy()
    pts = camera.backproject(uv, _t(np.nan_to_num(depths)), intr)
    return img, uv, mask, pts.numpy(), ok


def _angle_deg(R_a, R_b):
    return np.degrees(np.arccos(np.clip((np.trace(R_a @ R_b.T) - 1) / 2, -1, 1)))


def _corridor(rng):
    scene = j_syn.corridor_scene(rng, tex_size=512)
    args = (200.0, 200.0, 127.5, 95.5)
    return scene, j_cam.Intrinsics.create(*args), camera.Intrinsics.create(*args), 192, 256


def test_loop_database_detects_revisit(rng):
    scene, intr_j, intr, H, W = _corridor(rng)
    db = loop_closure.LoopDatabase(loop_closure.LoopParams(
        capacity=32, num_features=64, guard=2, min_matches=20, min_inliers=15), device="cpu")
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img0, uv, mask, pts, ok = _keyframe(scene, intr_j, intr, R0, t0, H, W, 10.0, 4)
    db.add(img0, uv, mask, pts, ok, R0, t0, 0)
    for k in range(1, 4):
        tk = np.array([0.0, 0.0, -5.0 * k], np.float32)
        imgk, uvk, mk, _, _ = _keyframe(scene, intr_j, intr, R0, tk, H, W, 10.0, 4)
        db.add(imgk, uvk, mk, np.zeros((64, 3), np.float32), np.zeros(64, bool), R0, tk, k)
    R_re, t_re = (a.numpy() for a in se3.se3_exp(
        torch.tensor([0.05, -0.02, 0.03, 0.01, -0.02, 0.005])))
    img_re, uv_re, m_re, _, _ = _keyframe(scene, intr_j, intr, R_re, t_re, H, W, 10.0, 4)
    cand = db.detect(img_re, uv_re, m_re, R_re, t_re, intr)
    assert cand is not None and cand.db_index == 0 and cand.inliers >= 15
    # T_rel = T_re * T_0^-1 with T_0 the identity.
    assert _angle_deg(cand.R_rel, R_re) < 0.5
    assert np.linalg.norm(cand.t_rel - t_re) < 0.05


def test_loop_database_detects_rolled_revisit(rng):
    """A revisit under 90 degrees of camera roll closes the loop, and PnP
    recovers the roll."""
    scene, intr_j, intr, H, W = _corridor(rng)
    db = loop_closure.LoopDatabase(loop_closure.LoopParams(
        capacity=32, num_features=128, guard=2, min_matches=15, min_inliers=12,
        pnp_threshold_px=2.0), device="cpu")
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img0, uv, mask, pts, ok = _keyframe(scene, intr_j, intr, R0, t0, H, W, 8.0, 8)
    db.add(img0, uv, mask, pts, ok, R0, t0, 0)
    for k in range(1, 4):
        tk = np.array([0.0, 0.0, -5.0 * k], np.float32)
        imgk, uvk, mk, _, _ = _keyframe(scene, intr_j, intr, R0, tk, H, W, 8.0, 8)
        db.add(imgk, uvk, mk, np.zeros((128, 3), np.float32), np.zeros(128, bool), R0, tk, k)
    roll = np.deg2rad(90.0)
    R_re = np.array([[np.cos(roll), -np.sin(roll), 0.0], [np.sin(roll), np.cos(roll), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)
    t_re = np.array([0.03, -0.02, 0.04], np.float32)
    img_re, uv_re, m_re, _, _ = _keyframe(scene, intr_j, intr, R_re, t_re, H, W, 8.0, 8)
    cand = db.detect(img_re, uv_re, m_re, R_re, t_re, intr)
    assert cand is not None, "rolled revisit not detected"
    assert cand.db_index == 0
    assert _angle_deg(cand.R_rel, R_re) < 5.0
    assert np.linalg.norm(cand.t_rel - t_re) < 2.5


def test_loop_database_ring_wrap(rng):
    """Once full, the database recycles slots and detection returns the
    caller's node_id, not the slot."""
    scene, intr_j, intr, H, W = _corridor(rng)
    db = loop_closure.LoopDatabase(loop_closure.LoopParams(
        capacity=4, num_features=64, guard=1, min_matches=20, min_inliers=15), device="cpu")
    R = np.eye(3, dtype=np.float32)
    for node in range(6):
        t = np.array([0.0, 0.0, -1.2 * node], np.float32)
        img, uv, m, pts_cam, okp = _keyframe(scene, intr_j, intr, R, t, H, W, 10.0, 4)
        db.add(img, uv, m, pts_cam - t, okp, R, t, node, node_id=node)   # world = cam - t
    assert db.total == 6 and db.count == 4
    assert set(db.node_id.tolist()) == {2, 3, 4, 5}
    dR, dt = se3.se3_exp(torch.tensor([0.03, -0.02, 0.02, 0.008, -0.01, 0.004]))
    R_re, t_re = (a.numpy() for a in se3.compose(
        dR, dt, torch.eye(3), torch.tensor([0.0, 0.0, -2.4])))
    img_re, uv_re, m_re, _, _ = _keyframe(scene, intr_j, intr, R_re, t_re, H, W, 10.0, 4)
    cand = db.detect(img_re, uv_re, m_re, R_re, t_re, intr)
    assert cand is not None and cand.db_index == 2


def test_loop_database_spatial_retention(rng):
    """Beyond the recency tier, eviction removes the most spatially
    redundant entry: a corridor inserted far past capacity keeps coverage
    of its whole length."""
    img = _t(j_syn.smooth_texture(rng, 96, 128))
    params = loop_closure.LoopParams(capacity=16, num_features=32, retain_recent=4)
    db = loop_closure.LoopDatabase(params, device="cpu")
    n_insert = 64
    kps = np.stack([rng.uniform(20, 108, 32), rng.uniform(20, 76, 32)], -1).astype(np.float32)
    desc = descriptors.compute(img, _t(kps), torch.ones(32, dtype=torch.bool))
    for i in range(n_insert):
        t = np.array([-float(i), 0.0, 0.0], np.float32)   # centre x = i
        db.add(None, kps, np.ones(32, bool), np.zeros((32, 3), np.float32),
               np.zeros(32, bool), np.eye(3, dtype=np.float32), t, i, node_id=i,
               path_len=float(i), desc=desc)
    assert db.total == n_insert and db.count == params.capacity
    xs = np.sort(-db.t[:, 0])
    assert (db.node_id >= n_insert - params.retain_recent).sum() >= params.retain_recent
    assert xs.min() < 8.0, xs
    assert np.diff(xs).max() < 16.0, xs


def test_pose_graph_padded_multi_loop():
    """300-node drifted circle plus loop edges through the padded solve
    (512 nodes: the automatic choice takes the PCG path)."""
    K = 300
    thetas = np.linspace(0, 2 * np.pi, K, endpoint=False)
    radius = 20.0
    R_gt, t_gt = [], []
    for th in thetas:
        Rwc = so3_exp([0.0, th, 0.0])
        center = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))], np.float32)
        R_gt.append(Rwc)
        t_gt.append((-Rwc @ center).astype(np.float32))
    dRb, dtb = se3.se3_exp(torch.tensor([0.002, 0.0, -0.001, 0.0, 0.0005, 0.0]))
    edges, pg_R, pg_t = [], [R_gt[0]], [t_gt[0]]
    for k in range(1, K):
        R_rel, t_rel = se3.relative(*(torch.from_numpy(a) for a in
                                      (R_gt[k - 1], t_gt[k - 1], R_gt[k], t_gt[k])))
        R_rel, t_rel = se3.compose(dRb, dtb, R_rel, t_rel)
        edges.append((k - 1, k, R_rel.numpy(), t_rel.numpy(), 1.0))
        Ri, ti = se3.compose(*se3.inverse(R_rel, t_rel), torch.from_numpy(pg_R[-1]),
                             torch.from_numpy(pg_t[-1]))
        pg_R.append(Ri.numpy())
        pg_t.append(ti.numpy())
    for a, b in [(0, K - 1), (50, 250), (100, 200)]:
        R_rel, t_rel = se3.relative(*(torch.from_numpy(x) for x in
                                      (R_gt[a], t_gt[a], R_gt[b], t_gt[b])))
        edges.append((a, b, R_rel.numpy(), t_rel.numpy(), 10.0))
    drift_before = np.linalg.norm(pg_t[-1] - t_gt[-1])
    out, info = pose_graph.solve_padded(pg_R, pg_t, edges, pose_graph.PGParams(iters=30),
                                        device="cpu")
    assert out.R.shape[0] == 512
    assert float(info["final_cost"]) < 0.1 * float(info["initial_cost"])
    drift_after = np.linalg.norm(out.t[K - 1].numpy() - t_gt[-1])
    assert drift_after < 0.3 * drift_before, (drift_before, drift_after)
