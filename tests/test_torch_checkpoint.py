"""Checkpoints of the port (viso_tpu_torch.utils.checkpoint) against
viso_tpu's, on the CPU: the two packages share one .npz format, so each
loads what the other writes, bit for bit; a StereoSLAM saved mid-run
resumes and closes its loop against places stored before the cut; a
MonoSLAM saved mid-run resumes with its Sim(3) graph and keeps tracking.
(A mono SLAM checkpoint crossing packages: tests/test_torch_mono_slam.py.)"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from viso_tpu.mapping import map_state as j_ms
from viso_tpu.utils import checkpoint as j_ckpt
from viso_tpu_torch.data import synthetic
from viso_tpu_torch.geometry import camera
from viso_tpu_torch.mapping import map_state as t_ms
from viso_tpu_torch.slam.engine import VOConfig
from viso_tpu_torch.slam.full import StereoSLAM
from viso_tpu_torch.slam.loop_closure import LoopParams
from viso_tpu_torch.utils import checkpoint as t_ckpt
from viso_tpu_torch.utils import metrics

torch.set_num_threads(2)


def _jax_map(rng):
    m = j_ms.empty(4, 32, (64, 96), 3)
    m = j_ms.insert_keyframe(
        m, 1, jnp.eye(3), jnp.array([1.0, 2.0, 3.0]), 7,
        tuple(jnp.full((64 // 2**l, 96 // 2**l), float(l)) for l in range(3)),
    )
    pts = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    m, slots, ok = j_ms.allocate_landmarks(m, pts, jnp.ones(5, bool))
    return j_ms.set_observations(m, 1, slots, jnp.zeros((5, 2)) + 10.0, ok)


def _assert_maps_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_map_checkpoint_crosses_packages(tmp_path, rng):
    """JAX writes, the port loads the same arrays (dtypes included); the
    port writes them back and JAX loads them unchanged."""
    m = _jax_map(rng)
    path_j = os.path.join(tmp_path, "jax.npz")
    j_ckpt.save_map(path_j, m, extra={"frame": 7})
    mt, extra = t_ckpt.load_map(path_j, device="cpu")
    assert extra == {"frame": 7}
    ref = j_ms.MapState(*m)
    for name, x in zip(t_ms.MapState._fields, mt):
        if name != "kf_pyr":
            assert x.dtype == torch.from_numpy(np.asarray(getattr(ref, name))).dtype, name
    _assert_maps_equal(
        [tuple(v.numpy() for v in x) if isinstance(x, tuple) else x.numpy() for x in mt], m)
    path_t = os.path.join(tmp_path, "port.npz")
    t_ckpt.save_map(path_t, mt, extra={"frame": 8})
    m2, extra2 = j_ckpt.load_map(path_t)
    assert extra2 == {"frame": 8}
    _assert_maps_equal(m2, m)


def test_trajectory_checkpoint_crosses_packages(tmp_path, rng):
    n = 11
    R = np.stack([synthetic.so3_exp(rng.normal(size=3) * 0.3) for _ in range(n)])
    t = rng.normal(size=(n, 3)).astype(np.float32)
    path = os.path.join(tmp_path, "traj.txt")
    t_ckpt.save_trajectory(path, torch.from_numpy(R), torch.from_numpy(t))
    R2, t2 = j_ckpt.load_trajectory(path)
    np.testing.assert_allclose(R2, R, atol=1e-5)
    np.testing.assert_allclose(t2, t, atol=1e-5)
    j_ckpt.save_trajectory(path, R, t)
    with open(path) as f:
        jax_text = f.read()
    t_ckpt.save_trajectory(path, R, t)
    with open(path) as f:
        assert f.read() == jax_text
    R3, t3 = t_ckpt.load_trajectory(path)
    np.testing.assert_array_equal(R3, R2)
    np.testing.assert_array_equal(t3, t2)


# tests/test_slam.py's checkpoint-resume run: 160x224, 72 orbit frames,
# cut after frame 39.
H, W = 160, 224
INTR = dict(fx=180.0, fy=180.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(height=H, width=W, baseline=0.25, max_keyframes=6, max_landmarks=512,
           num_features=128, detect_grid=(4, 4), fast_threshold=12.0, max_disparity=48,
           kf_min_gap=1, kf_max_gap=5, kf_min_visible_frac=0.7, **INTR)
LOOP = dict(capacity=64, num_features=128, guard=8, min_matches=25, min_inliers=15)


def test_slam_checkpoint_resume(tmp_path):
    """save_slam/load_slam restore the map window, the live pose, the pose
    graph and the loop database: every stored field comes back equal, and
    the resumed engine keeps tracking and closes a loop against a node
    stored before the cut (the JAX package's test_slam_checkpoint_resume,
    on the port)."""
    n, cut = 72, 40
    room = synthetic.room_scene(np.random.default_rng(11), tex_size=512, half=6.0)
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.orbit_trajectory(n, radius=2.0)
    frames = [synthetic.make_stereo_pair(room, intr, R, t, H, W, baseline=0.25)[:2]
              for R, t in zip(Rs, ts)]
    cfg, lp = VOConfig(**CFG), LoopParams(**LOOP)
    slam = StereoSLAM(cfg, lp, device="cpu")
    for il, ir in frames[:cut]:
        slam.process(il, ir)
    path = str(tmp_path / "slam.npz")
    t_ckpt.save_slam(path, slam, extra={"frame": cut - 1})
    slam2, extra = t_ckpt.load_slam(path, cfg, lp, device="cpu")
    assert extra == {"frame": cut - 1}
    nodes_at_cut = len(slam.pg_raw_R)
    assert slam2._next_node == nodes_at_cut and slam2.pg_frame == slam.pg_frame
    _assert_maps_equal(t_ms.to_numpy(slam2.map).values(), t_ms.to_numpy(slam.map).values())
    for name in ("R", "t", "prev_R", "prev_t", "vel_xi"):
        assert torch.equal(getattr(slam2, name), getattr(slam, name)), name
    assert slam2.kf_order == slam.kf_order and slam2.frame_idx == slam.frame_idx
    np.testing.assert_array_equal(np.stack(slam2.pg_R), np.stack(slam.pg_R))
    assert [e[:2] + (e[4],) for e in slam2.pg_edges] == [e[:2] + (e[4],) for e in slam.pg_edges]
    for name in ("desc", "desc_mask", "points_w_dev", "points_ok_dev"):
        assert torch.equal(getattr(slam2.loop_db, name), getattr(slam.loop_db, name)), name
    for name in ("kp_uv", "points_w", "R", "t", "node_id", "path_len", "seam_t", "insert_seq"):
        np.testing.assert_array_equal(getattr(slam2.loop_db, name), getattr(slam.loop_db, name))
    assert slam2.loop_db.total == slam.loop_db.total
    slam.close()

    for il, ir in frames[cut:]:
        slam2.process(il, ir)
    slam2.join()
    assert slam2.hook_errors == []
    assert any(lo["to"] < nodes_at_cut for lo in slam2.loops), slam2.loops
    R_all, t_all = slam2.trajectory()
    assert len(R_all) == n - cut
    ate = metrics.ate_rmse(metrics.camera_centers(R_all, t_all),
                           metrics.camera_centers(Rs[cut:], ts[cut:]),
                           align=True, with_scale=False)
    slam2.close()
    assert ate < 1.0, ate


def test_mono_slam_checkpoint_resume(tmp_path):
    """tests/test_slam.py::test_mono_slam_checkpoint_roundtrip on the port:
    save_slam / load_slam round-trip the MonoSLAM state (the Sim(3)
    graph's node scales and edge scale ratios; `kind: mono` restores a
    MonoSLAM) and the resumed engine keeps tracking to the end of the
    70-frame orbit with finite poses."""
    from viso_tpu_torch.slam.mono_full import MonoSLAM

    n, cut = 70, 45
    room = synthetic.room_scene(np.random.default_rng(11), tex_size=512, half=6.0)
    intr = camera.Intrinsics.create(**INTR)
    Rs, ts = synthetic.orbit_trajectory(n, radius=2.0, total_angle=1.5 * np.pi)
    frames = [room.render(intr, R, t, H, W)[0] for R, t in zip(Rs, ts)]
    cfg = VOConfig(height=H, width=W, max_keyframes=6, max_landmarks=768, num_features=192,
                   detect_grid=(4, 6), fast_threshold=10.0, kf_min_gap=1, kf_max_gap=3,
                   kf_min_visible_frac=0.6, min_init_tracks=25, disparity_squared_thresh=25.0,
                   **INTR)
    lp = LoopParams(**LOOP)
    slam = MonoSLAM(cfg, lp, device="cpu")
    for img in frames[:cut]:
        slam.process(img)
    path = str(tmp_path / "mono_slam.npz")
    t_ckpt.save_slam(path, slam, extra={"frame": cut - 1})
    nodes, edges, scales = len(slam.pg_raw_R), list(slam.pg_edges), list(slam.pg_s)
    slam.close()
    assert nodes >= 10 and slam.state == "tracking"

    slam2, extra = t_ckpt.load_slam(path, cfg, lp, device="cpu")
    assert isinstance(slam2, MonoSLAM) and extra == {"frame": cut - 1}
    assert len(slam2.pg_raw_R) == slam2._next_node == nodes
    np.testing.assert_array_equal(slam2.pg_s, np.float32(scales))
    assert len(slam2.pg_edges) == len(edges)
    for e_old, e_new in zip(edges, slam2.pg_edges):
        assert e_old[:2] == e_new[:2] and len(e_new) == 6
        assert abs(e_old[2] - e_new[2]) < 1e-6   # s_ij round-trips
        np.testing.assert_array_equal(e_new[3], e_old[3])
    for img in frames[cut:]:
        slam2.process(img)
    slam2.join()
    assert slam2.hook_errors == []
    R_all, t_all = slam2.trajectory()
    slam2.close()
    assert len(R_all) == n - cut
    assert np.all(np.isfinite(R_all)) and np.all(np.isfinite(t_all))
    assert len(slam2.pg_raw_R) > nodes      # new nodes joined the restored graph
