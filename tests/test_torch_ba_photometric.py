"""The port's photometric window BA against viso_tpu's on the problems of
tests/test_ba_photometric.py, on the CPU: `make_template`,
`as_photo_ba_problem` (anchors, templates), `compute_cost` and
`solve_impl`, and the anchor-survives-eviction case. The JAX solver's
window copies take its jnp path here (`use_pallas()` is False off the
TPU), the port's the plain version of K1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.backend import ba_photometric as j_pba
from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import se3 as j_se3
from viso_tpu.mapping import map_state as j_ms
from viso_tpu.ops import pyramid as j_pyr
from viso_tpu_torch.backend import ba_photometric as t_pba
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.mapping import map_state as t_ms

torch.set_num_threads(2)

H, W = 120, 160
INTR = (150.0, 150.0, W / 2 - 0.5, H / 2 - 0.5)


def T(x):
    return torch.tensor(np.asarray(x))


def _plane_scene(rng):
    scene = j_syn.PlaneScene()
    scene.planes = [j_syn.frontal_plane(j_syn.smooth_texture(rng, 768, 768), z=8.0,
                                        tex_scale=60.0)]
    return scene


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.fixture(scope="module")
def problem():
    """test_photometric_ba_recovers_poses's problem: a fronto-parallel
    plane, 4 cameras on a lateral baseline, 96 landmarks, cameras 2-3 and
    the points perturbed."""
    rng = np.random.default_rng(0)
    intr = j_cam.Intrinsics.create(*INTR)
    scene = _plane_scene(rng)
    C, L = 4, 96
    Rs = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    ts = np.stack([np.array([-0.25 * c, 0.05 * c, 0.0], np.float32) for c in range(C)])
    images = np.stack([scene.render(intr, Rs[c], ts[c], H, W)[0] for c in range(C)])
    uv0 = np.stack([rng.uniform(10, W - 10, L), rng.uniform(10, H - 10, L)], -1).astype(np.float32)
    depth = scene.depth_at(intr, Rs[0], ts[0], uv0).astype(np.float32)
    good = np.isfinite(depth)
    p_cam = np.asarray(j_cam.backproject(jnp.array(uv0), jnp.array(depth), intr))
    pts_w = np.asarray(j_se3.transform(*j_se3.inverse(jnp.array(Rs[0]), jnp.array(ts[0])),
                                       jnp.array(p_cam)))
    anchor = np.zeros(L, np.int32)
    R_pert, t_pert = Rs.copy(), ts.copy()
    for c in range(2, C):
        dR, dt = j_se3.se3_exp(jnp.array(rng.normal(0, 0.004, 6).astype(np.float32)))
        R_pert[c] = np.asarray(dR) @ R_pert[c]
        t_pert[c] = np.asarray(dR) @ t_pert[c] + np.asarray(dt)
    pts_pert = (pts_w + rng.normal(0, 0.01, pts_w.shape)).astype(np.float32)
    return dict(images=images, Rs=Rs, ts=ts, R=R_pert, t=t_pert, pts_w=pts_w, pts=pts_pert,
                anchor=anchor, good=good, intr=intr)


def _probs(p, template_j):
    C, L = p["R"].shape[0], p["pts"].shape[0]
    obs = np.ones((C, L), bool) & p["good"][None]
    kw = dict(R=p["R"], t=p["t"], points=p["pts"], images=p["images"], template=template_j,
              anchor_idx=p["anchor"], obs_mask=obs, cam_mask=np.ones(C, bool),
              point_mask=p["good"])
    return (j_pba.PhotoBAProblem(**{k: jnp.asarray(v) for k, v in kw.items()}),
            t_pba.PhotoBAProblem(**{k: T(v) for k, v in kw.items()}))


def test_make_template_matches(problem):
    p = problem
    tj = j_pba.make_template(jnp.array(p["images"]), jnp.array(p["anchor"]), jnp.array(p["pts_w"]),
                             jnp.array(p["Rs"]), jnp.array(p["ts"]), p["intr"])
    tt = t_pba.make_template(T(p["images"]), T(p["anchor"]).long(), T(p["pts_w"]), T(p["Rs"]),
                             T(p["ts"]), t_cam.Intrinsics.create(*INTR))
    # Bilinear gathers of the same pixels, [0, 255]: 1e-3.
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)


def test_cost_and_solve_match(problem):
    """compute_cost at the start and after 16 LM iterations (num_fixed 2),
    and the adjusted poses and points, against the JAX solver."""
    p = problem
    tmpl = j_pba.make_template(jnp.array(p["images"]), jnp.array(p["anchor"]), jnp.array(p["pts_w"]),
                               jnp.array(p["Rs"]), jnp.array(p["ts"]), p["intr"])
    prob_j, prob_t = _probs(p, np.asarray(tmpl))
    intr_t = t_cam.Intrinsics.create(*INTR)
    params_j = j_pba.PhotoBAParams(iters=16, num_fixed=2)
    params_t = t_pba.PhotoBAParams(iters=16, num_fixed=2)
    c_j = float(j_pba.compute_cost(prob_j, p["intr"], params_j))
    c_t = float(t_pba.compute_cost(prob_t, intr_t, params_t))
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4)
    out_j, info_j = j_pba.solve(prob_j, p["intr"], params_j)
    out_t, info_t = t_pba.solve_impl(prob_t, intr_t, params_t)
    np.testing.assert_allclose(float(info_t["initial_cost"]), float(info_j["initial_cost"]), rtol=1e-4)
    # 16 f32 LM iterations of Schur solves: the cost to 1e-3 relative,
    # poses to 2e-4 (rotation entries, metres), points to 1 mm at 8 m.
    np.testing.assert_allclose(float(info_t["final_cost"]), float(info_j["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=2e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=2e-4)
    good = p["good"]
    np.testing.assert_allclose(out_t.points.numpy()[good], np.asarray(out_j.points)[good], atol=1e-3)
    assert info_t["cost_history"].shape == (16,)
    # test_ba_photometric.py's bounds on the port.
    assert float(info_t["final_cost"]) < float(info_t["initial_cost"]) * 0.5
    for c in range(2, 4):
        ang0 = _rot_deg(p["R"][c], p["Rs"][c])
        assert _rot_deg(out_t.R.numpy()[c], p["Rs"][c]) < max(0.35 * ang0, 0.02)
        t_err0 = np.linalg.norm(p["t"][c] - p["ts"][c])
        assert np.linalg.norm(out_t.t.numpy()[c] - p["ts"][c]) < max(0.65 * t_err0, 0.004)


def _eviction_maps(rng):
    """test_photo_ba_anchor_survives_eviction's window in both packages:
    3 keyframes of a plane, 64 landmarks observed in every keyframe."""
    intr = j_cam.Intrinsics.create(*INTR)
    scene = _plane_scene(rng)
    K, L, C = 4, 64, 3
    Rs = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    ts = np.stack([np.array([-0.3 * c, 0.0, 0.0], np.float32) for c in range(C)])
    m = j_ms.empty(K, L, (H, W), 4)
    for c in range(C):
        img, _ = scene.render(intr, Rs[c], ts[c], H, W)
        m = j_ms.insert_keyframe(m, c, jnp.array(Rs[c]), jnp.array(ts[c]), c * 10,
                                 j_pyr.build_pyramid(jnp.asarray(img), 4))
    uv0 = np.stack([rng.uniform(12, W - 12, L), rng.uniform(12, H - 12, L)], -1).astype(np.float32)
    depth = scene.depth_at(intr, Rs[0], ts[0], uv0).astype(np.float32)
    p_cam = j_cam.backproject(jnp.array(uv0), jnp.array(depth), intr)
    pts_w = j_se3.transform(*j_se3.inverse(jnp.array(Rs[0]), jnp.array(ts[0])), p_cam)
    m, slots, ok = j_ms.allocate_landmarks(m, pts_w, jnp.array(np.isfinite(depth)))
    for c in range(C):
        pc = j_se3.transform(jnp.array(Rs[c]), jnp.array(ts[c]), m.points)
        uv, d = j_cam.project(pc, intr)
        m = j_ms.set_observations(m, c, slots, uv, ok & (d > 0.1) & j_cam.is_inside(uv, H, W, border=10))
    return m, Rs, intr


def _to_port(m):
    return t_ms.from_numpy(
        {k: (tuple(np.asarray(a) for a in v) if k == "kf_pyr" else np.asarray(v))
         for k, v in zip(m._fields, m)}, "cpu")


def test_as_photo_ba_problem_matches_and_reanchors(rng):
    m_j, Rs, intr = _eviction_maps(rng)
    intr_t = t_cam.Intrinsics.create(*INTR)
    for m in (m_j, j_ms.evict_keyframe(m_j, 0)):
        prob_j, il_j = j_ms.as_photo_ba_problem(m, intr, level=1)
        prob_t, il_t = t_ms.as_photo_ba_problem(_to_port(m), intr_t, level=1)
        alive = np.asarray(m.point_mask)
        assert np.array_equal(prob_t.anchor_idx.numpy(), np.asarray(prob_j.anchor_idx))
        np.testing.assert_allclose(prob_t.template.numpy()[alive], np.asarray(prob_j.template)[alive],
                                   atol=1e-3)
        np.testing.assert_allclose(il_t, [float(v) for v in il_j], rtol=1e-7)
        assert prob_t.images.shape == (4, H // 2, W // 2)
    # The anchor is the oldest observer (KF 0), and KF 1 once 0 is evicted.
    m2 = t_ms.evict_keyframe(_to_port(m_j), 0)
    prob2, _ = t_ms.as_photo_ba_problem(m2, intr_t, level=1)
    alive = m2.point_mask.numpy()
    assert alive.sum() > 20 and (prob2.anchor_idx.numpy()[alive] == 1).all()


def test_anchor_tie_goes_to_first_slot():
    """Two observing keyframes with the same frame id: argmin keeps the
    first slot in both packages."""
    fid = np.array([5, 3, 3, 9], np.int32)
    obs = np.array([[1, 0], [1, 1], [1, 1], [0, 1]], bool)
    age_j = jnp.where(jnp.asarray(obs), jnp.asarray(fid)[:, None], 2**30)
    age_t = torch.where(T(obs), T(fid)[:, None], 2**30)
    assert torch.argmin(age_t, dim=0).tolist() == np.asarray(jnp.argmin(age_j, axis=0)).tolist() == [1, 1]


def test_solve_after_eviction_matches(rng):
    """BA on the post-eviction window (KF 2 perturbed, KF 1 the gauge):
    both packages reduce the cost and land on the same pose."""
    m_j, Rs, intr = _eviction_maps(rng)
    m2 = j_ms.evict_keyframe(m_j, 0)
    R_pert = np.asarray(m2.kf_R).copy()
    t_pert = np.asarray(m2.kf_t).copy()
    dR, dt = j_se3.se3_exp(jnp.array([0.004, -0.003, 0.002, 0.001, -0.002, 0.001]))
    R_pert[2] = np.asarray(dR) @ R_pert[2]
    t_pert[2] = np.asarray(dR) @ t_pert[2] + np.asarray(dt)
    m2 = m2._replace(kf_R=jnp.array(R_pert), kf_t=jnp.array(t_pert))
    fixed = np.array([False, True, False, True])
    prob_j, il_j = j_ms.as_photo_ba_problem(m2, intr, level=1)
    out_j, info_j = j_pba.solve(prob_j._replace(cam_fixed=jnp.asarray(fixed)), il_j,
                                j_pba.PhotoBAParams(iters=10, num_fixed=0))
    prob_t, il_t = t_ms.as_photo_ba_problem(_to_port(m2), t_cam.Intrinsics.create(*INTR), level=1)
    out_t, info_t = t_pba.solve_impl(prob_t._replace(cam_fixed=T(fixed)), il_t,
                                     t_pba.PhotoBAParams(iters=10, num_fixed=0))
    np.testing.assert_allclose(float(info_t["final_cost"]), float(info_j["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=2e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=2e-4)
    assert float(info_t["final_cost"]) < float(info_t["initial_cost"]) * 0.7
    assert _rot_deg(out_t.R.numpy()[2], Rs[2]) < 0.15
