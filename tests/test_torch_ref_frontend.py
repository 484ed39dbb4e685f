"""The JAX package's own front-end test cases (tests/test_frontend.py and
tests/test_pnp_stereo.py) run on the port, on the CPU: the same inputs
(the same rng draws and the reference tests' image helpers) and the same
assertions and tolerances, with the port's pyramid, fast, lk, direct,
pnp, stereo and align modules. Each test is named after the reference
test it restates. Where the reference draws RANSAC hypotheses from a JAX
key, the port draws them from a seeded `torch.Generator`: a recovery
case holds whatever the draw.

Parity of the same modules against the JAX package on one input is in
tests/test_torch_frontend.py (pyramid, FAST, stereo, direct, align, PnP
refine), tests/test_torch_lk.py (LK, the reference's translation case
included) and tests/test_torch_api.py (`fast.detect`).
"""

import numpy as np
import pytest
import torch
from test_frontend import _render_plane, checkerboard, smooth_texture, squares_image

from viso_tpu_torch.geometry import camera, se3
from viso_tpu_torch.ops import align, direct, fast, lk, pnp, pyramid, stereo

torch.set_num_threads(2)


def T(x):
    return torch.tensor(np.asarray(x))


def N(x):
    return x.detach().numpy()


def _shifted(img, dv, du):
    """img resampled at (v + dv, u + du), bilinear, edges clamped."""
    from scipy.ndimage import map_coordinates

    vs, us = np.meshgrid(np.arange(img.shape[0]), np.arange(img.shape[1]), indexing="ij")
    return map_coordinates(img, [vs + dv, us + du], order=1, mode="nearest").astype(np.float32)


def _pose_error(R_est, t_est, R2, t2):
    """|log(T_est^-1 T_2)| of the twist between two poses."""
    return np.linalg.norm(N(se3.se3_log(*se3.compose(*se3.inverse(R_est, t_est), R2, t2))))


# -- tests/test_frontend.py -----------------------------------------------------

def test_pyramid_shapes_and_content():
    img = T(checkerboard(64, 96))
    pyr = pyramid.build_pyramid(img)
    assert len(pyr) == 4
    assert pyr[0].shape == (64, 96)
    assert pyr[1].shape == (32, 48)
    assert pyr[3].shape == (8, 12)
    # Downsampled mean should be preserved by the Gaussian kernel.
    assert abs(float(torch.mean(pyr[1])) - float(torch.mean(img))) < 5.0


def test_fast_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    img = squares_image(rng)
    uv, _, mask = fast.detect(T(img), threshold=40.0, max_num=512)
    ours = N(uv)[N(mask)]
    det = cv2.FastFeatureDetector_create(
        threshold=40, nonmaxSuppression=True, type=cv2.FastFeatureDetector_TYPE_9_16)
    kps = det.detect(img.astype(np.uint8), None)
    cv_pts = np.array([k.pt for k in kps]) if kps else np.zeros((0, 2))
    assert len(ours) > 0 and len(cv_pts) > 0
    d = np.linalg.norm(ours[:, None, :] - cv_pts[None, :, :], axis=-1)
    assert (d.min(axis=0) <= 2.0).mean() > 0.9
    assert (d.min(axis=1) <= 2.0).mean() > 0.75


def test_fast_grid_distribution(rng):
    img = T(smooth_texture(rng, 128, 128))
    uv, _, mask = fast.detect_grid(img, threshold=5.0, grid=(4, 4), per_cell=8)
    assert uv.shape == (128, 2)
    pts = N(uv)[N(mask)]
    if len(pts) > 16:
        # Detections cover at least 3 of the 4 column bands.
        assert len(np.unique((pts[:, 0] // 32).astype(int))) >= 3


def test_detect_grid_pyramid_fills_from_coarse_levels(rng):
    from scipy.ndimage import gaussian_filter

    blurred = gaussian_filter(squares_image(rng, 128, 128), sigma=4.0)
    pyr = pyramid.build_pyramid(T(blurred), 4)
    _, _, m0 = fast.detect_grid(pyr[0], threshold=20.0, grid=(4, 4), per_cell=8)
    uv, _, m = fast.detect_grid_pyramid(pyr, threshold=20.0, grid=(4, 4), per_cell=8, levels=3)
    assert int(m.sum()) > int(m0.sum())
    assert int(m.sum()) >= 10
    pts = N(uv)[N(m)]
    assert (pts[:, 0] >= 0).all() and (pts[:, 0] < 128).all()
    assert (pts[:, 1] >= 0).all() and (pts[:, 1] < 128).all()


def test_detect_grid_pyramid_prefers_fine_levels(rng):
    pyr = pyramid.build_pyramid(T(squares_image(rng, 128, 128)), 4)
    uv0, _, m0 = fast.detect_grid(pyr[0], threshold=40.0, grid=(4, 4), per_cell=4)
    uv, _, m = fast.detect_grid_pyramid(pyr, threshold=40.0, grid=(4, 4), per_cell=4, levels=3)
    a, b = N(uv)[N(m)], N(uv0)[N(m0)]
    if len(b):
        d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        assert (d.min(axis=0) < 1e-3).mean() > 0.9


def test_lk_tracks_pure_translation(rng):
    img = smooth_texture(rng, 128, 160)
    dx, dy = 3.7, -2.3
    cur = _shifted(img, dy, dx)
    kps = T(np.stack([rng.uniform(20, 140, 64), rng.uniform(20, 108, 64)],
                     axis=-1).astype(np.float32))
    kp_cur, _, ok = lk.track(pyramid.build_pyramid(T(img)), pyramid.build_pyramid(T(cur)),
                             kps, torch.ones(64, dtype=torch.bool))
    ok_np = N(ok)
    assert ok_np.mean() > 0.8
    est = (N(kp_cur) - N(kps))[ok_np]
    assert np.allclose(est.mean(axis=0), [-dx, -dy], atol=0.1)
    assert np.abs(est - [-dx, -dy]).max() < 0.5


def test_lk_large_motion_needs_pyramid(rng):
    img = smooth_texture(rng, 128, 160)
    shift = 17.0
    cur = _shifted(img, 0.0, shift)
    kps = T(np.stack([rng.uniform(40, 120, 32), rng.uniform(30, 98, 32)],
                     axis=-1).astype(np.float32))
    kp_cur, _, ok = lk.track(pyramid.build_pyramid(T(img)), pyramid.build_pyramid(T(cur)),
                             kps, torch.ones(32, dtype=torch.bool))
    ok_np = N(ok)
    assert ok_np.mean() > 0.5
    flow = (N(kp_cur) - N(kps))[ok_np]
    assert np.allclose(flow.mean(axis=0), [-shift, 0.0], atol=0.3)


def _plane_scene(rng):
    """tests/test_frontend.py's textured plane seen from the identity pose:
    intrinsics, texture, frame-1 image and 80 of its plane points."""
    intr = camera.Intrinsics.create(120.0, 120.0, 80.0, 60.0)
    tex = smooth_texture(rng, 256, 256)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img1, pts_w = _render_plane(intr, R1, t1, tex)
    sel_v = rng.integers(10, 110, 80)
    sel_u = rng.integers(10, 150, 80)
    return intr, tex, (T(R1), T(t1)), img1, T(pts_w[sel_v, sel_u])


def test_direct_pose_estimation_recovers_motion(rng):
    intr, tex, (R1, t1), img1, points = _plane_scene(rng)
    R2, t2 = se3.se3_exp(torch.tensor([0.08, -0.05, 0.03, 0.01, -0.015, 0.01]))
    img2, _ = _render_plane(intr, N(R2), N(t2), tex)
    R_est, t_est, cost = direct.estimate_pose(
        pyramid.build_pyramid(T(img1)), pyramid.build_pyramid(T(img2)), R1, t1, points,
        torch.ones(80, dtype=torch.bool), intr, R1, t1)
    assert _pose_error(R_est, t_est, R2, t2) < 0.01
    assert float(cost) < 30.0


def test_pixel_jacobian_matches_autodiff(rng):
    intr = camera.Intrinsics.create(120.0, 120.0, 80.0, 60.0)
    p = torch.tensor([0.3, -0.2, 4.0])

    def proj_of_xi(xi):
        dR, dt = se3.se3_exp(xi)
        return camera.project(se3.transform(dR, dt, p), intr)[0]

    J_auto = torch.func.jacrev(proj_of_xi)(torch.zeros(6))   # jax.jacobian is jacrev
    assert np.allclose(N(J_auto), N(direct.pixel_jacobian(p, intr)), atol=1e-3)


def test_templated_tracking_reuses_templates(rng):
    intr, tex, (R1, t1), img1, points = _plane_scene(rng)
    templates = direct.build_templates(pyramid.build_pyramid(T(img1)), R1, t1, points,
                                       torch.ones(80, dtype=torch.bool), intr)
    # A small twist and a large forward step (19 % scale change) from one
    # template build.
    for xi_true in ([0.05, -0.03, 0.02, 0.008, -0.01, 0.006], [0.0, 0.0, 0.8, 0.0, 0.0, 0.0]):
        R2, t2 = se3.se3_exp(torch.tensor(xi_true))
        img2, _ = _render_plane(intr, N(R2), N(t2), tex)
        R_est, t_est, _ = direct.estimate_pose_templated(
            templates, pyramid.build_pyramid(T(img2)), points, intr, R1, t1)
        assert _pose_error(R_est, t_est, R2, t2) < 0.02, xi_true


# -- tests/test_pnp_stereo.py ---------------------------------------------------

def test_pnp_ransac_with_outliers(rng):
    n = 200
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)],
                   axis=-1).astype(np.float32)
    R_true, t_true = (N(x) for x in se3.se3_exp(
        torch.tensor([0.2, -0.1, 0.3, 0.05, -0.03, 0.08])))
    pc = pts @ R_true.T + t_true
    x = pc[:, :2] / pc[:, 2:3]
    x = x + rng.normal(0, 0.5 / 520.0, x.shape).astype(np.float32)
    n_out = 50
    out_idx = rng.choice(n, n_out, replace=False)
    x[out_idx] += rng.uniform(0.03, 0.3, (n_out, 2)).astype(np.float32)
    res = pnp.pnp_ransac(torch.Generator().manual_seed(0), T(pts), T(x),
                         torch.ones(n, dtype=torch.bool), threshold=1.6e-5)
    R_est, t_est = N(res.R), N(res.t)
    ang = np.degrees(np.arccos(np.clip((np.trace(R_est @ R_true.T) - 1) / 2, -1, 1)))
    assert ang < 0.2
    assert np.linalg.norm(t_est - t_true) < 0.02
    inl = N(res.inliers)
    gt_out = np.zeros(n, bool)
    gt_out[out_idx] = True
    assert inl[~gt_out].mean() > 0.9
    assert inl[gt_out].mean() < 0.1


def test_pnp_dlt_exact(rng):
    pts = np.stack([rng.uniform(-2, 2, 12), rng.uniform(-2, 2, 12), rng.uniform(5, 10, 12)],
                   axis=-1).astype(np.float32)
    R_true, t_true = (N(x) for x in se3.se3_exp(
        torch.tensor([0.1, 0.2, -0.1, 0.02, 0.05, -0.03])))
    pc = pts @ R_true.T + t_true
    R, t = pnp._dlt_pnp(T(pts), T(pc[:, :2] / pc[:, 2:3]))
    assert np.allclose(N(R), R_true, atol=1e-3)
    assert np.allclose(N(t), t_true, atol=1e-2)


def test_stereo_matching(rng):
    img = smooth_texture(rng, 96, 160)
    true_disp = 11.6
    right = _shifted(img, 0.0, true_disp)
    kps = np.stack([rng.uniform(40, 150, 48), rng.uniform(10, 86, 48)], axis=-1).astype(np.float32)
    disp, _, ok = stereo.match(T(img), T(right), T(kps), torch.ones(48, dtype=torch.bool),
                               stereo.StereoParams(max_disparity=32))
    ok_np = N(ok)
    assert ok_np.mean() > 0.8
    est = N(disp)[ok_np]
    assert np.abs(est - true_disp).max() < 0.35
    z = stereo.disparity_to_depth(disp, focal=520.0, baseline=0.54, ok=ok)
    assert np.allclose(N(z)[ok_np], 520.0 * 0.54 / est, atol=1e-3)


def test_align_refines_predictions(rng):
    img = smooth_texture(rng, 128, 160)
    shift = np.array([2.3, -1.7], np.float32)
    cur = _shifted(img, shift[1], shift[0])
    # Two identical keyframes stacked; pairs reference either.
    kf_pyrs = tuple(torch.stack([p, p]) for p in pyramid.build_pyramid(T(img)))
    n = 32
    uv_ref = np.stack([rng.uniform(30, 130, n), rng.uniform(30, 98, n)], -1).astype(np.float32)
    k_idx = T(rng.integers(0, 2, n).astype(np.int32))
    true_uv = uv_ref - shift[None, :]
    uv_pred = true_uv + rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    uv_out, _, ok = align.align(kf_pyrs, k_idx, T(uv_ref), pyramid.build_pyramid(T(cur)),
                                T(uv_pred), torch.ones(n, dtype=torch.bool))
    ok_np = N(ok)
    assert ok_np.mean() > 0.8
    d = np.linalg.norm(N(uv_out) - true_uv, axis=-1)
    assert np.median(d[ok_np]) < 0.1


def test_select_reference_keyframes():
    # A point on the optical axis of kf0 but oblique to kf1 picks kf0.
    pts = torch.tensor([[0.0, 0.0, 5.0]])
    R1, t1 = se3.se3_exp(torch.tensor([2.0, 0.0, 0.0, 0.0, -0.5, 0.0]))
    k, cos = align.select_reference_keyframes(
        pts, torch.stack([torch.eye(3), R1]), torch.stack([torch.zeros(3), t1]),
        torch.ones(2, dtype=torch.bool))
    assert int(k[0]) == 0
    assert float(cos[0]) > 0.999
