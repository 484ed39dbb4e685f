"""The JAX package's own geometry test cases (tests/test_geometry.py and
tests/test_se3.py) run on the port, on the CPU: the same inputs (the
same rng draws and helpers) and the same assertions and tolerances, with
the port's camera, sampling, triangulation, epipolar and se3 modules.
Each test is named after the reference test it restates.

Parity of the same modules against the JAX package on random inputs is
in tests/test_torch_geometry.py (se3, camera, samplers),
tests/test_torch_twoview.py (epipolar fits and decompositions,
triangulation) and tests/test_torch_api.py (the gather samplers,
`denormalize`, `make_matrix`, `from_matrix`).
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rsp
from test_geometry import random_scene
from test_se3 import random_rotvecs

from viso_tpu_torch.geometry import camera, epipolar, sampling, se3, triangulation

torch.set_num_threads(2)


def T(x):
    return torch.tensor(np.asarray(x))


def N(x):
    return x.detach().numpy()


def make_intr():
    # tests/test_geometry.py's TUM freiburg1-style calibration.
    return camera.Intrinsics.create(517.3, 516.5, 325.1, 249.7)


def _two_views(pts, R2, t2):
    """Normalized observations of pts in camera 1 (identity) and camera 2."""
    x1 = pts[:, :2] / pts[:, 2:3]
    pc2 = (R2 @ pts.T).T + t2
    return x1, pc2[:, :2] / pc2[:, 2:3]


def _plane_views(rng, xi):
    """tests/test_geometry.py's homography cases: 40 points on z = 5 and a
    second camera at se3_exp(xi)."""
    n = 40
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.full(n, 5.0)], axis=-1
    ).astype(np.float32)
    R2, t2 = (N(x) for x in se3.se3_exp(torch.tensor(xi, dtype=torch.float32)))
    return _two_views(pts, R2, t2), R2, t2


# -- tests/test_geometry.py --------------------------------------------------

def test_project_backproject_roundtrip(rng):
    intr = make_intr()
    pts = T(rng.uniform(0.5, 10.0, size=(40, 3)).astype(np.float32))
    uv, depth = camera.project(pts, intr)
    back = camera.backproject(uv, depth, intr)
    assert np.allclose(N(back), N(pts), rtol=1e-5, atol=1e-4)


def test_intrinsics_level_scaling():
    l1 = make_intr().at_level(1)
    assert np.isclose(float(l1.fx), 517.3 * 0.5)
    assert np.isclose(float(l1.cx), (325.1 + 0.5) * 0.5 - 0.5)


def test_normalize_denormalize(rng):
    intr = make_intr()
    uv = T(rng.uniform(0, 500, size=(13, 2)).astype(np.float32))
    back = camera.denormalize(camera.normalize(uv, intr), intr)
    assert np.allclose(N(back), N(uv), atol=1e-4)


def test_is_inside():
    uv = torch.tensor([[5.0, 5.0], [-1.0, 5.0], [636.0, 470.0], [100.0, 100.0]])
    mask = camera.is_inside(uv, height=480, width=640, border=4)
    assert np.array_equal(N(mask), [True, False, False, True])


def test_bilinear_matches_scipy(rng):
    from scipy.ndimage import map_coordinates

    img = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
    uv = np.stack([rng.uniform(1, 62, 100), rng.uniform(1, 46, 100)], axis=-1).astype(np.float32)
    out = N(sampling.bilinear(T(img), T(uv)))
    ref = map_coordinates(img, [uv[:, 1], uv[:, 0]], order=1, mode="nearest")
    assert np.allclose(out, ref, atol=1e-3)


def test_gradient_on_linear_ramp():
    # I(u, v) = 3u + 5v has exact gradient (3, 5) everywhere inside.
    vs, us = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    img = T((3.0 * us + 5.0 * vs).astype(np.float32))
    uv = torch.tensor([[10.3, 12.7], [5.5, 20.2]])
    assert np.allclose(N(sampling.gradient(img, uv)), [[3.0, 5.0], [3.0, 5.0]], atol=1e-3)


def test_sample_patches_shape(rng):
    img = T(rng.uniform(0, 1, size=(64, 64)).astype(np.float32))
    centers = torch.tensor([[20.0, 20.0], [30.5, 10.25]])
    patches = sampling.sample_patches(img, centers, half=4)
    assert patches.shape == (2, 8, 8)
    # Integer center on integer image = direct lookup.
    assert np.isclose(float(patches[0, 4, 4]), float(img[20, 20]), atol=1e-5)


def test_triangulate_recovers_points(rng):
    pts, (R1, t1), (R2, t2) = random_scene(rng)
    x1, x2 = _two_views(pts, R2, t2)
    Xw, d1, d2 = triangulation.triangulate(T(x1), T(x2), T(R1), T(t1), T(R2), T(t2))
    assert np.allclose(N(Xw), pts, atol=1e-2)
    assert np.all(N(d1) > 0) and np.all(N(d2) > 0)
    err = N(triangulation.reprojection_error(Xw, T(x1), T(R1), T(t1)))
    assert np.max(err) < 1e-3


def test_parallax_cos(rng):
    pts, (R1, t1), (R2, t2) = random_scene(rng)
    cos = N(triangulation.parallax_cos(T(pts), T(R1), T(t1), T(R2), T(t2)))
    assert np.all(cos <= 1.0 + 1e-6) and np.all(cos > 0.9)  # small baseline


def test_fit_essential_and_residual(rng):
    pts, _, (R2, t2) = random_scene(rng, n=100)
    x1, x2 = _two_views(pts, R2, t2)
    E = epipolar.fit_essential(T(x1), T(x2))
    assert np.max(N(epipolar.epipolar_residual(E, T(x1), T(x2)))) < 1e-6
    # E encodes the true motion: E ~ [t]x R up to scale and sign.
    E_true = N(se3.hat(T(t2))) @ R2
    E_true = E_true / np.linalg.norm(E_true)
    E_est = N(E) / np.linalg.norm(N(E))
    assert abs(np.sum(E_true * E_est)) > 0.999


def test_decompose_essential_contains_truth(rng):
    pts, _, (R2, t2) = random_scene(rng, n=64)
    x1, x2 = _two_views(pts, R2, t2)
    Rs, ts = (N(x) for x in epipolar.decompose_essential(epipolar.fit_essential(T(x1), T(x2))))
    t_unit = t2 / np.linalg.norm(t2)
    best = min(np.linalg.norm(Rs[i] - R2) + np.linalg.norm(ts[i] - t_unit) for i in range(4))
    assert best < 1e-2


def test_fit_homography_planar(rng):
    (x1, x2), _, _ = _plane_views(rng, [0.2, -0.1, 0.02, 0.03, -0.02, 0.01])
    H = epipolar.fit_homography(T(x1), T(x2))
    assert np.max(N(epipolar.homography_residual(H, T(x1), T(x2)))) < 1e-6


def test_decompose_homography_contains_truth(rng):
    (x1, x2), R2, t2 = _plane_views(rng, [0.3, -0.1, 0.02, 0.03, -0.02, 0.01])
    Rs, ts, _ = (N(x) for x in epipolar.decompose_homography(
        epipolar.fit_homography(T(x1), T(x2))))
    t_unit = t2 / np.linalg.norm(t2)
    dists = [np.linalg.norm(Rs[i] - R2) + np.linalg.norm(ts[i] - t_unit)
             for i in range(Rs.shape[0])]
    assert min(dists) < 5e-2


# -- tests/test_se3.py ---------------------------------------------------------

def test_hat_vee_roundtrip(rng):
    w = rng.normal(size=(17, 3)).astype(np.float32)
    W = se3.hat(T(w))
    assert np.allclose(N(W), -N(W.transpose(-1, -2)))
    assert np.allclose(N(se3.vee(W)), w, atol=1e-6)


def test_so3_exp_matches_scipy(rng):
    w = random_rotvecs(rng, 64).astype(np.float32)
    assert np.allclose(N(se3.so3_exp(T(w))), Rsp.from_rotvec(w).as_matrix(), atol=1e-5)


def test_so3_exp_log_roundtrip(rng):
    w = random_rotvecs(rng, 64, max_angle=3.1).astype(np.float32)
    assert np.allclose(N(se3.so3_log(se3.so3_exp(T(w)))), w, atol=2e-3)


def test_so3_log_small_angle():
    w = np.array([[1e-6, -2e-6, 3e-6], [0.0, 0.0, 0.0]], dtype=np.float32)
    out = N(se3.so3_log(se3.so3_exp(T(w))))
    assert np.all(np.isfinite(out))
    assert np.allclose(out, w, atol=1e-5)


def test_so3_log_near_pi():
    w = np.array([[np.pi - 1e-4, 0.0, 0.0], [0.0, np.pi - 1e-4, 0.0]], dtype=np.float64)
    out = N(se3.so3_log(T(Rsp.from_rotvec(w).as_matrix())))
    assert np.allclose(out, w, atol=1e-3)


def test_se3_exp_log_roundtrip(rng):
    xi = rng.normal(size=(32, 6)).astype(np.float32) * 0.7
    assert np.allclose(N(se3.se3_log(*se3.se3_exp(T(xi)))), xi, atol=1e-4)


def test_se3_exp_zero_is_identity():
    R, t = se3.se3_exp(torch.zeros(6))
    assert np.allclose(N(R), np.eye(3), atol=1e-7)
    assert np.allclose(N(t), 0.0, atol=1e-7)


def test_compose_inverse(rng):
    R1, t1 = se3.se3_exp(T(rng.normal(size=6).astype(np.float32)))
    R2, t2 = se3.se3_exp(T(rng.normal(size=6).astype(np.float32)))
    Rb, tb = se3.compose(*se3.compose(R1, t1, R2, t2), *se3.inverse(R2, t2))
    assert np.allclose(N(Rb), N(R1), atol=1e-5)
    assert np.allclose(N(tb), N(t1), atol=1e-5)


def test_transform_matches_matrix(rng):
    R, t = se3.se3_exp(T(rng.normal(size=6).astype(np.float32)))
    pts = rng.normal(size=(11, 3)).astype(np.float32)
    out = se3.transform(R, t, T(pts))
    hom = np.concatenate([pts, np.ones((11, 1), np.float32)], axis=-1)
    expect = (N(se3.make_matrix(R, t)) @ hom.T).T[:, :3]
    assert np.allclose(N(out), expect, atol=1e-5)


def test_left_update_matches_reference_rule(rng):
    # T <- exp(xi) * T, the update at viso.cpp:737.
    xi = T((rng.normal(size=6) * 0.1).astype(np.float32))
    R, t = se3.se3_exp(T(rng.normal(size=6).astype(np.float32)))
    Ru, tu = se3.left_update(xi, R, t)
    Re, te = se3.compose(*se3.se3_exp(xi), R, t)
    assert np.allclose(N(Ru), N(Re), atol=1e-6)
    assert np.allclose(N(tu), N(te), atol=1e-6)


def test_jit_and_grad():
    """The reference's `jax.jit` + `jax.grad` of |t(exp(xi))|^2 at 0: the
    port's gradient by autograd and by `torch.func.grad`, finite."""
    def f(xi):
        return torch.sum(se3.se3_exp(xi)[1] ** 2)

    xi = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad(f(xi), xi)
    assert np.all(np.isfinite(N(g)))
    assert np.all(np.isfinite(N(torch.func.grad(f)(torch.zeros(6)))))


def test_relative():
    Ra, ta = se3.se3_exp(torch.tensor([0.1, 0.2, -0.1, 0.3, -0.2, 0.1]))
    Rb, tb = se3.se3_exp(torch.tensor([-0.2, 0.1, 0.4, -0.1, 0.2, -0.3]))
    # T_ab * T_b == T_a
    Rc, tc = se3.compose(*se3.relative(Ra, ta, Rb, tb), Rb, tb)
    assert np.allclose(N(Rc), N(Ra), atol=1e-5)
    assert np.allclose(N(tc), N(ta), atol=1e-5)
