"""Two-view geometry of the port against viso_tpu on the same numpy
inputs, on the CPU: epipolar fits, residuals and decompositions,
triangulation, RANSAC from JAX-drawn indices, `initialize`, the
low-disparity flag, the median and top-k tie semantics, and
`draw_indices`.

Null vectors and singular vectors carry an arbitrary sign that depends on
the solver, so fitted E and H are compared up to scale and sign, and
decompositions as sets of candidate motions. A minimal sample's fit also
differs in its last bits, which can reorder hypotheses whose MSAC scores
differ by rounding; `initialize` is judged by the motion it selects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import epipolar as je
from viso_tpu.geometry import se3 as jse3
from viso_tpu.geometry import triangulation as jtri
from viso_tpu.ops import ransac as jr
from viso_tpu.ops import twoview as jtv
from viso_tpu_torch.geometry import epipolar as te
from viso_tpu_torch.geometry import triangulation as ttri
from viso_tpu_torch.ops import ransac as tr
from viso_tpu_torch.ops import twoview as ttv

torch.set_num_threads(2)


def T(x):
    return torch.tensor(np.asarray(x))


XI_REF = (0.3, -0.05, 0.05, 0.02, -0.04, 0.03)
# The same rotation with a 0.65 m baseline: ~5 deg of parallax, so that the
# motion is well determined and two solvers' fits agree.
XI_WIDE = (0.6, -0.1, 0.25, 0.02, -0.04, 0.03)


def make_correspondences(rng, n=256, outlier_frac=0.3, noise_px=0.3, focal=520.0,
                         xi=XI_REF):
    """tests/test_twoview.py's scene: 4-10 m points, a 0.06 m / 3 deg
    motion (`xi`), 0.3 px noise, gross outliers."""
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)], -1
    ).astype(np.float32)
    R2, t2 = (np.asarray(a) for a in jse3.se3_exp(jnp.array(xi, jnp.float32)))
    x1 = pts[:, :2] / pts[:, 2:3]
    pc2 = pts @ R2.T + t2
    x2 = pc2[:, :2] / pc2[:, 2:3]
    x1 = x1 + rng.normal(0, noise_px / focal, x1.shape).astype(np.float32)
    x2 = x2 + rng.normal(0, noise_px / focal, x2.shape).astype(np.float32)
    out_idx = rng.choice(n, int(n * outlier_frac), replace=False)
    x2[out_idx] = rng.uniform(-0.5, 0.5, (len(out_idx), 2)).astype(np.float32)
    inlier = np.ones(n, bool)
    inlier[out_idx] = False
    return x1, x2, inlier, (R2, t2 / np.linalg.norm(t2)), pts


def _unit_sign(M):
    M = np.asarray(M, np.float64).reshape(-1)
    M = M / np.linalg.norm(M)
    return M * np.sign(M[np.argmax(np.abs(M))])


def _rot_deg(Ra, Rb):
    """Angle of Ra Rb^T in float64, from its skew part (accurate near 0)."""
    D = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    ang = np.degrees(np.arcsin(np.clip(np.linalg.norm(s) / 2, 0, 1)))
    return ang if np.trace(D) > 1 else 180.0 - ang


def _same_motion_set(Rs_a, ts_a, Rs_b, ts_b, rot_deg, t_tol):
    """Every candidate of a has a candidate of b within the tolerances."""
    for Ra, ta in zip(np.asarray(Rs_a), np.asarray(ts_a)):
        assert any(
            _rot_deg(Ra, Rb) < rot_deg and np.abs(ta - tb).max() < t_tol
            for Rb, tb in zip(np.asarray(Rs_b), np.asarray(ts_b))
        ), (Ra, ta)


def test_epipolar_fits_and_residuals_match(rng):
    x1, x2, _, (R2, t2u), _ = make_correspondences(rng, outlier_frac=0.0, noise_px=0.0,
                                                   xi=XI_WIDE)
    idx = np.stack([rng.choice(256, 32, replace=False) for _ in range(16)])
    # The null vector of a well-conditioned weighted system: equal up to
    # sign (1e-4).
    A = rng.normal(0, 1, (4, 20, 9)).astype(np.float32)
    wA = rng.uniform(0.5, 1, (4, 20)).astype(np.float32)
    for a, b in zip(te._weighted_nullvec(T(A), T(wA)).numpy(),
                    np.asarray(je._weighted_nullvec(jnp.asarray(A), jnp.asarray(wA)))):
        np.testing.assert_allclose(_unit_sign(a), _unit_sign(b), atol=1e-4)
    # 16 batched fits of 32 noise-free correspondences each. The normal
    # matrix of unnormalized f32 coordinates is ill-conditioned: two eigh
    # solvers' smallest eigenvectors differ in the second or third digit
    # (and may differ entirely for an 8-point hypothesis inside RANSAC), so
    # the fits are compared by the motion they recover: the candidate of
    # each nearest the truth agree within 0.5 deg and 0.02 on the unit
    # translation.
    Ej = np.asarray(jax.vmap(je.fit_essential)(jnp.asarray(x1)[idx], jnp.asarray(x2)[idx]))
    Et = te.fit_essential(T(x1)[T(idx)], T(x2)[T(idx)]).numpy()

    def nearest(Rs, ts):
        k = int(np.argmin([_rot_deg(R, R2) + 100 * np.abs(t - t2u).max()
                           for R, t in zip(np.asarray(Rs), np.asarray(ts))]))
        return np.asarray(Rs)[k], np.asarray(ts)[k]

    for a, b in zip(Et, Ej):
        R_t, t_t = nearest(*te.decompose_essential(T(a)))
        R_j, t_j = nearest(*je.decompose_essential(jnp.asarray(b)))
        assert _rot_deg(R_t, R_j) < 0.5 and np.abs(t_t - t_j).max() < 0.02
        s = np.linalg.svd(a, compute_uv=False)
        np.testing.assert_allclose(s, [1.0, 1.0, 0.0], atol=1e-5)   # on the manifold
    # Sampson residuals and homography transfer on the same E / H: 1e-6
    # relative in f32 plus a 1e-12 floor.
    np.testing.assert_allclose(
        te.epipolar_residual(T(Ej), T(x1)[None], T(x2)[None]).numpy(),
        np.asarray(jax.vmap(lambda E: je.epipolar_residual(E, x1, x2))(jnp.asarray(Ej))),
        rtol=1e-4, atol=1e-12)
    w = rng.uniform(0, 1, 256).astype(np.float32)
    Hj = np.asarray(je.fit_homography(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    Ht = te.fit_homography(T(x1), T(x2), T(w)).numpy()
    np.testing.assert_allclose(Ht / np.linalg.norm(Ht), Hj / np.linalg.norm(Hj), atol=1e-4)
    np.testing.assert_allclose(te.homography_residual(T(Hj), T(x1), T(x2)).numpy(),
                               np.asarray(je.homography_residual(Hj, x1, x2)), rtol=1e-4, atol=1e-10)
    R, t = (np.asarray(a) for a in jse3.se3_exp(jnp.array([0.1, 0.2, -0.3, 0.05, -0.1, 0.2])))
    np.testing.assert_allclose(te.essential_from_rt(T(R), T(t)).numpy(),
                               np.asarray(je.essential_from_rt(R, t)), atol=1e-6)


def test_decompositions_match_as_sets(rng):
    _, _, _, (R2, t2u), _ = make_correspondences(rng)
    E = np.asarray(je.essential_from_rt(R2, t2u))
    Rs_j, ts_j = je.decompose_essential(jnp.asarray(E))
    Rs_t, ts_t = te.decompose_essential(T(E))
    _same_motion_set(Rs_t, ts_t, Rs_j, ts_j, 0.01, 1e-4)
    _same_motion_set(Rs_j, ts_j, Rs_t, ts_t, 0.01, 1e-4)
    # The true motion is among the candidates.
    _same_motion_set([R2], [t2u], Rs_t, ts_t, 0.01, 1e-4)
    # A homography of the plane z = 6: H = R + t n^T / d.
    n = np.array([0.0, 0.0, 1.0])
    Hm = (R2 + np.outer(t2u * 0.3, n) / 6.0).astype(np.float32)
    Rj, tj, nj = je.decompose_homography(jnp.asarray(Hm))
    Rt, tt, nt = te.decompose_homography(T(Hm))
    # f32 SVDs of two solvers: 0.1 deg, 1e-3 on the unit translation.
    _same_motion_set(Rt, tt, Rj, tj, 0.1, 1e-3)
    _same_motion_set(Rj, tj, Rt, tt, 0.1, 1e-3)


def test_refine_essential_matches(rng):
    x1, x2, _, (R2, t2u), _ = make_correspondences(rng)
    mask = np.ones(256, bool)
    # Two starts off the truth by ~1 deg; K starts at once in the port.
    starts = [jse3.se3_exp(jnp.array(d, jnp.float32)) for d in
              ([0.0, 0.0, 0.0, 0.01, -0.01, 0.015], [0.0, 0.0, 0.0, -0.02, 0.01, 0.0])]
    R0 = np.stack([np.asarray(dR) @ R2 for dR, _ in starts])
    t0 = np.stack([t2u + np.array([0.05, -0.03, 0.02], np.float32)] * 2).astype(np.float32)
    tau = float(np.sqrt(np.float32(4e-6)))
    Rf_t, tf_t, c_t = te.refine_essential(T(R0), T(t0), T(x1), T(x2), T(mask), tau)
    for k in range(2):
        Rf_j, tf_j, c_j = je.refine_essential(jnp.asarray(R0[k]), jnp.asarray(t0[k]), x1, x2,
                                              jnp.asarray(mask), jnp.sqrt(4e-6))
        # 12 LM steps in f32 from the same start: 0.01 deg, 1e-4 on the
        # unit translation, 1e-3 relative on the robust cost.
        assert _rot_deg(Rf_t[k].numpy(), Rf_j) < 0.01
        np.testing.assert_allclose(tf_t[k].numpy(), np.asarray(tf_j), atol=1e-4)
        np.testing.assert_allclose(float(c_t[k]), float(c_j), rtol=1e-3)


def test_triangulation_matches(rng):
    x1, x2, _, (R2, t2u), pts = make_correspondences(rng, outlier_frac=0.0, noise_px=0.0)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Xj, d1j, d2j = jtri.triangulate(jnp.asarray(x1), jnp.asarray(x2), eye, zero, R2, t2u)
    Xt, d1t, d2t = ttri.triangulate(T(x1), T(x2), T(eye), T(zero), T(R2), T(t2u))
    # Rays 1-5 deg apart: the reference's dot-product form of the 2x2
    # solve cancels ~3 of f32's 7 digits there, the port's cross-product
    # form does not; they agree to 1e-3 relative.
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(d1t.numpy(), np.asarray(d1j), rtol=1e-3)
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-3)
    # Noise-free: exact up to the translation's scale.
    scale = np.linalg.norm(np.asarray(jse3.se3_exp(
        jnp.array([0.3, -0.05, 0.05, 0.02, -0.04, 0.03], jnp.float32))[1]))
    np.testing.assert_allclose(Xt.numpy() * scale, pts, rtol=1e-3)
    # The same points through both packages' gates.
    np.testing.assert_allclose(
        ttri.reprojection_error(T(Xj), T(x2), T(R2), T(t2u)).numpy(),
        np.asarray(jtri.reprojection_error(Xj, x2, R2, t2u)), atol=1e-7)
    np.testing.assert_allclose(
        ttri.parallax_cos(T(Xj), T(eye), T(zero), T(R2), T(t2u)).numpy(),
        np.asarray(jtri.parallax_cos(Xj, eye, zero, R2, t2u)), atol=1e-6)


def test_triangulation_is_stable_near_the_epipole():
    """Rays 1e-4 rad apart (a point near the focus of expansion of forward
    motion): the dot-product determinant cancels to f32 noise, the port's
    cross-product form keeps the float64 depth's sign and size (with the
    reference's 1e-12 floor on the determinant)."""
    rng = np.random.default_rng(4)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.0, 0.0, -1.0], np.float32)
    x1 = rng.uniform(-2e-3, 2e-3, (64, 2)).astype(np.float32)
    x2 = (x1 * (1.0 + rng.uniform(1e-5, 1e-4, (64, 1)))).astype(np.float32)
    _, d1, _ = ttri.triangulate(T(x1), T(x2), T(np.eye(3, dtype=np.float32)), T(np.zeros(3, np.float32)),
                                T(R), T(t))
    f1 = np.concatenate([x1, np.ones((64, 1))], 1).astype(np.float64)
    f2 = np.concatenate([x2, np.ones((64, 1))], 1).astype(np.float64)
    aa, ab, bb = (f1 * f1).sum(1), (f1 * f2).sum(1), (f2 * f2).sum(1)
    at, bt = f1 @ t, f2 @ t
    det = aa * bb - ab * ab
    d1_64 = (ab * bt - bb * at) / np.where(np.abs(det) < 1e-12, 1e-12, det)
    np.testing.assert_allclose(d1.numpy(), d1_64, rtol=1e-2)


def _ransac_inputs(rng, outlier_frac):
    x1, x2, inlier, motion, pts = make_correspondences(rng, outlier_frac=outlier_frac,
                                                       xi=XI_WIDE)
    mask = np.ones(len(x1), bool)
    mask[:5] = False
    return x1, x2, mask, inlier, motion, pts


def test_essential_ransac_from_jax_indices(rng):
    """test_twoview.py::test_essential_ransac_rejects_outliers's bounds on
    both packages, the same hypotheses drawn by jax.random."""
    x1, x2, mask, inlier, (R2, t2u), _ = _ransac_inputs(rng, 0.3)
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jr._sample_indices(key, jnp.asarray(mask), 2048, 8))
    res_j = jr.essential_ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                threshold=4e-6)
    res_t = tr.essential_ransac_from_indices(T(idx), T(x1), T(x2), T(mask), threshold=4e-6)
    for inl in (np.asarray(res_j.inliers), res_t.inliers.numpy()):
        assert inl[inlier & mask].mean() > 0.85 and inl[~inlier].mean() < 0.1
        assert not inl[~mask].any()
    np.testing.assert_allclose(_unit_sign(res_t.model), _unit_sign(res_j.model), atol=2e-3)
    agree = (res_t.inliers.numpy() == np.asarray(res_j.inliers)).mean()
    assert agree > 0.98, agree


def test_homography_ransac_from_jax_indices(rng):
    """A planar scene (z = 6 m) with 30 % outliers: both packages find the
    plane's inliers from the same 4-point hypotheses and agree on H."""
    n = 200
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 6.0)], -1)
    R2, t2 = (np.asarray(a) for a in jse3.se3_exp(jnp.array([0.2, -0.05, 0.05, 0.02, -0.03, 0.02])))
    x1 = (pts[:, :2] / pts[:, 2:3]).astype(np.float32)
    pc2 = pts @ R2.T + t2
    x2 = (pc2[:, :2] / pc2[:, 2:3] + rng.normal(0, 0.3 / 520, (n, 2))).astype(np.float32)
    out = rng.choice(n, 60, replace=False)
    x2[out] = rng.uniform(-0.5, 0.5, (60, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jr._sample_indices(key, jnp.asarray(mask), 256, 4))
    res_j = jr.homography_ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                 threshold=4e-6)
    res_t = tr.homography_ransac_from_indices(T(idx), T(x1), T(x2), T(mask), threshold=4e-6)
    assert int(res_t.best_hypo) == int(res_j.best_hypo)    # first best count
    np.testing.assert_allclose(_unit_sign(res_t.model), _unit_sign(res_j.model), atol=1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 2
    assert int(res_t.num_inliers) >= 130


def test_topk_ties_keep_index_order():
    """lax.top_k(-scores) returns equal scores in index order; the port's
    stable argsort does too (ransac.essential_ransac_from_indices)."""
    scores = np.array([3.0, 1.0, 2.0, 1.0, 1.0, 0.5, 2.0, 1.0], np.float32)
    _, top_j = jax.lax.top_k(-jnp.asarray(scores), 5)
    top_t = torch.argsort(T(scores), stable=True)[:5]
    assert top_t.tolist() == np.asarray(top_j).tolist() == [5, 1, 3, 4, 7]


def test_select_motion_median_averages_middle_values():
    """select_motion's median parallax is nanquantile(., 0.5), the mean of
    the two middle values as jnp.nanmedian gives; torch.nanmedian would
    return the lower one."""
    ang = T(np.array([1.0, 2.0, np.nan, 3.0, 10.0], np.float32))
    assert float(torch.nanquantile(ang, 0.5)) == float(jnp.nanmedian(jnp.asarray(ang.numpy()))) == 2.5
    assert float(torch.nanmedian(ang)) == 2.0


def test_initialize_recovers_motion_from_jax_indices(rng):
    """test_twoview.py::test_twoview_initialize_recovers_motion on both
    packages, the hypotheses of the E and H RANSAC drawn by jax.random as
    `twoview.initialize` draws them."""
    x1, x2, mask, inlier, (R2, t2u), pts = _ransac_inputs(rng, 0.2)
    key = jax.random.PRNGKey(1)
    params_j = jtv.TwoViewParams(projection_error_thresh=1.0, parallax_thresh_deg=15.0)
    params_t = ttv.TwoViewParams(projection_error_thresh=1.0, parallax_thresh_deg=15.0)
    k_e, k_h = jax.random.split(key)
    m = jnp.asarray(mask)
    idx_e = np.asarray(jr._sample_indices(k_e, m, 512, 8))
    idx_h = np.asarray(jr._sample_indices(k_h, m, 256, 4))
    res_j = jtv.initialize(key, jnp.asarray(x1), jnp.asarray(x2), m, params_j)
    res_t = ttv.initialize_from_indices(T(idx_e), T(idx_h), T(x1), T(x2), T(mask), params_t)
    assert bool(res_t.disparity_ok) and bool(res_j.disparity_ok)
    assert int(res_t.num_tracks) == int(res_j.num_tracks) == mask.sum()
    # The same motion: 0.05 deg, 1e-3 on t (mean-depth normalized), the
    # median parallax within 0.01 deg.
    assert _rot_deg(res_t.R.numpy(), res_j.R) < 0.05
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t), atol=1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 3
    assert abs(float(res_t.median_parallax_deg) - float(res_j.median_parallax_deg)) < 0.01
    # And the truth, as test_twoview.py bounds it (5 deg on the direction
    # of this scene's 0.65 m baseline under 0.3 px noise).
    assert int(res_t.num_inliers) > 100 and _rot_deg(res_t.R.numpy(), R2) < 1.0
    t_u = res_t.t.numpy() / np.linalg.norm(res_t.t.numpy())
    assert np.degrees(np.arccos(np.clip(abs(t_u @ t2u), -1, 1))) < 5.0
    inl = res_t.inliers.numpy()
    est, true = res_t.points.numpy()[inl], pts[inl]
    s = np.median(true[:, 2]) / np.median(est[:, 2])
    assert np.median(np.linalg.norm(est * s - true, axis=-1) / np.linalg.norm(true, axis=-1)) < 0.05


def test_initialize_low_disparity_flagged(rng):
    n = 128
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)],
                   -1).astype(np.float32)
    x1 = pts[:, :2] / pts[:, 2:3]
    x2 = x1 + rng.normal(0, 0.05 / 520.0, x1.shape).astype(np.float32)
    gen = torch.Generator().manual_seed(2)
    res = ttv.initialize(gen, T(x1), T(x2), torch.ones(n, dtype=torch.bool))
    res_j = jtv.initialize(jax.random.PRNGKey(2), jnp.asarray(x1), jnp.asarray(x2),
                           jnp.ones(n, bool))
    assert not bool(res.disparity_ok) and not bool(res_j.disparity_ok)


@pytest.mark.parametrize("valid", [0, 1, 7, 300])
def test_draw_indices_only_masked(valid):
    rng = np.random.default_rng(valid)
    mask = np.zeros(300, bool)
    mask[rng.choice(300, valid, replace=False)] = True
    gen = torch.Generator().manual_seed(0)
    idx = tr.draw_indices(gen, T(mask), 512, 8).numpy()
    assert idx.shape == (512, 8) and idx.dtype == np.int64
    if valid == 0:
        # An all-false mask gives index 0 everywhere, as the JAX draw does.
        assert (idx == 0).all()
        jidx = np.asarray(jr._sample_indices(jax.random.PRNGKey(0), jnp.asarray(mask), 64, 8))
        assert (jidx == 0).all()
        return
    assert mask[idx].all()
    # Uniform over the valid entries: every one drawn, counts within 5
    # sigma of the binomial mean.
    counts = np.bincount(idx.reshape(-1), minlength=300)[mask]
    mean = idx.size / valid
    assert (counts > 0).all() and np.abs(counts - mean).max() < 5 * np.sqrt(mean) + 1


def test_draw_indices_needs_no_host_read():
    """draw_indices reads no tensor value on the host (no
    aten::_local_scalar_dense, which every .item(), int() or bool() of a
    tensor goes through), so on CUDA it never synchronises -- an all-false
    mask included."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    for mask in (torch.zeros(50, dtype=torch.bool), torch.arange(50) % 3 == 0):
        gen = torch.Generator().manual_seed(1)
        with Ops() as ops:
            tr.draw_indices(gen, mask, 16, 4)
        assert ops.names and not any("_local_scalar_dense" in n for n in ops.names), ops.names
