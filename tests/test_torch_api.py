"""The JAX package's public functions that no engine path calls, on the
port, against viso_tpu on the same seeded numpy inputs, on the CPU:
`fast.detect`, the RANSAC calls that draw and fit in one (`ransac`,
`essential_ransac`, `homography_ransac`), `se3.make_matrix` /
`from_matrix`, `camera.denormalize`, `epipolar.signed_sampson` and the
gather samplers of `geometry/sampling.py`.

torch cannot reproduce a `jax.random` stream: the RANSAC calls are held
against JAX with JAX's drawn indices (`draw_indices` replaced by the JAX
draw of the same key, as tests/test_torch_mono.py's `ReplayJaxDraws`
does), and their generator path on the JAX tests' own recovery cases.
Tolerances: FAST on uint8-derived images is exact in f32 (its scores are
multiples of 1/256), so `detect` is equal; the samplers compute the same
f32 formulas, 1e-4 absolute on [0, 255] values (the window samplers sum
their products in another order, 1e-3, the tolerance
tests/test_sampling_fast.py holds them to against the gather samplers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_frontend import squares_image
from test_geometry import random_scene
from test_twoview import make_correspondences

from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import epipolar as j_epi
from viso_tpu.geometry import sampling as j_smp
from viso_tpu.geometry import se3 as j_se3
from viso_tpu.ops import fast as j_fast
from viso_tpu.ops import ransac as j_ransac
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.geometry import epipolar as t_epi
from viso_tpu_torch.geometry import sampling as t_smp
from viso_tpu_torch.geometry import se3 as t_se3
from viso_tpu_torch.ops import fast as t_fast
from viso_tpu_torch.ops import ransac as t_ransac

torch.set_num_threads(2)

TOL = 1e-4


def T(x):
    return torch.tensor(np.asarray(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, tol=TOL):
    a, b = N(a), N(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


# -- fast.detect ---------------------------------------------------------------

def _tied_dots():
    img = np.zeros((64, 96), np.uint8)
    img[::8, ::8] = 255          # identical isolated dots: tied scores
    img[4::16, 4::16] = 200
    return img


@pytest.mark.parametrize("case", ["squares", "tied_dots"])
@pytest.mark.parametrize("nms", [True, False])
def test_fast_detect_equals_reference(rng, case, nms):
    """uv, score and mask equal to the JAX package's on uint8 images, with
    and without NMS, at a max_num that cuts through tied scores."""
    img = (np.clip(squares_image(rng), 0, 255).astype(np.uint8) if case == "squares"
           else _tied_dots()).astype(np.float32)
    found = []
    for thr, max_num in ((40.0, 512), (10.0, 512), (10.0, 37)):
        out_t = t_fast.detect(T(img), threshold=thr, max_num=max_num, nms=nms)
        out_j = j_fast.detect(jnp.asarray(img), threshold=thr, max_num=max_num, nms=nms)
        for a, b in zip(out_t, out_j):
            assert np.array_equal(N(a), np.asarray(b))
        assert out_t[0].dtype == torch.float32
        found.append(int(out_t[2].sum()))
    assert found[1] > 37 and found[2] == 37, found


# -- the RANSAC calls ---------------------------------------------------------

class JaxDraws:
    """Stands in for `ransac.draw_indices`: the JAX package's
    `_sample_indices` of the given key over the same mask."""

    def __init__(self, key):
        self.key = key

    def __call__(self, generator, mask, num_hypotheses, sample_size):
        return T(np.asarray(j_ransac._sample_indices(
            self.key, jnp.asarray(N(mask)), num_hypotheses, sample_size)))


def _unit_sign(M):
    """A model up to scale and sign: unit Frobenius norm, largest entry > 0."""
    M = np.asarray(N(M), np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def _planar(rng, n=200, n_out=60):
    """tests/test_torch_twoview.py's planar scene (z = 6 m) with gross
    outliers: normalized x1, x2, the outliers' indices."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 6.0)], -1)
    R2, t2 = (np.asarray(a) for a in j_se3.se3_exp(
        jnp.array([0.2, -0.05, 0.05, 0.02, -0.03, 0.02])))
    x1 = (pts[:, :2] / pts[:, 2:3]).astype(np.float32)
    pc2 = pts @ R2.T + t2
    x2 = (pc2[:, :2] / pc2[:, 2:3] + rng.normal(0, 0.3 / 520, (n, 2))).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    x2[out] = rng.uniform(-0.5, 0.5, (n_out, 2)).astype(np.float32)
    return x1, x2, out


def test_generic_ransac_with_jax_draws(rng, monkeypatch):
    """`ransac` with the homography's fit and residual: the same winning
    hypothesis, inliers and count as the JAX package's `ransac` of the same
    key, the model within 1e-3 (unit norm, the DLT's f32 eigh)."""
    x1, x2, _ = _planar(rng)
    mask = np.ones(len(x1), bool)
    mask[:7] = False
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(t_ransac, "draw_indices", JaxDraws(key))
    res_t = t_ransac.ransac(torch.Generator(), T(x1), T(x2), T(mask), t_epi.fit_homography,
                            t_epi.homography_residual, 4, 128, 4e-6)
    res_j = j_ransac.ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                            j_epi.fit_homography, j_epi.homography_residual, 4, 128, 4e-6)
    assert int(res_t.best_hypo) == int(res_j.best_hypo)
    assert int(res_t.num_inliers) == int(res_j.num_inliers) >= 120
    assert np.array_equal(N(res_t.inliers), np.asarray(res_j.inliers))
    np.testing.assert_allclose(_unit_sign(res_t.model), _unit_sign(res_j.model), atol=1e-3)


def test_generic_ransac_takes_a_tuple_model(rng):
    """A fit that returns a tuple: the winner's parts picked together (the
    JAX package maps the pick over the model's tree)."""
    x1, x2, _ = _planar(rng)
    idx = t_ransac.draw_indices(torch.Generator().manual_seed(1),
                                torch.ones(len(x1), dtype=torch.bool), 64, 4)
    res = t_ransac.ransac_from_indices(
        idx, T(x1), T(x2), torch.ones(len(x1), dtype=torch.bool),
        lambda a, b: (t_epi.fit_homography(a, b), a.mean(0)),
        lambda m, a, b: t_epi.homography_residual(m[0], a, b), 4e-6)
    best = int(res.best_hypo)
    plain = t_ransac.ransac_from_indices(
        idx, T(x1), T(x2), torch.ones(len(x1), dtype=torch.bool), t_epi.fit_homography,
        t_epi.homography_residual, 4e-6)
    assert best == int(plain.best_hypo)
    assert torch.equal(res.model[0], plain.model)
    assert torch.equal(res.model[1], T(x1)[idx[best]].mean(0))


def test_essential_ransac_with_jax_draws(rng, monkeypatch):
    """`essential_ransac` against the JAX package's of the same key on
    tests/test_twoview.py's scene (30 % outliers): both within that test's
    bounds, E within 2e-3 up to scale and sign, inliers 98 % the same
    (tests/test_torch_twoview.py's bounds for the `_from_indices` half)."""
    x1, x2, gt_inlier, _, _ = make_correspondences(rng)
    x1, x2 = np.asarray(x1), np.asarray(x2)
    mask = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(0)
    monkeypatch.setattr(t_ransac, "draw_indices", JaxDraws(key))
    res_t = t_ransac.essential_ransac(torch.Generator(), T(x1), T(x2), T(mask), threshold=4e-6)
    res_j = j_ransac.essential_ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                      threshold=4e-6)
    for inl in (N(res_t.inliers), np.asarray(res_j.inliers)):
        assert inl[gt_inlier].mean() > 0.85 and inl[~gt_inlier].mean() < 0.1
    np.testing.assert_allclose(_unit_sign(res_t.model), _unit_sign(res_j.model), atol=2e-3)
    assert (N(res_t.inliers) == np.asarray(res_j.inliers)).mean() > 0.98


def test_homography_ransac_with_jax_draws(rng, monkeypatch):
    """`homography_ransac` against the JAX package's of the same key on the
    planar scene: the same first best hypothesis, H within 1e-3 up to scale
    and sign, inlier counts within 2 (the local-optimisation refits)."""
    x1, x2, _ = _planar(rng)
    mask = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(t_ransac, "draw_indices", JaxDraws(key))
    res_t = t_ransac.homography_ransac(torch.Generator(), T(x1), T(x2), T(mask), threshold=4e-6)
    res_j = j_ransac.homography_ransac(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                       threshold=4e-6)
    assert int(res_t.best_hypo) == int(res_j.best_hypo)
    np.testing.assert_allclose(_unit_sign(res_t.model), _unit_sign(res_j.model), atol=1e-3)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 2
    assert int(res_t.num_inliers) >= 130


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_essential_ransac_generator_rejects_outliers(rng, seed):
    """tests/test_twoview.py::test_essential_ransac_rejects_outliers with the
    hypotheses drawn from a seeded torch.Generator: the reference's bounds."""
    x1, x2, gt_inlier, _, _ = make_correspondences(rng)
    res = t_ransac.essential_ransac(torch.Generator().manual_seed(seed), T(np.asarray(x1)),
                                    T(np.asarray(x2)), torch.ones(len(gt_inlier), dtype=torch.bool),
                                    threshold=4e-6)
    inl = N(res.inliers)
    assert inl[gt_inlier].mean() > 0.85
    assert inl[~gt_inlier].mean() < 0.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_ransac_generator_on_a_plane(rng, seed):
    """tests/test_geometry.py::test_fit_homography_planar's plane (noise
    free) through `homography_ransac` with a seeded generator: every point
    an inlier and the reference's residual bound (1e-6); and the planar
    scene with 30 % outliers: the outliers rejected."""
    n = 40
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), np.full(n, 5.0)],
                   axis=-1).astype(np.float32)
    R2, t2 = (N(x) for x in t_se3.se3_exp(torch.tensor([0.2, -0.1, 0.02, 0.03, -0.02, 0.01])))
    x1 = pts[:, :2] / pts[:, 2:3]
    pc2 = (R2 @ pts.T).T + t2
    x2 = pc2[:, :2] / pc2[:, 2:3]
    gen = torch.Generator().manual_seed(seed)
    res = t_ransac.homography_ransac(gen, T(x1), T(x2), torch.ones(n, dtype=torch.bool),
                                     threshold=1e-6)
    assert int(res.num_inliers) == n
    assert N(t_epi.homography_residual(res.model, T(x1), T(x2))).max() < 1e-6
    x1, x2, out = _planar(rng)
    res = t_ransac.homography_ransac(gen, T(x1), T(x2), torch.ones(len(x1), dtype=torch.bool),
                                     threshold=4e-6)
    inl = N(res.inliers)
    assert not inl[out].any() and int(res.num_inliers) >= 130


# -- se3, camera, epipolar ------------------------------------------------------

def test_make_and_split_matrix_match(rng):
    """`make_matrix` (batched and single) and `from_matrix` equal to the
    JAX package's on the same poses."""
    xi = rng.normal(size=(5, 6)).astype(np.float32)
    Rj, tj = j_se3.se3_exp(jnp.asarray(xi))
    Rt, tt = T(np.asarray(Rj)), T(np.asarray(tj))
    for sl in (slice(None), 2):
        M = t_se3.make_matrix(Rt[sl], tt[sl])
        assert np.array_equal(N(M), np.asarray(j_se3.make_matrix(Rj[sl], tj[sl])))
        for a, b in zip(t_se3.from_matrix(M), j_se3.from_matrix(jnp.asarray(N(M)))):
            assert np.array_equal(N(a), np.asarray(b))


def test_denormalize_matches(rng):
    intr_t = t_cam.Intrinsics.create(517.3, 516.5, 325.1, 249.7)
    intr_j = j_cam.Intrinsics.create(517.3, 516.5, 325.1, 249.7)
    xy = rng.normal(0, 0.5, (3, 13, 2)).astype(np.float32)
    close(t_cam.denormalize(T(xy), intr_t), j_cam.denormalize(jnp.asarray(xy), intr_j), 1e-4)


def test_signed_sampson_matches(rng):
    """`signed_sampson` of E = [t]x R on tests/test_geometry.py's scene, with
    noise, single and batched over 4 E's: within 1e-6 of the JAX package's
    (normalized units; the distances are ~1e-3), and its square equal to
    `epipolar_residual` within the same."""
    pts, _, (R2, t2) = random_scene(rng, n=100)
    x1 = pts[:, :2] / pts[:, 2:3] + rng.normal(0, 1e-3, (100, 2)).astype(np.float32)
    pc2 = (R2 @ pts.T).T + t2
    x2 = pc2[:, :2] / pc2[:, 2:3]
    E = np.asarray(j_se3.hat(jnp.asarray(t2))) @ R2
    Es = np.stack([E, E.T, 2 * E, -E]).astype(np.float32)
    for e in (Es[0], Es):
        d_t = t_epi.signed_sampson(T(e), T(x1), T(x2))
        close(d_t, j_epi.signed_sampson(jnp.asarray(e), jnp.asarray(x1), jnp.asarray(x2)), 1e-6)
        close(d_t ** 2, t_epi.epipolar_residual(T(e), T(x1), T(x2)), 1e-6)


# -- the gather samplers --------------------------------------------------------

def _img(rng, shape=(96, 128)):
    return rng.uniform(0, 255, shape).astype(np.float32)


def _centers(rng, n, lo_u, hi_u, lo_v, hi_v):
    return np.stack([rng.uniform(lo_u, hi_u, n), rng.uniform(lo_v, hi_v, n)],
                    -1).astype(np.float32)


def _grid(centers, half):
    return centers[:, None, None, :] + np.asarray(j_smp.patch_offsets(half))[None]


def _with_outside(rng, uv, H, W):
    """uv with a few samples moved outside the image on each side, for the
    border clamping."""
    uv = uv.copy()
    flat = uv.reshape(-1, 2)
    flat[:4] = [[-3.7, 5.2], [W + 2.4, 7.9], [11.1, -5.5], [W - 0.5, H + 3.25]]
    return uv


@pytest.mark.parametrize("fn", ["bilinear", "bilinear_with_grad", "gradient"])
def test_gather_samplers_match(rng, fn):
    """tests/test_sampling_fast.py's gather case (64 patches of 8x8 on a
    96x128 image) plus samples off the image on every side: the port's
    sampler equal to the JAX package's within 1e-4 (values and gradients
    on [0, 255])."""
    img = _img(rng)
    uv = _with_outside(rng, _grid(_centers(rng, 64, 12, 116, 12, 84), 4), 96, 128)
    out_t = getattr(t_smp, fn)(T(img), T(uv))
    out_j = getattr(j_smp, fn)(jnp.asarray(img), jnp.asarray(uv))
    for a, b in zip(*((out_t, out_j) if isinstance(out_t, tuple) else ((out_t,), (out_j,)))):
        close(a, b)


@pytest.mark.parametrize("fn", ["bilinear_indexed_with_grad", "gradient_indexed"])
def test_indexed_gather_samplers_match(rng, fn):
    """tests/test_sampling_fast.py::test_windowed_indexed's stack (3 images
    of 64x80, 24 patches of 6x6) with samples off the image: equal to the
    JAX package's within 1e-4."""
    imgs = _img(rng, (3, 64, 80))
    uv = _with_outside(rng, _grid(_centers(rng, 24, 12, 68, 12, 52), 3), 64, 80)
    k = rng.integers(0, 3, 24).astype(np.int32)
    out_t = getattr(t_smp, fn)(T(imgs), T(k), T(uv))
    out_j = getattr(j_smp, fn)(jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(uv))
    for a, b in zip(*((out_t, out_j) if isinstance(out_t, tuple) else ((out_t,), (out_j,)))):
        close(a, b)


@pytest.mark.parametrize("half", [2, 4])
def test_sample_patches_match(rng, half):
    """`sample_patches` and `sample_patches_with_grad` at
    tests/test_geometry.py::test_sample_patches_shape's centres and at
    random ones, some by the border: within 1e-4 of the JAX package's."""
    img = _img(rng, (64, 64))
    c = np.concatenate([np.array([[20.0, 20.0], [30.5, 10.25], [1.5, 62.2]], np.float32),
                        _centers(rng, 16, 0, 64, 0, 64)])
    close(t_smp.sample_patches(T(img), T(c), half),
          j_smp.sample_patches(jnp.asarray(img), jnp.asarray(c), half))
    for a, b in zip(t_smp.sample_patches_with_grad(T(img), T(c), half),
                    j_smp.sample_patches_with_grad(jnp.asarray(img), jnp.asarray(c), half)):
        close(a, b)


@pytest.mark.parametrize("half,win", [(4, 24), (3, 16), (2, 16)])
def test_sample_windows_match(rng, half, win):
    """tests/test_sampling_fast.py's windowed cases (and two centres by the
    image's edges, as its edge-clamping case): `sample_windows` and
    `sample_windows_with_grad` on the JAX package's windows, within 1e-3 of
    its own (the three-operand product sums in another order) and of the
    JAX gather samplers (1e-3 values, 1e-2 gradients: that file's
    bounds)."""
    img = _img(rng)
    c = np.concatenate([_centers(rng, 32, 12, 116, 12, 84),
                        np.array([[5.0, 5.0], [122.0, 90.0]], np.float32)])
    uv = _grid(c, half)
    win_j, base_j = j_smp.extract_windows(jnp.asarray(img), jnp.asarray(c), win)
    win_t, base_t = T(np.asarray(win_j)), T(np.asarray(base_j))
    v = t_smp.sample_windows(win_t, base_t, T(uv))
    close(v, j_smp.sample_windows(win_j, base_j, jnp.asarray(uv)), 1e-3)
    close(v, j_smp.bilinear(jnp.asarray(img), jnp.asarray(uv)), 1e-3)
    v, g = t_smp.sample_windows_with_grad(win_t, base_t, T(uv))
    v_j, g_j = j_smp.sample_windows_with_grad(win_j, base_j, jnp.asarray(uv))
    close(v, v_j, 1e-3)
    close(g, g_j, 1e-3)
    v_ref, g_ref = j_smp.bilinear_with_grad(jnp.asarray(img), jnp.asarray(uv))
    close(v, v_ref, 1e-3)
    # Gradients against the gather sampler's at the random centres only (as
    # the reference compares them): on the integer edge centres' samples
    # the hat weights' derivative is 0 where the gather's one-sided
    # difference is not.
    close(g[:32], g_ref[:32], 1e-2)
