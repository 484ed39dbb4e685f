"""Steered BRIEF descriptors, PnP RANSAC and the loop-closure synthetic
scenes of the port against viso_tpu, on the same numpy inputs (CPU).

On the CPU the descriptor windows come from K1's plain version; the CUDA
path (K1 launched for the 34x34 windows) is in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.data import synthetic as j_syn
from viso_tpu.ops import descriptors as j_desc
from viso_tpu.ops import pnp as j_pnp
from viso_tpu_torch.data import synthetic as t_syn
from viso_tpu_torch.ops import descriptors as t_desc
from viso_tpu_torch.ops import pnp as t_pnp

torch.set_num_threads(2)


def _keypoints(rng, n, H, W):
    kps = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    kps[:4] = [[16.4, 30.0], [W - 17.6, 40.0], [50.0, H - 17.2], [60.5, 70.5]]  # borders, a .5 tie
    return kps, rng.uniform(size=n) > 0.1


@pytest.mark.parametrize("oriented", [True, False])
def test_compute_matches_reference(rng, oriented):
    """Masks equal; at most 1 % of the bits differ (a comparison whose two
    samples tie to within f32 roundoff may flip; measured: none here)."""
    H, W = 120, 176
    img = j_syn.smooth_texture(rng, H, W)
    kps, mask = _keypoints(rng, 200, H, W)
    dj = np.asarray(j_desc.compute(jnp.asarray(img), jnp.asarray(kps), jnp.asarray(mask),
                                   oriented=oriented)).astype(np.float32)
    dt = t_desc.compute(torch.from_numpy(img), torch.from_numpy(kps), torch.from_numpy(mask),
                        oriented=oriented)
    assert dt.dtype == torch.bfloat16 and dt.shape == (200, t_desc.DESC_BITS)
    dt = dt.float().numpy()
    rows_j, rows_t = np.any(dj != 0, axis=1), np.any(dt != 0, axis=1)
    assert np.array_equal(rows_j, rows_t) and 60 < rows_j.sum() < 180
    assert set(np.unique(dt)) <= {-1.0, 0.0, 1.0}
    assert (dj != dt).sum() <= 0.01 * (dj != 0).sum()


def test_smoothing_and_constants_match(rng):
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    np.testing.assert_allclose(t_desc._smooth(torch.from_numpy(img)).numpy(),
                               np.asarray(j_desc._smooth(jnp.asarray(img))), atol=1e-4)
    np.testing.assert_array_equal(t_desc._pattern_matrix(), np.asarray(j_desc._PATTERN_MAT))
    np.testing.assert_array_equal(t_desc._oriented_pattern_mats(),
                                  np.asarray(j_desc._PATTERN_MATS_ORIENTED))
    np.testing.assert_array_equal(t_desc._moment_matrix(), np.asarray(j_desc._MOMENT_MAT))


def test_hamming_and_match_are_exact(rng):
    """Fed the same descriptors, hamming and match agree exactly; match
    batches over stored sets as a vmap of the JAX match does."""
    n1, n2 = 96, 80
    d2 = np.where(rng.uniform(size=(n2, 256)) < 0.5, -1.0, 1.0).astype(np.float32)
    d1 = d2[rng.integers(0, n2, n1)].copy()
    flip = rng.uniform(size=d1.shape) < rng.uniform(0.0, 0.3, (n1, 1))
    d1[flip] *= -1
    m1, m2 = rng.uniform(size=n1) > 0.1, rng.uniform(size=n2) > 0.1
    j1, j2 = jnp.asarray(d1, jnp.bfloat16), jnp.asarray(d2, jnp.bfloat16)
    t1, t2 = torch.from_numpy(d1).bfloat16(), torch.from_numpy(d2).bfloat16()
    np.testing.assert_array_equal(t_desc.hamming(t1, t2).numpy(), np.asarray(j_desc.hamming(j1, j2)))
    ij, dj, okj = j_desc.match(j1, jnp.asarray(m1), j2, jnp.asarray(m2))
    it, dt, okt = t_desc.match(t1, torch.from_numpy(m1), t2, torch.from_numpy(m2))
    assert np.array_equal(okt.numpy(), np.asarray(okj)) and 10 < okt.sum() < n1
    assert np.array_equal(it.numpy()[okt.numpy()], np.asarray(ij)[np.asarray(okj)])
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # Batched over 3 stored sets.
    d3 = np.stack([d2, -d2, d2[::-1]])
    m3 = np.stack([m2, m2, m2[::-1]])
    okb = jax.vmap(lambda d, m: j_desc.match(j1, jnp.asarray(m1), d, m)[2])(
        jnp.asarray(d3, jnp.bfloat16), jnp.asarray(m3))
    _, _, okt3 = t_desc.match(t1, torch.from_numpy(m1), torch.from_numpy(d3).bfloat16(),
                              torch.from_numpy(m3))
    assert np.array_equal(okt3.numpy(), np.asarray(okb))


def _pnp_problem(rng, n, outliers=0.3, noise_px=0.5, f=400.0):
    P = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 9, n)], -1).astype(np.float32)
    R = t_syn.so3_exp(rng.normal(0, 0.2, 3))
    t = rng.normal(0, 0.5, 3).astype(np.float32)
    pc = P @ R.T + t
    x = (pc[:, :2] / pc[:, 2:]).astype(np.float32)
    x += rng.normal(0, noise_px / f, x.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    x[bad] += rng.uniform(-0.2, 0.2, (bad.sum(), 2)).astype(np.float32)
    return P, x, R, t


@pytest.mark.parametrize("k", [6, 12, 40])
def test_dlt_pnp_matches_reference(rng, k):
    """The 6+ point DLT, on noise-free points (8 draws of the seed-0 rng).

    In float64 the port recovers the true pose to 5e-5 (the inputs are
    float32; measured worst 1.0e-5 at 6 points).

    In float32 the null vector of A^T A comes from an f32 symmetric
    eigensolver whose roundoff differs between LAPACK builds by
    ~eps * cond(A^T A). At 12 and 40 points the two packages agree to
    2e-3 and 1e-3 (measured worst 1.4e-4 and 9.6e-5). At 6 points the
    system is exactly determined and neither package's f32 answer is
    reproducible: on draw 8 they differ by 0.18, JAX 0.061 and the port
    0.12 from the true pose. So no parity is claimed at 6 points.

    Batched calls equal one-by-one calls."""
    Ps, xs, rows = [], [], []
    for _ in range(8):
        P, x, R, t = _pnp_problem(rng, k, outliers=0.0, noise_px=0.0)
        R64, t64 = t_pnp._dlt_pnp(torch.from_numpy(P).double(), torch.from_numpy(x).double())
        assert max(np.abs(R64.numpy() - R).max(), np.abs(t64.numpy() - t).max()) < 5e-5
        Rt, tt = (a.numpy() for a in t_pnp._dlt_pnp(torch.from_numpy(P), torch.from_numpy(x)))
        assert np.allclose(Rt @ Rt.T, np.eye(3), atol=1e-5) and np.linalg.det(Rt) > 0
        if k >= 12:
            Rj, tj = (np.asarray(a) for a in j_pnp._dlt_pnp(jnp.asarray(P), jnp.asarray(x)))
            rows.append(max(np.abs(Rj - Rt).max(), np.abs(tj - tt).max()))
        Ps.append(P)
        xs.append(x)
    if k >= 12:
        assert max(rows) < (2e-3 if k == 12 else 1e-3), rows
    Rb, tb = t_pnp._dlt_pnp(torch.from_numpy(np.stack(Ps)), torch.from_numpy(np.stack(xs)))
    R1, t1 = t_pnp._dlt_pnp(torch.from_numpy(Ps[3]), torch.from_numpy(xs[3]))
    np.testing.assert_allclose(Rb[3].numpy(), R1.numpy(), atol=1e-6)
    np.testing.assert_allclose(tb[3].numpy(), t1.numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_with_the_jax_draw_matches_reference(seed):
    """Given the hypotheses jax.random.categorical draws from the key,
    the port's RANSAC equals JAX pnp_ransac(key, ...): pose within 1e-4
    (the refinement converges past the DLT's roundoff), the same inlier
    mask."""
    rng = np.random.default_rng(100 + seed)
    N = 256
    P, x, R, t = _pnp_problem(rng, N)
    mask = rng.uniform(size=N) < 0.8
    key = jax.random.PRNGKey(seed)
    thr = (4.0 / 400.0) ** 2
    rj = j_pnp.pnp_ransac(key, jnp.asarray(P), jnp.asarray(x), jnp.asarray(mask), threshold=thr)
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    idx = np.array(jax.random.categorical(key, logits[None, :], shape=(512, 6)))
    rt = t_pnp.pnp_ransac_from_indices(torch.from_numpy(idx), torch.from_numpy(P),
                                       torch.from_numpy(x), torch.from_numpy(mask),
                                       threshold=thr)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert np.array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 100
    assert np.abs(rt.R.numpy() - R).max() < 1e-2


def test_hypothesis_draw_follows_the_categorical_rule():
    """Six draws per hypothesis, with replacement, uniform over the masked
    points; with no masked point every index is 0 (as the JAX draw)."""
    g = torch.Generator()
    g.manual_seed(0)
    mask = torch.zeros(300, dtype=torch.bool)
    mask[torch.arange(0, 300, 3)] = True
    idx = t_pnp.draw_hypotheses(g, mask, 4096)
    assert idx.shape == (4096, 6) and bool(mask[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=300)[mask].float()
    # 24576 draws over 100 points: 245.8 each, binomial sd ~15.6.
    assert counts.min() > 170 and counts.max() < 330
    assert (idx[:, 0] == idx[:, 1]).float().mean() > 0.003       # with replacement
    assert int(t_pnp.draw_hypotheses(g, torch.zeros(10, dtype=torch.bool), 4).abs().sum()) == 0
    r = t_pnp.pnp_ransac(g, torch.zeros(10, 3), torch.zeros(10, 2),
                         torch.zeros(10, dtype=torch.bool), num_hypotheses=8)
    assert int(r.num_inliers) == 0 and torch.isfinite(r.R).all()


def test_room_scene_and_orbit_match_reference():
    Rj, tj = j_syn.orbit_trajectory(40, radius=2.5, total_angle=4 * np.pi)
    Rt, tt = t_syn.orbit_trajectory(40, radius=2.5, total_angle=4 * np.pi)
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    sj = j_syn.room_scene(np.random.default_rng(11), tex_size=48, half=5.5)
    st = t_syn.room_scene(np.random.default_rng(11), tex_size=48, half=5.5)
    assert len(st.planes) == len(sj.planes) == 5
    for a, b in zip(st.planes, sj.planes):
        np.testing.assert_array_equal(a.texture, b.texture)
        for f in ("p0", "n", "e1", "e2"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    from viso_tpu.geometry import camera as j_cam
    from viso_tpu_torch.geometry import camera as t_cam
    ij = j_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    it = t_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    a = j_syn.make_stereo_pair(sj, ij, Rj[7], tj[7], 48, 64, baseline=0.537)
    b = t_syn.make_stereo_pair(st, it, Rt[7], tt[7], 48, 64, baseline=0.537)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=1e-2)   # bilinear lookups of f32 poses
