"""The port's gather sampler and window samplers against viso_tpu's on
the same numpy inputs, on the CPU, with the cases and tolerances of
tests/test_sampling_fast.py (the same sampling formulas in f32: 1e-4 on
[0, 255] values where the arithmetic is the same, the reference's own
1e-3 / 1e-2 where two samplers are compared)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import sampling as js
from viso_tpu_torch.geometry import sampling as ts

torch.set_num_threads(2)


def T(x):
    return torch.tensor(np.asarray(x))


def close(a, b, tol):
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), rtol=0, atol=tol)


def _img(rng, shape=(96, 128)):
    return rng.uniform(0, 255, shape).astype(np.float32)


def _centers(rng, n, lo_u, hi_u, lo_v, hi_v):
    return np.stack([rng.uniform(lo_u, hi_u, n), rng.uniform(lo_v, hi_v, n)], -1).astype(np.float32)


def _grid(centers, half):
    offs = np.asarray(js.patch_offsets(half, jnp.float32))
    return centers[:, None, None, :] + offs[None]


def test_patch_offsets_match():
    for half in (2, 3, 4):
        assert np.array_equal(ts.patch_offsets(half).numpy(), np.asarray(js.patch_offsets(half)))


@pytest.mark.parametrize("half,win", [(4, 24), (3, 16)])
def test_windowed_matches_gather(rng, half, win):
    """test_sampling_fast.py::test_windowed_matches_gather and its grad
    variant on the port's separable window samplers: they agree with the
    JAX package's gather samplers (1e-3 values, 1e-2 gradients) and with
    its window samplers on the same windows (1e-4)."""
    img = _img(rng)
    c = _centers(rng, 64, 12, 116, 12, 84)
    uv = jnp.asarray(_grid(c, half))
    win_t, base_t = ts.extract_windows(T(img), T(c), win)
    v = ts.sample_patch_grid(win_t, base_t, T(c), half)
    close(v, js.bilinear(jnp.asarray(img), uv), 1e-3)
    v, gx, gy = ts.sample_patch_grid_with_grad(win_t, base_t, T(c), half)
    v_ref, g_ref = js.bilinear_with_grad(jnp.asarray(img), uv)
    close(v, v_ref, 1e-3)
    close(gx, g_ref[..., 0], 1e-2)
    close(gy, g_ref[..., 1], 1e-2)
    win_j, base_j = js.extract_windows(jnp.asarray(img), jnp.asarray(c), win)
    v_j, gx_j, gy_j = js.sample_patch_grid_with_grad(win_j, base_j, jnp.asarray(c), half)
    close(v, v_j, 1e-4)
    close(gx, gx_j, 1e-4)
    close(gy, gy_j, 1e-4)


def test_indexed_samplers_match(rng):
    """bilinear_indexed over a stack, corners clamped to [0, W-2] x
    [0, H-2], against JAX's (1e-4); and the windowed indexed path against
    it (test_windowed_indexed's case, 1e-3)."""
    imgs = _img(rng, (3, 64, 80))
    c = _centers(rng, 24, 12, 68, 12, 52)
    k = rng.integers(0, 3, 24).astype(np.int32)
    uv = _grid(c, 3)
    ref = js.bilinear_indexed(jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(uv))
    win, base = ts.extract_windows_indexed(T(imgs), T(k), T(c), 20)
    close(ts.sample_patch_grid(win, base, T(c), 3), ref, 1e-3)
    c[:2] = [[-2.0, 70.0], [85.0, -4.0]]
    uv = _grid(c, 3)
    close(ts.bilinear_indexed(T(imgs), T(k), T(uv)),
          js.bilinear_indexed(jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(uv)), 1e-4)


def test_window_edge_clamping(rng):
    """Centres near the border: windows clip to the image, and samples
    inside the image stay exact (JAX's gather sampler, 1e-3)."""
    img = _img(rng, (48, 64))
    c = np.asarray([[5.0, 5.0], [60.0, 44.0]], np.float32)
    win, base = ts.extract_windows(T(img), T(c), 16)
    close(ts.sample_patch_grid(win, base, T(c), 2),
          js.bilinear(jnp.asarray(img), jnp.asarray(_grid(c, 2))), 1e-3)


def test_patch_grid_scaled_with_grad_matches(rng):
    """test_patch_grid_scaled_matches_flattened's case: the port's scaled
    sampler against JAX's (1e-4) and against JAX's flattened window
    sampler at the reference's 3e-3 / 5e-3."""
    img = _img(rng)
    c = _centers(rng, 40, 16, 112, 16, 80)
    scale = rng.uniform(0.6, 1.8, 40).astype(np.float32)
    half = 3
    uv = c[:, None, None, :] + np.asarray(js.patch_offsets(half))[None] * scale[:, None, None, None]
    win, base = ts.extract_windows(T(img), T(c), 24)
    v, gx, gy = ts.sample_patch_grid_scaled_with_grad(win, base, T(c), half, T(scale))
    win_j, base_j = js.extract_windows(jnp.asarray(img), jnp.asarray(c), 24)
    v_j, gx_j, gy_j = js.sample_patch_grid_scaled_with_grad(
        win_j, base_j, jnp.asarray(c), half, jnp.asarray(scale))
    close(v, v_j, 1e-4)
    close(gx, gx_j, 1e-4)
    close(gy, gy_j, 1e-4)
    ref, g_ref = js.sample_windows_with_grad(win_j, base_j, jnp.asarray(uv))
    close(v, ref, 3e-3)
    close(gx, g_ref[..., 0], 5e-3)
    close(gy, g_ref[..., 1], 5e-3)
