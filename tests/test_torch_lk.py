"""The port's pyramidal LK against viso_tpu's on the same pyramids (built
by the JAX package) and keypoints, on the CPU. The JAX tracker's window
copies take its jnp path here (`extract_pallas.use_pallas()` is False off
the TPU); the port's take the plain version of K1 through the two-source
entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import extract_pallas
from viso_tpu.ops import fast as j_fast
from viso_tpu.ops import lk as j_lk
from viso_tpu.ops import pyramid as j_pyr
from viso_tpu_torch.geometry import extract
from viso_tpu_torch.ops import lk as t_lk

torch.set_num_threads(2)

H, W = 184, 616    # the mono cell's geometry: level 3 is 23 x 77 (window 23)
INTR = dict(fx=359.428, fy=359.428, cx=303.5964, cy=92.60785)


def _pyramids(a, b):
    pa = j_pyr.build_pyramid(jnp.asarray(a, jnp.float32), 4)
    pb = j_pyr.build_pyramid(jnp.asarray(b, jnp.float32), 4)
    to_t = lambda p: tuple(torch.tensor(np.asarray(x)) for x in p)  # noqa: E731
    return pa, pb, to_t(pa), to_t(pb)


def _keypoints(pyr):
    uv, _, mask = j_fast.detect_grid_pyramid(pyr, threshold=8.0, grid=(4, 8), per_cell=8,
                                             levels=3)
    return np.asarray(uv), np.asarray(mask)


@pytest.fixture(scope="module")
def corridor_pair():
    """Two frames of the mono cell's corridor, 0.45 m and 0.6 deg apart
    (three frames of its trajectory)."""
    scene = j_syn.corridor_scene(np.random.default_rng(5), tex_size=512, far_z=90.0)
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(4, step=0.15, yaw_rate=0.002)
    a = np.clip(scene.render(intr, Rs[0], ts[0], H, W)[0], 0, 255).astype(np.uint8)
    b = np.clip(scene.render(intr, Rs[3], ts[3], H, W)[0], 0, 255).astype(np.uint8)
    return a, b


def _compare(pa, pb, ta, tb, uv, mask, flow_tol, err_tol):
    kj, ej, okj = (np.asarray(x) for x in j_lk.track(pa, pb, jnp.asarray(uv), jnp.asarray(mask)))
    kt, et, okt = (x.numpy() for x in t_lk.track(ta, tb, torch.tensor(uv), torch.tensor(mask)))
    both = okj & okt
    assert both.sum() >= 0.97 * okj.sum() and both.sum() >= 0.97 * okt.sum(), (okj.sum(), okt.sum())
    assert np.abs(kt - kj)[both].max() < flow_tol
    np.testing.assert_allclose(et[both], ej[both], rtol=err_tol, atol=err_tol)
    return kt, okt


def test_lk_pure_translation_matches(rng):
    """A textured image shifted by (3.4, -2.2) px: both trackers recover
    the shift, and agree to 1e-3 px on points both accept (10 GN steps at
    each of 4 levels in f32, summed in another order)."""
    img = j_syn.smooth_texture(rng, H, W)
    moved = nd_shift(img, (-2.2, 3.4), order=3, mode="nearest").astype(np.float32)
    pa, pb, ta, tb = _pyramids(img, moved)
    uv, mask = _keypoints(pa)
    inner = (uv[:, 0] > 20) & (uv[:, 0] < W - 20) & (uv[:, 1] > 20) & (uv[:, 1] < H - 20)
    kt, ok = _compare(pa, pb, ta, tb, uv, mask & inner, 1e-3, 1e-2)
    np.testing.assert_allclose(np.median(kt[ok] - uv[ok], axis=0), [3.4, -2.2], atol=0.05)


def test_lk_large_motion_matches(corridor_pair):
    """Corridor frames three steps apart (radial flow up to ~20 px at the
    border): tracked positions agree within 0.01 px, the photometric
    errors within 1 %."""
    pa, pb, ta, tb = _pyramids(*corridor_pair)
    uv, mask = _keypoints(pa)
    _, ok = _compare(pa, pb, ta, tb, uv, mask, 1e-2, 1e-2)
    assert ok.sum() > 100


def test_lk_window_geometry_and_solver(monkeypatch):
    """The level windows are 4*half+8 = 24 px, clipped to 23 at level 3 of
    184x616, read from both images in one two-source call; `_solve2x2`
    matches the JAX solver, singular systems flagged."""
    calls = []
    real = extract.extract_windows_two_source

    def spy(stack, k, centers, img, centers2, win):
        calls.append((tuple(stack.shape), win))
        return real(stack, k, centers, img, centers2, win)

    monkeypatch.setattr(extract, "extract_windows_two_source", spy)
    pyr = tuple(torch.rand((H >> lvl, W >> lvl)) * 255 for lvl in range(4))
    t_lk.track(pyr, pyr, torch.tensor([[100.0, 90.0], [300.0, 40.0]]),
               torch.ones(2, dtype=torch.bool))
    assert calls == [((1, 23, 77), 23), ((1, 46, 154), 24), ((1, 92, 308), 24),
                     ((1, 184, 616), 24)]
    assert not extract_pallas.use_pallas()     # the JAX side runs its jnp path
    Hm = np.array([[[2.0, 1.0], [1.0, 3.0]], [[1.0, 2.0], [2.0, 4.0]]], np.float32)
    b = np.array([[1.0, -1.0], [3.0, 1.0]], np.float32)
    xj, okj = j_lk._solve2x2(jnp.asarray(Hm), jnp.asarray(b), 1e-4)
    xt, okt = t_lk._solve2x2(torch.tensor(Hm), torch.tensor(b), 1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6)
    assert okt.tolist() == np.asarray(okj).tolist() == [True, False]
