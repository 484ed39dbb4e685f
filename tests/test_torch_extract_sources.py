"""K1's centred and two-source entries, the timers' byte count and K2's TMA
acceptance check, on the CPU.

The plain versions of the centred entries (`extract_windows_fast`,
`extract_windows_indexed_fast`) and of the two-source entry (align's one
call over the keyframe stack and the current image) must equal the JAX
package's `extract_pallas` entry points on their CPU gather path bit for
bit (a pure copy: tolerance 0), the two-source entry against the call the
JAX `_align_level` makes over `jnp.concatenate([stack, img[None]])`. The
CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import extract_pallas as j_ext
from viso_tpu_torch.geometry import extract as t_ext
from viso_tpu_torch.geometry import extract_aligned as t_k2
from viso_tpu_torch.tools import bench_extract as t_bench

torch.set_num_threads(2)


def _centers(rng, n, H, W):
    """Centres all over the image, at every border, beyond it and far out."""
    c = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    edge = np.array(
        [[-5.0, -5.0], [0.0, 0.0], [W - 1.0, H - 1.0], [W + 7.5, H + 3.2],
         [-0.5, H / 2], [W / 2, -0.7], [W - 0.2, H / 2], [W / 2, H - 0.01],
         [-1e6, 3.0], [3.0, 1e6]]
    )
    return np.concatenate([edge, c]).astype(np.float32)


@pytest.mark.parametrize("H,W,win", [(47, 155, 10), (94, 310, 24), (60, 90, 16),
                                     (46, 154, 12), (40, 60, 34)])
def test_centred_plain_matches_jax_entry(rng, H, W, win):
    """extract_windows_fast's plain version: windows and origins equal to
    extract_pallas.extract_windows_fast (CPU gather path), tolerance 0."""
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    c = _centers(rng, 90, H, W)
    wj, bj = j_ext.extract_windows_fast(jnp.asarray(img), jnp.asarray(c), win)
    wt, bt = t_ext.extract_windows_fast(torch.from_numpy(img), torch.from_numpy(c), win)
    assert bt.dtype == torch.int32 and wt.shape == (len(c), win, win)
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("H,W,win", [(60, 90, 16), (23, 77, 10)])
def test_centred_indexed_plain_matches_jax_entry(rng, H, W, win):
    K = 5
    imgs = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    c = _centers(rng, 70, H, W)
    k = rng.integers(0, K, len(c)).astype(np.int32)
    k[:2] = [0, K - 1]
    wj, bj = j_ext.extract_windows_indexed_fast(jnp.asarray(imgs), jnp.asarray(k),
                                                jnp.asarray(c), win)
    wt, bt = t_ext.extract_windows_indexed_fast(torch.from_numpy(imgs), torch.from_numpy(k),
                                                torch.from_numpy(c), win)
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("K,H,W,n", [(8, 60, 90, 64), (3, 23, 77, 17), (1, 40, 60, 5)])
def test_two_source_plain_matches_jax_align_call(rng, K, H, W, n):
    """The two-source entry (stack windows, then current-image windows)
    equals the JAX `_align_level` call: extract_windows_indexed_fast over
    the stack with the current image appended as image K. Tolerance 0."""
    win = 16
    stack = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    cur = rng.uniform(0, 255, (H, W)).astype(np.float32)
    c_ref = _centers(rng, n, H, W)
    c_cur = c_ref + rng.uniform(-3, 3, c_ref.shape).astype(np.float32)
    k = rng.integers(0, K, len(c_ref))                 # int64, as align's argmax
    m = len(c_ref)
    k_all = np.concatenate([k, np.full(m, K)]).astype(np.int32)
    wj, bj = j_ext.extract_windows_indexed_fast(
        jnp.concatenate([jnp.asarray(stack), jnp.asarray(cur)[None]]), jnp.asarray(k_all),
        jnp.concatenate([jnp.asarray(c_ref), jnp.asarray(c_cur)]), win)
    wt, bt = t_ext.extract_windows_two_source(
        torch.from_numpy(stack), torch.from_numpy(k), torch.from_numpy(c_ref),
        torch.from_numpy(cur), torch.from_numpy(c_cur), win)
    assert wt.shape == (2 * m, win, win) and bt.shape == (2 * m, 2)
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("H,W,win", [(376, 1240, 16), (23, 77, 23), (40, 60, 34)])
def test_centered_base_matches_jax(rng, H, W, win):
    """`base` (centered_base, which the kernel reproduces on the card)
    equals extract_pallas._centered_base, far-out centres included."""
    c = _centers(rng, 200, H, W)
    bj = j_ext._centered_base((H, W), jnp.asarray(c), win)
    bt = t_ext.centered_base((H, W), torch.from_numpy(c), win)
    assert bt.dtype == torch.int32
    assert np.array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("n,h,w,us", [(1024, 10, 10, 0.245), (256, 10, 10, 0.061),
                                      (1024, 16, 16, 0.626), (1024, 24, 24, 1.409),
                                      (2048, 16, 16, 1.252), (504, 12, 140, 2.022),
                                      (256, 34, 34, 0.707), (2048, 32, 24, 3.756)])
def test_bound_counts_each_window_read_and_written_once(n, h, w, us):
    """bound_ms: 2 * n * h * w * 4 bytes over 3.35 TB/s (exact), which
    gives the microseconds of the kernel table to 3 decimals."""
    assert t_bench.bound_ms(n, h, w) == 2.0 * n * h * w * 4 / 3.35e12 * 1e3
    assert round(1e3 * t_bench.bound_ms(n, h, w), 3) == us


def test_flat_index_takes_the_plain_windows(rng):
    """The library yardstick's flat index (torch.take) copies exactly the
    plain version's windows, explicit and indexed, clamping included."""
    K, H, W = 4, 30, 50
    imgs = torch.from_numpy(rng.uniform(0, 255, (K, H, W)).astype(np.float32))
    base = torch.from_numpy(np.stack([rng.integers(-20, W + 5, 40),
                                      rng.integers(-8, H + 5, 40)], -1).astype(np.int32))
    k = torch.from_numpy(rng.integers(-2, K + 2, 40).astype(np.int32))
    idx = t_bench.flat_index(imgs[0].shape, base, 6, 12)
    assert torch.equal(torch.take(imgs[0].reshape(-1), idx),
                       t_ext.extract_plain(imgs[0], base, 6, 12))
    idx = t_bench.flat_index(imgs.shape, base, 6, 12, k=k)
    assert torch.equal(torch.take(imgs.reshape(-1), idx),
                       t_ext.extract_plain(imgs, base, 6, 12, k=k))


@pytest.mark.parametrize("ptr,W,win,why", [
    (0x7F0000000000, 1240, 16, None), (0x7F0000000000, 1240, 24, None),
    (0x7F0000000010, 620, 12, None),
    (0x7F0000000004, 1240, 16, "16-byte aligned"),
    (0x7F0000000000, 1241, 16, "row pitch"), (0x7F0000000000, 1242, 24, "row pitch"),
    (0x7F0000000000, 1240, 10, "box row"), (0x7F0000000000, 1240, 252, "box"),
    (0x7F0000000000, 1240, 128, "stage"),
])
def test_k2_tma_acceptance(ptr, W, win, why):
    """K2's TMA needs a 16-byte aligned image and row pitch; its box (win + 4
    columns, so it can start at x0 & ~3) needs rows of a multiple of 16
    bytes, sides of at most 256, and must fit one stage."""
    got = t_k2.tma_rejects(ptr, W, win)
    if why is None:
        assert got is None
    else:
        assert got is not None and why in got


def test_new_entries_dispatch_by_device(rng):
    """CPU tensors take the plain versions and never launch; other devices
    raise; the CUDA wrappers refuse CPU tensors."""
    img = torch.from_numpy(rng.uniform(0, 255, (30, 40)).astype(np.float32))
    c = torch.tensor([[10.0, 10.0], [35.5, 2.0]])
    k = torch.zeros(2, dtype=torch.int64)
    before = t_ext.launch.launches
    w2, b2 = t_ext.extract_windows_two_source(img[None], k, c, img, c, 8)
    assert t_ext.launch.launches == before
    assert torch.equal(w2[:2], w2[2:]) and torch.equal(b2[:2], b2[2:])
    with pytest.raises(ValueError, match="no window extractor"):
        t_ext.extract_windows_two_source(img[None].to("meta"), k.to("meta"), c.to("meta"),
                                         img.to("meta"), c.to("meta"), 8)
    with pytest.raises(ValueError, match="CUDA image"):
        t_ext.launch_centered(img, c, 8)
    with pytest.raises(ValueError, match="CUDA image"):
        t_ext.launch_centered(img[None], c, 8, k=k.to(torch.int32), img2=img, centers2=c)


def test_k1_case_table_and_frame_bound(monkeypatch):
    """The main-path case table (shared by chip_smoke.py and
    tools/bench_k1.py): every window fits its image, align's cases hold
    the 8-keyframe stack plus the current image, a tracked frame makes 6
    calls, and their bytes bound the frame at 5.243 us on the H100."""
    from viso_tpu_torch.tools import bench_k1

    assert len(bench_k1.MAIN_PATH_CASES) == 26
    for name, shape, (h, w), n, indexed in bench_k1.MAIN_PATH_CASES:
        assert h <= shape[-2] and w <= shape[-1] and n > 0, name
        assert indexed == (len(shape) == 3) and (not indexed or shape[0] == 9), name
    assert len(bench_k1.TRACK_CASES) == 6
    cases = {c[0]: c for c in bench_k1.MAIN_PATH_CASES}
    frame = sum(t_bench.bound_ms(cases[n][3], *cases[n][2]) for n in bench_k1.TRACK_CASES)
    assert round(1e3 * frame, 3) == 5.243
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_k1.main([])
