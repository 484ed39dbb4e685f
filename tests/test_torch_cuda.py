"""The CUDA kernels (K1 window extraction, K2 row-aligned extraction)
against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, carries the `cuda` marker
and skips with a reason elsewhere. This file imports neither jax nor
viso_tpu, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from viso_tpu_torch.geometry import extract as t_ext
from viso_tpu_torch.geometry import extract_aligned as t_k2
from viso_tpu_torch.geometry import sampling as t_smp
from viso_tpu_torch.ops import descriptors as t_desc


def _centers(rng, n, H, W):
    """Centers all over the image, plus every border and beyond it."""
    c = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    edge = np.array(
        [[-5.0, -5.0], [0.0, 0.0], [W - 1.0, H - 1.0], [W + 7.5, H + 3.2],
         [-0.5, H / 2], [W / 2, -0.7], [W - 0.2, H / 2], [W / 2, H - 0.01]]
    )
    return np.concatenate([edge, c]).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,win,n", [(376, 1240, 16, 1024), (188, 620, 24, 1024),
                                       (47, 155, 24, 256), (376, 1240, 12, 504)])
def test_kernel_matches_plain_on_cuda(rng, cuda_device, H, W, win, n):
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(_centers(rng, n, H, W)).to(cuda_device)
    before = t_ext.launch.launches
    got, base = t_ext.extract_windows_fast(img, c, win)
    torch.cuda.synchronize()
    assert t_ext.launch.launches == before + 1
    assert torch.equal(got, t_ext.extract_plain(img, base, win, win))


@pytest.mark.cuda
def test_kernel_indexed_and_rect_match_plain_on_cuda(rng, cuda_device):
    imgs = torch.from_numpy(rng.uniform(0, 255, (9, 376, 1240)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(_centers(rng, 2048, 376, 1240)).to(cuda_device)
    k = torch.from_numpy(rng.integers(-2, 11, len(c)).astype(np.int32)).to(cuda_device)
    got, base = t_ext.extract_windows_indexed_fast(imgs, k, c, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, t_ext.extract_plain(imgs, base, 16, 16, k=k))
    b = torch.from_numpy(
        np.stack([rng.integers(-200, 1300, 504), rng.integers(-20, 400, 504)], -1).astype(np.int32)
    ).to(cuda_device)
    got, _ = t_ext.extract_rects_fast(imgs[0], b, 12, 140)
    torch.cuda.synchronize()
    assert torch.equal(got, t_ext.extract_plain(imgs[0], b, 12, 140))


@pytest.mark.cuda
def test_sampling_entry_points_launch_the_kernel(rng, cuda_device):
    """sampling.extract_windows* take the kernel on CUDA tensors, as the
    extract module's entry points do."""
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 94, 310)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(_centers(rng, 256, 94, 310)).to(cuda_device)
    k = torch.from_numpy(rng.integers(0, 3, len(c)).astype(np.int32)).to(cuda_device)
    before = t_ext.launch.launches
    got, base = t_smp.extract_windows(imgs[0], c, 24)
    got_k, base_k = t_smp.extract_windows_indexed(imgs, k, c, 16)
    torch.cuda.synchronize()
    assert t_ext.launch.launches == before + 2
    assert torch.equal(got, t_ext.extract_plain(imgs[0], base, 24, 24))
    assert torch.equal(got_k, t_ext.extract_plain(imgs, base_k, 16, 16, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("n,win,k", [(1024, 16, 64), (1024, 24, 128), (2048, 16, 256),
                                     (2048, 24, 64), (128, 16, 128)])
def test_k2_matches_plain_on_cuda(rng, cuda_device, n, win, k):
    """K2 is a pure copy: tiles and origins bit-equal to the plain
    version at the micro-benchmark's shapes, centres at and beyond every
    border included."""
    H, W = 376, 1240
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(_centers(rng, n - 8, H, W)).to(cuda_device)
    before = t_k2.launch.launches
    tiles, base = t_k2.extract_windows_aligned(img, c, win, k)
    torch.cuda.synchronize()
    assert t_k2.launch.launches == before + 1
    ref, ref_base = t_k2.extract_plain(img, c, win, k)
    assert tiles.shape == (n, win + 8, win)
    assert torch.equal(base, ref_base) and torch.equal(tiles, ref)
    with pytest.raises(ValueError, match="not a multiple of K"):
        t_k2.extract_windows_aligned(img, c[:-1], win, k)


def _nonfinite(c):
    """Eight centres with NaN and +-inf in either coordinate, then c."""
    inf, nan = float("inf"), float("nan")
    bad = torch.tensor([[nan, 5.0], [5.0, nan], [inf, 5.0], [-inf, 5.0], [5.0, inf],
                        [5.0, -inf], [nan, nan], [inf, -inf]])
    return torch.cat([bad, c])


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,win,n", [(376, 1240, 10, 1024), (47, 155, 10, 256),
                                       (188, 620, 24, 1024), (23, 77, 23, 256),
                                       (376, 1240, 12, 504), (184, 616, 34, 256),
                                       (94, 310, 16, 1)])
def test_centred_entries_match_plain_on_cuda(rng, cuda_device, H, W, win, n):
    """The centred entries compute the origins in the kernel: windows and
    origins bit-equal to `centered_plain` (torch on the card), NaN and
    +-inf centres included, one launch per call."""
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda_device)
    c = _nonfinite(torch.from_numpy(_centers(rng, n + 8, H, W))).to(cuda_device)
    before = t_ext.launch.launches
    got, base = t_ext.extract_windows_fast(img, c, win)
    torch.cuda.synchronize()
    assert t_ext.launch.launches == before + 1
    ref, ref_base = t_ext.centered_plain(img, c, win)
    assert torch.equal(base, ref_base) and torch.equal(got, ref)
    stack = torch.stack([img, img.flip(0), img + 1.0])
    k = torch.from_numpy(rng.integers(-4, 6, len(c)).astype(np.int32)).to(cuda_device)
    got, base = t_ext.extract_windows_indexed_fast(stack, k, c, win)
    ref, ref_base = t_ext.centered_plain(stack, c, win, k=k)
    assert torch.equal(base, ref_base) and torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,n", [(376, 1240, 1024), (188, 620, 1024), (92, 308, 1024),
                                   (40, 60, 3)])
def test_two_source_matches_plain_and_the_concat_on_cuda(rng, cuda_device, H, W, n):
    """The two-source entry (align's call) in one launch: bit-equal to its
    plain version and to the indexed extraction over the concatenated
    stack it replaces, k at and past the stack's ends, centres past every
    border and non-finite."""
    K, win = 8, 16
    stack = torch.from_numpy(rng.uniform(0, 255, (K, H, W)).astype(np.float32)).to(cuda_device)
    cur = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda_device)
    c_ref = _nonfinite(torch.from_numpy(_centers(rng, n + 8, H, W))).to(cuda_device)
    c_cur = torch.from_numpy(_centers(rng, n + 16, H, W)).to(cuda_device)
    k = torch.from_numpy(rng.integers(0, K, len(c_ref))).to(cuda_device)   # int64, as argmax
    k[:3] = torch.tensor([-1, K - 1, K + 2])
    before = t_ext.launch.launches
    got, base = t_ext.extract_windows_two_source(stack, k, c_ref, cur, c_cur, win)
    torch.cuda.synchronize()
    assert t_ext.launch.launches == before + 1
    assert got.shape == (2 * len(c_ref), win, win) and base.shape == (2 * len(c_ref), 2)
    ref, ref_base = t_ext.two_source_plain(stack, k, c_ref, cur, c_cur, win)
    assert torch.equal(base, ref_base) and torch.equal(got, ref)
    # Against the concatenation it replaces, with k inside the stack (as
    # align's argmax gives it; past the end, the concatenated stack's
    # clamp would reach the current image).
    k = torch.clamp(k, 0, K - 1)
    got, base = t_ext.extract_windows_two_source(stack, k, c_ref, cur, c_cur, win)
    k_all = torch.cat([k.to(torch.int32), torch.full_like(k, K, dtype=torch.int32)])
    old, old_base = t_ext.extract_windows_indexed_fast(
        torch.cat([stack, cur[None]]), k_all, torch.cat([c_ref, c_cur]), win)
    assert torch.equal(base, old_base) and torch.equal(got, old)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_cuda(rng, cuda_device):
    """Every K1 entry and K2 can be captured in a CUDA graph: a replay
    gives what the eager call gives."""
    from viso_tpu_torch.tools import bench_extract as bx

    H, W = 376, 1240
    imgs = torch.from_numpy(rng.uniform(0, 255, (9, H, W)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(_centers(rng, 1016, H, W)).to(cuda_device)
    k = torch.from_numpy(rng.integers(0, 8, len(c)).astype(np.int32)).to(cuda_device)
    b = t_ext.centered_base((H, W), c, 12)
    calls = [
        lambda: t_ext.extract_windows_fast(imgs[0], c, 16),
        lambda: t_ext.extract_windows_indexed_fast(imgs, k, c, 16),
        lambda: t_ext.extract_windows_two_source(imgs[:8], k, c, imgs[8], c + 1.5, 16),
        lambda: t_ext.extract_rects_fast(imgs[0], b, 12, 140),
        lambda: t_k2.extract_windows_aligned(imgs[0], c[:1024], 24, 256),
    ]
    for fn in calls:
        assert bx.graph_matches_eager(fn)


@pytest.mark.cuda
@pytest.mark.parametrize("n,win", [(1024, 16), (1024, 24), (2048, 16), (2048, 24)])
def test_k2_same_tiles_at_every_k_on_cuda(cuda_device, n, win):
    """At the tool's shapes K2's tiles and origins are the same for K =
    64, 128 and 256 (K no longer shapes the launch), and equal plain."""
    from viso_tpu_torch.tools import bench_extract as bx

    img, centers = bx.inputs(cuda_device)
    c = centers[n]
    ref, ref_base = t_k2.extract_plain(img, c, win, 64)
    for K in (64, 128, 256):
        tiles, base = t_k2.extract_windows_aligned(img, c, win, K)
        torch.cuda.synchronize()
        assert torch.equal(base, ref_base) and torch.equal(tiles, ref)


@pytest.mark.cuda
def test_k2_nonfinite_centres_and_tma_refusals_on_cuda(rng, cuda_device):
    """NaN and +-inf centres give the plain version's origins (torch's
    cast on the card); an image TMA cannot take raises, never falls back."""
    H, W = 376, 1240
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(cuda_device)
    c = _nonfinite(torch.from_numpy(_centers(rng, 240, H, W))).to(cuda_device)
    tiles, base = t_k2.extract_windows_aligned(img, c, 16, 64)
    ref, ref_base = t_k2.extract_plain(img, c, 16, 64)
    assert torch.equal(base, ref_base) and torch.equal(tiles, ref)
    before = t_k2.launch.launches
    odd = torch.zeros((H, W + 1), device=cuda_device)           # W * 4 % 16 == 4
    with pytest.raises(ValueError, match="row pitch"):
        t_k2.extract_windows_aligned(odd, c, 16, 64)
    shifted = torch.zeros(H * W + 1, device=cuda_device)[1:].view(H, W)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_k2.extract_windows_aligned(shifted, c, 16, 64)
    assert t_k2.launch.launches == before


@pytest.mark.cuda
def test_descriptors_launch_k1_on_cuda(rng, cuda_device):
    """descriptors.compute takes its 34x34 windows from K1 on a CUDA image
    and gives the CPU result (identical windows; matmuls in full f32, so
    at most a few near-tie bits may flip)."""
    H, W = 184, 616
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    kps = np.stack([rng.uniform(0, W, 256), rng.uniform(0, H, 256)], -1).astype(np.float32)
    mask = rng.uniform(size=256) > 0.1
    before = t_ext.launch.launches
    got = t_desc.compute(torch.from_numpy(img).to(cuda_device),
                         torch.from_numpy(kps).to(cuda_device),
                         torch.from_numpy(mask).to(cuda_device))
    torch.cuda.synchronize()
    assert t_ext.launch.launches == before + 1
    ref = t_desc.compute(torch.from_numpy(img), torch.from_numpy(kps), torch.from_numpy(mask))
    got = got.float().cpu()
    ref = ref.float()
    assert torch.equal(got != 0, ref != 0)
    assert int((got != ref).sum()) <= 0.01 * int((ref != 0).sum())
