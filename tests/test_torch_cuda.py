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
