"""The window-extraction kernel K1 (viso_tpu_torch.geometry.extract).

On the CPU its plain version must equal viso_tpu's gather path bit for
bit (a pure copy), including clamped borders. The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py and in
chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import extract_pallas as j_ext
from viso_tpu.geometry import sampling as j_smp
from viso_tpu_torch import _cuda
from viso_tpu_torch.geometry import extract as t_ext
from viso_tpu_torch.geometry import sampling as t_smp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _centers(rng, n, H, W):
    """Centers all over the image, plus every border and beyond it."""
    c = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    edge = np.array(
        [[-5.0, -5.0], [0.0, 0.0], [W - 1.0, H - 1.0], [W + 7.5, H + 3.2],
         [-0.5, H / 2], [W / 2, -0.7], [W - 0.2, H / 2], [W / 2, H - 0.01]]
    )
    return np.concatenate([edge, c]).astype(np.float32)


@pytest.mark.parametrize("H,W,win", [(376, 1240, 16), (47, 155, 24), (94, 310, 10),
                                     (40, 60, 12)])
def test_square_windows_bit_exact(rng, H, W, win):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    c = _centers(rng, 120, H, W)
    wj, bj = j_smp.extract_windows(jnp.asarray(img), jnp.asarray(c), win)
    wt, bt = t_ext.extract_windows_fast(torch.from_numpy(img), torch.from_numpy(c), win)
    assert bt.dtype == torch.int32 and wt.shape == (len(c), win, win)
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    # sampling.extract_windows takes the same dispatch.
    ws, bs = t_smp.extract_windows(torch.from_numpy(img), torch.from_numpy(c), win)
    assert torch.equal(ws, wt) and torch.equal(bs, bt)


def test_indexed_windows_bit_exact(rng):
    K, H, W, win = 9, 60, 90, 16
    imgs = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    c = _centers(rng, 100, H, W)
    k = rng.integers(0, K, len(c)).astype(np.int32)
    k[:3] = [0, K - 1, K - 1]          # the stack's ends
    wj, bj = j_smp.extract_windows_indexed(jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(c), win)
    wt, bt = t_ext.extract_windows_indexed_fast(
        torch.from_numpy(imgs), torch.from_numpy(k), torch.from_numpy(c), win
    )
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    ws, _ = t_smp.extract_windows_indexed(
        torch.from_numpy(imgs), torch.from_numpy(k), torch.from_numpy(c), win
    )
    assert torch.equal(ws, wt)


def test_rects_and_clamping_follow_dynamic_slice(rng):
    """Explicit origins outside the image and k outside the stack clamp as
    jax.lax.dynamic_slice clamps them; the rect path returns the base it
    was given."""
    H, W, h, w = 50, 200, 12, 140
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    base = np.stack([rng.integers(-30, W, 64), rng.integers(-10, H, 64)], -1).astype(np.int32)
    base[:2] = [[W, H], [-1000, -1000]]
    wj, bj = j_ext.extract_rects_fast(jnp.asarray(img), jnp.asarray(base), h, w)
    wt, bt = t_ext.extract_rects_fast(torch.from_numpy(img), torch.from_numpy(base), h, w)
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    assert np.array_equal(bt.numpy(), base) and np.array_equal(np.asarray(bj), base)

    K = 4
    imgs = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    k = np.array([-3, 0, 3, 9], np.int32)
    b = base[:4]
    ref = jax.vmap(
        lambda ki, bb: jax.lax.dynamic_slice(jnp.asarray(imgs), (ki, bb[1], bb[0]), (1, h, w))[0]
    )(jnp.asarray(k), jnp.asarray(b))
    got = t_ext.extract_plain(torch.from_numpy(imgs), torch.from_numpy(b), h, w,
                              k=torch.from_numpy(k))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_single_feature(rng):
    img = rng.uniform(0, 255, (20, 30)).astype(np.float32)
    c = np.array([[29.9, 19.9]], np.float32)
    wj, _ = j_smp.extract_windows(jnp.asarray(img), jnp.asarray(c), 10)
    wt, _ = t_ext.extract_windows_fast(torch.from_numpy(img), torch.from_numpy(c), 10)
    assert np.array_equal(wt.numpy(), np.asarray(wj))


def test_cpu_path_never_launches_and_other_devices_raise(rng):
    img = torch.from_numpy(rng.uniform(0, 255, (30, 40)).astype(np.float32))
    c = torch.tensor([[10.0, 10.0]])
    before = t_ext.launch.launches
    t_ext.extract_windows_fast(img, c, 8)
    assert t_ext.launch.launches == before
    with pytest.raises(ValueError, match="no window extractor"):
        t_ext.extract_windows_fast(img.to("meta"), c.to("meta"), 8)
    # sampling's entry points share that dispatch: no plain copy off the CPU.
    with pytest.raises(ValueError, match="no window extractor"):
        t_smp.extract_windows(img.to("meta"), c.to("meta"), 8)
    with pytest.raises(ValueError, match="no window extractor"):
        t_smp.extract_windows_indexed(img[None].to("meta"), torch.zeros(1, dtype=torch.int32,
                                      device="meta"), c.to("meta"), 8)
    with pytest.raises(ValueError, match="CUDA image"):
        t_ext.launch(img, torch.zeros((1, 2), dtype=torch.int32), 8, 8)


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: building the kernel raises (never returns None or falls
    back), naming nvcc."""
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "CUDA_ROOTS", (str(tmp_path / "no-cuda"),))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    assert _cuda.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        t_ext.load_library()
    assert _cuda._LIBS == {}
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    """A failing compiler raises RuntimeError carrying its output."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refuses' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        t_ext.load_library()
    assert not _cuda.library_path(t_ext.SOURCE).exists()


def test_port_imports_without_jax():
    """viso_tpu_torch never imports jax or viso_tpu: every module of the
    package imports in a process where importing jax fails."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['viso_tpu'] = None\n"
        "import importlib, pkgutil, viso_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(viso_tpu_torch.__path__, "
        "'viso_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'viso_tpu_torch.slam.full', 'viso_tpu_torch.tools.bench_extract', "
        "'viso_tpu_torch.utils.checkpoint', 'viso_tpu_torch.parallel.dist_ba'} <= set(names), "
        "names\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'viso_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
