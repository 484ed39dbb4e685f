"""Kernel K2, the row-aligned window extractor of the extraction
micro-benchmark (viso_tpu_torch.geometry.extract_aligned), and the port of
the benchmark tool.

The JAX kernel itself (`tools/bench_extract.py::extract_windows_pallas`)
runs here in Pallas interpret mode: the tool is imported by path and its
`pl.pallas_call` is swapped for an interpreting one for the test's
duration. The port's plain version must equal it bit for bit (a pure
copy), tiles and origins. The CUDA kernel is held against the plain
version in tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from viso_tpu.geometry import sampling as j_smp
from viso_tpu_torch import _cuda
from viso_tpu_torch.geometry import extract_aligned as k2
from viso_tpu_torch.geometry import sampling as t_smp
from viso_tpu_torch.tools import bench_extract as t_bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_tool(monkeypatch):
    """tools/bench_extract.py, imported by path, its Pallas call
    interpreted on the CPU."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    spec = importlib.util.spec_from_file_location(
        "_bench_extract_under_test", REPO / "tools" / "bench_extract.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(
        pl, "pallas_call",
        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()),
    )
    return mod


def _centers(rng, n, H, W, margin=0.0):
    c = np.stack([rng.uniform(margin, W - margin, n), rng.uniform(margin, H - margin, n)], -1)
    # Every border and beyond it: the origin clips to the image.
    edge = np.array([[-5.0, -5.0], [0.0, 0.0], [W - 1.0, H - 1.0], [W + 7.5, H + 3.2],
                     [-0.5, H / 2], [W / 2, -0.7], [W - 0.2, H / 2], [W / 2, H - 0.01]])
    c[: len(edge)] = edge
    return c.astype(np.float32)


@pytest.mark.parametrize("win,K", [(16, 64), (16, 32), (24, 64), (12, 128)])
def test_plain_equals_jax_kernel_in_interpret_mode(jax_tool, rng, win, K):
    H, W, N = 94, 310, 128
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    c = _centers(rng, N, H, W)
    tj, bj = jax_tool.extract_windows_pallas(jnp.asarray(img), jnp.asarray(c), win, K)
    tt, bt = k2.extract_windows_aligned(torch.from_numpy(img), torch.from_numpy(c), win, K)
    assert tt.shape == (N, win + 8, win) and bt.dtype == torch.int32
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.all(bt.numpy()[:, 1] % 8 == 0)
    # Bit-equal, every window written (N % K == 0).
    assert np.array_equal(tt.numpy(), np.asarray(tj))


def test_oracle_against_k1_windows(rng):
    """The tool's value oracle on the CPU: samples over K2's tiles equal
    samples over K1's exact windows (both plain versions here), and the
    JAX package's sampler over K1's windows."""
    H, W, N, win = 120, 200, 256, 16
    img = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32))
    c = torch.from_numpy(_centers(rng, N, H, W, margin=20.0)[8:])
    c = torch.cat([c, c[:8]])
    tiles, base = k2.extract_windows_aligned(img, c, win, 64)
    win1, base1 = t_smp.extract_windows(img, c, win)
    vals = t_smp.sample_patch_grid(tiles, base, c, win // 4)
    ref = t_smp.sample_patch_grid(win1, base1, c, win // 4)
    assert float((vals - ref).abs().max()) < t_bench.ORACLE_TOL
    jwin, jbase = j_smp.extract_windows(jnp.asarray(img.numpy()), jnp.asarray(c.numpy()), win)
    jref = j_smp.sample_patch_grid(jwin, jbase, jnp.asarray(c.numpy()), win // 4)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jref), atol=1e-3)


def test_k_must_divide_n_and_image_must_hold_a_tile(rng):
    img = torch.from_numpy(rng.uniform(0, 255, (40, 60)).astype(np.float32))
    c = torch.full((96, 2), 20.0)
    with pytest.raises(ValueError, match="not a multiple of K"):
        k2.extract_windows_aligned(img, c, 16, 64)
    with pytest.raises(ValueError, match="not a multiple of K"):
        k2.extract_windows_aligned(img, c, 16, 0)
    with pytest.raises(ValueError, match="smaller than"):
        k2.extract_windows_aligned(img[:23], c, 16, 32)
    with pytest.raises(ValueError, match="smaller than"):
        k2.extract_windows_aligned(img[:, :15], c, 16, 32)
    tiles, _ = k2.extract_windows_aligned(img[:24, :16], c, 16, 32)   # exactly one tile
    assert torch.equal(tiles[0], img[:24, :16])


def test_cpu_never_launches_and_other_devices_raise(rng):
    img = torch.from_numpy(rng.uniform(0, 255, (40, 60)).astype(np.float32))
    c = torch.full((64, 2), 20.0)
    before = k2.launch.launches
    k2.extract_windows_aligned(img, c, 16, 64)
    assert k2.launch.launches == before
    with pytest.raises(ValueError, match="no aligned window extractor"):
        k2.extract_windows_aligned(img.to("meta"), c.to("meta"), 16, 64)
    with pytest.raises(ValueError, match="CUDA image"):
        k2.launch(img, c, 16, 64)


def test_k2_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "CUDA_ROOTS", (str(tmp_path / "no-cuda"),))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    with pytest.raises(RuntimeError, match="extract_aligned.cu: nvcc not found"):
        k2.load_library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build_all()
    assert _cuda._LIBS == {}


def test_build_all_starts_one_compiler_per_source(monkeypatch, tmp_path):
    """build_all runs nvcc once for every csrc/*.cu, each into its own
    hash-keyed library, and reports every failing source."""
    log = tmp_path / "calls"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "for a in \"$@\"; do case $a in *extract_aligned.cu) "
        "echo 'error: refuses aligned' >&2; exit 2;; esac; done\n"
        "prev=''; for a in \"$@\"; do [ \"$prev\" = -o ] && : > \"$a\"; prev=$a; done\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    srcs = _cuda.sources()
    assert {s.name for s in srcs} >= {"extract_windows.cu", "extract_aligned.cu"}
    with pytest.raises(RuntimeError, match="refuses aligned"):
        _cuda.build_all()
    assert len(log.read_text().splitlines()) == len(srcs)
    assert "sm_90a" in log.read_text()
    assert _cuda.library_path(_cuda.CSRC / "extract_windows.cu").is_file()
    assert not _cuda.library_path(_cuda.CSRC / "extract_aligned.cu").exists()


def test_tool_needs_a_cuda_device_and_times_every_shape():
    """Without a card the tool raises (it never times the CPU); its shape
    sweep is the JAX tool's: 2 N x 2 windows x every K dividing N."""
    code = (
        "import torch; torch.cuda.is_available = lambda: False\n"
        "from viso_tpu_torch.tools import bench_extract as b\n"
        "try:\n    b.main()\nexcept RuntimeError as e:\n    print('raised', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert "raised bench_extract needs a CUDA device" in out.stdout, out.stderr
    shapes = [(n, w, k) for n in t_bench.NS for w in t_bench.WINS for k in t_bench.KS
              if n % k == 0]
    assert len(shapes) == 12
    img, centers = t_bench.inputs("cpu")
    assert img.shape == (t_bench.H, t_bench.W)
    assert {n: tuple(c.shape) for n, c in centers.items()} == {1024: (1024, 2), 2048: (2048, 2)}
