"""The JAX package's own ingestion test cases (tests/test_native.py and
tests/test_datasets.py) run on the port, on the CPU: the same files
(written by the reference tests' helpers from the same rng draws, and
tests/fixtures/) and the same assertions, with the port's native
decoder and prefetch ring and its dataset loaders. Each test is named
after the reference test it restates; the native cases skip where the
reference's do (no native library).

Both packages' loaders on the same files, field by field, are in
tests/test_torch_data.py; the ring on the engine's sequences in
tests/test_torch_ingest.py.
"""

import os
import shutil

import numpy as np
import pytest
from test_datasets import FIXTURES, _write_euroc_cam, make_mini_kitti
from test_datasets import _write_png as _write_png_dirs
from test_native import _write_png

from viso_tpu_torch.data import datasets, native, png_io


@pytest.fixture
def needs_native():
    """Skips where the reference's native tests skip: no native library
    (decided when the test runs, not when the module is imported)."""
    if not native.available():
        pytest.skip("native library unavailable")


# -- tests/test_native.py -------------------------------------------------------

def test_decode_matches_opencv(needs_native, tmp_path, rng):
    img = rng.integers(0, 255, size=(120, 200)).astype(np.uint8)
    p = os.path.join(tmp_path, "img.png")
    _write_png(p, img)
    out = native.decode_gray(p)
    assert out is not None and out.dtype == np.float32
    assert np.array_equal(out.astype(np.uint8), img)


def test_decode_color_and_16bit(needs_native, tmp_path, rng):
    pc = os.path.join(tmp_path, "c.png")
    _write_png(pc, rng.integers(0, 255, size=(40, 50, 3)).astype(np.uint8))
    oc = native.decode_gray(pc)
    assert oc is not None and oc.shape == (40, 50)
    img16 = rng.integers(0, 65535, size=(32, 32)).astype(np.uint16)
    p16 = os.path.join(tmp_path, "d16.png")
    _write_png(p16, img16)
    o16 = native.decode_gray(p16)
    assert o16 is not None
    assert np.allclose(o16, img16 >> 8, atol=1)


def test_decode_pgm(needs_native, tmp_path, rng):
    img = rng.integers(0, 255, size=(30, 40)).astype(np.uint8)
    p = os.path.join(tmp_path, "img.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n40 30\n255\n" + img.tobytes())
    out = native.decode_gray(p)
    assert out is not None
    assert np.array_equal(out.astype(np.uint8), img)


def test_prefetcher_order_and_completeness(needs_native, tmp_path, rng):
    paths, truth = [], []
    for i in range(9):
        img = rng.integers(0, 255, size=(48, 64)).astype(np.uint8)
        paths.append(os.path.join(tmp_path, f"{i}.png"))
        _write_png(paths[-1], img)
        truth.append(img)
    pf = native.Prefetcher(paths, ring=3, threads=2)
    for i, img in enumerate(pf):
        assert np.array_equal(img.astype(np.uint8), truth[i]), i
    assert i == 8
    pf.close()


def test_decode_missing_file(needs_native):
    assert native.decode_gray("/nonexistent/nope.png") is None


# -- tests/test_datasets.py -----------------------------------------------------

def test_kitti_loader(tmp_path, rng):
    make_mini_kitti(str(tmp_path), rng)
    seq = datasets.load_kitti(str(tmp_path), "03", stereo=True)
    assert abs(float(seq.intrinsics.fx) - 700.0) < 1e-6
    assert abs(seq.baseline - 375.0 / 700.0) < 1e-6
    frames = list(seq.frames)
    assert len(frames) == 4
    assert frames[0].image.shape == (60, 120)
    assert frames[0].image_right is not None
    assert seq.gt_R.shape == (4, 3, 3)
    c = -np.einsum("nji,nj->ni", seq.gt_R, seq.gt_t)
    assert np.allclose(c[:, 0], [0, 0.5, 1.0, 1.5], atol=1e-5)
    assert np.allclose(c[:, 2], [0, 1, 2, 3], atol=1e-5)


def test_image_dir_protocol(tmp_path, rng):
    # The reference's "<dir><n>.png" protocol (frame_sequence.h:28).
    for n in (1, 2, 3):
        _write_png_dirs(os.path.join(str(tmp_path), f"{n}.png"), rng.integers(0, 255, (32, 40)))
    frames = list(datasets.load_image_dir(str(tmp_path) + os.sep))
    assert len(frames) == 3
    assert frames[0].image.shape == (32, 40)


def test_tum_loader(tmp_path, rng):
    root = str(tmp_path)
    entries = []
    for i in range(3):
        ts = 1000.0 + 0.1 * i
        rel = f"rgb/{ts:.6f}.png"
        _write_png_dirs(os.path.join(root, rel), rng.integers(0, 255, (24, 32)))
        entries.append(f"{ts:.6f} {rel}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# comment\n" + "\n".join(entries) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n")
        for i in range(5):
            f.write(f"{999.9 + 0.1 * i:.6f} {0.1 * i} 0 0 0 0 0 1\n")
    seq = datasets.load_tum(root, max_frames=3)
    assert len(list(seq.frames)) == 3
    assert seq.gt_R is not None and len(seq.gt_R) == 3
    c = -np.einsum("nji,nj->ni", seq.gt_R, seq.gt_t)
    assert np.allclose(c[:, 0], [0.1, 0.2, 0.3], atol=1e-5)


def test_euroc_loader(tmp_path, rng):
    cam = os.path.join(str(tmp_path), "mav0", "cam0")
    entries = []
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        _write_png_dirs(os.path.join(cam, "data", f"{ts}.png"), rng.integers(0, 255, (24, 32)))
        entries.append(f"{ts},{ts}.png")
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(entries) + "\n")
    frames = list(datasets.load_euroc(str(tmp_path)).frames)
    assert len(frames) == 3
    assert frames[1].timestamp > frames[0].timestamp


def test_kitti_calib_real_format(tmp_path):
    seq = tmp_path / "sequences" / "00"
    seq.mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "kitti_calib.txt"), seq / "calib.txt")
    intr, baseline = datasets._kitti_calib(str(seq))
    assert abs(float(intr.fx) - 718.856) < 1e-3
    assert abs(float(intr.cx) - 607.1928) < 1e-3
    assert abs(baseline - 0.53716) < 1e-3


@pytest.mark.parametrize("text,match", [
    ("P0: 1.0 2.0 three 4.0\n", "calib.txt"),
    ("P0: 1 2 3 4 5\n", "12 values"),
    ("Tr: " + " ".join(["0.1"] * 12) + "\n", "no P0"),
])
def test_kitti_calib_malformed_fails_loudly(tmp_path, text, match):
    """The reference test's three malformed files, one case each."""
    (tmp_path / "calib.txt").write_text(text)
    with pytest.raises(ValueError, match=match):
        datasets._kitti_calib(str(tmp_path))


def test_euroc_sensor_yaml_real_format():
    calib = datasets._euroc_sensor_yaml(os.path.join(FIXTURES, "euroc_sensor.yaml"))
    assert calib == dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)


@pytest.mark.parametrize("text,match", [
    ("camera_model: pinhole\n", "intrinsics"),
    ("intrinsics: [458.654, 457.296]\n", "fx, fy, cx, cy"),
])
def test_euroc_sensor_yaml_malformed(tmp_path, text, match):
    """The reference test's two malformed files, one case each."""
    bad = tmp_path / "sensor.yaml"
    bad.write_text(text)
    with pytest.raises(ValueError, match=match):
        datasets._euroc_sensor_yaml(str(bad))


def test_euroc_loader_prefers_sensor_yaml(tmp_path):
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "euroc_sensor.yaml"), cam / "sensor.yaml")
    (cam / "data.csv").write_text(
        "#timestamp [ns],filename\n1403636579763555584,1403636579763555584.png\n")
    seq = datasets.load_euroc(str(tmp_path))
    assert abs(float(seq.intrinsics.fx) - 458.654) < 1e-3


def test_euroc_stereo_and_groundtruth(tmp_path, rng):
    root = str(tmp_path)
    n = 3
    tss = [1403636579763555584 + i * 50_000_000 for i in range(n)]
    imgs = [rng.integers(0, 255, (96, 128)) for _ in range(n)]
    T1 = np.eye(4)
    T1[0, 3] = 0.11
    _write_euroc_cam(os.path.join(root, "mav0", "cam0"), tss, imgs, np.eye(4))
    _write_euroc_cam(os.path.join(root, "mav0", "cam1"), tss, imgs, T1)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir)
    rows = ["#timestamp, p_RS_R_x [m], ..."]
    for k in range(11):
        rows.append(f"{tss[0] - 25_000_000 + k * 25_000_000},0.0,0.0,{0.05 * k - 0.05},"
                    "1.0,0.0,0.0,0.0,0,0,0")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    seq = datasets.load_euroc(root, stereo=True)
    assert abs(seq.baseline - 0.11) < 1e-6, seq.baseline
    frames = list(seq.frames)
    assert len(frames) == n
    assert frames[0].image_right is not None
    assert frames[0].image.shape == (96, 128)
    assert seq.gt_R is not None and len(seq.gt_R) == n
    c = -np.einsum("nji,nj->ni", seq.gt_R, seq.gt_t)
    assert np.allclose(c[:, 2], [0.0, 0.1, 0.2], atol=1e-5), c


def test_euroc_stereo_requires_cam1(tmp_path, rng):
    _write_euroc_cam(os.path.join(str(tmp_path), "mav0", "cam0"), [1403636579763555584],
                     [rng.integers(0, 255, (96, 128))], np.eye(4))
    with pytest.raises(ValueError, match="cam1"):
        datasets.load_euroc(str(tmp_path), stereo=True)


def test_tum_rgb_txt_real_format(tmp_path):
    shutil.copy(os.path.join(FIXTURES, "tum_rgb.txt"), tmp_path / "rgb.txt")
    rgb = tmp_path / "rgb"
    rgb.mkdir()
    img = (np.arange(48 * 64, dtype=np.uint8).reshape(48, 64)) % 251
    for name in ("1305031102.175304.png", "1305031102.211214.png", "1305031102.243211.png"):
        png_io.write_gray_png(str(rgb / name), img)
    frames = list(datasets.load_tum(str(tmp_path)).frames)
    # CRLF and comment headers parsed; all three frames load.
    assert len(frames) == 3
    assert frames[0].timestamp == 1305031102.175304
    assert frames[0].image.shape == (48, 64)
