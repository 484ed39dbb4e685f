"""The port's data and utility modules against viso_tpu's, on the CPU:
dataset loaders on generated mini-datasets and tests/fixtures/, the PNG
writer and native decoder, run logging, viz's numpy outputs (byte-equal)
and the synthetic additions; and a scan of the port's sources for
imports of jax or viso_tpu."""

import ast
import json
import os
import pathlib

import numpy as np
import pytest

from viso_tpu.data import datasets as j_ds
from viso_tpu.data import native as j_native
from viso_tpu.data import png_io as j_png
from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.utils import logging as j_log
from viso_tpu.utils import viz as j_viz
from viso_tpu_torch.data import datasets as t_ds
from viso_tpu_torch.data import native as t_native
from viso_tpu_torch.data import png_io as t_png
from viso_tpu_torch.data import synthetic as t_syn
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.utils import logging as t_log
from viso_tpu_torch.utils import viz as t_viz

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"


def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t_png.write_gray_png(path, img)


def _same_sequence(a, b):
    """Two Sequences: the same intrinsics, baseline, ground truth, name and
    frames (bit-equal images)."""
    assert tuple(float(v) for v in a.intrinsics) == tuple(float(v) for v in b.intrinsics)
    assert a.baseline == b.baseline and a.name == b.name
    for x, y in ((a.gt_R, b.gt_R), (a.gt_t, b.gt_t)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    fa, fb = list(a.frames), list(b.frames)
    assert len(fa) == len(fb) > 0
    for p, q in zip(fa, fb):
        assert p.index == q.index and p.timestamp == q.timestamp
        np.testing.assert_array_equal(p.image, q.image)
        assert (p.image_right is None) == (q.image_right is None)


def test_kitti_loaders_match(tmp_path, rng):
    root = str(tmp_path)
    seq_dir = os.path.join(root, "sequences", "03")
    for i in range(4):
        img = rng.integers(0, 255, (60, 120)).astype(np.uint8)
        _png(os.path.join(seq_dir, "image_0", f"{i:06d}.png"), img)
        _png(os.path.join(seq_dir, "image_1", f"{i:06d}.png"), img[:, ::-1])
    # The real header format: CRLF, comments, extra cameras, Tr row.
    with open(FIXTURES / "kitti_calib.txt", newline="") as f:
        calib = f.read()
    with open(os.path.join(seq_dir, "calib.txt"), "w", newline="") as f:
        f.write(calib)
    os.makedirs(os.path.join(root, "poses"))
    with open(os.path.join(root, "poses", "03.txt"), "w") as f:
        f.write("\n".join(f"1 0 0 {0.5 * i} 0 1 0 0 0 0 1 {1.0 * i}" for i in range(4)) + "\n")
    for stereo in (True, False):
        _same_sequence(t_ds.load_kitti(root, "03", stereo=stereo, max_frames=3),
                       j_ds.load_kitti(root, "03", stereo=stereo, max_frames=3))


def test_tum_euroc_and_dir_loaders_match(tmp_path, rng):
    root = str(tmp_path / "tum")
    entries = []
    for i in range(3):
        ts = 1000.0 + 0.1 * i
        _png(os.path.join(root, f"rgb/{ts:.6f}.png"), rng.integers(0, 255, (24, 32)))
        entries.append(f"{ts:.6f} rgb/{ts:.6f}.png")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# comment\n" + "\n".join(entries) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n")
        f.writelines(f"{999.9 + 0.1 * i:.6f} {0.1 * i} 0 0 0 0 0.0998 0.995\n" for i in range(5))
    _same_sequence(t_ds.load_tum(root, max_frames=3), j_ds.load_tum(root, max_frames=3))

    root = str(tmp_path / "euroc")
    cam = os.path.join(root, "mav0", "cam0")
    entries = []
    for i in range(3):
        ts = 1403636579763555584 + i * 50000000
        _png(os.path.join(cam, "data", f"{ts}.png"), rng.integers(0, 255, (24, 32)))
        entries.append(f"{ts},{ts}.png")
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(entries) + "\n")
    with open(FIXTURES / "euroc_sensor.yaml") as f:
        yaml_text = f.read()
    with open(os.path.join(cam, "sensor.yaml"), "w") as f:
        f.write(yaml_text)
    _same_sequence(t_ds.load_euroc(root), j_ds.load_euroc(root))
    assert t_ds._euroc_cam_conf(str(FIXTURES / "euroc_sensor.yaml"))[0] == \
        j_ds._euroc_cam_conf(str(FIXTURES / "euroc_sensor.yaml"))[0]

    root = str(tmp_path / "dir")
    for n in (1, 2, 3):
        _png(os.path.join(root, f"{n}.png"), rng.integers(0, 255, (32, 40)))
    a = list(t_ds.load_image_dir(root + os.sep))
    b = list(j_ds.load_image_dir(root + os.sep))
    assert len(a) == len(b) == 3
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.image, q.image)


def test_calib_errors_match(tmp_path):
    bad = tmp_path / "calib.txt"
    bad.write_text("P0: 1 2 3\n")
    for mod in (t_ds, j_ds):
        with pytest.raises(ValueError, match="needs 12 values"):
            mod._kitti_calib(str(tmp_path))


def test_png_writer_and_native_decoder_match(tmp_path, rng):
    gray = rng.integers(0, 255, (37, 53)).astype(np.uint8)
    rgb = rng.integers(0, 255, (20, 30, 3)).astype(np.uint8)
    for name, fn_t, fn_j, img in (("g", t_png.write_gray_png, j_png.write_gray_png, gray),
                                  ("c", t_png.write_rgb_png, j_png.write_rgb_png, rgb)):
        fn_t(str(tmp_path / f"{name}_t.png"), img)
        fn_j(str(tmp_path / f"{name}_j.png"), img)
        assert (tmp_path / f"{name}_t.png").read_bytes() == (tmp_path / f"{name}_j.png").read_bytes()
    # The port resolves the repository's native library from its own file.
    assert t_native._LIB_PATH == j_native._LIB_PATH
    assert t_native.available() == j_native.available()
    if t_native.available():
        dec = t_native.decode_gray(str(tmp_path / "g_t.png"))
        np.testing.assert_array_equal(dec, gray.astype(np.float32))
        np.testing.assert_array_equal(dec, j_native.decode_gray(str(tmp_path / "g_t.png")))
        paths = [str(tmp_path / "g_t.png")] * 3
        pre = t_native.Prefetcher(paths, ring=2, threads=2)
        out = list(pre)
        pre.close()
        assert len(out) == 3 and all(np.array_equal(o, dec) for o in out)
        assert t_native.decode_gray(str(tmp_path / "missing.png")) is None


def test_run_logger_matches(tmp_path):
    records = []
    for mod in (t_log, j_log):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        log = mod.RunLogger(path=str(path))
        for i in range(6):
            log.log_frame(i, num_tracked=10 * i, num_landmarks=50, num_keyframes=i // 2,
                          is_keyframe=i % 3 == 0, state="tracking", extra={"k": i})
        summary = log.summary()
        log.close()
        lines = [json.loads(s) for s in path.read_text().splitlines()]
        for line in lines:
            line.pop("wall_ms")
        summary.pop("fps")
        records.append((lines, summary))
    assert records[0] == records[1]
    rec = t_log.FrameLog(frame=3, wall_ms=1.23456, num_tracked=5)
    assert rec.to_json() == j_log.FrameLog(frame=3, wall_ms=1.23456, num_tracked=5).to_json()


def test_viz_numpy_outputs_byte_equal(tmp_path, rng):
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    uv = rng.uniform(-5, 65, (30, 2)).astype(np.float32)
    uv2 = uv + rng.normal(0, 3, uv.shape).astype(np.float32)
    mask = rng.uniform(size=30) > 0.3
    assert t_viz.to_rgb(img).tobytes() == j_viz.to_rgb(img).tobytes()
    assert (t_viz.draw_keypoints(img, uv, mask).tobytes()
            == j_viz.draw_keypoints(img, uv, mask).tobytes())
    assert (t_viz.draw_tracks(img, uv, uv2, mask).tobytes()
            == j_viz.draw_tracks(img, uv, uv2, mask).tobytes())
    pts = rng.normal(0, 3, (50, 3)).astype(np.float32)
    pm = rng.uniform(size=50) > 0.2
    traj = rng.normal(0, 1, (12, 3)).astype(np.float32)
    t_viz.export_map_html(pts, pm, traj, str(tmp_path / "t.html"))
    j_viz.export_map_html(pts, pm, traj, str(tmp_path / "j.html"))
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_synthetic_additions_match(rng):
    """render_sequence, PlaneScene.depth_at and PhotometricNuisance."""
    scene_j = j_syn.corridor_scene(np.random.default_rng(1), tex_size=64)
    scene_t = t_syn.corridor_scene(np.random.default_rng(1), tex_size=64)
    ij = j_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    it = t_cam.Intrinsics.create(60.0, 60.0, 31.5, 23.5)
    Rs, ts = t_syn.forward_trajectory(3, step=0.5, yaw_rate=0.01)
    for a, b in zip(t_syn.render_sequence(scene_t, it, Rs, ts, 48, 64),
                    j_syn.render_sequence(scene_j, ij, Rs, ts, 48, 64)):
        np.testing.assert_array_equal(a, b)
    uv = rng.uniform(0, 60, (40, 2))
    np.testing.assert_array_equal(scene_t.depth_at(it, Rs[1], ts[1], uv),
                                  scene_j.depth_at(ij, Rs[1], ts[1], uv))
    # depth_at agrees with the rendered depth at pixel centres.
    _, depth = scene_t.render(it, Rs[1], ts[1], 48, 64)
    pix = np.array([[10, 5], [40, 30], [63, 47]], np.float64)
    np.testing.assert_allclose(scene_t.depth_at(it, Rs[1], ts[1], pix),
                               depth[pix[:, 1].astype(int), pix[:, 0].astype(int)], rtol=1e-5)
    img = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    nt = t_syn.PhotometricNuisance(np.random.default_rng(9))
    nj = j_syn.PhotometricNuisance(np.random.default_rng(9))
    for _ in range(5):
        nt.step()
        nj.step()
        assert (nt.gain, nt.bias) == (nj.gain, nj.bias)
        np.testing.assert_array_equal(nt.apply(img), nj.apply(img))


def test_port_sources_import_no_jax_or_viso_tpu():
    """No module of viso_tpu_torch, and not chip_smoke.py, imports jax,
    viso_tpu, the reference's bench.py or the tests -- lazy imports inside
    functions included (the import test of tests/test_torch_extract.py
    sees module-level imports only)."""
    files = sorted((REPO / "viso_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"run.py", "lk.py", "ransac.py", "twoview.py", "ba_photometric.py", "epipolar.py",
            "triangulation.py", "datasets.py", "native.py", "png_io.py", "viz.py",
            "logging.py", "dist_ba.py", "mesh.py", "debug.py", "profiling.py",
            "diag_loops.py", "diag_drift.py", "diag_track_bias.py", "diag_mono_seam.py",
            "profile_frame.py", "profile_track.py", "profile_direct.py", "fast.py", "se3.py",
            "camera.py", "sampling.py", "mono_full.py", "full.py",
            "loop_closure.py", "pose_graph_sim3.py"} <= {f.name for f in files}
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "viso_tpu", "bench", "tests")]
    assert not bad, bad
