"""The ingestion path on the CPU, the port against viso_tpu: PNG sequences
through each package's writer and native prefetch ring, the photometric
nuisance of the degraded loop cell, a degraded StereoVO run staged one
frame ahead through `to_device`, the KITTI loader on a layout written by
chip_smoke's helper, and the upload's copy of the caller's frame.

chip_smoke phase 16 runs the same path on the card at full size.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from viso_tpu.data import datasets as j_ds
from viso_tpu.data import native as j_native
from viso_tpu.data import png_io as j_png
from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.slam.engine import StereoVO as JStereoVO
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu_torch.data import datasets as t_ds
from viso_tpu_torch.data import native as t_native
from viso_tpu_torch.data import png_io as t_png
from viso_tpu_torch.data import synthetic as t_syn
from viso_tpu_torch.slam.engine import StereoVO, VOConfig
from viso_tpu_torch.utils import metrics

torch.set_num_threads(2)

# tests/test_torch_engine.py's configuration and corridor (rng 7), and its
# per-frame agreement band between the engines: both compute in f32 but
# sum in different orders, a few millimetres over the run.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(
    height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
    detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
    kf_min_gap=2, stats_deterministic=True, **INTR,
)
N_FRAMES = 12
CENTER_BAND_M = 0.01
ROT_BAND_DEG = 0.1
# The same band on degraded frames (seed NUISANCE_SEED), where the
# engines' f32 sums part further. Measured on a CPU: the bench's feed
# 0.014032 m; faulty feeds of the port against the reference's right one:
# the right image left undegraded 0.023003 m, the nuisance drawn from seed
# 78 0.029748 m, no nuisance 0.058597 m (other keyframes). At seeds 1-3 the
# right feed reads 0.015740-0.029321 m.
DEGRADED_BAND_M = 0.02
# The degraded cell's nuisance seed (bench.py:693-711).
NUISANCE_SEED = 77
# The loaded ground truth against the poses written: float32 after a
# float64 inversion (the file holds 17 significant digits).
GT_TOL = 1e-6

PACKAGES = {"jax": (j_png, j_native), "port": (t_png, t_native)}


@pytest.fixture(scope="module")
def corridor():
    """The corridor's stereo pairs (float renders) and ground truth."""
    rng = np.random.default_rng(7)
    scene = j_syn.corridor_scene(rng, tex_size=512)
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(N_FRAMES, step=0.25, yaw_rate=0.004)
    frames = [j_syn.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.3)[:2]
              for R, t in zip(Rs, ts)]
    return frames, np.asarray(Rs), np.asarray(ts)


def _available():
    if not (j_native.available() and t_native.available()):
        pytest.skip("the native library could not be built (make -C native)")


def _decode(native, paths, ring=4, threads=3):
    pre = native.Prefetcher(paths, ring=ring, threads=threads)
    try:
        return list(pre)
    finally:
        pre.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_png_sequence_through_the_prefetch_ring(tmp_path, corridor, writer, reader):
    """A sequence written in bench.py's layout by one package's png_io and
    read back through a package's Prefetcher: every image, in order, equal
    byte for byte to the frame clipped and cast to uint8 (what both
    engines upload), nothing missing."""
    _available()
    frames, _, _ = corridor
    paths, images = chip_smoke.write_sequence(PACKAGES[writer][0], str(tmp_path), frames)
    decoded = _decode(PACKAGES[reader][1], paths)
    assert len(decoded) == len(images) == 2 * N_FRAMES
    for d, img in zip(decoded, images):
        assert d.dtype == np.float32 and d.shape == (H, W)
        np.testing.assert_array_equal(d, chip_smoke.as_u8(img).astype(np.float32))


def test_png_writers_write_the_same_files(tmp_path, corridor):
    frames, _, _ = corridor
    a, _ = chip_smoke.write_sequence(j_png, str(tmp_path / "jax"), frames[:3])
    b, _ = chip_smoke.write_sequence(t_png, str(tmp_path / "port"), frames[:3])
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()


def _degrade(syn, pairs):
    """bench.py's degraded feed: one exposure step a frame, applied to both
    images (noise drawn per image), then the uint8 cast."""
    nuisance = syn.PhotometricNuisance(np.random.default_rng(NUISANCE_SEED))
    out = []
    for il, ir in pairs:
        nuisance.step()
        il = nuisance.apply(il)
        ir = nuisance.apply(ir)
        out.append((il, ir))
    return out


def test_photometric_nuisance_is_byte_equal(corridor):
    frames, _, _ = corridor
    pairs = [tuple(chip_smoke.as_u8(x).astype(np.float32) for x in p) for p in frames]
    for a, b in zip(_degrade(j_syn, pairs), _degrade(t_syn, pairs)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    # The nuisance moves the frames: a degraded run is not the clean one.
    assert not np.array_equal(_degrade(t_syn, pairs)[0][0], pairs[0][0])


def _rot_deg(Ra, Rb):
    D = Ra @ np.swapaxes(Rb, -1, -2)
    s = np.stack([D[..., 2, 1] - D[..., 1, 2], D[..., 0, 2] - D[..., 2, 0],
                  D[..., 1, 0] - D[..., 0, 1]], -1)
    return np.degrees(np.arcsin(np.clip(np.linalg.norm(s, axis=-1) / 2, 0, 1)))


def _assert_same_run(tvo, jvo, band=CENTER_BAND_M):
    assert [r.is_keyframe for r in tvo.results] == [r.is_keyframe for r in jvo.results]
    Rt, tt = tvo.trajectory()
    Rj, tj = jvo.trajectory()
    d = np.linalg.norm(metrics.camera_centers(Rt, tt) - metrics.camera_centers(Rj, tj), axis=-1)
    assert d.max() < band, d
    assert _rot_deg(Rt, Rj).max() < ROT_BAND_DEG


def _run_ahead(vo, next_pair):
    """bench_long_slam's loop: the next pair staged before this frame's
    process()."""
    nxt = next_pair()
    for i in range(N_FRAMES):
        cur = nxt
        nxt = next_pair() if i < N_FRAMES - 1 else None
        vo.process(*cur)


@pytest.mark.parametrize("degrade", [False, True], ids=["clean", "degraded"])
def test_stereo_vo_fed_one_frame_ahead_through_the_ring(tmp_path, corridor, degrade):
    """A PNG sequence through each package's ring (and, degraded, its
    nuisance) into its StereoVO, each pair staged one frame ahead through
    `to_device`: both engines get the same bytes at every frame; the same
    keyframes; camera centres within tests/test_torch_engine.py's band on
    clean frames, and within DEGRADED_BAND_M on degraded frames (noise of
    3 grey levels, blur, an exposure walk), which lies between the right
    feed's gap and a faulty feed's; both within tests/test_engine.py's ATE
    bound."""
    _available()
    frames, Rs, ts = corridor
    paths, _ = chip_smoke.write_sequence(t_png, str(tmp_path), frames)
    runs, fed = {}, {}
    for name, vo_cls, cfg_cls, syn in (("jax", JStereoVO, JVOConfig, j_syn),
                                       ("port", StereoVO, VOConfig, t_syn)):
        pre = PACKAGES[name][1].Prefetcher(paths, ring=4, threads=3)
        nuisance = syn.PhotometricNuisance(np.random.default_rng(NUISANCE_SEED))
        vo = vo_cls(cfg_cls(**CFG)) if name == "jax" else vo_cls(cfg_cls(**CFG), device="cpu")
        fed[name] = []

        def next_pair(pre=pre, nuisance=nuisance, vo=vo, fed=fed[name]):
            il, ir = next(pre), next(pre)
            if degrade:
                nuisance.step()
                il, ir = nuisance.apply(il), nuisance.apply(ir)
            staged = vo.to_device(chip_smoke.as_u8(il), chip_smoke.as_u8(ir))
            fed.append([np.asarray(x) for x in staged])
            return staged

        try:
            _run_ahead(vo, next_pair)
        finally:
            pre.close()
        runs[name] = vo
    try:
        for a, b in zip(fed["jax"], fed["port"], strict=True):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        c_gt = metrics.camera_centers(Rs, ts)
        _assert_same_run(runs["port"], runs["jax"], DEGRADED_BAND_M if degrade else CENTER_BAND_M)
        for vo in runs.values():
            R, t = vo.trajectory()
            ate = metrics.ate_rmse(metrics.camera_centers(R, t), c_gt, align=True,
                                   with_scale=False)
            assert ate < 0.05, ate
    finally:
        for vo in runs.values():
            vo.close()


def _at_alignment(a, offset):
    """A copy of `a` whose buffer starts `offset` bytes past a 64-byte
    boundary. XLA's CPU client takes a 64-byte aligned numpy buffer without
    a copy (jax 0.9.0), so the reference's `jnp.asarray` aliases such an
    array on the CPU; off that alignment it copies, as its transfer to an
    accelerator always does."""
    raw = np.empty(a.nbytes + 128, np.uint8)
    start = (-raw.ctypes.data) % 64 + offset
    out = raw[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_to_device_copies_the_callers_frame(corridor):
    """Stage a uint8 pair with `to_device`, overwrite the caller's arrays
    with a frame 1 m further on, then process the staged pair: the port
    tracks the staged bytes, as the reference does given the same calls
    with arrays it copies."""
    frames, Rs, ts = corridor
    u8 = [tuple(chip_smoke.as_u8(x) for x in p) for p in frames]
    staged_at, other = 6, 10
    tvo = StereoVO(VOConfig(**CFG), device="cpu")
    jvo = JStereoVO(JVOConfig(**CFG))
    try:
        for vo, offset in ((tvo, 0), (jvo, 16)):
            for i, (il, ir) in enumerate(u8):
                if i != staged_at:
                    vo.process(il, ir)
                    continue
                left, right = _at_alignment(il, offset), _at_alignment(ir, offset)
                staged = vo.to_device(left, right)
                left[...] = u8[other][0]
                right[...] = u8[other][1]
                if vo is tvo:
                    assert all(torch.equal(s, torch.from_numpy(x)) for s, x in zip(staged, (il, ir)))
                vo.process(*staged)
        _assert_same_run(tvo, jvo)
        R, t = tvo.trajectory()
        c = metrics.camera_centers(R, t)
        c_gt = metrics.camera_centers(Rs, ts)
        assert np.linalg.norm(c[staged_at] - c_gt[staged_at]) < 0.05
    finally:
        tvo.close()
        jvo.close()


def test_to_device_on_the_cpu_returns_a_copy():
    vo = StereoVO(VOConfig(**CFG), device="cpu")
    try:
        il = np.full((H, W), 7, np.uint8)
        ir = np.full((H, W), 9, np.float32)
        tl, tr = vo.to_device(il, ir)
        il[...] = 1
        ir[...] = 1
        assert tl.dtype == tr.dtype == torch.uint8
        assert int(tl.min()) == int(tl.max()) == 7 and int(tr.min()) == int(tr.max()) == 9
        # A tensor the caller passes in is only moved.
        x = torch.zeros((H, W), dtype=torch.uint8)
        assert vo.to_device(x, x)[0] is x
    finally:
        vo.close()


def test_kitti_layout_loads_alike_in_both_packages(tmp_path, corridor):
    """chip_smoke's KITTI writer: both packages' `load_kitti` read the
    intrinsics, the baseline, the ground truth and the frames written."""
    _available()
    frames, Rs, ts = corridor
    chip_smoke.write_kitti(t_png, str(tmp_path), "00", frames, INTR, 0.537, Rs, ts)
    seqs = {"jax": j_ds.load_kitti(str(tmp_path), "00"),
            "port": t_ds.load_kitti(str(tmp_path), "00")}
    j, t = seqs["jax"], seqs["port"]
    assert tuple(float(v) for v in j.intrinsics) == tuple(t.intrinsics) == tuple(
        float(np.float32(INTR[k])) for k in ("fx", "fy", "cx", "cy"))
    assert j.baseline == t.baseline and abs(t.baseline - 0.537) <= 1e-12
    np.testing.assert_array_equal(j.gt_R, t.gt_R)
    np.testing.assert_array_equal(j.gt_t, t.gt_t)
    np.testing.assert_allclose(t.gt_R, Rs, atol=GT_TOL)
    np.testing.assert_allclose(t.gt_t, ts, atol=GT_TOL)
    fj, ft = list(j.frames), list(t.frames)
    assert len(fj) == len(ft) == N_FRAMES
    for a, b, (il, ir) in zip(fj, ft, frames):
        assert a.index == b.index
        for x, y, img in ((a.image, b.image, il), (a.image_right, b.image_right, ir)):
            np.testing.assert_array_equal(np.asarray(x), y)
            np.testing.assert_array_equal(y, chip_smoke.as_u8(img).astype(np.float32))
