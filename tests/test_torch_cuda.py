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


@pytest.mark.cuda
def test_mono_call_sites_launch_the_kernel(rng, cuda_device):
    """LK (one two-source launch per level) and the photometric BA's window
    cache (one indexed launch over the keyframe stack) take K1 on CUDA
    tensors and agree with the same code on the CPU (the plain version):
    LK within 0.01 px, the windows bit-equal where the origins agree."""
    from viso_tpu_torch.backend import ba_photometric as pba
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera
    from viso_tpu_torch.ops import lk, pyramid

    tex = synthetic.smooth_texture(rng, 184, 640)
    a, b = tex[:, :616], tex[:, 3:619]          # a 3 px shift
    kp = np.stack([rng.uniform(30, 586, 256), rng.uniform(30, 154, 256)], -1).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        pa = pyramid.build_pyramid(torch.from_numpy(a).to(dev), 4)
        pb = pyramid.build_pyramid(torch.from_numpy(b).to(dev), 4)
        before = t_ext.launch.launches
        kp2, _, ok = lk.track(pa, pb, torch.from_numpy(kp).to(dev), torch.ones(256, dtype=torch.bool,
                                                                                device=dev))
        out[str(dev)] = (kp2.cpu().numpy(), ok.cpu().numpy(), t_ext.launch.launches - before)
    (k_c, ok_c, n_c), (k_g, ok_g, n_g) = out["cpu"], out[str(cuda_device)]
    assert n_c == 0 and n_g == 4
    both = ok_c & ok_g
    assert both.sum() > 200 and np.abs(k_c - k_g)[both].max() < 1e-2

    C, L = 8, 1024
    images = rng.uniform(0, 255, (C, 92, 308)).astype(np.float32)
    pts = np.stack([rng.uniform(-3, 3, L), rng.uniform(-1, 1, L), rng.uniform(4, 20, L)], -1)
    intr = camera.Intrinsics.create(179.7, 179.7, 151.6, 46.1)
    arrays = dict(
        R=np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)),
        t=(np.arange(C)[:, None] * np.array([0.1, 0.0, 0.0])).astype(np.float32),
        points=pts.astype(np.float32), images=images,
        template=np.zeros((L, 16), np.float32), anchor_idx=np.zeros(L, np.int64),
        obs_mask=np.ones((C, L), bool), cam_mask=np.ones(C, bool), point_mask=np.ones(L, bool))
    wins = {}
    for dev in ("cpu", cuda_device):
        prob = pba.PhotoBAProblem(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})
        before = t_ext.launch.launches
        w = pba._precompute_windows(prob, intr, pba.PhotoBAParams())
        wins[str(dev)] = (w.win.cpu(), w.base.cpu(), t_ext.launch.launches - before)
    (w_c, b_c, n_c), (w_g, b_g, n_g) = wins["cpu"], wins[str(cuda_device)]
    assert n_c == 0 and n_g == 1 and w_g.shape == (C * L, 16, 16)
    same = (b_c == b_g).all(dim=-1)
    assert same.float().mean() > 0.99 and torch.equal(w_c[same], w_g[same])


@pytest.mark.cuda
def test_nccl_world_one_sharded_solve_is_bit_equal(cuda_device, tmp_path):
    """The landmark-sharded BA over an NCCL group of one rank on the card:
    bit-equal to `ba.solve_impl`, handing `all_reduce` psum_bytes_per_iter
    bytes in 2 calls per LM iteration, timed by CUDA events."""
    import datetime

    import torch.distributed as dist

    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from viso_tpu_torch.tools import bench_dist_ba

    prob = bench_dist_ba.build_problem(16, 4096, cuda_device)
    params = ba.BAParams(iters=10, num_fixed=2)
    out_1, info_1 = ba.solve_impl(prob, params)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_mod.make_mesh(device=cuda_device)
        assert mesh.size == 1 and mesh.group is not None
        out_s, info_s = dist_ba.solve_sharded(prob, params, mesh)
        calls, nbytes, ms = dist_ba.make_sharded_solver(mesh, params).stats.per_iter(10)
    finally:
        dist.destroy_process_group()
    for name in ("R", "t", "points"):
        assert torch.equal(getattr(out_s, name), getattr(out_1, name)), name
    for key in info_1:
        assert torch.equal(info_s[key], info_1[key]), key
    assert dist_ba.psum_bytes_per_iter(16) == 39_948 and (calls, nbytes) == (2, 39_948)
    assert ms is not None and ms > 0


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(cuda_device):
    """2 spawned gloo ranks whose tensors live on the one card (NCCL takes
    one rank per GPU): each rank within the solver tolerances of its own
    single-rank solve (R 1e-4, t 1e-3, points 1e-2, cost 1e-3 relative),
    and both ranks equal."""
    from viso_tpu_torch.tools import multiprocess_ba

    ranks = multiprocess_ba.launch(multiprocess_ba.ba_rank, 2, args=(None, 10, 2),
                                   device="cuda")
    for r in ranks:
        assert multiprocess_ba.ba_ok(r)
        np.testing.assert_allclose(r["R"], r["local_R"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["t"], r["local_t"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(r["points"], r["local_points"], rtol=0, atol=1e-2)
        for key in ("R", "t", "points"):
            np.testing.assert_array_equal(r[key], ranks[0][key])


# The engines' programs as CUDA graphs (slam/programs.py): the small
# configuration of tests/test_torch_engine.py and tests/test_torch_mono.py.
ENGINE_HW = (192, 256)
ENGINE_CFG = dict(height=192, width=256, max_keyframes=6, max_landmarks=384,
                  num_features=192, detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3,
                  max_disparity=48, kf_min_gap=2, kf_max_gap=4, fx=200.0, fy=200.0,
                  cx=127.5, cy=95.5)
ENGINE_MONO = dict(ENGINE_CFG, fast_threshold=10.0, kf_max_gap=6, kf_min_visible_frac=0.45,
                   min_init_tracks=25, disparity_squared_thresh=25.0)


def _engine_frames(mono: bool, n: int):
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    H, W = ENGINE_HW
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    intr = camera.Intrinsics.create(200.0, 200.0, 127.5, 95.5)
    Rs, ts = synthetic.forward_trajectory(n, step=0.15 if mono else 0.25, yaw_rate=0.004)
    out = []
    for R, t in zip(Rs, ts):
        il, ir, _ = synthetic.make_stereo_pair(scene, intr, R, t, H, W, baseline=0.3)
        u8 = [np.clip(x, 0, 255).astype(np.uint8) for x in (il, ir)]
        out.append(u8[:1] if mono else u8)
    return out


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("mono,name", [(False, "track"), (False, "templates"),
                                       (False, "stereo_kf"), (False, "ba"),
                                       (True, "mono_kf"), (True, "ba")])
def test_program_replays_equal_eager_calls_on_cuda(cuda_device, mono, name):
    """Each program, captured at its first call, replays bit-equal to an
    eager call of its bare function on the same inputs, with the eager
    call's K1 launches, at its second to fourth calls."""
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.slam.engine import MonocularVO, StereoVO, VOConfig

    vo = (MonocularVO(VOConfig(**ENGINE_MONO), device=cuda_device) if mono
          else StereoVO(VOConfig(**ENGINE_CFG), device=cuda_device))
    real, checked = vo._program, []

    def program(n):
        prog = real(n)
        if n != name:
            return prog

        def call(*args):
            if not 1 <= prog.replays <= 3:
                return prog(*args)
            before = t_ext.launch.launches
            ref = [x.clone() for x in programs.flatten(prog.fn(*args))[0]]
            eager, before = t_ext.launch.launches - before, t_ext.launch.launches
            out = prog(*args)
            replayed = t_ext.launch.launches - before
            got = programs.flatten(out)[0]
            checked.append(prog.graph is not None and replayed == eager
                           and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref)))
            return out

        return call

    vo._program = program
    try:
        for f in _engine_frames(mono, 40):
            vo.process(*f)
            if len(checked) == 3:
                break
    finally:
        vo.close()
    assert checked == [True] * 3


# The SLAM loop layer's programs (slam/programs.Cache): each captured at
# its second call and replayed after.
LOOP_NF, LOOP_CAPACITY = 256, 64
# A replayed solve against an eager one: bit for bit, since the solves sum
# their normal equations in a fixed order, with no atomics (with atomic
# sums the bound was 1e-4, the tolerance the port's solves keep against the
# JAX package's).
SOLVE_REPLAY_ATOL = 0.0


def _loop_scene(device, seed=5, sim3=False):
    """A loop database of LOOP_CAPACITY stored keyframes (identity poses)
    and a query that sees entry 2 from a moved camera, 10 % of its bits
    flipped and a fifth of its keypoints outliers (tests/test_torch_slam.py's
    scene at the digest's width)."""
    from viso_tpu_torch.data.synthetic import so3_exp
    from viso_tpu_torch.slam.loop_closure import LoopDatabase, LoopParams

    rng = np.random.default_rng(seed)
    nf = LOOP_NF
    db = LoopDatabase(LoopParams(capacity=LOOP_CAPACITY, num_features=nf, guard=1,
                                 min_matches=20, min_inliers=15), seed=1, device=device)
    entries = []
    for k in range(LOOP_CAPACITY):
        kps = rng.uniform(0, 200, (nf, 2)).astype(np.float32)
        desc = np.where(rng.uniform(size=(nf, 256)) < 0.5, -1.0, 1.0).astype(np.float32)
        pts = np.stack([rng.uniform(-2, 2, nf), rng.uniform(-1, 1, nf),
                        rng.uniform(3, 7, nf)], -1).astype(np.float32)
        mask = np.ones(nf, bool)
        entries.append((pts, desc))
        db.add(None, kps, mask, pts, mask, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
               k, desc=torch.from_numpy(desc).bfloat16().to(device))
    pts, desc = entries[2]
    Rq, tq = so3_exp([0.02, -0.05, 0.01]), np.array([0.1, -0.05, 0.2], np.float32)
    pc = pts @ Rq.T + tq
    kps_q = np.stack([180.0 * pc[:, 0] / pc[:, 2] + 111.5, 180.0 * pc[:, 1] / pc[:, 2] + 79.5],
                     -1).astype(np.float32)
    kps_q[::5] = rng.uniform(0, 200, (len(kps_q[::5]), 2))
    desc_q = desc.copy()
    desc_q[rng.uniform(size=desc.shape) < 0.1] *= -1
    perm = rng.permutation(nf)
    query = [torch.from_numpy(desc_q[perm]).bfloat16(), torch.ones(nf, dtype=torch.bool),
             torch.from_numpy(kps_q[perm])]
    if sim3:
        query += [torch.from_numpy(1.5 * pts[perm]), torch.from_numpy(rng.uniform(size=nf) > 0.1),
                  torch.from_numpy(Rq.astype(np.float32)), torch.from_numpy(1.5 * tq)]
    return db, [x.to(device) for x in query]


@pytest.mark.cuda
@pytest.mark.parametrize("sim3", [False, True])
def test_detection_segments_replay_equal_eager_calls_on_cuda(cuda_device, sim3):
    """Four detections through the database's programs (the first eager,
    the second captures every segment): each packed result bit-equal to
    the eager function's with the draws of a second database at the same
    seed, the generators in the same state after them."""
    from viso_tpu_torch.geometry import camera
    from viso_tpu_torch.ops import pnp
    from viso_tpu_torch.slam import loop_closure as lc

    db, query = _loop_scene(cuda_device, sim3=sim3)
    ref, _ = _loop_scene(cuda_device, sim3=sim3)
    intr = camera.Intrinsics.create(180.0, 180.0, 111.5, 79.5)
    thresh = (db.params.pnp_threshold_px / intr.fx) ** 2
    kernel = lc._detect_fused_sim3_kernel if sim3 else lc._detect_fused_kernel
    for call in range(4):
        got = db._detect_packed(query, intr)
        eligible = torch.from_numpy(db._eligible()).to(cuda_device)
        want = kernel(*query, ref.desc, ref.desc_mask, ref.points_w_dev, ref.points_ok_dev,
                      eligible, intr, thresh, 20, 15,
                      lambda m: pnp.draw_hypotheses(ref.generator, m)).cpu().numpy()
        np.testing.assert_array_equal(got, want)
        assert got[1] == 2 and got[3] >= 40
    progs = db.programs.programs.values()
    assert len(progs) == (5 if sim3 else 4)
    assert all(p.graph is not None and p.replays == 3 for p in progs)
    assert torch.equal(db.generator.get_state(), ref.generator.get_state())


def _solve_case(K, sim3, seed):
    """A drifted ring of K nodes with two loop edges (numpy): the node
    estimates (with scales for Sim(3)) and the edges."""
    from viso_tpu_torch.data.synthetic import so3_exp

    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = so3_exp([0.0, ang, 0.0]).T.astype(np.float32)
        Rs.append(R)
        ts.append((-R @ np.array([2 * np.sin(ang), 0.0, -2 * np.cos(ang)])).astype(np.float32))
    edges = []
    for i, j in [(k - 1, k) for k in range(1, K)] + [(0, K - 1), (1, K - 2)]:
        Rm = Rs[i] @ Rs[j].T
        tm = ts[i] - Rm @ ts[j]
        if j == i + 1:
            Rm, tm = so3_exp(rng.normal(0, 0.01, 3)) @ Rm, tm + rng.normal(0, 0.02, 3)
        e = (i, j, Rm.astype(np.float32), tm.astype(np.float32), 1.0 if j == i + 1 else 2.0)
        edges.append(e[:2] + (1.0,) + e[2:] if sim3 else e)
    R0 = [so3_exp(rng.normal(0, 0.05, 3)).astype(np.float32) @ R for R in Rs]
    t0 = [t + rng.normal(0, 0.1, 3).astype(np.float32) for t in ts]
    return ([1.0] * K, R0, t0, edges) if sim3 else (R0, t0, edges)


@pytest.mark.cuda
@pytest.mark.parametrize("K, sim3", [(40, False), (60, True), (400, False)])
def test_solve_programs_replay_within_tolerance_of_eager_on_cuda(cuda_device, K, sim3):
    """Four graphs at one bucket through the loop layer's solve program
    (the first eager, captured at the second): each within
    SOLVE_REPLAY_ATOL (0: bit for bit) of an eager solve of its graph,
    the fourth replay under set_sync_debug_mode("error"). 400 nodes go to
    the 512-node PCG bucket."""
    from viso_tpu_torch.backend import pose_graph as pg
    from viso_tpu_torch.backend import pose_graph_sim3 as pgs
    from viso_tpu_torch.slam import programs

    mod = pgs if sim3 else pg
    params = mod.PGParams(iters=25)
    cache = programs.Cache(cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    for seed in range(4):
        case = _solve_case(K, sim3, seed)
        with torch.cuda.stream(stream):
            if seed == 3:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                out, info = mod.solve_padded(*case, params, device=cuda_device, programs=cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got = [getattr(out, k)[:K].cpu() for k in (("s", "R", "t") if sim3 else ("R", "t"))]
        ref, _ = mod.solve_padded(*case, params, device=cuda_device)
        for a, k in zip(got, ("s", "R", "t") if sim3 else ("R", "t")):
            torch.testing.assert_close(a, getattr(ref, k)[:K].cpu(), rtol=0,
                                       atol=SOLVE_REPLAY_ATOL)
        assert float(info["final_cost"]) < float(info["initial_cost"])
    (prog,) = cache.programs.values()
    assert prog.graph is not None and prog.replays == 3
    assert prog.inputs[0].shape[0] == (512 if K > 320 else 16 * 2 ** int(np.ceil(np.log2(K / 16))))


@pytest.mark.cuda
def test_digest_program_replays_equal_eager_calls_on_cuda(cuda_device):
    """The keyframe digest on a StereoSLAM whose map holds seeded images,
    observations and landmarks (184x616, 256 keypoints): calls 2-4 are
    replays, each bit-equal to an eager call of the bare function, with
    the eager call's K1 launch counted at each replay."""
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.engine import VOConfig
    from viso_tpu_torch.slam.loop_closure import LoopParams

    H, W = 184, 616
    cfg = VOConfig(height=H, width=W, max_keyframes=8, max_landmarks=1024, num_features=256,
                   fx=359.428, fy=359.428, cx=303.596, cy=92.608)
    slam = StereoSLAM(cfg, LoopParams(), device=cuda_device)
    rng = np.random.default_rng(4)
    m = slam.map
    for lvl in m.kf_pyr:
        lvl.copy_(torch.from_numpy(rng.uniform(0, 255, lvl.shape).astype(np.float32)))
    shape = m.obs_mask.shape
    m.obs_mask.copy_(torch.from_numpy(rng.uniform(size=shape) < 0.3))
    m.obs_uv.copy_(torch.from_numpy(np.stack([rng.uniform(20, W - 20, shape),
                                              rng.uniform(20, H - 20, shape)], -1)
                                    .astype(np.float32)))
    m.points.copy_(torch.from_numpy(rng.normal(0, 2, m.points.shape).astype(np.float32)))
    hooks = []
    slam._hook_pool.shutdown(wait=True)
    slam._hook_pool = type("Pool", (), {"submit": lambda self, fn, *a: hooks.append(a),
                                        "shutdown": lambda self, wait: None})()
    rows = []
    try:
        for slot in (0, 3, 5, 7):
            before = t_ext.launch.launches
            slam._post_keyframe(slot, None)
            n_prog = t_ext.launch.launches - before
            before = t_ext.launch.launches
            want = slam._digest_program(m, slot)
            n_eager = t_ext.launch.launches - before
            rows.append((n_prog, n_eager, all(torch.equal(_bits(a), _bits(b))
                                              for a, b in zip(hooks[-1][1], want))))
        prog = slam._loop_programs.programs[("digest",)]
        assert prog.graph is not None and prog.replays == 3
    finally:
        slam.close()
    assert rows == [(1, 1, True)] * 4, rows


# The monocular bootstrap's programs (the engine's programs.Cache): the
# init chain's LK and the two-view segments, each captured at its second
# call; a re-init forced at this frame gives a second bootstrap.
INIT_REINIT_AT, INIT_CHECKS = 10, 3


@pytest.mark.cuda
def test_init_programs_replay_equal_eager_calls_on_cuda(cuda_device):
    """Through a bootstrap and a forced re-init, each init program's calls
    3 to 2 + INIT_CHECKS (replays) are held against an eager call of its
    bare function on the same staged inputs: bit-equal, with the eager
    call's K1 launches (LK in the init chain)."""
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.slam.engine import MonocularVO, VOConfig

    vo = MonocularVO(VOConfig(**ENGINE_MONO), device=cuda_device)
    lost = vo._update_lost
    vo._update_lost = lambda n: vo.frame_idx == INIT_REINIT_AT or lost(n)
    cache, real_get, rows = vo._cache, vo._cache.get, []

    def get(key, fn, **kw):
        prog = real_get(key, fn, **kw)

        def call(*args):
            if not 3 <= prog.calls + 1 <= 2 + INIT_CHECKS:
                return prog(*args)
            prog._stage(args)
            before = t_ext.launch.launches
            ref = [x.clone() for x in programs.flatten(
                prog.fn(*programs.unflatten(prog.spec, prog.inputs)))[0]
                if isinstance(x, torch.Tensor)]
            eager, before = t_ext.launch.launches - before, t_ext.launch.launches
            out = prog(*args)
            replayed = t_ext.launch.launches - before
            got = [x for x in programs.flatten(out)[0] if isinstance(x, torch.Tensor)]
            rows.append((key[0], prog.graph is not None and replayed == eager
                         and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref))))
            return out

        return call

    cache.get = get
    try:
        for f in _engine_frames(True, 30):
            vo.process(*f)
        states = [r.state for r in vo.results]
    finally:
        vo.close()
    assert vo.num_reinits == 1 and states[-1] == "tracking"
    names = {key[0] for key in cache.programs}
    assert names == {"init_track", "essential_system", "essential_score", "essential_refine",
                     "homography_system", "homography_score", "homography_refit",
                     "twoview_select"}
    assert {n for n, _ in rows} == names and all(ok for _, ok in rows), rows


@pytest.mark.cuda
def test_nccl_world_one_ba_solve_program_replays_bit_equal(cuda_device, tmp_path):
    """The sharded solve as the engine's `ba_solve` program over an NCCL
    group of one rank: eager at its first call, captured at its second,
    each of its four results bit-equal to `ba.solve_impl`, its collective
    record restored after each replay."""
    import datetime

    import torch.distributed as dist

    from viso_tpu_torch.backend import ba
    from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
    from viso_tpu_torch.slam import programs
    from viso_tpu_torch.tools import bench_dist_ba

    prob = bench_dist_ba.build_problem(16, 4096, cuda_device)
    params = ba.BAParams(iters=10, num_fixed=2)
    out_1, info_1 = ba.solve_impl(prob, params)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_mod.make_mesh(device=cuda_device)
        assert dist_ba.capturable(mesh)
        solver = dist_ba.ShardedSolver(mesh, params)
        program = solver.program(programs.Cache(cuda_device))
        rows = []
        for _ in range(4):
            out, info = program(prob)
            rows.append(all(torch.equal(getattr(out, k), getattr(out_1, k))
                            for k in ("R", "t", "points"))
                        and all(torch.equal(info[k], info_1[k]) for k in info_1)
                        and solver.stats.per_iter(10)[:2] == (2, 39_948))
    finally:
        dist.destroy_process_group()
    assert rows == [True] * 4
    assert program.graph is not None and program.replays == 3


@pytest.mark.cuda
def test_device_synchronise_between_frames_meets_no_capture_on_cuda(cuda_device):
    """A StereoSLAM on `multiprocess_ba`'s 14-frame corridor with a
    keyframe every frame and loop guard 1, so that the loop worker calls
    each detection segment at every keyframe from the second and solves
    the graph of one bucket more than once: the caller synchronises the
    whole device after every `process()` call while the worker runs. No
    hook error; by `join()` every loop program called twice or more is
    captured (the worker's asked for and made inside engine calls), none
    is pending, and the worker's programs replayed."""
    import dataclasses

    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.loop_closure import LoopParams
    from viso_tpu_torch.tools import multiprocess_ba

    frames, _, _, intr_kw = multiprocess_ba.engine_frames()
    cfg = dataclasses.replace(multiprocess_ba.engine_config(intr_kw), kf_min_gap=1, kf_max_gap=1)
    slam = StereoSLAM(cfg, LoopParams(capacity=16, guard=1), device=cuda_device)
    try:
        for il, ir in frames:
            slam.process(il, ir)
            torch.cuda.synchronize()
        slam.join()
        torch.cuda.synchronize()
        cache = slam._loop_programs
        progs = {k[0]: p for k, p in cache.programs.items()}
        errors, pending = list(slam.hook_errors), cache.pending
        drained = {name for name, _ in cache.captures}
    finally:
        slam.close()
    assert errors == [] and pending == 0
    assert progs["pose_graph"].calls >= 2 and progs["detect_match"].calls >= 3, progs
    assert all(p.graph is not None for p in progs.values() if p.calls >= 2)
    assert {"detect_match", "detect_dlt", "detect_dlt_sign", "detect_pnp", "pose_graph"} <= drained
    assert all(progs[n].replays >= 1 for n in ("detect_match", "detect_pnp", "digest"))


@pytest.mark.cuda
def test_bucket_512_solve_captured_then_replayed_on_cuda(cuda_device, monkeypatch):
    """A 300-node SE(3) ring (`synthetic.ring_graph`: exact sequential
    edges, 4 loop edges, a drifting start) through the loop layer's path,
    `solve_padded(..., programs=Cache(card))`, three times on the cache's
    own thread: the first call eager, the second captured and replayed,
    the third replayed. Its program is node bucket 512's, the LM took the
    PCG route in the eager call and in the capture (25 iterations each, no
    dense step), and each replay's camera centres equal the eager call's
    bit for bit (the normal equations are summed with no atomics; when
    they were scatter-added, an H100 read 5.4e-6 m)."""
    from viso_tpu_torch.backend import pose_graph as pg
    from viso_tpu_torch.data.synthetic import ring_graph
    from viso_tpu_torch.slam import programs

    routes = []
    for name in ("pcg", "dense"):
        real = getattr(pg, f"{name}_delta")

        def noted(*a, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(pg, f"{name}_delta", noted)
    K = 300
    (R0, t0, edges), _ = ring_graph(K, seed=3)
    cache = programs.Cache(cuda_device)
    centres = []
    for _ in range(3):
        out, info = pg.solve_padded(R0, t0, edges, pg.PGParams(iters=25), device=cuda_device,
                                    programs=cache)
        R, t = out.R[:K].cpu().double(), out.t[:K].cpu().double()
        centres.append(-torch.einsum("kji,kj->ki", R, t))
        assert float(info["final_cost"]) < 1e-4 * float(info["initial_cost"])
    ((key, prog),) = cache.programs.items()
    assert key[:3] == ("pose_graph", 512, 512) and prog.graph is not None and prog.replays == 2
    assert routes == ["pcg"] * 50
    for c in centres[1:]:
        assert torch.equal(c, centres[0])


@pytest.mark.cuda
@pytest.mark.parametrize("K, sim3", [(50, False), (50, True), (400, False), (400, True)])
def test_solves_bit_equal_eager_and_replayed_on_cuda(cuda_device, K, sim3):
    """One padded graph (node bucket 64, the dense route; 512, PCG)
    solved 5 times eagerly and 6 times through a `programs.Cache` (its
    first call eager, then captured and replayed 5 times): every result
    (nodes, final cost, cost history) bit-equal to the first. The normal
    equations are summed in a fixed order, with no atomics, and no
    process-wide determinism switch is set."""
    from viso_tpu_torch.backend import pose_graph as pg
    from viso_tpu_torch.backend import pose_graph_sim3 as pgs
    from viso_tpu_torch.slam import programs

    mod = pgs if sim3 else pg
    params = mod.PGParams(iters=25)
    case = _solve_case(K, sim3, 0)
    names = ("s", "R", "t") if sim3 else ("R", "t")

    def bits(out, info):
        xs = [getattr(out, k) for k in names] + [info["final_cost"], info["cost_history"]]
        return [x.detach().clone().view(torch.int32) for x in xs]

    results = [bits(*mod.solve_padded(*case, params, device=cuda_device)) for _ in range(5)]
    cache = programs.Cache(cuda_device)
    for _ in range(6):
        results.append(bits(*mod.solve_padded(*case, params, device=cuda_device,
                                              programs=cache)))
    (prog,) = cache.programs.values()
    assert prog.graph is not None and prog.replays == 5
    assert not torch.are_deterministic_algorithms_enabled()
    for r in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, results[0]))


def _upload_engine(device):
    """A StereoVO on `multiprocess_ba`'s corridor (its configuration, its
    frames) for the frame-upload tests."""
    from viso_tpu_torch.slam.engine import StereoVO
    from viso_tpu_torch.tools import multiprocess_ba

    frames, _, _, intr_kw = multiprocess_ba.engine_frames()
    return StereoVO(multiprocess_ba.engine_config(intr_kw), device=device), frames


@pytest.mark.cuda
def test_to_device_makes_no_synchronising_call_on_cuda(cuda_device):
    """`to_device` of uint8 and float32 arrays under
    `set_sync_debug_mode("error")` (the first upload pins a buffer, a later
    one adds one): no synchronising call; the device tensors hold the
    frames, cast as the engine casts them."""
    vo, frames = _upload_engine(cuda_device)
    try:
        torch.cuda.synchronize()
        staged = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for il, ir in frames:
                staged.append(vo.to_device(np.clip(il, 0, 255).astype(np.uint8), ir))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for (il, ir), (tl, tr) in zip(frames, staged):
            assert tl.device.type == "cuda" and tl.dtype == tr.dtype == torch.uint8
            assert np.array_equal(tl.cpu().numpy(), np.clip(il, 0, 255).astype(np.uint8))
            assert np.array_equal(tr.cpu().numpy(), np.clip(ir, 0, 255).astype(np.uint8))
    finally:
        vo.close()


@pytest.mark.cuda
def test_frames_staged_40_ahead_arrive_intact_on_cuda(cuda_device):
    """40 frames staged ahead from ONE caller buffer rewritten after each
    `to_device`, behind a long queue of work on the stream, so that every
    copy is still in flight when the next frame is written: each device
    tensor holds its own frame (no buffer is rewritten before its copy has
    read it), and the engine made more buffers to hold them."""
    vo, _ = _upload_engine(cuda_device)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (376, 1240), dtype=np.uint8) for _ in range(40)]
    buf = np.empty_like(frames[0])
    try:
        x = torch.rand((2048, 2048), device=cuda_device)
        for _ in range(50):   # keeps the stream busy behind the copies
            x = x @ x
            x = x / x.norm()
        staged = []
        for f in frames:
            buf[...] = f
            staged.append(vo.to_device(buf, buf)[0])
        assert len(vo._staging.slots) >= 2
        torch.cuda.synchronize()
        for f, t in zip(frames, staged):
            assert np.array_equal(t.cpu().numpy(), f)
    finally:
        vo.close()


@pytest.mark.cuda
def test_no_pinned_allocation_inside_a_capture_on_cuda(cuda_device, monkeypatch):
    """The upload runs, and pins its buffers, only outside a capture: over
    a run staged one frame ahead and one fed arrays through process()
    (every program captured on the way), no upload runs while the current
    stream captures."""
    from viso_tpu_torch.slam import engine

    made = []
    real = engine.FrameStaging.upload

    def noted(self, a, device):
        made.append(torch.cuda.is_current_stream_capturing())
        return real(self, a, device)

    monkeypatch.setattr(engine.FrameStaging, "upload", noted)
    vo, frames = _upload_engine(cuda_device)
    try:
        nxt = vo.to_device(*frames[0])
        for i in range(len(frames)):
            cur = nxt
            nxt = vo.to_device(*frames[i + 1]) if i + 1 < len(frames) else None
            vo.process(*cur)
        for il, ir in frames:
            vo.process(il, ir)
        torch.cuda.synchronize()
        captured = [n for n, p in vo._kernels.items() if p.graph is not None]
    finally:
        vo.close()
    assert len(made) >= 4 * len(frames) and not any(made) and captured, (made, captured)


@pytest.mark.cuda
def test_api_functions_on_cuda_match_their_cpu_results(rng, cuda_device):
    """The public functions no engine path calls (`fast.detect`, the RANSAC
    calls that draw and fit in one, `make_matrix` / `from_matrix`,
    `denormalize`, `signed_sampson`, the gather samplers), each run on the
    card against the same function on the CPU: FAST equal (its scores are
    exact on uint8 images and its sort stable); the samplers within 1e-4
    on [0, 255] values; the geometry within 1e-5; each RANSAC call's
    hypotheses drawn on the card, then the same indices through the CPU's
    `*_from_indices` half, on a planar scene (homography; noise free for the
    generic call, which has no refit) and a 3-D one (essential) with 0.3 px
    of noise and 30 % outliers. The homography calls: the same inliers but
    for 2 % and the model within 2e-3 up to scale and sign
    (tests/test_torch_twoview.py's bounds between the packages; with noise
    and no refit, the generic call's hypotheses' counts differ by a few
    between the devices' f32 `eigh` and the two pick other winners: an
    H100 read 77 % agreement). The essential: card and CPU each within
    tests/test_twoview.py's recovery bounds (> 85 % of the true inliers
    kept, < 10 % of the outliers); its MSAC ranking and the LM refinement
    from the top hypotheses start from f32 `eigh` / `svd` results that
    differ between the devices, so the two inlier sets agree only in part
    (an H100 read 92 %)."""
    from viso_tpu_torch.geometry import camera as t_cam
    from viso_tpu_torch.geometry import epipolar as t_epi
    from viso_tpu_torch.geometry import se3 as t_se3
    from viso_tpu_torch.ops import fast as t_fast
    from viso_tpu_torch.ops import ransac as t_ransac

    def both(fn, *args):
        """fn on the card (results on the CPU) and on the CPU."""
        cpu = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        dev = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in cpu]
        out_d, out_c = fn(*dev), fn(*cpu)
        if isinstance(out_d, torch.Tensor):
            out_d, out_c = (out_d,), (out_c,)
        return [d.cpu() for d in out_d], list(out_c)

    def close(pairs, tol):
        for d, c in zip(*pairs):
            np.testing.assert_allclose(d.numpy(), c.numpy(), rtol=0, atol=tol)

    img = np.clip(rng.normal(128, 60, (120, 160)), 0, 255).astype(np.uint8).astype(np.float32)
    for nms in (True, False):
        d, c = both(lambda x: t_fast.detect(x, 20.0, 300, nms), img)
        assert all(torch.equal(a, b) for a, b in zip(d, c)) and int(c[2].sum()) > 0
    stack = rng.uniform(0, 255, (3, 64, 80)).astype(np.float32)
    uv = np.stack([rng.uniform(-4, 84, (24, 6, 6)), rng.uniform(-4, 68, (24, 6, 6))],
                  -1).astype(np.float32)
    k = rng.integers(0, 3, 24).astype(np.int64)
    centres = np.stack([rng.uniform(2, 78, 24), rng.uniform(2, 62, 24)], -1).astype(np.float32)
    for name in ("bilinear", "bilinear_with_grad", "gradient"):
        close(both(getattr(t_smp, name), stack[0], uv), 1e-4)
    for name in ("bilinear_indexed_with_grad", "gradient_indexed"):
        close(both(getattr(t_smp, name), stack, k, uv), 1e-4)
    for name in ("sample_patches", "sample_patches_with_grad"):
        close(both(lambda i, c: getattr(t_smp, name)(i, c, 3), stack[0], centres), 1e-4)
    windows, base = t_smp.extract_windows(torch.from_numpy(stack[0]), torch.from_numpy(centres), 16)
    for name in ("sample_windows", "sample_windows_with_grad"):
        close(both(getattr(t_smp, name), windows, base, uv), 1e-4)
    R, t = t_se3.se3_exp(torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32)))
    close(both(t_se3.make_matrix, R, t), 1e-5)
    close(both(t_se3.from_matrix, t_se3.make_matrix(R, t)), 1e-5)
    intr = t_cam.Intrinsics.create(517.3, 516.5, 325.1, 249.7)
    x1 = rng.normal(0, 0.3, (200, 2)).astype(np.float32)
    close(both(lambda x: t_cam.denormalize(x, intr), x1), 1e-4)
    x2 = (x1 + 0.05 + rng.normal(0, 1e-3, (200, 2))).astype(np.float32)
    E = t_epi.essential_from_rt(R[:1], t[:1])
    close(both(t_epi.signed_sampson, E, x1, x2), 1e-5)

    def scene(planar, noise_px=0.3, n=200):
        """Normalized x1, x2 of n points (on the plane z = 6 m, or at 4-10 m)
        seen from two poses, noise_px of noise at f = 520, 30 % outliers,
        and the inlier mask."""
        z = np.full(n, 6.0) if planar else rng.uniform(4, 10, n)
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], -1)
        R2, t2 = (x.double().numpy() for x in t_se3.se3_exp(
            torch.tensor([0.2, -0.05, 0.05, 0.02, -0.03, 0.02])))
        pc2 = pts @ R2.T + t2
        a = (pts[:, :2] / pts[:, 2:3] + rng.normal(0, noise_px / 520, (n, 2))).astype(np.float32)
        b = (pc2[:, :2] / pc2[:, 2:3] + rng.normal(0, noise_px / 520, (n, 2))).astype(np.float32)
        out = rng.choice(n, int(0.3 * n), replace=False)
        b[out] = rng.uniform(-0.5, 0.5, (len(out), 2)).astype(np.float32)
        inlier = np.ones(n, bool)
        inlier[out] = False
        return a, b, inlier

    mask = torch.ones(200, dtype=torch.bool)
    scenes = {"homography": scene(True), "essential": scene(False),
              "generic": scene(True, noise_px=0.0)}
    calls = [("homography", lambda g, a, b, m: t_ransac.homography_ransac(g, a, b, m, 4e-6),
              lambda i, a, b, m: t_ransac.homography_ransac_from_indices(i, a, b, m, 4e-6), 4),
             ("essential", lambda g, a, b, m: t_ransac.essential_ransac(g, a, b, m, 4e-6),
              lambda i, a, b, m: t_ransac.essential_ransac_from_indices(i, a, b, m, 4e-6), 8),
             ("generic", lambda g, a, b, m: t_ransac.ransac(
                 g, a, b, m, t_epi.fit_homography, t_epi.homography_residual, 4, 128, 4e-6),
              lambda i, a, b, m: t_ransac.ransac_from_indices(
                  i, a, b, m, t_epi.fit_homography, t_epi.homography_residual, 4e-6), 4)]
    for name, draw_fit, fit, k_sample in calls:
        drawn = []
        real = t_ransac.draw_indices

        def noted(*a, **kw):
            drawn.append(real(*a, **kw))
            return drawn[-1]

        t_ransac.draw_indices = noted
        a, b, inlier = scenes[name]
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        try:
            gen = torch.Generator(cuda_device).manual_seed(0)
            res_d = draw_fit(gen, a.to(cuda_device), b.to(cuda_device), mask.to(cuda_device))
        finally:
            t_ransac.draw_indices = real
        assert drawn[0].device.type == "cuda" and drawn[0].shape[1] == k_sample, name
        res_c = fit(drawn[0].cpu(), a, b, mask)
        if name == "essential":
            for inl in (res_d.inliers.cpu().numpy(), res_c.inliers.numpy()):
                assert inl[inlier].mean() > 0.85 and inl[~inlier].mean() < 0.1, name
            continue
        agree = (res_d.inliers.cpu() == res_c.inliers).float().mean()
        assert agree >= 0.98 and int(res_c.num_inliers) >= 120, (name, agree, res_c.num_inliers)
        m_d, m_c = (r.model.cpu().double() for r in (res_d, res_c))
        m_d, m_c = (m / m.norm() * torch.sign(m.flatten()[m.abs().argmax()]) for m in (m_d, m_c))
        assert (m_d - m_c).abs().max() < 2e-3, name


@pytest.mark.cuda
def test_track_program_kernel_count_equals_the_profilers_on_cuda(cuda_device, monkeypatch):
    """The track program's kernel nodes, counted once at its capture
    (`Program.kernels`, through the driver), equal the kernels that
    `profiling.profile_stage` sees in one replay of its graph (the
    profiler also lists the graph's memset and memcpy nodes); a tracked
    frame that is no keyframe adds exactly them to its `graph_kernels`.
    With every frame timed, each frame's events read its device ms, the
    gap to the next frame and each replay's stream ms."""
    from viso_tpu_torch import _cuda
    from viso_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "EVENT_EVERY", 1)
    vo, frames = _upload_engine(cuda_device)
    try:
        results = [vo.process(il, ir) for il, ir in frames[:8]]
        torch.cuda.synchronize()
        prog = vo._kernels["track"]
        nodes = _cuda.graph_nodes(prog.graph.raw_cuda_graph())
        row = profiling.profile_stage("track", lambda: (prog.graph.replay(), prog.outputs)[1],
                                      reps=2)
        recorded = profiling.RECORDER.frames(0, len(results), engine=vo.engine_id)
    finally:
        vo.close()
    kinds = (_cuda.GRAPH_NODE_KERNEL, _cuda.GRAPH_NODE_MEMCPY, _cuda.GRAPH_NODE_MEMSET)
    assert prog.kernels == nodes[_cuda.GRAPH_NODE_KERNEL] > 1000, nodes
    assert row["fence"][0] > 0 and row["fence"][1] > 0
    assert row["kernels"] == sum(nodes.get(k, 0) for k in kinds), (row, nodes)
    plain = [f for f, r in zip(recorded, results) if r.state == "tracking" and not r.is_keyframe]
    assert plain and all(f.counters["graph_kernels"] == prog.kernels for f in plain)
    for f, r in zip(recorded[:-1], results):
        assert f.device_ms > 0 and f.gap_ms >= 0, (f.index, f.device_ms, f.gap_ms)
        names = [n for n, _ in f.programs]
        assert all(ms > 0 for _, ms in f.programs)
        assert ("track" in names) == (f.index > 0) and ("ba" in names) == (
            r.is_keyframe and f.index > 0), (f.index, names)
    print(f"track program: {prog.kernels} kernel nodes, nodes by type {nodes}, "
          f"profiler {row['kernels']}")


def _mono_engine_frames(device, n):
    """A MonocularVO with tests/test_torch_mono.py's gates and n frames of
    the port's synthetic corridor, which it bootstraps on."""
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera
    from viso_tpu_torch.slam.engine import MonocularVO, VOConfig

    H, W = 192, 256
    intr_kw = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    cfg = VOConfig(height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
                   detect_grid=(4, 6), fast_threshold=10.0, kf_min_gap=2, kf_max_gap=6,
                   kf_min_visible_frac=0.45, min_init_tracks=25,
                   disparity_squared_thresh=25.0, stats_deterministic=True, **intr_kw)
    intr = camera.Intrinsics.create(**intr_kw)
    scene = synthetic.corridor_scene(np.random.default_rng(7), tex_size=512)
    Rs, ts = synthetic.forward_trajectory(n, step=0.15, yaw_rate=0.004)
    frames = [np.clip(scene.render(intr, R, t, H, W)[0], 0, 255).astype(np.uint8)
              for R, t in zip(Rs, ts)]
    return MonocularVO(cfg, device=device), frames


@pytest.mark.cuda
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_recorder_adds_no_synchronising_call_on_cuda(cuda_device, mono):
    """A tracked stereo window (after the warm-up's captures) and a mono
    window from its first frame through its bootstrap, under
    `set_sync_debug_mode("warn")`: every synchronising call warned from
    `slam/engine.py` is at `engine._host`, the one host read the frames'
    `host_syncs` count, and there are no more of them than the count; none
    is warned from the recorder (`utils/profiling.py`)."""
    import inspect
    import os
    import warnings

    from viso_tpu_torch.slam import engine
    from viso_tpu_torch.utils import profiling

    src, first = inspect.getsourcelines(engine._host)
    host_line = first + next(i for i, line in enumerate(src) if "x.cpu()" in line)
    if mono:
        vo, frames = _mono_engine_frames(cuda_device, 20)
        warm, window = [], frames
    else:
        vo, frames = _upload_engine(cuda_device)
        warm, window = frames[:6], frames[6:]
    try:
        for f in warm:
            vo.process(*f)
        torch.cuda.synchronize()
        start = vo.frame_idx + 1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for f in window:
                    vo.process(*((f,) if mono else f))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        state = vo.state
        recorded = profiling.RECORDER.frames(start, len(window), engine=vo.engine_id)
    finally:
        vo.close()
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    here = [(os.path.basename(w.filename), w.lineno) for w in syncs
            if w.filename.endswith(os.path.join("slam", "engine.py"))]
    assert all(line == host_line for _, line in here), here
    assert not [w for w in syncs if w.filename.endswith(os.path.join("utils", "profiling.py"))]
    counted = sum(f.counters.get("host_syncs", 0) for f in recorded)
    assert len(recorded) == len(window) and len(here) <= counted
    if mono:
        assert state == "tracking" and here, (state, len(here))
    print(f"{'mono' if mono else 'stereo'}: {len(syncs)} synchronising calls warned, "
          f"{len(here)} from slam/engine.py, host_syncs {counted} over {len(window)} frames")
