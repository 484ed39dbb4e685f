"""The engines' programs as `slam/programs.Program` runs them, on the CPU.

On a CUDA engine a program is captured once as a CUDA graph and replayed;
on the CPU the same static buffers are filled and the function runs
eagerly. Here:

  * `Program` itself: its outputs are the same tensors at every call, a
    caller's later writes do not reach them, and they equal the bare
    function's; the engine's own tensors are read in place;
  * the programs with 0-d tensor arguments (the JAX jit's traced slot,
    eviction flag, frame id and existing-observations flag) against the
    JAX package's `insert` and template programs on the same numpy-seeded
    state, at both eviction values;
  * the engine state keeps its storage for a whole run (tests/
    test_torch_engine.py's 12 frames; a MonoSLAM run through a re-init and
    a checkpoint save and restore), and each frame's pose is its own;
  * no program reads the device on the host (a dispatch-mode guard);
  * the launch-counter bookkeeping of replays, with a fake counter.

The replays on the card: tests/test_torch_cuda.py and chip_smoke.py's
phase 12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from viso_tpu.data import synthetic as j_syn
from viso_tpu.geometry import camera as j_cam
from viso_tpu.mapping import map_state as j_ms
from viso_tpu.slam.engine import MonocularVO as JMonocularVO
from viso_tpu.slam.engine import StereoVO as JStereoVO
from viso_tpu.slam.engine import VOConfig as JVOConfig
from viso_tpu_torch.mapping import map_state as t_ms
from viso_tpu_torch.slam import programs
from viso_tpu_torch.slam.engine import PROGRAMS, MonocularVO, StereoVO, VOConfig
from viso_tpu_torch.slam.loop_closure import LoopParams
from viso_tpu_torch.slam.mono_full import MonoSLAM
from viso_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

# tests/test_torch_engine.py's configuration and 12-frame stereo corridor.
H, W = 192, 256
INTR = dict(fx=200.0, fy=200.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
CFG = dict(
    height=H, width=W, max_keyframes=6, max_landmarks=384, num_features=192,
    detect_grid=(4, 6), fast_threshold=15.0, baseline=0.3, max_disparity=48,
    kf_min_gap=2, stats_deterministic=True, **INTR,
)
N_FRAMES = 12
# tests/test_torch_mono.py's mono gates.
MONO_CFG = dict(CFG, fast_threshold=10.0, kf_max_gap=6, kf_min_visible_frac=0.45,
                min_init_tracks=25, disparity_squared_thresh=25.0)


class NoHostSync(TorchDispatchMode):
    """Records every op that reads a device value on the host: `.item()`,
    `int(t)` and `bool(t)` (`_local_scalar_dense`), ops whose output shape
    depends on the data, boolean-mask indexing and `torch.tensor` of host
    data (`lift_fresh`)."""

    BANNED = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
              "_unique2", "unique_dim", "unique_consecutive", "lift_fresh"}
    INDEX = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.INDEX and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                      for i in args[1]):
            self.found.append(f"{func} with a boolean mask")
        elif name in self.BANNED:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def guard_programs(vo, found, ran):
    """Run each of `vo`'s programs under `NoHostSync`, as the engine calls
    it (through its `Program`)."""
    real, done = vo._program, set()

    def program(name):
        prog = real(name)
        if name not in done:
            fn = prog.fn

            def guarded(*args):
                ran.add(name)
                with NoHostSync(found):
                    return fn(*args)

            prog.fn = guarded
            done.add(name)
        return prog

    vo._program = program


def state_tensors(vo):
    """Every tensor of the engine state a program reads."""
    return programs.flatten((vo.map, vo.R, vo.t, vo.prev_R, vo.prev_t, vo.vel_xi,
                             vo._templates, vo._active_idx, vo._cam_fixed))[0]


def ptrs(vo):
    return [x.data_ptr() for x in state_tensors(vo)]


@pytest.fixture(scope="module")
def corridor():
    return j_syn.corridor_scene(np.random.default_rng(7), tex_size=512)


@pytest.fixture(scope="module")
def stereo_run(corridor):
    """The port's StereoVO over the 12 frames, its programs guarded; the
    state's data pointers at construction and after every frame."""
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(N_FRAMES, step=0.25, yaw_rate=0.004)
    frames = []
    for R, t in zip(Rs, ts):
        il, ir, _ = j_syn.make_stereo_pair(corridor, intr, R, t, H, W, baseline=0.3)
        frames.append((np.clip(il, 0, 255).astype(np.uint8),
                       np.clip(ir, 0, 255).astype(np.uint8)))
    vo = StereoVO(VOConfig(**CFG), device="cpu")
    found, ran = [], set()
    guard_programs(vo, found, ran)
    seen = [ptrs(vo)]
    for il, ir in frames:
        vo.process(il, ir)
        seen.append(ptrs(vo))
    yield vo, frames, seen, found, ran
    vo.close()


@pytest.fixture(scope="module")
def mono_run(corridor, tmp_path_factory):
    """MonoSLAM over the mono corridor through a re-init and a checkpoint
    save and restore, its programs guarded; the state's data pointers of
    both engines after every frame."""
    intr = j_cam.Intrinsics.create(**INTR)
    Rs, ts = j_syn.forward_trajectory(34, step=0.15, yaw_rate=0.004)
    frames = [np.clip(corridor.render(intr, R, t, H, W)[0], 0, 255).astype(np.uint8)
              for R, t in zip(Rs, ts)]
    cfg = VOConfig(**MONO_CFG)
    lp = LoopParams(capacity=16, num_features=64, guard=4)
    slam = MonoSLAM(cfg, lp, device="cpu")
    found, ran = [], set()
    guard_programs(slam, found, ran)
    first, seen, reinit_at = ptrs(slam), [], None
    for k, img in enumerate(frames[:22]):
        slam.process(img)
        seen.append(ptrs(slam))
        if reinit_at is None and slam.state == "tracking" and len(slam.kf_order) >= 3:
            slam._reinitialize(tuple(lvl.clone() for lvl in slam.last_pyr))
            reinit_at = k
            seen.append(ptrs(slam))
    path = str(tmp_path_factory.mktemp("ckpt") / "mono.npz")
    checkpoint.save_slam(path, slam)
    slam.close()
    slam2, _ = checkpoint.load_slam(path, cfg, lp, device="cpu")
    guard_programs(slam2, found, ran)
    restored = [ptrs(slam2)]
    for img in frames[22:]:
        slam2.process(img)
        restored.append(ptrs(slam2))
    slam2.join()
    yield dict(slam=slam, slam2=slam2, first=first, seen=seen, restored=restored,
               reinit_at=reinit_at, found=found, ran=ran)
    slam2.close()


# -- (a) Program on the CPU ------------------------------------------------

def _fn(x, y, k, flag):
    """Two new outputs and one passed through (a view of an input)."""
    return x * k + y, torch.where(flag, x.sum(), -1.0), y[1:]


def test_program_outputs_are_static_and_equal_the_bare_function():
    prog = programs.Program(_fn, "cpu")
    rng = np.random.default_rng(0)
    outs, ptr0 = [], None
    for k, flag in ((2, True), (3, False), (5, True)):
        x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
        out = prog(x, y, k, flag)
        ref = _fn(x, y, torch.tensor(k), torch.tensor(flag))
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        ptr = [o.data_ptr() for o in out]
        assert ptr0 is None or ptr == ptr0     # the same tensors every call
        ptr0 = ptr
        kept = [o.clone() for o in out]
        x.add_(100.0)                          # a caller's later write
        y.add_(100.0)
        for a, b in zip(out, kept):
            assert torch.equal(a, b)
        outs.append(kept)
    assert not torch.equal(outs[0][0], outs[1][0])   # new inputs were read
    # The scalars are staged as 0-d tensors, not baked in.
    assert [s.dim() for s in prog.inputs[2:]] == [0, 0]
    assert prog.inputs[2].dtype == torch.int64 and prog.inputs[3].dtype == torch.bool


def test_program_reads_owned_tensors_in_place_and_checks_its_signature():
    state = torch.arange(6.0).reshape(2, 3)
    prog = programs.Program(lambda s, v: (s * v, s[0]), "cpu", owned={state.data_ptr()})
    prog(state, torch.ones(3))
    assert prog.inputs[0] is state              # read where it lies
    state.mul_(2.0)
    out = prog(state, torch.ones(3))
    assert torch.equal(out[0], state) and out[1].data_ptr() == state.data_ptr()
    with pytest.raises(ValueError, match="engine's own"):
        prog(state.clone(), torch.ones(3))
    with pytest.raises(ValueError, match="captured as"):
        prog(state, torch.ones(4))
    with pytest.raises(TypeError, match="structure"):
        prog(state, (torch.ones(3),))


def test_engine_program_is_static_on_the_cpu(stereo_run):
    vo, frames, *_ = stereo_run
    img = vo.to_device(*frames[-1])[0]
    args = (vo.map, vo._templates, vo._active_idx, img, vo.R, vo.t, vo.vel_xi)
    prog = vo._program("track")
    out = prog(*args)
    first = [x.data_ptr() for x in programs.flatten(out)[0]]
    ref = programs.flatten(vo._track(*args))[0]
    again = programs.flatten(prog(*args))[0]
    assert [x.data_ptr() for x in again] == first
    for a, b in zip(again, ref):
        assert torch.equal(a, b)


# -- (b) device-scalar arguments against the JAX programs ------------------

def _state(vo, frames):
    """Numpy state of the run (map, pose) and the last frame's track
    outputs (pyramid, observations), from the port's run."""
    m = t_ms.to_numpy(vo.map)
    il, ir = frames[-1]
    img = vo.to_device(il, ir)[0]
    out = vo._track(vo.map, vo._templates, vo._active_idx, img, vo.R, vo.t, vo.vel_xi)
    track = dict(R=out[0].numpy(), t=out[1].numpy(), ok=out[2].numpy(), refined=out[3].numpy(),
                 pyr=tuple(p.numpy() for p in out[5]))
    return m, track, il, ir


def _jax_map(m):
    return j_ms.MapState(**{k: (tuple(jnp.asarray(a) for a in v) if k == "kf_pyr"
                                else jnp.asarray(v)) for k, v in m.items()})


def _t(x):
    return torch.from_numpy(np.array(x))


def _slot_for(vo, do_evict):
    """An occupied slot (evicted) or a free one (not evicted)."""
    if do_evict:
        return vo.kf_order[0]
    free = [s for s in range(vo.cfg.max_keyframes) if s not in vo.kf_order]
    return free[0]


def _compare_maps(m_t, m_j):
    """As tests/test_torch_engine.py holds the keyframe programs: masks
    agree on at least 99 % of entries (borderline detections may flip),
    the landmarks valid in both within 1e-2 (metres, depth 1-30 m), the
    inserted poses and frame ids exact."""
    tm = t_ms.to_numpy(m_t)
    jm = {k: np.asarray(v) for k, v in zip(m_j._fields, m_j) if k != "kf_pyr"}
    for k in ("kf_R", "kf_t", "kf_frame_id", "kf_mask"):
        np.testing.assert_array_equal(tm[k], jm[k])
    for k in ("point_mask", "obs_mask"):
        assert (tm[k] == jm[k]).mean() >= 0.99, k
    keep = tm["point_mask"] & jm["point_mask"]
    np.testing.assert_allclose(tm["points"][keep], jm["points"][keep], rtol=1e-2, atol=1e-2)
    for a, b in zip(m_t.kf_pyr, m_j.kf_pyr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("do_evict", [True, False])
def test_stereo_kf_program_with_device_scalars_matches_jax(stereo_run, do_evict):
    vo, frames, *_ = stereo_run
    m, tr, il, ir = _state(vo, frames)
    slot = _slot_for(vo, do_evict)
    jins = JStereoVO(JVOConfig(**CFG))._build_stereo_kf_kernel()
    m_j = jins(_jax_map(m), slot, jnp.asarray(do_evict), jnp.asarray(tr["R"]),
               jnp.asarray(tr["t"]), 99, tuple(jnp.asarray(p) for p in tr["pyr"]),
               jnp.asarray(il), jnp.asarray(ir), jnp.asarray(tr["ok"]),
               jnp.asarray(tr["refined"]), jnp.asarray(True))
    args = (t_ms.from_numpy(m, "cpu"), _t(tr["R"]), _t(tr["t"]),
            tuple(_t(p) for p in tr["pyr"]), _t(il), _t(ir), _t(tr["ok"]), _t(tr["refined"]))
    m_, R, t, pyr, il_t, ir_t, ok, ref = args
    m_t = vo._stereo_kf_program(m_, torch.tensor(slot), torch.tensor(do_evict), R, t,
                                torch.tensor(99), pyr, il_t, ir_t, ok, ref, torch.tensor(True))
    _compare_maps(m_t, m_j)
    # The Python-value call (the bare function's other form) is the same map.
    m_py = vo._stereo_kf_program(m_, slot, do_evict, R, t, 99, pyr, il_t, ir_t, ok, ref, True)
    for a, b in zip(programs.flatten(m_t)[0], programs.flatten(m_py)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("do_evict", [True, False])
def test_mono_kf_program_with_device_scalars_matches_jax(stereo_run, do_evict):
    """The mono keyframe insertion on the stereo run's map, as if its
    last frame were a mono keyframe: LK from the previous keyframe,
    two-view triangulation and far points, both packages on the same
    inputs."""
    vo, frames, *_ = stereo_run
    m, tr, _, _ = _state(vo, frames)
    slot, prev = _slot_for(vo, do_evict), vo.kf_order[-1]
    jins = JMonocularVO(JVOConfig(**MONO_CFG))._build_mono_kf_kernel()
    m_j = jins(_jax_map(m), slot, jnp.asarray(do_evict), prev, jnp.asarray(tr["R"]),
               jnp.asarray(tr["t"]), 99, tuple(jnp.asarray(p) for p in tr["pyr"]),
               jnp.asarray(tr["ok"]), jnp.asarray(tr["refined"]))
    mvo = MonocularVO(VOConfig(**MONO_CFG), device="cpu")
    pyr = tuple(_t(p) for p in tr["pyr"])
    m_t = mvo._mono_kf_program(t_ms.from_numpy(m, "cpu"), torch.tensor(slot),
                               torch.tensor(do_evict), torch.tensor(prev), _t(tr["R"]),
                               _t(tr["t"]), torch.tensor(99), pyr, _t(tr["ok"]),
                               _t(tr["refined"]))
    _compare_maps(m_t, m_j)
    new = t_ms.to_numpy(m_t)["point_mask"] & ~m["point_mask"]
    assert new.sum() > 0                       # LK tracks became landmarks
    mvo.close()


def test_templates_program_with_a_device_slot_matches_jax(stereo_run):
    vo, frames, *_ = stereo_run
    m, *_ = _state(vo, frames)
    slot = vo.kf_order[-1]
    tmpl_j, active_j = JStereoVO(JVOConfig(**CFG))._build_template_kernel()(_jax_map(m), slot)
    tmpl_t, active_t = vo._templates_program(t_ms.from_numpy(m, "cpu"), torch.tensor(slot))
    assert np.array_equal(active_t.numpy(), np.asarray(active_j))
    # tests/test_torch_engine.py's tolerance on template patches; a point
    # at the image border may fall either side of it in f32 (1 of 184 at
    # level 1 here).
    for a, b in zip(tmpl_t, tmpl_j):
        ok_t, ok_j = a.ok.numpy(), np.asarray(b.ok)
        assert (ok_t == ok_j).mean() >= 0.99
        both = ok_t & ok_j
        np.testing.assert_allclose(a.T.numpy()[both], np.asarray(b.T)[both], rtol=1e-3, atol=1e-3)


# -- (c) persistent state ---------------------------------------------------

def test_stereo_state_keeps_its_storage(stereo_run):
    vo, _, seen, _, _ = stereo_run
    assert all(p == seen[0] for p in seen)
    assert set(seen[0]) == vo._owned
    assert sum(r.is_keyframe for r in vo.results) >= 2 and len(vo.kf_order) >= 2
    # Each frame's pose is its own: no two frames share storage, and the
    # trajectory moves every frame.
    assert len({r.R.data_ptr() for r in vo.results} | set(seen[0])) == N_FRAMES + len(seen[0])
    R, t = vo.trajectory()
    assert (np.linalg.norm(np.diff(t, axis=0), axis=-1) > 1e-3).all()


def test_mono_state_keeps_its_storage_through_reinit_and_restore(mono_run):
    r = mono_run
    assert r["reinit_at"] is not None and r["slam"].num_reinits == 1
    assert all(p == r["first"] for p in r["seen"])
    assert set(r["first"]) == r["slam"]._owned
    # The restored engine keeps the storage it was built with.
    assert all(p == r["restored"][0] for p in r["restored"])
    assert set(r["restored"][0]) == r["slam2"]._owned
    assert r["slam2"].state == "tracking"
    R, t = r["slam2"].trajectory()
    assert len(R) == 12 and np.isfinite(t).all()
    assert len({a.tobytes() for a in t}) == len(t)


# -- (d) no host sync -------------------------------------------------------

def test_programs_read_nothing_on_the_host(stereo_run, mono_run):
    _, _, _, found, ran = stereo_run
    assert ran == {"track", "templates", "stereo_kf", "ba"} and found == []
    assert mono_run["ran"] == {"track", "templates", "mono_kf", "ba"}
    assert mono_run["found"] == []
    assert set(PROGRAMS) == ran | mono_run["ran"]


def test_host_sync_guard_catches_reads():
    found = []
    x = torch.arange(5.0)
    with NoHostSync(found):
        x[torch.tensor(1)]
        x[x > 2.0]
    assert found == ["aten.lift_fresh.default", "aten._local_scalar_dense.default",
                     "aten.index.Tensor with a boolean mask"], found


# -- (e) launch counters under replay ---------------------------------------

class FakeGraph:
    def replay(self):
        pass


def test_replays_add_the_launches_the_capture_held(monkeypatch):
    """A capture runs the function (its counter moves, as a real capture's
    K1 wrapper would) and takes the moves back; each replay, which runs no
    Python, adds them. Warm-up calls are real launches and count."""
    counter = type("Counter", (), {"launches": 0})()
    monkeypatch.setattr(programs, "COUNTERS", ((counter, "launches"),))

    def fn(x):
        counter.launches += 3
        return x + 1

    def capture(f, args, device):
        for _ in range(programs.WARMUP_CALLS):
            f(*args)
        out = []
        counts = programs.measure_counts(lambda: out.append(f(*args)))
        return FakeGraph(), out[0], counts

    monkeypatch.setattr(programs, "_capture", capture)
    prog = programs.Program(fn, "cpu")
    prog.graphed = True
    x = torch.zeros(2)
    prog(x)
    assert prog.counts == {(counter, "launches"): 3}
    assert counter.launches == 3 * programs.WARMUP_CALLS + 3 and prog.replays == 1
    for k in range(2, 5):
        prog(x)
        assert counter.launches == 3 * programs.WARMUP_CALLS + 3 * k and prog.replays == k
    fn(x)                                      # the bare function counts itself
    assert counter.launches == 3 * programs.WARMUP_CALLS + 15
    assert programs.measure_counts(lambda: None) == {}
