"""Visual-odometry engines: the per-frame state machine (port of
`viso_tpu/slam/engine.py`: `VOConfig`, `FrameResult`, `BaseVO`,
`StereoVO`, `MonocularVO`, `blend_recovery_scale`).

Frame-rate decisions (keyframe policy, lost tracking, initialization
gates) are host-side Python on per-frame scalars; every per-feature /
per-pixel computation is tensor code on the engine's device, in these
programs (`slam/programs.Program`: on a CUDA engine each is captured once
as a CUDA graph and replayed every frame, the JAX engine's jit builders
and `_kernels` cache; on the CPU each runs eagerly through the same
static buffers):

  * track (every frame): pyramid, direct GN against frozen keyframe
    templates, 2-level LK alignment, 4-step PnP refine, acceleration gate;
  * stereo_kf / mono_kf (every keyframe): evict, insert, detect, then
    stereo match and backprojection (stereo) or LK tracking from the
    previous keyframe and gated two-view triangulation with far points
    (mono), and landmark allocation;
  * ba (every keyframe): reprojection or photometric window LM with the
    adoption gate ("auto": photometric for mono, reprojection for stereo);
  * templates (every keyframe): frozen tracking templates.

The per-frame path of a tracking engine is branchless on device values:
nothing in `track` reads a device scalar on the host. Per-frame stats
reach the host through a non-blocking copy into pinned memory, consumed a
fixed or opportunistic number of frames later (`stats_max_lag`,
`stats_hard_lag`, `stats_deterministic`, as in the reference). The
monocular bootstrap reads its gates on the host, as the reference does
(`MonocularVO._try_initialize`): its init-chain LK (`init_track`) and
the two-view initialization's segments run as programs of the engine's
`programs.Cache`, eager at their first call and captured at their second,
between the RANSAC draws and the two-view solvers' `eigh` and `svd`
(`ops/twoview.py`). All shapes are static across frames.

The engine state a program reads (the map, the pose, the previous pose,
the velocity twist, the templates and their landmark subset) lives in
storage allocated once, in `BaseVO.__init__`: a graph reads addresses,
not attributes. Assigning one of them writes into that storage
(`commit`). Slots, eviction flags and frame ids reach a program as 0-d
tensors (the JAX jit's traced arguments), and its branches on them are
selects. A program's outputs are overwritten by its next call: what the
engine keeps longer (a frame's pose in `results`, a segment's base pose)
is a copy.

`BaseVO._post_keyframe` is the keyframe hook of the SLAM layer
(`slam/full.py`); here it is a no-op.

Distributed window BA (`distribute_ba`, north-star config 5): the
window is solved landmark-sharded over the `torch.distributed` world
(`parallel/dist_ba.py`): camera blocks replicated, landmarks and their
Schur marginalization rank-local, the reduced camera system summed with
`all_reduce`. It is three programs, the JAX engine's jitted prep, solve
and finish: `ba_prep` (the problem, padded to the group), `ba_solve`
(the sharded LM, eager at its first call, which makes the NCCL
communicator, and captured at its second) and `ba_finish` (the
write-back and the adoption gate). gloo's collectives cannot be
captured: over gloo `ba_solve` runs eagerly, and `program_listing` says
so. Every other program runs replicated on each rank's own device. Each
rank must make the same keyframe decisions, so a run of more than one
rank needs `stats_deterministic` or `kf_min_gap == kf_max_gap`. The
SLAM engines distribute too: each rank runs its own loop layer on the
same keyframes (`slam/full.py`).

No CUDA graph capture runs outside an engine call: `process()` first
makes the captures that another thread (the SLAM loop worker) asked for
(`programs.Cache.drain`), so a caller may synchronise the whole device
between calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viso_tpu_torch.backend import ba, ba_photometric
from viso_tpu_torch.geometry import camera as cam_mod
from viso_tpu_torch.geometry import se3, triangulation
from viso_tpu_torch.mapping import map_state
from viso_tpu_torch.ops import align, direct, fast, lk, pnp, pyramid, stereo, twoview
from viso_tpu_torch.slam import programs

# The engine programs: name -> the method that is the bare function.
PROGRAMS = {"track": "_track", "templates": "_templates_program", "ba": "_ba_program",
            "stereo_kf": "_stereo_kf_program", "mono_kf": "_mono_kf_program"}
# A distributed engine's window BA: the problem, the sharded solve and the
# write-back (the solve eager over gloo: `dist_ba.capturable`).
DIST_BA_PROGRAMS = {"ba_prep": "_ba_prep_program", "ba_solve": "_dist_ba_solve",
                    "ba_finish": "_ba_finish_program"}


@dataclass
class VOConfig:
    # Image geometry
    height: int = 376
    width: int = 1241
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.537

    # Capacities (static shapes)
    max_keyframes: int = 8
    max_landmarks: int = 2048
    num_features: int = 512
    pyramid_levels: int = 4

    # Detection
    fast_threshold: float = 25.0
    detect_grid: tuple = (6, 12)
    detect_levels: int = 3

    # Initialization (monocular; kept for config parity)
    reinitialize_after: int = 10
    min_init_tracks: int = 50
    min_init_inlier_ratio: float = 0.9
    init_projection_error_px: float = 1.0
    init_parallax_deg: float = 60.0
    disparity_squared_thresh: float = 15.0**2
    init_min_parallax_deg: float = 1.5
    min_triangulation_parallax_deg: float = 0.5

    # Tracking
    ransac_threshold_px: float = 2.0
    min_tracked_points: int = 30
    direct_iters: int = 6
    align_iters: int = 5
    track_landmarks: int = 1024
    min_lost_points: int = 8
    lost_reinit_after: int = 3
    max_step_translation: float = 3.0
    max_step_rotation: float = 0.5
    max_accel_rotation: float = 0.2
    max_accel_translation: float = 1.0
    max_ba_shift_rotation: float = 0.05
    max_ba_shift_translation: float = 0.5

    # Keyframe policy
    kf_min_gap: int = 3
    kf_max_gap: int = 20
    kf_min_visible_frac: float = 0.6
    # Stats pipeline (see BaseVO._track_landmarks).
    stats_max_lag: int = 2
    stats_hard_lag: int = 0
    stats_deterministic: bool = False

    # Backend
    ba_iters: int = 8
    ba_huber_px: float = 3.0
    ba_trunc_px: float = 10.0
    run_ba: bool = True
    ba_backend: str = "auto"
    photo_ba_level: int = 1
    photo_ba_huber: float = 12.0
    # Distributed window BA over the torch.distributed world (reprojection
    # backend only); mesh_devices 0 = the whole world, the only group.
    distribute_ba: bool = False
    mesh_devices: int = 0

    # Stereo
    max_disparity: int = 128
    min_stereo_depth: float = 0.5
    max_stereo_depth: float = 80.0

    seed: int = 0

    def intrinsics(self):
        return cam_mod.Intrinsics.create(self.fx, self.fy, self.cx, self.cy)


@dataclass
class FrameResult:
    R: torch.Tensor
    t: torch.Tensor
    num_tracked: int = 0
    num_landmarks: int = 0
    is_keyframe: bool = False
    state: str = "init"


class HostFetch:
    """Small tensors on their way to the host (per-frame stats, a
    keyframe's digest).

    On CUDA: non-blocking copies into pinned host memory plus one event
    recorded after them; `done()` polls the event and `result()` waits on
    it (from any thread) before a byte is read. On the CPU the copies are
    immediate.
    """

    def __init__(self, *tensors):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = []
            for x in tensors:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [x.clone() for x in tensors]

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def result(self):
        """Numpy copies, in the order the tensors were given."""
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def commit(dst, src):
    """Write `src` into the storage of `dst` (a tensor, or a tree of them
    shaped alike) in place; a tensor written onto itself is skipped."""
    d_leaves, s_leaves = programs.flatten(dst)[0], programs.flatten(src)[0]
    if len(d_leaves) != len(s_leaves):
        raise ValueError(f"cannot write a tree of {len(s_leaves)} tensors into {len(d_leaves)}")
    for d, x in zip(d_leaves, s_leaves):
        if d.shape != x.shape:
            raise ValueError(f"cannot write {tuple(x.shape)} into state of {tuple(d.shape)}")
        if d.data_ptr() != x.data_ptr():
            d.copy_(x)


class _State:
    """An engine state attribute in storage allocated at its first
    assignment (in `BaseVO.__init__`); every later assignment writes into
    that storage (`commit`)."""

    def __set_name__(self, owner, name):
        self.key = "_state_" + name

    def __get__(self, obj, owner=None):
        return self if obj is None else obj.__dict__[self.key]

    def __set__(self, obj, value):
        if self.key in obj.__dict__:
            commit(obj.__dict__[self.key], value)
        else:
            obj.__dict__[self.key] = value


class BaseVO:
    """Shared machinery of the engines."""

    map = _State()
    R = _State()
    t = _State()
    prev_R = _State()
    prev_t = _State()
    vel_xi = _State()
    _templates = _State()
    _active_idx = _State()

    # How a frame's stats start their way to the host: called with the
    # stats tensor, returns an object with `done()` and `result()` (the
    # reference's injectable `_stats_reader`). A test replaces it to delay
    # when samples land.
    _host_fetch = HostFetch

    def __init__(self, config: VOConfig, device):
        self.cfg = config
        self.device = torch.device(device)
        self.intr = config.intrinsics()
        # The reference holds a jax.random key here: the monocular
        # bootstrap's RANSAC draws come from this generator.
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.map = map_state.empty(
            config.max_keyframes,
            config.max_landmarks,
            (config.height, config.width),
            config.pyramid_levels,
            device=self.device,
        )
        self.frame_idx = -1
        self.last_pyr = None
        self.R = torch.eye(3, dtype=torch.float32, device=self.device)
        self.t = torch.zeros(3, dtype=torch.float32, device=self.device)
        self.prev_R = self.R.clone()
        self.prev_t = self.t.clone()
        # Filtered per-frame velocity twist (EMA over healthy frames).
        self.vel_xi = torch.zeros(6, dtype=torch.float32, device=self.device)
        # The templates' storage, shaped by a build from the empty map.
        templates, active = self._templates_program(self.map, 0)
        self._templates = tuple(type(lvl)(*(x.clone() for x in lvl)) for lvl in templates)
        self._active_idx = active.clone()
        # The window BA's frozen cameras, written before each BA.
        self._cam_fixed = torch.zeros(config.max_keyframes, dtype=torch.bool, device=self.device)
        state = (self.map, self.R, self.t, self.prev_R, self.prev_t, self.vel_xi,
                 self._templates, self._active_idx, self._cam_fixed)
        self._owned = frozenset(x.data_ptr() for x in programs.flatten(state)[0])
        self._kernels: dict[str, programs.Program] = {}
        # Programs keyed by name and static shape (the monocular
        # bootstrap's), and the stream of the captures that are not a
        # program's first call (theirs and `ba_solve`'s).
        self._cache = programs.Cache(self.device)
        self.last_kf_frame = -(10**9)
        self.kf_order: list[int] = []   # slots, oldest first
        self.results: list[FrameResult] = []
        self._pending_stats: list = []
        # Debug overlays (run.py --viz-every): when True, each tracked frame
        # keeps (ok_mask, refined_uv, image, frame index) as device tensors
        # in _last_track; pulling them is the caller's choice and cost.
        self.debug_overlay = False
        self._last_track = None
        if config.distribute_ba:
            self._mesh()   # a group the run cannot use fails here, not at a keyframe

    # -- helpers -------------------------------------------------------
    def _next_kf_slot_peek(self) -> int:
        """Slot for the next keyframe; pops the oldest from kf_order if the
        window is full (the eviction happens in the insertion program)."""
        cfg = self.cfg
        if len(self.kf_order) < cfg.max_keyframes:
            used = set(self.kf_order)
            for s in range(cfg.max_keyframes):
                if s not in used:
                    return s
        return self.kf_order.pop(0)

    def _drain_captures(self):
        """Make the program captures that other threads asked for, on this
        thread, inside an engine call (`programs.Cache.drain`)."""
        self._cache.drain()

    def _post_keyframe(self, slot: int, pyr) -> None:
        """Hook invoked after a keyframe is fully integrated (inserted,
        window-BA-refined, templates rebuilt). SLAM layers add pose-graph
        nodes and loop detection here. Default: no-op."""

    def _recent_motion(self):
        """(speed m/frame, rot rad/frame) medians over the last healthy
        frames (num_tracked at or above the tracking floor), or
        (None, None) with too little history. One stacked pull of their
        poses: call at recovery time, not per frame."""
        healthy = [
            (i, r)
            for i, r in enumerate(self.results)
            if r.num_tracked >= self.cfg.min_tracked_points
        ]
        take = healthy[-12:]
        if len(take) < 5:
            return None, None
        idxs = np.array([i for i, _ in take])
        R, t = _pull_poses([r for _, r in take])
        c = -np.einsum("nji,nj->ni", R, t)
        gaps = np.diff(idxs)
        steps = np.linalg.norm(np.diff(c, axis=0), axis=-1) / gaps
        tr = np.einsum("nii->n", np.einsum("nij,nkj->nik", R[1:], R[:-1]))
        angs = np.arccos(np.clip((tr - 1) / 2, -1, 1)) / gaps
        sp = float(np.median(steps))
        rr = float(np.median(angs))
        return (sp if sp > 1e-6 else None), (rr if rr > 1e-9 else None)

    def _seam_span(self, recovery_frame: int) -> int:
        """Frames of dead reckoning ending at `recovery_frame`: distance
        back to the last healthy frame."""
        upto = min(recovery_frame, len(self.results))
        for i in range(upto - 1, -1, -1):
            if self.results[i].num_tracked >= self.cfg.min_tracked_points:
                return max(1, recovery_frame - i)
        return max(1, recovery_frame)

    def _per_cell(self) -> int:
        cfg = self.cfg
        return max(1, cfg.num_features // (cfg.detect_grid[0] * cfg.detect_grid[1]))

    def _detect(self, pyr):
        cfg = self.cfg
        if cfg.detect_levels > 1:
            return fast.detect_grid_pyramid(
                pyr, threshold=cfg.fast_threshold, grid=cfg.detect_grid,
                per_cell=self._per_cell(), levels=cfg.detect_levels,
            )
        return fast.detect_grid(
            pyr[0], threshold=cfg.fast_threshold, grid=cfg.detect_grid,
            per_cell=self._per_cell(),
        )

    def _clamp_twist(self, xi):
        cfg = self.cfg
        t_norm = torch.linalg.norm(xi[:3])
        r_norm = torch.linalg.norm(xi[3:])
        rho = xi[:3] * torch.clamp(
            cfg.max_step_translation / torch.clamp(t_norm, min=1e-9), max=1.0
        )
        phi = xi[3:] * torch.clamp(
            cfg.max_step_rotation / torch.clamp(r_norm, min=1e-9), max=1.0
        )
        return torch.cat([rho, phi])

    def _program(self, name: str) -> programs.Program:
        """The engine's program `name` (`PROGRAMS`, `DIST_BA_PROGRAMS`),
        captured at its first call on a CUDA engine and replayed after
        (`ba_solve`: at its second, `ShardedSolver.program`)."""
        prog = self._kernels.get(name)
        if prog is None:
            if name == "ba_solve":
                prog = self._sharded_solver().program(self._cache)
            else:
                method = PROGRAMS.get(name) or DIST_BA_PROGRAMS[name]
                prog = programs.Program(getattr(self, method), self.device, self._owned)
            self._kernels[name] = prog
        return prog

    def program_listing(self) -> dict:
        """How each program the engine has run so far runs: "graph" (a CUDA
        graph, replayed), "eager (cpu)" (its static buffers on the CPU), or
        for the sharded solve over gloo "eager (gloo)" (its collectives
        cannot be captured)."""
        mode = "graph" if self.device.type == "cuda" else "eager (cpu)"
        listing = dict.fromkeys(self._kernels, mode)
        listing.update((key[0], mode) for key in self._cache.programs)
        if self.cfg.distribute_ba and getattr(self, "_ba_mesh", None) is not None:
            from viso_tpu_torch.parallel import dist_ba

            if not dist_ba.capturable(self._ba_mesh):
                listing["ba_solve"] = "eager (gloo)"
        return listing

    # -- device programs -----------------------------------------------
    def _track(self, m: map_state.MapState, templates, active, img, R, t, vel_xi):
        """The per-frame program: pyramid + direct + align + refine + gate.

        Returns (R_new, t_new, ok_align (L,), refined (L, 2), stats (2,)
        int32 [n_tracked, num_points], pyr, vel_new)."""
        cfg = self.cfg
        intr = self.intr
        pyr = pyramid.build_pyramid(img.to(torch.float32), cfg.pyramid_levels)

        # Constant-velocity warm start from the filtered velocity twist.
        xi_warm = self._clamp_twist(vel_xi)
        dR, dt = se3.se3_exp(xi_warm)
        R0, t0 = se3.compose(dR, dt, R, t)

        L = m.points.shape[0]
        pts_a = m.points[active]
        mask_a = m.point_mask[active]
        R_d, t_d, _ = direct.estimate_pose_templated(
            templates, pyr, pts_a, intr, R0, t0,
            direct.DirectParams(iters=cfg.direct_iters),
        )
        p_cam = se3.transform(R_d, t_d, pts_a)
        uv_pred, depth = cam_mod.project(p_cam, intr)
        visible = (
            mask_a
            & (depth > 0.1)
            & cam_mod.is_inside(uv_pred, cfg.height, cfg.width, border=8)
        )
        k_idx_a, _ = align.select_reference_keyframes(
            pts_a, m.kf_R, m.kf_t, m.kf_mask, m.obs_mask[:, active]
        )
        has_obs = m.obs_mask[k_idx_a, active]
        uv_ref = m.obs_uv[k_idx_a, active]
        refined_a, _, ok_a = align.align(
            m.kf_pyr, k_idx_a, uv_ref, pyr, uv_pred, visible & has_obs,
            align.AlignParams(iters=cfg.align_iters),
        )
        x_ref = cam_mod.normalize(refined_a, intr)
        R_f, t_f = pnp.refine_pose(
            R_d, t_d, pts_a, x_ref, ok_a.to(torch.float32),
            huber=cfg.ransac_threshold_px / cfg.fx, iters=4,
        )
        n_tracked = torch.sum(ok_a)
        # Acceleration gate: the refined step must stay within max_accel_*
        # of the filtered velocity.
        dRm, dtm = se3.relative(R_f, t_f, R, t)
        xi_meas = self._clamp_twist(se3.se3_log(dRm, dtm))
        dev = xi_meas - vel_xi
        sane = (
            (torch.linalg.norm(dev[3:]) <= cfg.max_accel_rotation)
            & (torch.linalg.norm(dev[:3]) <= cfg.max_accel_translation)
        )
        use_refined = (n_tracked >= cfg.min_tracked_points) & sane
        # Lost: hold the previous pose. Degraded: hold the motion model.
        lost = n_tracked < cfg.min_lost_points
        R_new = torch.where(use_refined, R_f, torch.where(lost, R, R0))
        t_new = torch.where(use_refined, t_f, torch.where(lost, t, t0))
        vel_new = torch.where(use_refined, 0.7 * vel_xi + 0.3 * xi_meas, vel_xi)
        # Scatter back to the full landmark index space.
        ok_align = torch.zeros(L, dtype=torch.bool, device=ok_a.device)
        ok_align[active] = ok_a
        refined = torch.zeros((L, 2), dtype=refined_a.dtype, device=ok_a.device)
        refined[active] = refined_a
        # An acceleration-gate rejection reports a lost frame.
        n_rep = torch.where(sane, n_tracked, 0)
        stats = torch.stack(
            [n_rep.to(torch.int32), m.num_points.to(torch.int32)]
        )
        return R_new, t_new, ok_align, refined, stats, pyr, vel_new

    def _templates_program(self, m: map_state.MapState, slot: int):
        """Active landmark subset (valid first, then those observed in the
        new keyframe) and their frozen templates from keyframe `slot` (an
        int or a 0-d tensor)."""
        cfg = self.cfg
        row = map_state.row
        A = min(cfg.track_landmarks, cfg.max_landmarks)
        priority = (
            m.point_mask.to(torch.int32) * 2
            + (m.point_mask & row(m.obs_mask, slot)).to(torch.int32)
        )
        active = torch.argsort(-priority, stable=True)[:A]
        pts_a = m.points[active]
        mask_a = m.point_mask[active]
        pyr_kf = tuple(row(lvl, slot) for lvl in m.kf_pyr)
        templates = direct.build_templates(
            pyr_kf, row(m.kf_R, slot), row(m.kf_t, slot), pts_a, mask_a, self.intr
        )
        return templates, active

    def _refresh_templates(self, slot: int):
        """(Re)build the frozen tracking templates from keyframe `slot`."""
        self._templates, self._active_idx = self._program("templates")(self.map, slot)

    # What ba_backend="auto" resolves to (MonocularVO: "photometric").
    _default_ba_backend = "reprojection"

    def _ba_backend(self) -> str:
        b = self.cfg.ba_backend
        if b == "auto":
            b = self._default_ba_backend
        if b not in ("reprojection", "photometric"):
            raise ValueError(f"unknown ba_backend {b!r}")
        if self.cfg.distribute_ba:
            if b == "photometric" and self.cfg.ba_backend != "auto":
                raise ValueError("distribute_ba supports only the reprojection backend")
            b = "reprojection"
        return b

    def _mesh(self):
        """The landmark group of the distributed window BA, built once."""
        if getattr(self, "_ba_mesh", None) is None:
            from viso_tpu_torch.parallel import mesh as mesh_mod

            cfg = self.cfg
            mesh = mesh_mod.make_mesh(cfg.mesh_devices or None, device=self.device)
            if mesh.size > 1 and not (cfg.stats_deterministic
                                      or cfg.kf_min_gap == cfg.kf_max_gap):
                raise ValueError(
                    "distribute_ba over several ranks needs the same keyframe "
                    "decisions on every rank: set stats_deterministic or "
                    "kf_min_gap == kf_max_gap"
                )
            self._ba_mesh = mesh
        return self._ba_mesh

    @staticmethod
    def _gate_ba_adoption(m_old, m_new, R_new, t_new, R0, t0, cfg):
        """Adopt the BA result only when its newest-pose shift is sane;
        otherwise keep the pre-BA map and pose."""
        dR, dt = se3.relative(R_new, t_new, R0, t0)
        xi = se3.se3_log(dR, dt)
        sane = (
            (torch.linalg.norm(xi[3:]) <= cfg.max_ba_shift_rotation)
            & (torch.linalg.norm(xi[:3]) <= cfg.max_ba_shift_translation)
        )
        m = map_state.select(sane, m_new, m_old)
        return m, torch.where(sane, R_new, R0), torch.where(sane, t_new, t0)

    def _ba_program(self, m: map_state.MapState, cam_fixed, pose_slot: int, R0, t0):
        """Window BA of the map with the cameras `cam_fixed` frozen, gated
        on the shift of keyframe `pose_slot` (an int or a 0-d tensor) from
        the tracking pose (R0, t0). Returns (map, final cost, R, t)."""
        cfg = self.cfg
        if self._ba_backend() == "photometric":
            prob, intr_l = map_state.as_photo_ba_problem(m, self.intr, level=cfg.photo_ba_level)
            params = ba_photometric.PhotoBAParams(
                iters=cfg.ba_iters, huber=cfg.photo_ba_huber, num_fixed=0
            )
            out, info = ba_photometric.solve_impl(
                prob._replace(cam_fixed=cam_fixed), intr_l, params
            )
        elif cfg.distribute_ba:
            out, info = self._dist_ba_solve(self._ba_prep_program(m, cam_fixed))
        else:
            prob = map_state.as_ba_problem(m, self.intr)._replace(cam_fixed=cam_fixed)
            out, info = ba.solve_impl(prob, self._reprojection_ba_params())
        m_out, R_out, t_out = self._ba_finish_program(m, out.R, out.t, out.points, pose_slot,
                                                      R0, t0)
        return m_out, info["final_cost"], R_out, t_out

    def _reprojection_ba_params(self):
        cfg = self.cfg
        return ba.BAParams(
            iters=cfg.ba_iters,
            huber=cfg.ba_huber_px / cfg.fx,
            trunc=cfg.ba_trunc_px / cfg.fx,
            num_fixed=0,
        )

    def _ba_prep_program(self, m: map_state.MapState, cam_fixed):
        """The distributed window BA's problem: the map's, with the cameras
        `cam_fixed` frozen, its landmarks padded to split evenly over the
        group (the JAX engine's jitted `prep`)."""
        from viso_tpu_torch.parallel import dist_ba

        prob = map_state.as_ba_problem(m, self.intr)._replace(cam_fixed=cam_fixed)
        return dist_ba.pad_landmarks(prob, self._mesh().size)

    def _sharded_solver(self):
        """The landmark-sharded LM over the group (one object per mesh and
        parameters)."""
        from viso_tpu_torch.parallel import dist_ba

        return dist_ba.make_sharded_solver(self._mesh(), self._reprojection_ba_params())

    def _dist_ba_solve(self, prob):
        """The landmark-sharded LM of `prob` over the group: (problem, info)."""
        return self._sharded_solver()(prob)

    def _ba_finish_program(self, m: map_state.MapState, R, t, points, pose_slot: int, R0, t0):
        """The BA's solution written into the map, gated on the shift of
        keyframe `pose_slot` (an int or a 0-d tensor) from the tracking
        pose (R0, t0): (map, R, t). Padding landmarks past the map's are
        dropped (the JAX engine's jitted `finish`)."""
        m_new = map_state.update_from_ba(m, R, t, points[:self.cfg.max_landmarks])
        return self._gate_ba_adoption(
            m, m_new, map_state.row(R, pose_slot), map_state.row(t, pose_slot), R0, t0, self.cfg
        )

    def _run_window_ba(self, fixed_slots):
        self._ba_backend()
        cam_fixed = self._cam_fixed
        cam_fixed.zero_()
        for s in fixed_slots:
            cam_fixed[s].fill_(True)   # no host scalar copy (that syncs)
        if self.cfg.distribute_ba:
            from viso_tpu_torch.parallel import dist_ba

            prob = self._program("ba_prep")(self.map, cam_fixed)
            if dist_ba.capturable(self._mesh()):
                out, info = self._program("ba_solve")(prob)
            else:   # gloo: its collectives cannot be captured
                out, info = self._dist_ba_solve(prob)
            m, R, t = self._program("ba_finish")(self.map, out.R, out.t, out.points,
                                                 self.kf_order[-1], self.R, self.t)
            final_cost = info["final_cost"]
        else:
            m, final_cost, R, t = self._program("ba")(self.map, cam_fixed, self.kf_order[-1],
                                                      self.R, self.t)
        # Carry BA's pose correction onto prev_* so rel(T, prev) -- the
        # constant-velocity estimate -- is unchanged.
        Gi = se3.compose(*se3.inverse(self.R, self.t), R, t)
        self.prev_R, self.prev_t = se3.compose(self.prev_R, self.prev_t, *Gi)
        self.map, self.R, self.t = m, R, t
        return final_cost

    def _stats_hard_lag(self) -> int:
        hard = self.cfg.stats_hard_lag
        if not hard:
            # Fetches land sub-frame on the CPU; on an accelerator let them
            # ride deeper before force-joining.
            if self.device.type == "cpu":
                hard = max(2, self.cfg.stats_max_lag)
            else:
                hard = max(8, 2 * self.cfg.stats_max_lag)
        return hard

    def _track_landmarks(self, img):
        """Run the track program; returns (ok_align (L,), refined_uv (L, 2),
        n_tracked int, pyr). n_tracked comes from the stats pipeline and is
        a few frames stale by design."""
        R_new, t_new, ok_align, refined, stats, pyr, vel_new = self._program("track")(
            self.map, self._templates, self._active_idx, img,
            self.R, self.t, self.vel_xi,
        )
        self.prev_R, self.prev_t = self.R, self.t
        self.R, self.t = R_new, t_new
        self.vel_xi = vel_new
        q = self._pending_stats
        if len(q) < max(1, self.cfg.stats_max_lag):
            q.append((self.frame_idx, self._host_fetch(stats)))
        consumed = None
        if self.cfg.stats_deterministic:
            # Consume each sample at exactly stats_hard_lag frames of age.
            delta = self.cfg.stats_hard_lag or self.cfg.stats_max_lag
            while q and self.frame_idx - q[0][0] >= delta:
                f, fetch = q.pop(0)
                consumed = (f, fetch.result()[0])
        else:
            while q and q[0][1].done():
                f, fetch = q.pop(0)
                consumed = (f, fetch.result()[0])
        if q and self.frame_idx - q[0][0] >= self._stats_hard_lag():
            f, fetch = q.pop(0)
            consumed = (f, fetch.result()[0])
            while q and q[0][1].done():
                f, fetch = q.pop(0)
                consumed = (f, fetch.result()[0])
        if consumed is not None:
            self._stats_frame = consumed[0]
            n_tracked, n_points = (int(v) for v in consumed[1])
            self._n_points_cache = n_points
            self._n_tracked_cache = n_tracked
        # Pipeline still filling: be optimistic.
        n_tracked = getattr(self, "_n_tracked_cache", self.cfg.num_features)
        if self.debug_overlay:
            # Stamped with the frame index so that overlay writers skip
            # data from before a re-init or init frame. The track
            # program's outputs: valid until its next call.
            self._last_track = (ok_align, refined, pyr[0], self.frame_idx)
        return ok_align, refined, n_tracked, pyr

    def close(self):
        """Drop in-flight stats fetches and the engine's programs. Their
        CUDA graphs go here, not whenever the engine's reference cycles are
        collected: NCCL does not destroy a communicator while a graph that
        captured its collectives (`ba_solve`) lives, so a process group
        destroyed after an engine run would wait on it for ever."""
        self._pending_stats = []
        self._kernels = {}

    def _stats_fresh(self) -> bool:
        """True when the last consumed stats sample postdates the newest
        keyframe."""
        return getattr(self, "_stats_frame", -1) > self.last_kf_frame

    def _update_lost(self, n_tracked) -> bool:
        """Advance the lost-tracking counter; True = force recovery now."""
        cfg = self.cfg
        if self._stats_fresh():
            if n_tracked < cfg.min_lost_points:
                self._lost_count = getattr(self, "_lost_count", 0) + 1
            else:
                self._lost_count = 0
        forced = getattr(self, "_lost_count", 0) >= cfg.lost_reinit_after
        if forced:
            self._lost_count = 0
        return forced

    def _should_insert_keyframe(self, n_tracked):
        cfg = self.cfg
        gap = self.frame_idx - self.last_kf_frame
        if gap < cfg.kf_min_gap:
            return False
        if gap >= cfg.kf_max_gap:
            return True
        if not self._stats_fresh():
            return False
        n_landmarks = getattr(self, "_n_points_cache", None)
        if n_landmarks is None:
            n_landmarks = int(self.map.num_points)
        if n_landmarks == 0:
            return True
        return n_tracked < cfg.kf_min_visible_frac * min(
            n_landmarks, self.cfg.num_features
        )

    def trajectory(self):
        """Per-frame world->cam poses as (N, 3, 3) / (N, 3) numpy arrays."""
        return _pull_poses(self.results)

    def _record(self, **kw):
        self.results.append(FrameResult(R=self.R.clone(), t=self.t.clone(), **kw))


class StereoVO(BaseVO):
    """Stereo visual odometry: disparity triangulation + direct/aligned
    tracking + PnP refinement + sliding-window BA."""

    def __init__(self, config: VOConfig, device):
        super().__init__(config, device)
        self.state = "init"

    def to_device(self, img_left, img_right):
        """Upload a stereo pair as uint8 tensors on the engine's device;
        process() accepts the returned pair directly."""
        return _upload(img_left, self.device), _upload(img_right, self.device)

    def process(self, img_left, img_right) -> FrameResult:
        cfg = self.cfg
        self._drain_captures()
        self.frame_idx += 1
        img_left, img_right = self.to_device(img_left, img_right)

        if self.state == "init":
            pyr = pyramid.build_pyramid(img_left.to(torch.float32), cfg.pyramid_levels)
            slot = self._insert_stereo_keyframe(pyr, img_left, img_right)
            self._refresh_templates(slot)
            self._post_keyframe(slot, pyr)
            self.state = "tracking"
            self.last_pyr = pyr
            self.last_kf_frame = self.frame_idx
            self._n_points_cache = int(self.map.num_points)
            self._record(
                num_tracked=0,
                num_landmarks=self._n_points_cache,
                is_keyframe=True,
                state="init",
            )
            return self.results[-1]

        ok_align, refined, n_tracked, pyr = self._track_landmarks(img_left)

        forced_recovery = self._update_lost(n_tracked)
        if forced_recovery:
            # SLAM loop gating treats this keyframe as a re-anchor after
            # dead reckoning: its pose and odometry edge are low-confidence.
            self._last_recovery_frame = self.frame_idx
        is_kf = forced_recovery or self._should_insert_keyframe(n_tracked)
        if is_kf:
            slot = self._insert_stereo_keyframe(
                pyr, img_left, img_right, existing_obs=(ok_align, refined)
            )
            self.last_kf_frame = self.frame_idx
            if cfg.run_ba and len(self.kf_order) >= 2:
                self._run_window_ba(self.kf_order[:1])
            self._refresh_templates(slot)
            # Post-BA hook: SLAM layers see the refined pose and map.
            self._post_keyframe(slot, pyr)

        self.last_pyr = pyr
        self._record(
            num_tracked=n_tracked,
            num_landmarks=getattr(self, "_n_points_cache", 0),
            is_keyframe=is_kf,
            state=self.state,
        )
        return self.results[-1]

    def _stereo_kf_program(self, m, slot: int, do_evict: bool, R, t,
                           frame_id: int, pyr, img_left, img_right,
                           ok_align, refined, have_existing: bool):
        """Keyframe insertion: evict, insert, record tracked observations,
        detect, stereo-match, backproject and allocate new landmarks.
        `slot`, `do_evict`, `frame_id` and `have_existing` are Python
        values or 0-d tensors."""
        cfg = self.cfg
        intr = self.intr
        m = map_state.select(do_evict, map_state.evict_keyframe(m, slot), m)
        img_left = img_left.to(torch.float32)
        img_right = img_right.to(torch.float32)
        m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
        L = m.points.shape[0]
        existing = ok_align & have_existing
        m = map_state.set_observations(
            m, slot, torch.arange(L, device=self.device), refined, existing
        )
        uv, score, det_mask = self._detect(pyr)
        det_mask = det_mask & ~_near_existing(uv, refined, existing, 8.0)
        disp, _, ok_d = stereo.match(
            img_left, img_right, uv, det_mask,
            stereo.StereoParams(max_disparity=cfg.max_disparity),
        )
        depth = stereo.disparity_to_depth(disp, cfg.fx, cfg.baseline, ok_d)
        good = (
            ok_d
            & (depth > cfg.min_stereo_depth)
            & (depth < cfg.max_stereo_depth)
        )
        budget = torch.clamp(cfg.num_features - torch.sum(existing), min=0)
        good = _top_m_by_score(good, score, budget)
        p_cam = cam_mod.backproject(uv, depth, intr)
        R_inv, t_inv = se3.inverse(R, t)
        p_world = se3.transform(R_inv, t_inv, p_cam)
        m, slots, ok_alloc = map_state.allocate_landmarks(m, p_world, good)
        return map_state.set_observations(m, slot, slots, uv, ok_alloc)

    def _insert_stereo_keyframe(self, pyr, img_left, img_right, existing_obs=None) -> int:
        cfg = self.cfg
        evict = len(self.kf_order) >= cfg.max_keyframes
        slot = self._next_kf_slot_peek()
        self.kf_order.append(slot)
        if existing_obs is not None:
            ok_align, refined = existing_obs
        else:
            ok_align = torch.zeros(cfg.max_landmarks, dtype=torch.bool, device=self.device)
            refined = torch.zeros((cfg.max_landmarks, 2), dtype=torch.float32,
                                  device=self.device)
        self.map = self._program("stereo_kf")(
            self.map, slot, evict, self.R, self.t, self.frame_idx, pyr,
            img_left, img_right, ok_align, refined, existing_obs is not None,
        )
        return slot


class MonocularVO(BaseVO):
    """Monocular VO: chained-LK two-view bootstrap, then direct/aligned
    tracking, keyframes with LK-tracked triangulation and photometric
    window BA (by default).

    After `lost_reinit_after` consecutive fresh lost samples the engine
    re-initializes: a new two-view bootstrap anchored at the current pose,
    its scale tied to the dying segment by a depth-continuity and a
    speed-continuity prior (`blend_recovery_scale`), with constant-
    velocity dead reckoning through the blackout. Monocular scale is not
    observable across a re-init; within a segment the two frozen gauge
    cameras of the window BA hold it.
    """

    _default_ba_backend = "photometric"

    def __init__(self, config: VOConfig, device):
        super().__init__(config, device)
        self.state = "init"
        # (ref_pyr, ref_kps, chained_cur_kps, mask, ref_frame_idx)
        self.init_ref = None
        # World->cam pose of the init segment's reference camera.
        self.init_base = (self.R.clone(), self.t.clone())
        self.num_reinits = 0

    def to_device(self, img):
        """Upload a frame as a uint8 tensor on the engine's device."""
        return _upload(img, self.device)

    def process(self, img) -> FrameResult:
        cfg = self.cfg
        self._drain_captures()
        self.frame_idx += 1
        img = self.to_device(img)

        if self.state == "init":
            # Op by op, as the reference builds it outside its programs.
            pyr = pyramid.build_pyramid(img.to(torch.float32), cfg.pyramid_levels)
            self._dead_reckon()
            self._try_initialize(pyr)
        else:
            ok_align, refined, n_tracked, pyr = self._track_landmarks(img)
            if self._update_lost(n_tracked):
                # The new segment keeps this pyramid past the track
                # program's next call: its own copy.
                pyr = tuple(lvl.clone() for lvl in pyr)
                self._reinitialize(pyr)
                self._record(num_tracked=n_tracked, num_landmarks=0,
                             is_keyframe=False, state="init")
                self.last_pyr = pyr
                return self.results[-1]
            is_kf = self._should_insert_keyframe(n_tracked)
            if is_kf:
                self._insert_mono_keyframe(pyr, ok_align, refined)
                self.last_kf_frame = self.frame_idx
                if cfg.run_ba and len(self.kf_order) >= 2:
                    # Two frozen gauge cameras; moves self.R / self.t to
                    # the adjusted newest-keyframe pose.
                    self._run_window_ba(self.kf_order[:2])
                self._refresh_templates(self.kf_order[-1])
                self._post_keyframe(self.kf_order[-1], pyr)
            self.last_pyr = pyr
            self._record(
                num_tracked=n_tracked,
                num_landmarks=getattr(self, "_n_points_cache", 0),
                is_keyframe=is_kf,
                state=self.state,
            )
            return self.results[-1]

        self.last_pyr = pyr
        self._record(
            num_tracked=0,
            num_landmarks=int(self.map.num_points),   # a host read, as the reference's
            is_keyframe=self.state == "tracking",
            state="init",
        )
        return self.results[-1]

    def _next_kf_slot(self) -> int:
        """A free slot, or the oldest one evicted from the map."""
        evict = len(self.kf_order) >= self.cfg.max_keyframes
        slot = self._next_kf_slot_peek()
        if evict:
            self.map = map_state.evict_keyframe(self.map, slot)
        return slot

    def _reinitialize(self, pyr):
        """Drop the map and bootstrap a new segment at the current pose."""
        cfg = self.cfg
        self._last_track = None   # overlay data of the old segment is stale
        # Scale priors for the new segment (see _try_initialize): the
        # camera's speed and the visible scene's depth are continuous
        # through a short loss.
        self._scale_prior = self._recent_speed()
        self._depth_prior = self._map_median_depth()
        # Constant-velocity dead reckoning through the blackout: the
        # pre-loss increment on the device, copied once without waiting for
        # it (`_dead_reckon` applies it at every frame of the blackout).
        dr = self._recent_fwd()
        self._dr_fwd = None if dr is None else tuple(
            x.to(self.device, non_blocking=True) for x in programs.host_tensors(dr, self.device))
        self.map = map_state.empty(
            cfg.max_keyframes, cfg.max_landmarks, (cfg.height, cfg.width),
            cfg.pyramid_levels, device=self.device,
        )
        self.kf_order = []
        self.state = "init"
        self.init_base = (self.R.clone(), self.t.clone())
        self.prev_R, self.prev_t = self.R, self.t   # zero velocity
        # Velocity filter: carry the pre-loss per-frame increment when one
        # exists (it also drives _dead_reckon), else reset.
        if self._dr_fwd is not None:
            self.vel_xi = se3.se3_log(*self._dr_fwd)
        else:
            self.vel_xi = torch.zeros(6, dtype=torch.float32, device=self.device)
        self.init_ref = None
        self.num_reinits += 1
        # SLAM layers treat the post-reinit odometry edge as dead reckoning.
        self._last_recovery_frame = self.frame_idx
        self._try_initialize(pyr)

    def _recent_speed(self):
        """Median per-frame camera-centre speed (m/frame) over the last
        healthy frames (`BaseVO._recent_motion`), or None."""
        return self._recent_motion()[0]

    def _map_median_depth(self):
        """Median camera-frame depth of the map's valid landmarks, or None
        if the map is empty or degenerate. One host read; re-init only.
        The median is `nanquantile(., 0.5)`, as `jnp.nanmedian` (the mean
        of the two middle values)."""
        m = self.map
        p_cam = se3.transform(self.R, self.t, m.points)
        z = torch.where(m.point_mask, p_cam[:, 2], float("nan"))
        med = float(torch.nanquantile(z, 0.5))
        if not np.isfinite(med) or med <= 1e-6:
            return None
        return med

    def _recent_fwd(self):
        """Pre-loss per-frame forward increment T_fwd = T_k o T_{k-1}^-1
        (world->cam) from the recorded healthy poses: componentwise-median
        translation over the last adjacent healthy pairs, rotation from the
        newest pair. None with too little history or when the increment
        fails the motion-model clamps. One stacked host pull."""
        healthy = [
            (i, r) for i, r in enumerate(self.results)
            if r.num_tracked >= self.cfg.min_tracked_points
        ]
        h = healthy[-9:]
        pairs = [(a[1], b[1]) for a, b in zip(h, h[1:]) if b[0] - a[0] == 1]
        if not pairs:
            return None
        R, t = _pull_poses([r for p in pairs for r in p])
        Ra, ta = R[0::2], t[0::2]
        Rb, tb = R[1::2], t[1::2]
        R_f = np.einsum("nij,nkj->nik", Rb, Ra)        # Rb @ Ra^T
        t_f = tb - np.einsum("nij,nj->ni", R_f, ta)
        t_med = np.median(t_f, axis=0).astype(np.float32)
        R_last = R_f[-1].astype(np.float32)
        if not (np.all(np.isfinite(t_med)) and np.all(np.isfinite(R_last))):
            return None
        ang = np.arccos(np.clip((np.trace(R_last) - 1) / 2, -1, 1))
        if (np.linalg.norm(t_med) > self.cfg.max_step_translation
                or ang > self.cfg.max_step_rotation):
            return None
        return R_last, t_med

    def _dead_reckon(self):
        """Advance the pose by the pre-loss increment during a post-re-init
        blackout (no-op otherwise); no host read."""
        dr = getattr(self, "_dr_fwd", None)
        if dr is None or self.num_reinits == 0:
            return
        R_f, t_f = dr
        self.R = R_f @ self.R
        self.t = R_f @ self.t + t_f

    def _try_initialize(self, pyr):
        """Two-view bootstrap with chained correspondence tracking.

        Init features are tracked frame to frame from the reference while
        the ref<->current correspondence set spans the accumulated
        baseline. The chain reseeds when it dies (fewer than
        min_init_tracks tracks) and otherwise at 4x reinitialize_after.
        The gates are read on the host, as the reference reads them: the
        track count, then the two-view gates. The chain's LK and the two-view
        initialization run as programs of `self._cache` (`init_track`, the
        segments of `ops/twoview.py`); the detection of a reseed runs op by
        op, as in the reference. A tracked chain's keypoints and mask are
        `init_track`'s outputs, read by its next call.
        """
        cfg = self.cfg
        ir = self.init_ref
        reseed = ir is None or (self.frame_idx - ir[4]) >= 4 * cfg.reinitialize_after
        if not reseed:
            ref_pyr, ref_kps, cur_kps, mask, ref_idx = ir
            kp2, ok, n_tracks, x1, x2 = self._cache.run(
                "init_track", self._init_track_program, {}, self.last_pyr, pyr, cur_kps, mask,
                ref_kps, counted=True)
            n_tracks = int(n_tracks)
            if n_tracks < cfg.min_init_tracks:
                reseed = True
            else:
                self.init_ref = (ref_pyr, ref_kps, kp2, ok, ref_idx)
        if reseed:
            uv, _, mask = self._detect(pyr)
            self.init_ref = (pyr, uv, uv, mask, self.frame_idx)
            # Anchor the segment at the reference frame's current pose.
            self.init_base = (self.R.clone(), self.t.clone())
            return

        params = twoview.TwoViewParams(
            focal=cfg.fx,
            projection_error_thresh=cfg.init_projection_error_px,
            parallax_thresh_deg=cfg.init_parallax_deg,
            disparity_squared_thresh=cfg.disparity_squared_thresh,
        )
        res = twoview.initialize(self.generator, x1, x2, ok, params, run=self._cache.run)
        disp_ok, n_inl, med_par = torch.stack([
            res.disparity_ok.to(torch.float32), res.num_inliers.to(torch.float32),
            res.median_parallax_deg,
        ]).tolist()
        if not disp_ok:
            return
        # Rotation-compensated baseline gate, relaxing with init age down
        # to 1/6 of the configured parallax.
        age = max(self.frame_idx - ref_idx, 1)
        eff_par = cfg.init_min_parallax_deg * min(1.0, cfg.reinitialize_after / age)
        eff_par = max(eff_par, cfg.init_min_parallax_deg / 6.0)
        if med_par < eff_par:
            return
        n_inl = int(n_inl)
        # The inlier-ratio gate relaxes with age too (chained LK drifts),
        # floored at 0.6; the absolute count still applies.
        ratio_eff = max(0.6, cfg.min_init_inlier_ratio * min(1.0, cfg.reinitialize_after / age))
        if n_inl < cfg.min_init_tracks or n_inl < ratio_eff * n_tracks:
            return
        # Accept: promote both frames to keyframes. Two-view works in the
        # reference camera's frame; compose with the segment base pose.
        speed_prior = getattr(self, "_scale_prior", None)
        depth_prior = getattr(self, "_depth_prior", None)
        if self.num_reinits > 0 and (depth_prior is not None or speed_prior is not None):
            # Depth continuity (robust to the two-view ratio error, wrong
            # across occlusions) cross-checked with speed continuity.
            s_d = None
            if depth_prior is not None:
                z = res.points[:, 2].cpu().numpy()
                inl_np = res.inliers.cpu().numpy()
                med_boot = float(np.median(z[inl_np])) if inl_np.any() else 0.0
                if med_boot > 1e-9:
                    s_d = depth_prior / med_boot
            s_s = None
            if speed_prior is not None:
                gap = max(1, self.frame_idx - ref_idx)
                meas = float(np.linalg.norm(res.t.cpu().numpy()))
                if meas > 1e-9:
                    s_s = speed_prior * gap / meas
            s = blend_recovery_scale(s_d, s_s)
            if s is not None:
                res = res._replace(t=res.t * s, points=res.points * s)
            self._scale_prior = None
            self._depth_prior = None
        Rb, tb = self.init_base
        R1, t1 = se3.compose(res.R, res.t, Rb, tb)
        points_w = se3.transform(*se3.inverse(Rb, tb), res.points)
        slot0 = self._next_kf_slot()
        self.map = map_state.insert_keyframe(self.map, slot0, Rb, tb, ref_idx, ref_pyr)
        self.kf_order.append(slot0)
        slot1 = self._next_kf_slot()
        self.map = map_state.insert_keyframe(self.map, slot1, R1, t1, self.frame_idx, pyr)
        self.kf_order.append(slot1)
        self.map, slots, ok_alloc = map_state.allocate_landmarks(self.map, points_w, res.inliers)
        self.map = map_state.set_observations(self.map, slot0, slots, ref_kps, ok_alloc)
        self.map = map_state.set_observations(self.map, slot1, slots, kp2, ok_alloc)
        self.R, self.t = R1, t1
        self.prev_R, self.prev_t = Rb, tb
        # Velocity seed: the bootstrap spans `gap` chained frames.
        gap_f = float(max(1, self.frame_idx - ref_idx))
        self.vel_xi = se3.se3_log(*se3.relative(R1, t1, Rb, tb)) / gap_f
        self.last_kf_frame = self.frame_idx
        self._refresh_templates(slot1)
        self.state = "tracking"
        self._post_keyframe(slot1, pyr)

    def _init_track_program(self, pyr_prev, pyr, kps, mask, ref_kps):
        """The init chain's step: LK from the previous frame, the tracks'
        count and both ends' normalized coordinates. Returns (kps (N, 2),
        ok (N,), n_tracks, x1 (N, 2) of `ref_kps`, x2 (N, 2))."""
        kp2, _, ok = lk.track(pyr_prev, pyr, kps, mask)
        return (kp2, ok, torch.sum(ok), cam_mod.normalize(ref_kps, self.intr),
                cam_mod.normalize(kp2, self.intr))

    def _mono_kf_program(self, m, slot: int, do_evict: bool, prev_slot: int, R, t,
                         frame_id: int, pyr, ok_align, refined):
        """Keyframe insertion: evict, insert with the tracked observations,
        FAST in the previous keyframe, LK to the new frame, two-view
        triangulation with reprojection and parallax gates, far points for
        low-parallax tracks, landmark allocation. `slot`, `do_evict`,
        `prev_slot` and `frame_id` are Python values or 0-d tensors."""
        cfg = self.cfg
        intr = self.intr
        row = map_state.row
        m = map_state.select(do_evict, map_state.evict_keyframe(m, slot), m)
        prev_R = row(m.kf_R, prev_slot)
        prev_t = row(m.kf_t, prev_slot)
        prev_pyr = tuple(row(lvl, prev_slot) for lvl in m.kf_pyr)
        m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
        L = m.points.shape[0]
        m = map_state.set_observations(
            m, slot, torch.arange(L, device=self.device), refined, ok_align
        )
        # New landmarks: detect in the previous keyframe, LK-track to the
        # current frame, triangulate with the two keyframe poses.
        uv_prev, _, det_mask = self._detect(prev_pyr)
        det_mask = det_mask & ~_near_existing(
            uv_prev, row(m.obs_uv, prev_slot), row(m.obs_mask, prev_slot), 8.0
        )
        uv_cur, _, ok_trk = lk.track(prev_pyr, pyr, uv_prev, det_mask)
        x1 = cam_mod.normalize(uv_prev, intr)
        x2 = cam_mod.normalize(uv_cur, intr)
        pts, d1, d2 = triangulation.triangulate(x1, x2, prev_R, prev_t, R, t)
        e1 = triangulation.reprojection_error(pts, x1, prev_R, prev_t)
        e2 = triangulation.reprojection_error(pts, x2, R, t)
        # Below the parallax floor depth is unobservable: such tracks
        # become far points instead.
        cosang = triangulation.parallax_cos(pts, prev_R, prev_t, R, t)
        enough_parallax = cosang < float(
            np.cos(np.deg2rad(np.float32(cfg.min_triangulation_parallax_deg)))
        )
        good = (
            ok_trk
            & (d1 > 0.05)
            & (d2 > 0.05)
            & enough_parallax
            & (e1 * cfg.fx < cfg.ransac_threshold_px)
            & (e2 * cfg.fx < cfg.ransac_threshold_px)
        )
        # Far points: twice the 90th-percentile well-triangulated depth
        # along the previous keyframe's ray, or 4x the map's median depth
        # when this keyframe triangulated nothing.
        nan = float("nan")
        d_far = 2.0 * torch.nanquantile(torch.where(good, d1, nan), 0.9)
        p_prev_cam = torch.einsum("ij,nj->ni", prev_R, m.points) + prev_t
        d_map = torch.nanquantile(torch.where(m.point_mask, p_prev_cam[:, 2], nan), 0.5)
        d_far = torch.where(torch.isfinite(d_far), d_far, 4.0 * d_map)
        prev_c = -prev_R.T @ prev_t
        rays_w = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1) @ prev_R
        pts_far = prev_c[None, :] + d_far * rays_w
        e2_far = triangulation.reprojection_error(pts_far, x2, R, t)
        far_ok = (
            ok_trk
            & ~enough_parallax
            & torch.isfinite(d_far)
            & (e2_far * cfg.fx < cfg.ransac_threshold_px)
        )
        pts = torch.where(enough_parallax[:, None], pts, pts_far)
        m, slots, ok_alloc = map_state.allocate_landmarks(m, pts, good | far_ok)
        m = map_state.set_observations(m, prev_slot, slots, uv_prev, ok_alloc)
        return map_state.set_observations(m, slot, slots, uv_cur, ok_alloc)

    def _insert_mono_keyframe(self, pyr, ok_align, refined):
        cfg = self.cfg
        prev_slot = self.kf_order[-1]
        evict = len(self.kf_order) >= cfg.max_keyframes
        slot = self._next_kf_slot_peek()
        self.kf_order.append(slot)
        self.map = self._program("mono_kf")(
            self.map, slot, evict, prev_slot, self.R, self.t, self.frame_idx, pyr,
            ok_align, refined,
        )


def blend_recovery_scale(s_d, s_s, agree=2.5, lo=0.05, hi=20.0):
    """Cross-check the two recovery scale anchors of a re-init.

    s_d: depth-continuity estimate (robust to the two-view ratio error,
    wrong across occlusions); s_s: speed-continuity estimate (holds
    through occlusions, carries the ratio error). Agreement within
    `agree`x picks depth, disagreement speed; either may be None.
    Returns a clipped float or None."""
    if s_d is not None and s_s is not None:
        ratio = s_d / s_s
        s = s_d if 1.0 / agree < ratio < agree else s_s
    else:
        s = s_d if s_d is not None else s_s
    if s is None:
        return None
    return float(np.clip(s, lo, hi))


def _upload(im, device):
    """An image as a uint8 tensor on `device` (a tensor is only moved)."""
    if isinstance(im, torch.Tensor):
        return im.to(device)
    a = np.asarray(im)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pull_poses(results):
    """Stack per-frame (R, t) tensors and pull them to the host at once."""
    if not results:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32)
    R = torch.stack([r.R for r in results]).cpu().numpy()
    t = torch.stack([r.t for r in results]).cpu().numpy()
    return R.astype(np.float32), t.astype(np.float32)


def _top_m_by_score(good, score, m):
    """Keep at most `m` True entries of `good`, highest `score` first
    (stable ranks, as jnp.argsort's)."""
    s = torch.where(good, score, float("-inf"))
    rank = torch.argsort(torch.argsort(-s, stable=True), stable=True)
    return good & (rank < m)


def _near_existing(uv, existing_uv, existing_mask, radius=8.0):
    """Mask of `uv` entries within `radius` px of any valid existing point."""
    d = torch.linalg.norm(uv[:, None, :] - existing_uv[None, :, :], dim=-1)
    d = torch.where(existing_mask[None, :], d, float("inf"))
    return torch.amin(d, dim=-1) < radius
