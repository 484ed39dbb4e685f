"""Visual-odometry engines: the per-frame state machine (port of
`viso_tpu/slam/engine.py`: `VOConfig`, `FrameResult`, `BaseVO`,
`StereoVO`).

Frame-rate decisions (keyframe policy, lost tracking) are host-side
Python on per-frame scalars; every per-feature / per-pixel computation
is tensor code on the engine's device, in four programs:

  * track (every frame): pyramid, direct GN against frozen keyframe
    templates, 2-level LK alignment, 4-step PnP refine, acceleration gate;
  * stereo_kf (every keyframe): evict, multi-level FAST, stereo match,
    backproject, allocate landmarks;
  * ba (every keyframe): reprojection LM with the adoption gate;
  * templates (every keyframe): frozen tracking templates.

The per-frame path is branchless on device values: nothing in `track`
reads a device scalar on the host. Per-frame stats reach the host
through a non-blocking copy into pinned memory, consumed a fixed or
opportunistic number of frames later (`stats_max_lag`,
`stats_hard_lag`, `stats_deterministic`, as in the reference). All
shapes are static across frames.

`BaseVO._post_keyframe` is the keyframe hook of the SLAM layer
(`slam/full.py`); here it is a no-op. Not ported yet (see ROADMAP.md):
`MonocularVO`, the photometric BA backend and distributed BA; the last
two raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from viso_tpu_torch.backend import ba
from viso_tpu_torch.geometry import camera as cam_mod
from viso_tpu_torch.geometry import se3
from viso_tpu_torch.mapping import map_state
from viso_tpu_torch.ops import align, direct, fast, pnp, pyramid, stereo


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


class BaseVO:
    """Shared machinery of the engines."""

    def __init__(self, config: VOConfig, device):
        self.cfg = config
        self.device = torch.device(device)
        self.intr = config.intrinsics()
        # The reference holds a jax.random key here; the stereo path draws
        # no random numbers, so this generator is unused until mono lands.
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
        self.prev_R = self.R
        self.prev_t = self.t
        # Filtered per-frame velocity twist (EMA over healthy frames).
        self.vel_xi = torch.zeros(6, dtype=torch.float32, device=self.device)
        self.last_kf_frame = -(10**9)
        self.kf_order: list[int] = []   # slots, oldest first
        self.results: list[FrameResult] = []
        self._pending_stats: list = []

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
        new keyframe) and their frozen templates from keyframe `slot`."""
        cfg = self.cfg
        A = min(cfg.track_landmarks, cfg.max_landmarks)
        priority = (
            m.point_mask.to(torch.int32) * 2
            + (m.point_mask & m.obs_mask[slot]).to(torch.int32)
        )
        active = torch.argsort(-priority, stable=True)[:A]
        pts_a = m.points[active]
        mask_a = m.point_mask[active]
        pyr_kf = tuple(lvl[slot] for lvl in m.kf_pyr)
        templates = direct.build_templates(
            pyr_kf, m.kf_R[slot], m.kf_t[slot], pts_a, mask_a, self.intr
        )
        return templates, active

    def _refresh_templates(self, slot: int):
        """(Re)build the frozen tracking templates from keyframe `slot`."""
        self._templates, self._active_idx = self._templates_program(self.map, slot)

    def _ba_backend(self) -> str:
        b = self.cfg.ba_backend
        if b == "auto":   # the stereo engine's default backend
            b = "reprojection"
        if self.cfg.distribute_ba:
            raise NotImplementedError(
                "distribute_ba is not ported yet (ROADMAP.md Queue 1, "
                "'Distributed BA')"
            )
        if b == "photometric":
            raise NotImplementedError(
                "the photometric BA backend is not ported yet (ROADMAP.md "
                "Queue 1, 'Photometric BA')"
            )
        if b != "reprojection":
            raise ValueError(f"unknown ba_backend {b!r}")
        return b

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
        cfg = self.cfg
        params = ba.BAParams(
            iters=cfg.ba_iters,
            huber=cfg.ba_huber_px / cfg.fx,
            trunc=cfg.ba_trunc_px / cfg.fx,
            num_fixed=0,
        )
        prob = map_state.as_ba_problem(m, self.intr)._replace(cam_fixed=cam_fixed)
        out, info = ba.solve_impl(prob, params)
        m_new = map_state.update_from_ba(m, out.R, out.t, out.points)
        m_out, R_out, t_out = self._gate_ba_adoption(
            m, m_new, out.R[pose_slot], out.t[pose_slot], R0, t0, cfg
        )
        return m_out, info["final_cost"], R_out, t_out

    def _run_window_ba(self, fixed_slots):
        self._ba_backend()
        cam_fixed = torch.zeros(self.cfg.max_keyframes, dtype=torch.bool,
                                device=self.device)
        for s in fixed_slots:
            cam_fixed[s].fill_(True)   # no host scalar copy (that syncs)
        slot = self.kf_order[-1]
        R0, t0 = self.R, self.t
        self.map, final_cost, self.R, self.t = self._ba_program(
            self.map, cam_fixed, slot, R0, t0
        )
        # Carry BA's pose correction onto prev_* so rel(T, prev) -- the
        # constant-velocity estimate -- is unchanged.
        Gi = se3.compose(*se3.inverse(R0, t0), self.R, self.t)
        self.prev_R, self.prev_t = se3.compose(self.prev_R, self.prev_t, *Gi)
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
        R_new, t_new, ok_align, refined, stats, pyr, vel_new = self._track(
            self.map, self._templates, self._active_idx, img,
            self.R, self.t, self.vel_xi,
        )
        self.prev_R, self.prev_t = self.R, self.t
        self.R, self.t = R_new, t_new
        self.vel_xi = vel_new
        q = self._pending_stats
        if len(q) < max(1, self.cfg.stats_max_lag):
            q.append((self.frame_idx, HostFetch(stats)))
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
        return ok_align, refined, n_tracked, pyr

    def close(self):
        """Drop in-flight stats fetches."""
        self._pending_stats = []

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
        self.results.append(FrameResult(R=self.R, t=self.t, **kw))


class StereoVO(BaseVO):
    """Stereo visual odometry: disparity triangulation + direct/aligned
    tracking + PnP refinement + sliding-window BA."""

    def __init__(self, config: VOConfig, device):
        super().__init__(config, device)
        self.state = "init"

    def to_device(self, img_left, img_right):
        """Upload a stereo pair as uint8 tensors on the engine's device;
        process() accepts the returned pair directly."""
        def conv(im):
            if isinstance(im, torch.Tensor):
                return im.to(self.device)
            a = np.asarray(im)
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return conv(img_left), conv(img_right)

    def process(self, img_left, img_right) -> FrameResult:
        cfg = self.cfg
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
        detect, stereo-match, backproject and allocate new landmarks."""
        cfg = self.cfg
        intr = self.intr
        if do_evict:
            m = map_state.evict_keyframe(m, slot)
        img_left = img_left.to(torch.float32)
        img_right = img_right.to(torch.float32)
        m = map_state.insert_keyframe(m, slot, R, t, frame_id, pyr)
        L = m.points.shape[0]
        existing = ok_align if have_existing else torch.zeros_like(ok_align)
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
        self.map = self._stereo_kf_program(
            self.map, slot, evict, self.R, self.t, self.frame_idx, pyr,
            img_left, img_right, ok_align, refined, existing_obs is not None,
        )
        return slot


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
