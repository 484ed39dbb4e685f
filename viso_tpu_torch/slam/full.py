"""Full stereo SLAM: VO + loop closure + pose-graph correction (port of
`viso_tpu/slam/full.py`).

Loosely coupled, as in the JAX package: the VO front end runs
uncorrected, its map, pose, templates and motion model are never touched
by the pose graph. Every keyframe adds a node (raw odometry pose) and a
sequential edge; verified loop candidates add loop edges; the solved node
poses exist only in the output (`trajectory()` re-anchors every frame
onto its node's solved pose, `graph_trajectory()` returns the solved
keyframe path).

The keyframe hook runs on one background worker thread. The dispatch
thread only computes the keyframe's digest (loop keypoints, their
descriptors and landmarks: one program on the device), starts
non-blocking copies of what the worker reads on the host into
pinned memory, records a CUDA event after them and enqueues. The worker
waits on that event before it reads a byte: a non-blocking copy has not
landed when `.to("cpu", non_blocking=True)` returns. On a CUDA engine the
worker's device work runs on a stream of its own, made to wait on the
same event, so that it never lands on a stream the dispatch thread is
capturing a program from (`slam/programs.py`). Node ids are
assigned at enqueue time, so frame -> node anchoring stays exact;
`trajectory()` / `graph_trajectory()` join the worker first.

Worker failures are recorded in `hook_errors`, not raised (a failed hook
leaves a placeholder node so later ids stay dense), as the JAX package
does; callers that must not pass over a failure check `hook_errors`.

The loop layer's device work runs as programs of its own cache
(`slam/programs.Cache`, keyed by name and static shape like the JAX jit
cache): the digest (on the dispatch thread), loop detection's segments
and the pose-graph solve of each power-of-two bucket (on the worker,
replayed on the worker's stream). On a CUDA engine each is a CUDA graph
from its second call on; on the CPU each runs eagerly through the same
static buffers. The dispatch thread makes every capture, inside an
engine call: the digest's at its second call, the worker's programs'
when `process()`, `join()` or `trajectory()` drains what the worker
asked for (the worker runs a program eagerly until its graph is in
place). A caller may synchronise the device between engine calls.

Over several ranks (`distribute_ba` with `stats_deterministic`, or a
pinned keyframe cadence) every rank runs the whole engine on the same
frames, its loop layer included: SPMD, with the window BA's collectives
the only traffic. The raw VO is equal across ranks bit for bit (poses,
keyframes, map): each rank makes the same decisions on the same values,
and every all-reduce hands each rank the same sums. The nodes, the
database and each loop detection follow from the raw poses and the map
(and the database's generator, seeded alike), and the throttle counts
node ids, so every rank solves the same graphs at the same nodes. The
solved node poses, and so `trajectory()`, agree only within a tolerance
on CUDA: the pose-graph LM accumulates with atomics
(`backend/pose_graph.py`), whose order differs from run to run
(chip_smoke.py phase 10(e) measures the ranks' spread).

`LoopLayer` holds what stereo and monocular SLAM (`slam/mono_full.py`)
share: the node and edge bookkeeping, the hook's two sides, the throttle,
the solve-health gate with its rollback and the node-anchored
trajectory. The JAX package writes it out in both classes; here a
subclass says only how its nodes and edges look (SE(3) here, Sim(3) for
mono), how it detects a loop and how it solves. A stereo node's scale is
1 throughout.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import sys

import numpy as np
import torch

from viso_tpu_torch.backend import pose_graph
from viso_tpu_torch.mapping import map_state
from viso_tpu_torch.ops import descriptors
from viso_tpu_torch.slam import programs
from viso_tpu_torch.slam.engine import HostFetch, StereoVO, VOConfig, _pull_poses
from viso_tpu_torch.slam.loop_closure import LoopDatabase, LoopParams


# How often join() looks for the worker's capture requests while it waits.
JOIN_POLL_S = 0.005


def _rel_np(Ra, ta, Rb, tb):
    """T_a o T_b^-1 in numpy (host-side pose bookkeeping)."""
    R = Ra @ Rb.T
    t = ta - R @ tb
    return R, t


def make_digest_kernel(num_features: int):
    """The keyframe digest: the loop layer's keypoint set (observed
    landmarks first, ascending slot order) and its steered BRIEF
    descriptors from the keyframe image. A function of tensor ops (K1
    copies the descriptor windows on CUDA), not a kernel of its own;
    `slot` is an int or a 0-d tensor."""
    NF = num_features

    def digest(m, slot: int, img0):
        obs = map_state.row(m.obs_mask, slot)
        order = torch.argsort(-obs.to(torch.int32), stable=True)[:NF]
        kp_mask = obs[order]
        kps = map_state.row(m.obs_uv, slot)[order]
        pts = m.points[order]
        desc = descriptors.compute(img0, kps, kp_mask)
        return kps, kp_mask, desc, pts

    return digest


class LoopLayer:
    """The SLAM loop layer of an engine (a mixin before the VO class).

    Subclasses set `_thread_name` and define `_odometry_edge` (the
    sequential edge and the new node's estimate), `_detect_loop`,
    `_loop_edge` and `_solve`; for nodes with a scale also
    `_node_scales`, `_add_estimate`, `_store_solution` and
    `_solve_health`."""

    def _init_loop_layer(self, loop_params: LoopParams | None):
        self.loop_params = loop_params or LoopParams()
        # The loop layer's programs; the engine state and the database's
        # tensors are read where they lie.
        self._loop_programs = programs.Cache(self.device, self._owned)
        self.loop_db = LoopDatabase(self.loop_params, seed=self.cfg.seed + 1,
                                    device=self.device, programs=self._loop_programs)
        self._digest = make_digest_kernel(self.loop_params.num_features)
        # Pose graph over all keyframes. pg_raw_*: immutable odometry
        # poses at node creation (the frame every edge is measured in).
        # pg_R / pg_t: current best global estimates (solver init and
        # output).
        self.pg_raw_R: list[np.ndarray] = []
        self.pg_raw_t: list[np.ndarray] = []
        self.pg_R: list[np.ndarray] = []
        self.pg_t: list[np.ndarray] = []
        self.pg_frame: list[int] = []
        self.pg_edges: list[tuple] = []
        self.loops: list[dict] = []
        # Per-frame anchor node.
        self._anchors: list[int] = []
        # Odometry arc-length integrals (m, rad): the loop gate's clock.
        self._path_len = 0.0
        self._rot_len = 0.0
        # Dead-reckoning seam allowances (m, rad), budgeted by the loop
        # gate at full magnitude.
        self._seam_trans = 0.0
        self._seam_rot = 0.0
        self._seam_recovery_seen = -(10**9)
        # One worker: enqueue order == execution order, so node ids
        # assigned at enqueue keep frame anchoring exact.
        self._hook_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=self._thread_name
        )
        self._hook_last = None
        self._loop_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._next_node = 0
        # Loop edges added since the last accepted solve (indices into
        # pg_edges / loops): a rejected solve rolls all of them back.
        self._pending_loop_edges: list[int] = []
        self._pending_loops: list[int] = []
        self._last_event_node = -(10**9)
        # A loop edge joined the graph after the last solve: join()
        # flushes one final solve.
        self._pg_dirty = False
        # Hook failures are recorded, not raised.
        self.hook_errors: list[Exception] = []

    def join(self):
        """Block until every enqueued keyframe hook has completed, making
        the captures the worker asks for meanwhile (so that a worker behind
        the frames replays what it would run eagerly), flush a pose-graph
        solve still pending behind the throttle, then make the captures
        left."""
        if self._hook_last is not None:
            while not self._hook_last.done():
                self._drain_captures()
                concurrent.futures.wait([self._hook_last], timeout=JOIN_POLL_S)
            self._hook_last.result()
        if self._pg_dirty:
            self._pg_dirty = False
            self._optimize_pose_graph()
        self._drain_captures()

    def _drain_captures(self):
        super()._drain_captures()
        self._loop_programs.drain()

    def close(self):
        super().close()
        pool = getattr(self, "_hook_pool", None)
        if pool is not None:
            self._hook_pool = None
            pool.shutdown(wait=True)

    # -- node scales (1 for SE(3) nodes) --------------------------------
    def _node_scales(self) -> np.ndarray:
        return np.ones(len(self.pg_R), np.float32)

    def _add_estimate(self, s, R, t):
        self.pg_R.append(R)
        self.pg_t.append(t)

    def _store_solution(self, s, R, t):
        self.pg_R = [R[k].copy() for k in range(len(R))]
        self.pg_t = [t[k].copy() for k in range(len(t))]

    def _solve_health(self, jump, s_new):
        """(jump, scales_ok) for the gate. SE(3) nodes, as the JAX
        package's stereo gate: a NaN jump or angle compares false with the
        ceilings, so a non-finite solve is accepted
        (tests/test_torch_loop_layer.py pins it on both packages)."""
        return jump, True

    # -- node-anchored trajectory --------------------------------------
    def _record(self, **kw):
        super()._record(**kw)
        self._anchors.append(self._next_node - 1)

    def trajectory(self):
        """Per-frame world->cam poses with all pose-graph corrections:
        T_final = (T_frame o T_raw_node^-1) o T_node_solved for each
        frame's anchor node, in metric form: a node's solved similarity
        (s_k, R_k, t_k) is the pose (R_k, t_k / s_k), and the frame's
        offset from its node (raw odometry, node-local metric) has its
        translation divided by s_k too. The raw VO poses are never
        mutated."""
        self.join()
        R, t = _pull_poses(self.results)
        anchors = np.asarray(self._anchors[: len(R)])
        sel = anchors >= 0
        if sel.any():
            a = anchors[sel]
            raw_R = np.stack(self.pg_raw_R)[a]
            raw_t = np.stack(self.pg_raw_t)[a]
            s = self._node_scales()[a]
            sol_R = np.stack(self.pg_R)[a]
            sol_t = np.stack(self.pg_t)[a] / s[:, None]
            R_rel = np.einsum("nij,nkj->nik", R[sel], raw_R)
            t_rel = (t[sel] - np.einsum("nij,nj->ni", R_rel, raw_t)) / s[:, None]
            R[sel] = np.einsum("nij,njk->nik", R_rel, sol_R)
            t[sel] = np.einsum("nij,nj->ni", R_rel, sol_t) + t_rel
        return R, t

    def graph_trajectory(self):
        """Keyframe trajectory after pose-graph corrections (metric)."""
        s = self._node_scales()
        return np.stack(self.pg_R), np.stack(self.pg_t) / s[:, None], list(self.pg_frame)

    # Post-BA keyframe hook, dispatch-thread side: the digest, the
    # copies to the host, one event, and the enqueue.
    def _post_keyframe(self, slot, pyr):
        node_id = self._next_node
        self._next_node = node_id + 1
        frame_idx = self.frame_idx
        tracked = getattr(self, "_n_tracked_cache", self.cfg.num_features)
        recovery = getattr(self, "_last_recovery_frame", -(10**9))
        if recovery > self._seam_recovery_seen:
            # New dead-reckoning seam: budget its unobserved motion as
            # recent speed x span (2x margin; generous fallbacks without
            # healthy history), the span floored at the detection latency
            # of a loss.
            self._seam_recovery_seen = recovery
            sp, rr = self._recent_motion()
            span = max(
                self._seam_span(recovery),
                self.cfg.lost_reinit_after + 2 * self.cfg.kf_min_gap + 4,
            )
            self._seam_trans += 2.0 * (sp if sp else 0.3) * span
            self._seam_rot += 2.0 * (rr if rr else 0.1) * span
        # (kps, kp_mask, desc, pts) on the device; the pose and the
        # keypoints, their mask and landmarks on their way to the host.
        # The program's outputs are overwritten by its next call, before
        # the worker may have read them: the hook gets copies.
        digest = self._loop_programs.get(("digest",), self._digest_program, counted=True)(
            self.map, slot)
        digest = tuple(x.clone() for x in digest)
        host = HostFetch(self.R, self.t, digest[0], digest[1], digest[3])
        self._hook_last = self._hook_pool.submit(
            self._hook_task, node_id, digest, host, frame_idx, tracked, recovery,
            self._seam_trans, self._seam_rot,
        )

    def _digest_program(self, m, slot):
        """The digest of keyframe `slot` from its level-0 image where the
        insertion stored it (`pyr[0]` of the hook): every keyframe's image
        is read in place, whichever pyramid it came from."""
        return self._digest(m, slot, map_state.row(m.kf_pyr[0], slot))

    def _hook_task(self, node_id, digest, host, frame_idx, tracked, recovery_frame,
                   seam_t=0.0, seam_r=0.0):
        """Worker-side keyframe hook. A failure is recorded and leaves a
        placeholder node (the raw pose, scale 1), so ids stay dense for
        later hooks and trajectory()."""
        try:
            with self._on_loop_stream(host, digest):
                self._hook_task_impl(node_id, digest, host, frame_idx, tracked,
                                     recovery_frame, seam_t, seam_r)
        except Exception as e:  # noqa: BLE001 -- record, don't poison the worker
            self.hook_errors.append(e)
            print(f"[{self._thread_name}] keyframe hook failed (node {node_id}): "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            try:
                R_np, t_np = host.result()[:2]
            except Exception:  # the copies themselves failed
                if self.pg_raw_R:
                    R_np, t_np = self.pg_raw_R[-1], self.pg_raw_t[-1]
                else:
                    R_np, t_np = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            while len(self.pg_raw_R) <= node_id:
                self.pg_raw_R.append(R_np.copy())
                self.pg_raw_t.append(t_np.copy())
                self._add_estimate(1.0, R_np.copy(), t_np.copy())
                self.pg_frame.append(frame_idx)

    @contextlib.contextmanager
    def _on_loop_stream(self, host, digest):
        """The worker's device work on its own stream (CUDA), ordered after
        the digest by the fetch's event; the digest's tensors are marked
        as used there, so their memory is not reused before it is done."""
        stream = self._loop_stream
        if stream is None:
            yield
            return
        stream.wait_event(host.event)
        for x in digest:
            x.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    def _hook_task_impl(self, node_id, digest, host, frame_idx, tracked,
                        recovery_frame, seam_t=0.0, seam_r=0.0):
        R_np, t_np, kps_h, mask_h, pts_h = host.result()   # waits on the event
        assert node_id == len(self.pg_raw_R)
        self.pg_raw_R.append(R_np.copy())
        self.pg_raw_t.append(t_np.copy())
        self.pg_frame.append(frame_idx)
        if node_id > 0:
            prev = node_id - 1
            R_rel, t_rel = _rel_np(self.pg_raw_R[prev], self.pg_raw_t[prev], R_np, t_np)
            # An odometry edge spanning a forced lost-tracking recovery
            # (stereo) or a re-init seam (mono) is dead reckoning: low
            # weight.
            w_seq = 0.1 if recovery_frame >= self.pg_frame[prev] else 1.0
            # The new node's estimate: the raw forward increment on top of
            # the previous node's solved estimate.
            R_fwd, t_fwd = _rel_np(R_np, t_np, self.pg_raw_R[prev], self.pg_raw_t[prev])
            self._odometry_edge(prev, R_rel, t_rel, w_seq, R_fwd, t_fwd)
            # Advance the drift clock by this keyframe step's odometry.
            c_prev = -self.pg_raw_R[prev].T @ self.pg_raw_t[prev]
            c_cur = -R_np.T @ t_np
            self._path_len += float(np.linalg.norm(c_cur - c_prev))
            self._rot_len += float(
                np.arccos(np.clip((np.trace(R_rel) - 1) / 2, -1, 1))
            )
        else:
            self._add_estimate(1.0, R_np.copy(), t_np.copy())

        # Database entry in the raw odometry frame: the descriptors stay
        # on the device, the host mirrors come from the pinned copies.
        self.loop_db.add(
            None, kps_h, mask_h, pts_h, mask_h, R_np, t_np, frame_idx,
            node_id=node_id, desc=digest[2],
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )

        # Detect only from a healthy state: a keyframe inserted during or
        # just after dead reckoning carries a low-confidence pose.
        recent_recovery = frame_idx - recovery_frame <= 2 * self.cfg.kf_min_gap
        if recent_recovery or tracked < self.cfg.min_tracked_points:
            return
        cand = self._detect_loop(digest, R_np, t_np, seam_t, seam_r)
        if cand is None:
            return
        # Loop edge weight: a bounded multiple of the odometry weight.
        w_loop = min(float(cand.inliers) / self.loop_params.min_inliers, 3.0)
        edge, loop = self._loop_edge(cand, node_id, w_loop)
        loop = {"from": node_id, "to": cand.db_index, "frame": frame_idx,
                "inliers": cand.inliers, **loop}
        self._pending_loop_edges.append(len(self.pg_edges))
        self._pending_loops.append(len(self.loops))
        self.pg_edges.append(edge)
        self.loops.append(loop)
        self._pg_dirty = True
        # Throttle: optimize at most once per min_event_gap_kf keyframes;
        # join() flushes what is still pending at the end.
        if node_id - self._last_event_node >= self.loop_params.min_event_gap_kf:
            self._event_node_prev = self._last_event_node
            self._last_event_node = node_id
            self._pg_dirty = False
            self._optimize_pose_graph()

    def _optimize_pose_graph(self):
        """Re-solve the global graph. Touches only the node estimates (the
        output); the live VO state is never corrected."""
        K = len(self.pg_R)
        if K < 3 or not self.pg_edges:
            return
        debug = os.environ.get("VISO_LOOP_DEBUG") == "1"
        s_new, R_new, t_new, info = self._solve(K, debug)

        # Solve-health gate over all nodes: a metric camera centre moving
        # beyond the loop gate's hard ceilings means a diverged solve or
        # an inconsistent graph (an aliased mid-trajectory edge can bend
        # the middle while barely moving the newest node). Reject: drop
        # the pending loop edges and keep the previous solution.
        s_old = self._node_scales()
        R_old = np.stack(self.pg_R)
        t_old = np.stack(self.pg_t)
        c_old = -np.einsum("nji,nj->ni", R_old, t_old) / s_old[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            c_new = -np.einsum("nji,nj->ni", R_new, t_new) / s_new[:, None]
        jump = float(np.linalg.norm(c_new - c_old, axis=-1).max())
        tr = np.einsum("nii->n", np.einsum("nij,nkj->nik", R_new, R_old))
        ang = float(np.arccos(np.clip((tr - 1) / 2, -1, 1)).max())
        jump, scales_ok = self._solve_health(jump, s_new)
        lp = self.loop_params
        if jump > lp.max_correction_m or ang > lp.max_correction_rad or not scales_ok:
            # Roll back every loop edge added since the last accepted
            # solve, and the throttle clock with them.
            for k in reversed(self._pending_loop_edges):
                del self.pg_edges[k]
            for k in reversed(self._pending_loops):
                del self.loops[k]
            n_dropped = len(self._pending_loop_edges)
            self._pending_loop_edges.clear()
            self._pending_loops.clear()
            self._last_event_node = getattr(self, "_event_node_prev", -(10**9))
            if debug:
                print(f"[pose-graph] REJECTED event: |jump|={jump:.2f} m "
                      f"ang={ang:.3f} rad scales_ok={scales_ok} "
                      f"({n_dropped} loop edge(s) dropped)", file=sys.stderr)
            return
        if debug:
            print(f"[pose-graph] K={K} E={len(self.pg_edges)} "
                  f"cost {float(info['initial_cost']):.4f} -> "
                  f"{float(info['final_cost']):.4f} |corr|={jump:.3f} "
                  f"s[{K - 1}]={s_new[K - 1]:.3f}", file=sys.stderr)
        self._store_solution(s_new, R_new, t_new)
        # Accepted: the loop edges it incorporated are now permanent.
        self._pending_loop_edges.clear()
        self._pending_loops.clear()


class StereoSLAM(LoopLayer, StereoVO):
    """Stereo VO + loop closure + SE(3) pose-graph correction. Edges are
    (i, j, R_ij, t_ij, weight)."""

    _thread_name = "viso-loop"

    def __init__(self, config: VOConfig, loop_params: LoopParams | None = None, *, device):
        super().__init__(config, device)
        self._init_loop_layer(loop_params)

    def _odometry_edge(self, prev, R_rel, t_rel, w_seq, R_fwd, t_fwd):
        node_id = prev + 1
        self.pg_edges.append((prev, node_id, R_rel, t_rel, w_seq))
        self.pg_R.append(R_fwd @ self.pg_R[prev])
        self.pg_t.append(R_fwd @ self.pg_t[prev] + t_fwd)

    def _detect_loop(self, digest, R_np, t_np, seam_t, seam_r):
        kps, kp_mask, desc, _ = digest
        return self.loop_db.detect_fused(
            desc, kps, kp_mask, R_np, t_np, self.intr,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )

    def _loop_edge(self, cand, node_id, w_loop):
        # cand.R_rel is T_cur o T_cand^-1; the (cand -> cur) edge needs
        # T_cand o T_cur^-1.
        R_e = cand.R_rel.T
        t_e = -cand.R_rel.T @ cand.t_rel
        return (cand.db_index, node_id, R_e, t_e, w_loop), {}

    def _solve(self, K, debug):
        if debug:
            g0, _ = pose_graph.solve_padded(
                self.pg_R, self.pg_t, self.pg_edges, pose_graph.PGParams(iters=0),
                device=self.device,
            )
            rn = np.linalg.norm(
                pose_graph.residuals(g0).cpu().numpy(), axis=-1
            )[: len(self.pg_edges)]
            w = int(np.argmax(rn))
            print(f"[pose-graph-pre] K={K} worst edge {w} "
                  f"({self.pg_edges[w][0]}->{self.pg_edges[w][1]}) "
                  f"resid={rn[w]:.3f} median={np.median(rn):.4f}", file=sys.stderr)
        out, info = pose_graph.solve_padded(
            self.pg_R, self.pg_t, self.pg_edges, pose_graph.PGParams(iters=25),
            device=self.device, programs=self._loop_programs,
        )
        return np.ones(K, np.float32), out.R[:K].cpu().numpy(), out.t[:K].cpu().numpy(), info
