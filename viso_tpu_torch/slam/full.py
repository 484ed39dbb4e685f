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
descriptors and landmarks: one function of tensor ops on the device),
starts non-blocking copies of what the worker reads on the host into
pinned memory, records a CUDA event after them and enqueues. The worker
waits on that event before it reads a byte: a non-blocking copy has not
landed when `.to("cpu", non_blocking=True)` returns. Node ids are
assigned at enqueue time, so frame -> node anchoring stays exact;
`trajectory()` / `graph_trajectory()` join the worker first.

Worker failures are recorded in `hook_errors`, not raised (a failed hook
leaves a placeholder node so later ids stay dense), as the JAX package
does; callers that must not pass over a failure check `hook_errors`.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys

import numpy as np
import torch

from viso_tpu_torch.backend import pose_graph
from viso_tpu_torch.ops import descriptors
from viso_tpu_torch.slam.engine import HostFetch, StereoVO, VOConfig, _pull_poses
from viso_tpu_torch.slam.loop_closure import LoopDatabase, LoopParams


def _rel_np(Ra, ta, Rb, tb):
    """T_a o T_b^-1 in numpy (host-side pose bookkeeping)."""
    R = Ra @ Rb.T
    t = ta - R @ tb
    return R, t


def make_digest_kernel(num_features: int):
    """The keyframe digest: the loop layer's keypoint set (observed
    landmarks first, ascending slot order) and its steered BRIEF
    descriptors from the keyframe image. A function of tensor ops (K1
    copies the descriptor windows on CUDA), not a kernel of its own."""
    NF = num_features

    def digest(m, slot: int, img0):
        obs = m.obs_mask[slot]
        order = torch.argsort(-obs.to(torch.int32), stable=True)[:NF]
        kp_mask = obs[order]
        kps = m.obs_uv[slot][order]
        pts = m.points[order]
        desc = descriptors.compute(img0, kps, kp_mask)
        return kps, kp_mask, desc, pts

    return digest


class StereoSLAM(StereoVO):
    def __init__(self, config: VOConfig, loop_params: LoopParams | None = None, *, device):
        super().__init__(config, device)
        self.loop_params = loop_params or LoopParams()
        self.loop_db = LoopDatabase(self.loop_params, seed=config.seed + 1,
                                    device=self.device)
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
        self.pg_edges: list[tuple] = []   # (i, j, R_ij, t_ij, weight)
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
            max_workers=1, thread_name_prefix="viso-loop"
        )
        self._hook_last = None
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
        """Block until every enqueued keyframe hook has completed, then
        flush a pose-graph solve still pending behind the throttle."""
        if self._hook_last is not None:
            self._hook_last.result()
        if self._pg_dirty:
            self._pg_dirty = False
            self._optimize_pose_graph()

    def close(self):
        super().close()
        pool = getattr(self, "_hook_pool", None)
        if pool is not None:
            self._hook_pool = None
            pool.shutdown(wait=True)

    # -- node-anchored trajectory --------------------------------------
    def _record(self, **kw):
        super()._record(**kw)
        self._anchors.append(self._next_node - 1)

    def trajectory(self):
        """Per-frame world->cam poses with all pose-graph corrections:
        T_final = (T_frame o T_raw_node^-1) o T_node_solved for each
        frame's anchor node. The raw VO poses are never mutated."""
        self.join()
        R, t = _pull_poses(self.results)
        anchors = np.asarray(self._anchors[: len(R)])
        sel = anchors >= 0
        if sel.any():
            a = anchors[sel]
            raw_R = np.stack(self.pg_raw_R)[a]
            raw_t = np.stack(self.pg_raw_t)[a]
            sol_R = np.stack(self.pg_R)[a]
            sol_t = np.stack(self.pg_t)[a]
            R_rel = np.einsum("nij,nkj->nik", R[sel], raw_R)
            t_rel = t[sel] - np.einsum("nij,nj->ni", R_rel, raw_t)
            R[sel] = np.einsum("nij,njk->nik", R_rel, sol_R)
            t[sel] = np.einsum("nij,nj->ni", R_rel, sol_t) + t_rel
        return R, t

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
        kps, kp_mask, desc, pts = self._digest(self.map, slot, pyr[0])
        host = HostFetch(self.R, self.t, kps, kp_mask, pts)
        self._hook_last = self._hook_pool.submit(
            self._hook_task, node_id, kps, kp_mask, desc, host,
            frame_idx, tracked, recovery, self._seam_trans, self._seam_rot,
        )

    def _hook_task(self, node_id, kps, kp_mask, desc, host, frame_idx,
                   tracked, recovery_frame, seam_t=0.0, seam_r=0.0):
        """Worker-side keyframe hook. A failure is recorded and leaves a
        placeholder node, so ids stay dense for later hooks and
        trajectory()."""
        try:
            self._hook_task_impl(node_id, kps, kp_mask, desc, host, frame_idx,
                                 tracked, recovery_frame, seam_t, seam_r)
        except Exception as e:  # noqa: BLE001 -- record, don't poison the worker
            self.hook_errors.append(e)
            print(f"[viso-loop] keyframe hook failed (node {node_id}): "
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
                self.pg_R.append(R_np.copy())
                self.pg_t.append(t_np.copy())
                self.pg_frame.append(frame_idx)

    def _hook_task_impl(self, node_id, kps, kp_mask, desc, host, frame_idx,
                        tracked, recovery_frame, seam_t=0.0, seam_r=0.0):
        p = self.loop_params
        R_np, t_np, kps_h, mask_h, pts_h = host.result()   # waits on the event
        assert node_id == len(self.pg_raw_R)
        self.pg_raw_R.append(R_np.copy())
        self.pg_raw_t.append(t_np.copy())
        self.pg_frame.append(frame_idx)
        if node_id > 0:
            R_rel, t_rel = _rel_np(
                self.pg_raw_R[node_id - 1], self.pg_raw_t[node_id - 1], R_np, t_np,
            )
            # An odometry edge spanning a forced lost-tracking recovery is
            # dead reckoning: low weight.
            prev_f = self.pg_frame[node_id - 1]
            recovered = recovery_frame >= prev_f
            w_seq = 0.1 if recovered else 1.0
            self.pg_edges.append((node_id - 1, node_id, R_rel, t_rel, w_seq))
            # Global estimate for the new node: the raw forward increment
            # on top of the previous node's solved estimate.
            R_fwd, t_fwd = _rel_np(
                R_np, t_np, self.pg_raw_R[node_id - 1], self.pg_raw_t[node_id - 1],
            )
            self.pg_R.append(R_fwd @ self.pg_R[node_id - 1])
            self.pg_t.append(R_fwd @ self.pg_t[node_id - 1] + t_fwd)
            # Advance the drift clock by this keyframe step's odometry.
            c_prev = -self.pg_raw_R[node_id - 1].T @ self.pg_raw_t[node_id - 1]
            c_cur = -R_np.T @ t_np
            self._path_len += float(np.linalg.norm(c_cur - c_prev))
            self._rot_len += float(
                np.arccos(np.clip((np.trace(R_rel) - 1) / 2, -1, 1))
            )
        else:
            self.pg_R.append(R_np.copy())
            self.pg_t.append(t_np.copy())

        # Database entry in the raw odometry frame: the descriptors stay
        # on the device, the host mirrors come from the pinned copies.
        self.loop_db.add(
            None, kps_h, mask_h, pts_h, mask_h, R_np, t_np, frame_idx,
            node_id=node_id, desc=desc,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )

        # Detect only from a healthy state: a keyframe inserted during or
        # just after dead reckoning carries a low-confidence pose.
        recent_recovery = frame_idx - recovery_frame <= 2 * self.cfg.kf_min_gap
        if recent_recovery or tracked < self.cfg.min_tracked_points:
            return
        cand = self.loop_db.detect_fused(
            desc, kps, kp_mask, R_np, t_np, self.intr,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )
        if cand is not None:
            # cand.R_rel is T_cur o T_cand^-1; the (cand -> cur) edge
            # needs T_cand o T_cur^-1.
            R_e = cand.R_rel.T
            t_e = -cand.R_rel.T @ cand.t_rel
            # Loop edge weight: a bounded multiple of the odometry weight.
            w_loop = min(float(cand.inliers) / p.min_inliers, 3.0)
            self._pending_loop_edges.append(len(self.pg_edges))
            self._pending_loops.append(len(self.loops))
            self.pg_edges.append((cand.db_index, node_id, R_e, t_e, w_loop))
            self.loops.append({"from": node_id, "to": cand.db_index,
                               "frame": frame_idx, "inliers": cand.inliers})
            self._pg_dirty = True
            # Throttle: optimize at most once per min_event_gap_kf
            # keyframes; join() flushes what is still pending at the end.
            if node_id - self._last_event_node >= p.min_event_gap_kf:
                self._event_node_prev = self._last_event_node
                self._last_event_node = node_id
                self._pg_dirty = False
                self._optimize_pose_graph()

    def _optimize_pose_graph(self):
        """Re-solve the global graph. Touches only pg_R / pg_t (the output
        estimates); the live VO state is never corrected."""
        K = len(self.pg_R)
        if K < 3 or not self.pg_edges:
            return
        debug = os.environ.get("VISO_LOOP_DEBUG") == "1"
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
            device=self.device,
        )
        R_new = out.R[:K].cpu().numpy()
        t_new = out.t[:K].cpu().numpy()

        # Solve-health gate over all nodes: any node moving beyond the
        # loop gate's hard ceilings means a diverged solve or an
        # inconsistent graph. Reject: drop the pending loop edges and
        # keep the previous solution.
        R_old = np.stack(self.pg_R)
        t_old = np.stack(self.pg_t)
        c_old = -np.einsum("nji,nj->ni", R_old, t_old)
        c_new = -np.einsum("nji,nj->ni", R_new, t_new)
        jump = float(np.linalg.norm(c_new - c_old, axis=-1).max())
        tr = np.einsum("nii->n", np.einsum("nij,nkj->nik", R_new, R_old))
        ang = float(np.arccos(np.clip((tr - 1) / 2, -1, 1)).max())
        lp = self.loop_params
        if jump > lp.max_correction_m or ang > lp.max_correction_rad:
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
                      f"ang={ang:.3f} rad exceeds gate ceilings "
                      f"({n_dropped} loop edge(s) dropped)", file=sys.stderr)
            return
        if debug:
            print(f"[pose-graph] K={K} E={len(self.pg_edges)} "
                  f"cost {float(info['initial_cost']):.4f} -> "
                  f"{float(info['final_cost']):.4f} |corr|={jump:.3f}", file=sys.stderr)
        self.pg_R = [R_new[k].copy() for k in range(K)]
        self.pg_t = [t_new[k].copy() for k in range(K)]
        # Accepted: the loop edges it incorporated are now permanent.
        self._pending_loop_edges.clear()
        self._pending_loops.clear()

    def graph_trajectory(self):
        """Keyframe trajectory after pose-graph corrections."""
        return np.stack(self.pg_R), np.stack(self.pg_t), list(self.pg_frame)

