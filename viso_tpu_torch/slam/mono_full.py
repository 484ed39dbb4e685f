"""Monocular SLAM: mono VO + loop closure + Sim(3) pose-graph correction
(port of `viso_tpu/slam/mono_full.py`).

The loop layer of stereo SLAM (`slam/full.py`, `LoopLayer`: the VO front
end is never touched, the graph is a parallel global estimate kept by one
worker thread), with Sim(3) nodes: monocular scale drifts, and jumps at a
re-init, and an SE(3) graph cannot express that. Odometry edges enter
scale-blind (s_ij = 1); a loop edge carries the relative scale of a
masked Umeyama fit over the PnP inliers (`LoopDatabase.
detect_fused_sim3`), and `backend/pose_graph_sim3` spreads log-scale
along the loop. Edges are (i, j, s_ij, R_ij, t_ij, weight). A node's
solved similarity (s_k, R_k, t_k) is the metric pose (R_k, t_k / s_k),
which `trajectory()` and `graph_trajectory()` return.

The digest (its descriptor windows copied by K1) runs on the dispatch
thread, as in stereo SLAM; the current keyframe's landmarks go to the
host for the database's mirror and stay on the device for the Umeyama
fit. The solve runs on the engine's device, on the worker thread, as the
loop layer's program of its bucket.
"""

from __future__ import annotations

import numpy as np

from viso_tpu_torch.backend import pose_graph_sim3 as pgs
from viso_tpu_torch.geometry import sim3
from viso_tpu_torch.slam.engine import MonocularVO, VOConfig
from viso_tpu_torch.slam.full import LoopLayer
from viso_tpu_torch.slam.loop_closure import LoopParams


class MonoSLAM(LoopLayer, MonocularVO):
    _thread_name = "viso-mono-loop"

    def __init__(self, config: VOConfig, loop_params: LoopParams | None = None, *, device):
        super().__init__(config, device)
        self._init_loop_layer(loop_params)
        # Solved node scales: s_k estimates node k's local-metric scale
        # (odometry knows none: raw nodes have s = 1).
        self.pg_s: list[float] = []

    def _node_scales(self) -> np.ndarray:
        return np.asarray(self.pg_s, np.float64)

    def _add_estimate(self, s, R, t):
        super()._add_estimate(s, R, t)
        self.pg_s.append(float(s))

    def _store_solution(self, s, R, t):
        super()._store_solution(s, R, t)
        self.pg_s = [float(v) for v in s]

    def _solve_health(self, jump, s_new):
        # A non-finite solve is rejected, and node scales must stay inside
        # (0.2, 5): a diverged solve or an inconsistent graph.
        scales_ok = bool(np.all(np.isfinite(s_new)) and np.all(s_new > 0.2)
                         and np.all(s_new < 5.0))
        return (jump if np.isfinite(jump) else np.inf), scales_ok

    def _odometry_edge(self, prev, R_rel, t_rel, w_seq, R_fwd, t_fwd):
        # Scale-blind odometry edge; the new node's estimate is the raw
        # forward increment on top of the previous solved similarity (its
        # scale rides along), in numpy on the worker.
        self.pg_edges.append((prev, prev + 1, 1.0, R_rel, t_rel, w_seq))
        s_e, R_e, t_e = sim3.compose(1.0, R_fwd, t_fwd, self.pg_s[prev],
                                     self.pg_R[prev], self.pg_t[prev])
        self._add_estimate(s_e, np.asarray(R_e), np.asarray(t_e))

    def _detect_loop(self, digest, R_np, t_np, seam_t, seam_r):
        kps, kp_mask, desc, pts = digest
        return self.loop_db.detect_fused_sim3(
            desc, kps, kp_mask, pts, kp_mask, R_np, t_np, self.intr,
            path_len=self._path_len, rot_len=self._rot_len,
            seam_t=seam_t, seam_r=seam_r,
        )

    def _loop_edge(self, cand, node_id, w_loop):
        # cand carries the Umeyama similarity G = S_cand o S_cur^-1
        # directly: the edge measurement for (i = cand, j = cur).
        return ((cand.db_index, node_id, cand.s_rel, cand.R_rel, cand.t_rel, w_loop),
                {"s_rel": cand.s_rel})

    def _solve(self, K, debug):
        out, info = pgs.solve_padded(self.pg_s, self.pg_R, self.pg_t, self.pg_edges,
                                     pgs.PGParams(iters=25), device=self.device,
                                     programs=self._loop_programs)
        return (out.s[:K].cpu().numpy(), out.R[:K].cpu().numpy(), out.t[:K].cpu().numpy(),
                info)
