"""Sim(3) pose-graph optimization, the monocular loop-closure backend (port
of `viso_tpu/backend/pose_graph_sim3.py`).

An SE(3) graph cannot express monocular scale drift: a mono loop closure
observes that the revisited segment runs at another scale than when it
was first mapped, and the correction must spread log-scale along the loop
as well as rotation and translation. Nodes are world->cam similarities
S_k = (s_k, R_k, t_k) (odometry enters at s = 1), and edge (i, j) with
measured S_ij has the 7-dim residual

    r = log_dec(S_ij^-1 o S_i o S_j^-1) * [1, 1, 1, 1, 1, 1, scale_weight].

The LM machinery is the SE(3) graph's (`backend/pose_graph.py`): per-edge
(E, 7, 14) Jacobians by forward mode over the real edge axis, the dense
(7K x 7K) solve up to `pcg_threshold` nodes and block-Jacobi PCG above
it, accept or reject through `torch.where` with no host sync.
`cold_start_init` stays numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from viso_tpu_torch.backend import pose_graph, robust
from viso_tpu_torch.geometry import sim3
from viso_tpu_torch.slam.programs import host_tensors


class Sim3Graph(NamedTuple):
    s: torch.Tensor            # (K,) node scales
    R: torch.Tensor            # (K, 3, 3) world->cam
    t: torch.Tensor            # (K, 3)
    node_mask: torch.Tensor    # (K,)
    edge_i: torch.Tensor       # (E,) int64
    edge_j: torch.Tensor       # (E,) int64
    s_ij: torch.Tensor         # (E,) measured relative scale
    R_ij: torch.Tensor         # (E, 3, 3) measured S_i o S_j^-1
    t_ij: torch.Tensor         # (E, 3)
    edge_weight: torch.Tensor  # (E,)
    edge_mask: torch.Tensor    # (E,)


class PGParams(NamedTuple):
    iters: int = 25
    huber: float = 0.5
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 1
    # Scale residuals are log-ratios (~0.1 for 10 % drift), translation
    # residuals metres: weight the scale row so a 10 % scale error counts
    # like a half-metre one.
    scale_weight: float = 5.0
    # "dense" materializes the (7K x 7K) system, "pcg" is matrix-free
    # block-Jacobi-preconditioned CG on the edge list, "auto" switches to
    # pcg above pcg_threshold nodes.
    solver: str = "auto"
    pcg_threshold: int = 320
    pcg_iters: int = 96


def edge_residual(si, Ri, ti, sj, Rj, tj, s_ij, R_ij, t_ij, sw):
    """r = log_dec(S_ij^-1 o S_i o S_j^-1), scale row weighted by sw (..., 7)."""
    rel = sim3.compose(si, Ri, ti, *sim3.inverse(sj, Rj, tj))
    r = sim3.log_decomposed(*sim3.compose(*sim3.inverse(s_ij, R_ij, t_ij), *rel))
    # A tensor of the residual's dtype: a Python float here would meet the
    # tangents of forward mode and promote them to float64. Made on the
    # device (`torch.tensor` of a list would copy host data, which a
    # captured solve cannot).
    weight = torch.cat([torch.ones(6, dtype=r.dtype, device=r.device),
                        torch.full((1,), sw, dtype=r.dtype, device=r.device)])
    return r * weight


def _edge_residual_perturbed(xi2, si, Ri, ti, sj, Rj, tj, s_ij, R_ij, t_ij, sw):
    """Residual with left perturbations applied to both endpoint nodes."""
    si_p, Ri_p, ti_p = sim3.left_update(xi2[..., :7], si, Ri, ti)
    sj_p, Rj_p, tj_p = sim3.left_update(xi2[..., 7:], sj, Rj, tj)
    return edge_residual(si_p, Ri_p, ti_p, sj_p, Rj_p, tj_p, s_ij, R_ij, t_ij, sw)


def _endpoints(s, R, t, graph):
    ei, ej = graph.edge_i, graph.edge_j
    return s[ei], R[ei], t[ei], s[ej], R[ej], t[ej]


def residuals(graph: Sim3Graph, params: PGParams = PGParams()):
    """All edge residuals (E, 7), zeroed where masked."""
    r = edge_residual(*_endpoints(graph.s, graph.R, graph.t, graph),
                      graph.s_ij, graph.R_ij, graph.t_ij, params.scale_weight)
    return torch.where(graph.edge_mask[:, None], r, 0.0)


def compute_cost(graph: Sim3Graph, params: PGParams = PGParams()):
    r_norm = torch.linalg.norm(residuals(graph, params), dim=-1)
    w = graph.edge_weight * graph.edge_mask
    return torch.sum(w * robust.huber_cost(r_norm, params.huber))


def edge_jacobians(si, Ri, ti, sj, Rj, tj, s_ij, R_ij, t_ij, sw):
    """Residuals (E, 7) and their Jacobians (E, 7, 14) with respect to the
    left perturbations [delta_i, delta_j] at zero."""
    zeros = torch.zeros((Ri.shape[0], 14), dtype=Ri.dtype, device=Ri.device)
    return pose_graph.forward_jacobian(
        lambda xi2: _edge_residual_perturbed(xi2, si, Ri, ti, sj, Rj, tj,
                                             s_ij, R_ij, t_ij, sw),
        zeros,
    )


def _edge_system(s, R, t, graph: Sim3Graph, params: PGParams):
    """Shared LM linearization: residuals, Jacobians, robust weights and
    the free-node mask."""
    r, J = edge_jacobians(*_endpoints(s, R, t, graph), graph.s_ij, graph.R_ij,
                          graph.t_ij, params.scale_weight)
    return (r, J) + pose_graph.robust_weights(r, graph, params)


def solve(graph: Sim3Graph, params: PGParams = PGParams()):
    """LM Sim(3) pose-graph optimization; returns (graph, info). The
    linear solver is dense up to params.pcg_threshold nodes, PCG above."""
    K = graph.R.shape[0]
    delta = pose_graph.linear_step(params, K)
    ei, ej = graph.edge_i, graph.edge_j

    def step(state, lam):
        r, J, w, f = _edge_system(*state, graph, params)
        return sim3.left_update(delta(r, J, w, f, lam, ei, ej, K), *state)

    def cost(state):
        s, R, t = state
        return compute_cost(graph._replace(s=s, R=R, t=t), params)

    (s, R, t), cost0, cost1, hist = pose_graph.levenberg_marquardt(
        (graph.s, graph.R, graph.t), step, cost, params)
    return graph._replace(s=s, R=R, t=t), {
        "initial_cost": cost0, "final_cost": cost1, "cost_history": hist,
    }


def cold_start_init(pg_s, pg_R, pg_t, edges):
    """Cold-start initialization of a large graph with global scale seams
    (batch or checkpoint-resume solves; a live engine warm-starts every
    solve from the last solution). Numpy.

    The scale subproblem is convex in log space: edge (i, j, s_ij) says
    x_i - x_j = log s_ij with x = log s. Stage 1 solves that scalar least
    squares exactly (float64, dense (K, K)); stage 2 gives each sequential
    edge the field's scale ratio in place of its scale-blind 1 and
    re-integrates the chain, which lands near the global optimum's basin.
    Returns (s, R, t) lists.
    """
    K = len(pg_R)
    H = np.zeros((K, K), np.float64)
    b = np.zeros(K, np.float64)
    for (i, j, s_ij, _, _, w) in edges:
        m = np.log(max(float(s_ij), 1e-9))
        H[i, i] += w
        H[j, j] += w
        H[i, j] -= w
        H[j, i] -= w
        b[i] += w * m
        b[j] -= w * m
    # Gauge: pin x_0 to the caller's node-0 scale.
    H[0, 0] += 1e4
    b[0] += 1e4 * np.log(max(float(pg_s[0]), 1e-9))
    x = np.linalg.solve(H + 1e-9 * np.eye(K), b)

    seq = {}
    for (i, j, _, R_ij, t_ij, _) in edges:
        if j == i + 1:
            seq[j] = (i, np.asarray(R_ij), np.asarray(t_ij))
    s0 = float(np.exp(x[0]))
    out_s = [s0]
    out_R = [np.asarray(pg_R[0])]
    out_t = [np.asarray(pg_t[0]) * (s0 / max(float(pg_s[0]), 1e-9))]
    for k in range(1, K):
        if k in seq:
            i, R_m, t_m = seq[k]
            # Re-scaled measurement (exp(x_i - x_k), R_m, t_m): odometry
            # measured R and t in the local metric, only its scale was blind.
            s_m = float(np.exp(x[i] - x[k]))
            sk, Rk, tk = sim3.compose(*sim3.inverse(s_m, R_m, t_m),
                                      out_s[i], out_R[i], out_t[i])
            out_s.append(float(sk))
            out_R.append(np.asarray(Rk))
            out_t.append(np.asarray(tk))
        else:
            # No sequential edge into k (a placeholder gap): the caller's
            # pose, rescaled onto the solved field.
            sk = float(np.exp(x[k]))
            out_s.append(sk)
            out_R.append(np.asarray(pg_R[k]))
            out_t.append(np.asarray(pg_t[k]) * (sk / max(float(pg_s[k]), 1e-9)))
    return out_s, out_R, out_t


def pad_graph(pg_s, pg_R, pg_t, edges, *, device):
    """A growing Sim(3) graph padded to power-of-two capacities
    (`pose_graph._bucket`), as host tensors ready to stage onto `device`
    (`slam/programs.host_tensors`). `edges`: (i, j, s_ij, R_ij, t_ij, weight)."""
    K = len(pg_R)
    E = len(edges)
    Kp = pose_graph._bucket(K)
    Ep = pose_graph._bucket(E)

    s = np.ones(Kp, np.float32)
    R = np.zeros((Kp, 3, 3), np.float32)
    R[:] = np.eye(3)
    t = np.zeros((Kp, 3), np.float32)
    s[:K] = np.asarray(pg_s)
    R[:K] = np.stack(pg_R)
    t[:K] = np.stack(pg_t)
    node_mask = np.zeros(Kp, bool)
    node_mask[:K] = True

    ei = np.zeros(Ep, np.int64)
    ej = np.zeros(Ep, np.int64)
    s_ij = np.ones(Ep, np.float32)
    R_ij = np.zeros((Ep, 3, 3), np.float32)
    R_ij[:] = np.eye(3)
    t_ij = np.zeros((Ep, 3), np.float32)
    w = np.zeros(Ep, np.float32)
    edge_mask = np.zeros(Ep, bool)
    for k, (i, j, sm, Rm, tm, wt) in enumerate(edges):
        ei[k], ej[k] = i, j
        s_ij[k], R_ij[k], t_ij[k] = sm, Rm, tm
        w[k] = wt
        edge_mask[k] = True
    return Sim3Graph(*host_tensors(
        (s, R, t, node_mask, ei, ej, s_ij, R_ij, t_ij, w, edge_mask), device))


def solve_padded(pg_s, pg_R, pg_t, edges, params: PGParams = PGParams(), *, device,
                 programs=None):
    """Solve a growing Sim(3) graph padded to power-of-two capacities
    (`pad_graph`). Returns (Sim3Graph, info) with padded tensors on
    `device` -- slice [:len(pg_R)]. Eager, or with `programs` through the
    program of its bucket, as `pose_graph.solve_padded`."""
    g = pad_graph(pg_s, pg_R, pg_t, edges, device=device)
    return pose_graph.run_solve(g, params, solve, "pose_graph_sim3", device=device,
                                programs=programs)
