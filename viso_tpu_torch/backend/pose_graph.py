"""SE(3) pose-graph optimization, the loop-closure backend (port of
`viso_tpu/backend/pose_graph.py`).

The residual of edge (i, j) with measured relative transform T_ij is
r = log(T_ij^-1 * T_i * T_j^-1) in se(3). LM with a dense (6K x 6K)
solve below `pcg_threshold` nodes and matrix-free block-Jacobi PCG
above it. Per-edge 6x12 Jacobians are forward-mode derivatives of the
left-perturbed residual (`torch.func.jvp`, where the JAX package uses
`jax.jacfwd` under `jax.vmap`), scatter-added into the system. Edges and
nodes are fixed-capacity masked tensors; `solve_padded` pads a growing
graph to power-of-two buckets as the JAX package does (here it only
keeps shapes in a few sizes). The LM loop runs eagerly, with
accept/reject on device values and no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from viso_tpu_torch.backend import robust
from viso_tpu_torch.geometry import se3


class PoseGraph(NamedTuple):
    R: torch.Tensor            # (K, 3, 3) world->cam
    t: torch.Tensor            # (K, 3)
    node_mask: torch.Tensor    # (K,)
    edge_i: torch.Tensor       # (E,) int64
    edge_j: torch.Tensor       # (E,) int64
    R_ij: torch.Tensor         # (E, 3, 3) measured T_i * T_j^-1
    t_ij: torch.Tensor         # (E, 3)
    edge_weight: torch.Tensor  # (E,) scalar information weight
    edge_mask: torch.Tensor    # (E,)


class PGParams(NamedTuple):
    iters: int = 20
    huber: float = 0.5
    lam0: float = 1e-4
    lam_up: float = 4.0
    lam_down: float = 0.5
    num_fixed: int = 1
    # "dense" materializes the (6K x 6K) system, "pcg" is matrix-free
    # block-Jacobi-preconditioned CG on the edge list, "auto" switches to
    # pcg above pcg_threshold nodes.
    solver: str = "auto"
    pcg_threshold: int = 320
    pcg_iters: int = 96


def edge_residual(Ri, ti, Rj, tj, R_ij, t_ij):
    """r = log(T_ij^-1 * T_i * T_j^-1) (..., 6)."""
    R_rel, t_rel = se3.relative(Ri, ti, Rj, tj)
    R_err, t_err = se3.compose(*se3.inverse(R_ij, t_ij), R_rel, t_rel)
    return se3.se3_log(R_err, t_err)


def _edge_residual_perturbed(xi2, Ri, ti, Rj, tj, R_ij, t_ij):
    """Residual with left-perturbations applied to both endpoint poses."""
    Ri_p, ti_p = se3.left_update(xi2[..., :6], Ri, ti)
    Rj_p, tj_p = se3.left_update(xi2[..., 6:], Rj, tj)
    return edge_residual(Ri_p, ti_p, Rj_p, tj_p, R_ij, t_ij)


def residuals(graph: PoseGraph):
    """All edge residuals (E, 6), zeroed where masked."""
    Ri, ti = graph.R[graph.edge_i], graph.t[graph.edge_i]
    Rj, tj = graph.R[graph.edge_j], graph.t[graph.edge_j]
    r = edge_residual(Ri, ti, Rj, tj, graph.R_ij, graph.t_ij)
    return torch.where(graph.edge_mask[:, None], r, 0.0)


def compute_cost(graph: PoseGraph, params: PGParams = PGParams()):
    r = residuals(graph)
    r_norm = torch.linalg.norm(r, dim=-1)
    w = graph.edge_weight * graph.edge_mask
    return torch.sum(w * robust.huber_cost(r_norm, params.huber))


def edge_jacobians(Ri, ti, Rj, tj, R_ij, t_ij):
    """Residuals (E, 6) and their Jacobians (E, 6, 12) with respect to
    the left perturbations [xi_i, xi_j] at zero.

    Forward mode, one Jacobian column per basis direction of the 12
    perturbation coordinates, pushed through all E edges at once
    (`torch.func.vmap` over `torch.func.jvp`). The edge axis stays a real
    batch axis on purpose: under a per-edge vmap every scalar of the
    residual is 0-dim, and forward-mode AD then promotes the tangent of a
    0-dim tensor plus a Python float to float64."""
    E = Ri.shape[0]
    zeros = torch.zeros((E, 12), dtype=Ri.dtype, device=Ri.device)

    def res(xi2):
        return _edge_residual_perturbed(xi2, Ri, ti, Rj, tj, R_ij, t_ij)

    def column(v):
        return torch.func.jvp(res, (zeros,), (v.expand(E, 12),))[1]

    basis = torch.eye(12, dtype=Ri.dtype, device=Ri.device)
    J = torch.func.vmap(column)(basis)                  # (12, E, 6)
    return res(zeros), J.permute(1, 2, 0)


def _edge_system(R, t, graph: PoseGraph, params: PGParams):
    """Shared LM linearization: residuals, per-edge Jacobians, robust
    weights and the gauge/free mask. Used by both linear solvers."""
    ei, ej = graph.edge_i, graph.edge_j
    r, J = edge_jacobians(R[ei], t[ei], R[ej], t[ej], graph.R_ij, graph.t_ij)
    r_norm = torch.linalg.norm(r, dim=-1)
    w = (
        graph.edge_weight
        * graph.edge_mask
        * robust.huber_weight(r_norm, params.huber)
    )
    K = R.shape[0]
    free = graph.node_mask & (torch.arange(K, device=R.device) >= params.num_fixed)
    return r, J, w, free.to(R.dtype)


def _update(delta, R, t, f):
    delta = torch.where(torch.isfinite(delta), delta, 0.0) * f[:, None]
    return se3.left_update(delta, R, t)


def _gn_step(R, t, graph: PoseGraph, lam, params: PGParams, K: int):
    r, J, w, f = _edge_system(R, t, graph, params)
    Ji = J[..., :6] * w[:, None, None]    # weighted (E, 6, 6) wrt node i
    Jj = J[..., 6:] * w[:, None, None]
    ei, ej = graph.edge_i, graph.edge_j
    # Assemble the dense block system with scatter-adds.
    H = torch.zeros((K, K, 6, 6), dtype=R.dtype, device=R.device)
    b = torch.zeros((K, 6), dtype=R.dtype, device=R.device)
    H.index_put_((ei, ei), torch.einsum("eai,eaj->eij", Ji, J[..., :6]), accumulate=True)
    H.index_put_((ej, ej), torch.einsum("eai,eaj->eij", Jj, J[..., 6:]), accumulate=True)
    H.index_put_((ei, ej), torch.einsum("eai,eaj->eij", Ji, J[..., 6:]), accumulate=True)
    H.index_put_((ej, ei), torch.einsum("eai,eaj->eij", Jj, J[..., :6]), accumulate=True)
    b.index_add_(0, ei, -torch.einsum("eai,ea->ei", Ji, r))
    b.index_add_(0, ej, -torch.einsum("eai,ea->ei", Jj, r))

    # Damping + gauge freeze.
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    k = torch.arange(K, device=R.device)
    diag_blocks = H[k, k]
    diag_scale = torch.einsum("kii->k", diag_blocks) / 6.0 + 1e-6
    H[k, k] += lam * diag_scale[:, None, None] * eye6
    H = H * f[:, None, None, None] * f[None, :, None, None]
    H[k, k] += (1.0 - f)[:, None, None] * eye6
    b = b * f[:, None]

    H_flat = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    # solve_ex does not raise on a singular system; the NaN step is zeroed.
    delta, _ = torch.linalg.solve_ex(H_flat, b.reshape(6 * K))
    return _update(delta.reshape(K, 6), R, t, f)


def _gn_step_pcg(R, t, graph: PoseGraph, lam, params: PGParams, K: int):
    """Matrix-free LM step: block-Jacobi-preconditioned CG on the edge
    list. Never materializes H: each matvec is two gathers, two batched
    6x12 products and two scatter-adds over the E edges."""
    r, J, w, f = _edge_system(R, t, graph, params)
    Ji = J[..., :6]
    Jj = J[..., 6:]
    ei, ej = graph.edge_i, graph.edge_j

    # RHS b = -J^T W r and block diagonal D_kk = sum J^T W J.
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    b = torch.zeros((K, 6), dtype=R.dtype, device=R.device)
    b.index_add_(0, ei, -torch.einsum("eai,ea->ei", Jiw, r))
    b.index_add_(0, ej, -torch.einsum("eai,ea->ei", Jjw, r))
    D = torch.zeros((K, 6, 6), dtype=R.dtype, device=R.device)
    D.index_add_(0, ei, torch.einsum("eai,eaj->eij", Jiw, Ji))
    D.index_add_(0, ej, torch.einsum("eai,eaj->eij", Jjw, Jj))

    # LM damping as in the dense path: lam * mean-diag scale * I.
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    diag_scale = torch.einsum("kii->k", D) / 6.0 + 1e-6
    damp = lam * diag_scale
    D_damped = D + damp[:, None, None] * eye6
    # Gauge: fixed nodes get identity rows in H and 0 rhs.
    D_prec = torch.where(f[:, None, None] > 0, D_damped, eye6)
    M_inv, _ = torch.linalg.inv_ex(D_prec)
    b = b * f[:, None]

    def hv(v):
        y = (
            torch.einsum("eab,eb->ea", Ji, v[ei])
            + torch.einsum("eab,eb->ea", Jj, v[ej])
        ) * w[:, None]
        out = torch.zeros((K, 6), dtype=R.dtype, device=R.device)
        out.index_add_(0, ei, torch.einsum("eab,ea->eb", Ji, y))
        out.index_add_(0, ej, torch.einsum("eab,ea->eb", Jj, y))
        out = out + damp[:, None] * v
        return out * f[:, None] + (1.0 - f)[:, None] * v

    def prec(v):
        return torch.einsum("kij,kj->ki", M_inv, v)

    x = torch.zeros_like(b)
    rr = b
    z = prec(rr)
    pdir = z
    rz = torch.sum(rr * z)
    for _ in range(params.pcg_iters):
        Hp = hv(pdir)
        denom = torch.sum(pdir * Hp)
        alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
        x = x + alpha * pdir
        rr = rr - alpha * Hp
        z = prec(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
        pdir = z + beta * pdir
        rz = rz_new
    return _update(x, R, t, f)


def _bucket(n: int, floor: int = 16) -> int:
    """Smallest power-of-two capacity >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def solve_padded(pg_R, pg_t, edges, params: PGParams = PGParams(), *, device):
    """Solve a growing pose graph padded to power-of-two capacities.

    `pg_R`/`pg_t`: lists or arrays of world->cam poses; `edges`: list of
    (i, j, R_ij, t_ij, weight). Returns (PoseGraph, info) with padded
    tensors on `device` -- slice [:len(pg_R)].
    """
    K = len(pg_R)
    E = len(edges)
    Kp = _bucket(K)
    Ep = _bucket(E)

    R = np.zeros((Kp, 3, 3), np.float32)
    R[:] = np.eye(3)
    t = np.zeros((Kp, 3), np.float32)
    R[:K] = np.stack(pg_R)
    t[:K] = np.stack(pg_t)
    node_mask = np.zeros(Kp, bool)
    node_mask[:K] = True

    ei = np.zeros(Ep, np.int64)
    ej = np.zeros(Ep, np.int64)
    R_ij = np.zeros((Ep, 3, 3), np.float32)
    R_ij[:] = np.eye(3)
    t_ij = np.zeros((Ep, 3), np.float32)
    w = np.zeros(Ep, np.float32)
    edge_mask = np.zeros(Ep, bool)
    for k, (i, j, Rm, tm, wt) in enumerate(edges):
        ei[k], ej[k] = i, j
        R_ij[k], t_ij[k] = Rm, tm
        w[k] = wt
        edge_mask[k] = True

    def dev(a):
        return torch.from_numpy(a).to(device)

    g = PoseGraph(
        R=dev(R), t=dev(t), node_mask=dev(node_mask),
        edge_i=dev(ei), edge_j=dev(ej), R_ij=dev(R_ij), t_ij=dev(t_ij),
        edge_weight=dev(w), edge_mask=dev(edge_mask),
    )
    return solve(g, params)


def solve(graph: PoseGraph, params: PGParams = PGParams()):
    """LM pose-graph optimization; returns (graph, info).

    The linear solver is picked from the (static) node count: dense up to
    params.pcg_threshold nodes, matrix-free PCG above.
    """
    K = graph.R.shape[0]
    use_pcg = params.solver == "pcg" or (
        params.solver == "auto" and K > params.pcg_threshold
    )
    step = _gn_step_pcg if use_pcg else _gn_step

    cost0 = compute_cost(graph, params)
    R, t, cost = graph.R, graph.t, cost0
    lam = torch.full((), params.lam0, dtype=graph.R.dtype, device=graph.R.device)
    hist = []
    for _ in range(params.iters):
        R_n, t_n = step(R, t, graph, lam, params, K)
        new_cost = compute_cost(graph._replace(R=R_n, t=t_n), params)
        accept = new_cost < cost
        R = torch.where(accept, R_n, R)
        t = torch.where(accept, t_n, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(
            accept,
            torch.clamp(lam * params.lam_down, min=1e-9),
            torch.clamp(lam * params.lam_up, max=1e6),
        )
        hist.append(cost)
    return graph._replace(R=R, t=t), {
        "initial_cost": cost0,
        "final_cost": cost,
        "cost_history": torch.stack(hist) if hist else cost0[None][:0],
    }
