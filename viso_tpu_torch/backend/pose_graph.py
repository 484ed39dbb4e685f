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

The linearization (`forward_jacobian`, `robust_weights`), both linear
solvers (`dense_delta`, `pcg_delta`) and the LM loop
(`levenberg_marquardt`) take any node DoF: the Sim(3) graph
(`pose_graph_sim3.py`) runs on them with 7-DoF nodes.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from viso_tpu_torch.backend import robust
from viso_tpu_torch.geometry import se3
from viso_tpu_torch.slam.programs import host_tensors


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


# PyTorch keeps its forward-mode AD levels for the whole process, not per
# thread: two threads inside `torch.func.jvp` at once (the loop worker's
# eager solve while the dispatch thread captures a solve) break each
# other's level. One linearization at a time.
_FORWARD_AD = threading.Lock()


def forward_jacobian(res, zeros):
    """Residuals (E, m) of `res(xi)` at xi = `zeros` (E, n) and their
    Jacobians (E, m, n): forward mode, one column per basis direction of
    the n perturbation coordinates, pushed through all E edges at once
    (`torch.func.vmap` over `torch.func.jvp`). The edge axis stays a real
    batch axis on purpose: under a per-edge vmap every scalar of the
    residual is 0-dim, and forward-mode AD then promotes the tangent of a
    0-dim tensor plus a Python float to float64."""
    E, n = zeros.shape

    def column(v):
        return torch.func.jvp(res, (zeros,), (v.expand(E, n),))[1]

    basis = torch.eye(n, dtype=zeros.dtype, device=zeros.device)
    with _FORWARD_AD:
        J = torch.func.vmap(column)(basis)              # (n, E, m)
    return res(zeros), J.permute(1, 2, 0)


def edge_jacobians(Ri, ti, Rj, tj, R_ij, t_ij):
    """Residuals (E, 6) and their Jacobians (E, 6, 12) with respect to
    the left perturbations [xi_i, xi_j] at zero."""
    zeros = torch.zeros((Ri.shape[0], 12), dtype=Ri.dtype, device=Ri.device)
    return forward_jacobian(
        lambda xi2: _edge_residual_perturbed(xi2, Ri, ti, Rj, tj, R_ij, t_ij), zeros
    )


def robust_weights(r, graph, params):
    """Per-edge information x mask x Huber weights, and the free-node mask
    (node_mask minus the first `num_fixed` gauge nodes) as floats."""
    r_norm = torch.linalg.norm(r, dim=-1)
    w = (
        graph.edge_weight
        * graph.edge_mask
        * robust.huber_weight(r_norm, params.huber)
    )
    K = graph.node_mask.shape[0]
    free = graph.node_mask & (torch.arange(K, device=r.device) >= params.num_fixed)
    return w, free.to(r.dtype)


def _edge_system(R, t, graph: PoseGraph, params: PGParams):
    """Shared LM linearization: residuals, per-edge Jacobians, robust
    weights and the gauge/free mask. Used by both linear solvers."""
    ei, ej = graph.edge_i, graph.edge_j
    r, J = edge_jacobians(R[ei], t[ei], R[ej], t[ej], graph.R_ij, graph.t_ij)
    return (r, J) + robust_weights(r, graph, params)


def dense_delta(r, J, w, f, lam, ei, ej, K: int):
    """LM step of a graph with d-DoF nodes (J: (E, m, 2d)) from the dense
    (dK x dK) damped normal equations, assembled with scatter-adds; fixed
    nodes get identity rows and a zero step. Returns (K, d), non-finite
    entries zeroed."""
    d = J.shape[-1] // 2
    Ji = J[..., :d] * w[:, None, None]    # weighted (E, m, d) wrt node i
    Jj = J[..., d:] * w[:, None, None]
    dtype, dev = J.dtype, J.device
    H = torch.zeros((K, K, d, d), dtype=dtype, device=dev)
    b = torch.zeros((K, d), dtype=dtype, device=dev)
    H.index_put_((ei, ei), torch.einsum("eai,eaj->eij", Ji, J[..., :d]), accumulate=True)
    H.index_put_((ej, ej), torch.einsum("eai,eaj->eij", Jj, J[..., d:]), accumulate=True)
    H.index_put_((ei, ej), torch.einsum("eai,eaj->eij", Ji, J[..., d:]), accumulate=True)
    H.index_put_((ej, ei), torch.einsum("eai,eaj->eij", Jj, J[..., :d]), accumulate=True)
    b.index_add_(0, ei, -torch.einsum("eai,ea->ei", Ji, r))
    b.index_add_(0, ej, -torch.einsum("eai,ea->ei", Jj, r))

    # Damping + gauge freeze.
    eye = torch.eye(d, dtype=dtype, device=dev)
    k = torch.arange(K, device=dev)
    diag_blocks = H[k, k]
    diag_scale = torch.einsum("kii->k", diag_blocks) / float(d) + 1e-6
    H[k, k] += lam * diag_scale[:, None, None] * eye
    H = H * f[:, None, None, None] * f[None, :, None, None]
    H[k, k] += (1.0 - f)[:, None, None] * eye
    b = b * f[:, None]

    H_flat = H.permute(0, 2, 1, 3).reshape(d * K, d * K)
    # solve_ex does not raise on a singular system; the NaN step is zeroed.
    delta, _ = torch.linalg.solve_ex(H_flat, b.reshape(d * K))
    return _finite_step(delta.reshape(K, d), f)


def pcg_delta(r, J, w, f, lam, ei, ej, K: int, iters: int):
    """Matrix-free LM step: block-Jacobi-preconditioned CG on the edge
    list, `iters` iterations. Never materializes H: each matvec is two
    gathers, two batched (m x d) products and two scatter-adds over the E
    edges."""
    d = J.shape[-1] // 2
    Ji = J[..., :d]
    Jj = J[..., d:]
    dtype, dev = J.dtype, J.device

    # RHS b = -J^T W r and block diagonal D_kk = sum J^T W J.
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    b = torch.zeros((K, d), dtype=dtype, device=dev)
    b.index_add_(0, ei, -torch.einsum("eai,ea->ei", Jiw, r))
    b.index_add_(0, ej, -torch.einsum("eai,ea->ei", Jjw, r))
    D = torch.zeros((K, d, d), dtype=dtype, device=dev)
    D.index_add_(0, ei, torch.einsum("eai,eaj->eij", Jiw, Ji))
    D.index_add_(0, ej, torch.einsum("eai,eaj->eij", Jjw, Jj))

    # LM damping as in the dense path: lam * mean-diag scale * I.
    eye = torch.eye(d, dtype=dtype, device=dev)
    diag_scale = torch.einsum("kii->k", D) / float(d) + 1e-6
    damp = lam * diag_scale
    D_damped = D + damp[:, None, None] * eye
    # Gauge: fixed nodes get identity rows in H and 0 rhs.
    D_prec = torch.where(f[:, None, None] > 0, D_damped, eye)
    M_inv, _ = torch.linalg.inv_ex(D_prec)
    b = b * f[:, None]

    def hv(v):
        y = (
            torch.einsum("eab,eb->ea", Ji, v[ei])
            + torch.einsum("eab,eb->ea", Jj, v[ej])
        ) * w[:, None]
        out = torch.zeros((K, d), dtype=dtype, device=dev)
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
    for _ in range(iters):
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
    return _finite_step(x, f)


def _finite_step(delta, f):
    return torch.where(torch.isfinite(delta), delta, 0.0) * f[:, None]


def linear_step(params, K: int):
    """The LM step's linear solver, picked from the (static) node count:
    dense up to params.pcg_threshold nodes, matrix-free PCG above."""
    if params.solver == "pcg" or (params.solver == "auto" and K > params.pcg_threshold):
        return lambda *a: pcg_delta(*a, iters=params.pcg_iters)
    return dense_delta


def levenberg_marquardt(state, step, cost, params):
    """`params.iters` LM iterations over a tuple of node tensors: `step`
    maps (state, lam) to a candidate state, `cost` a state to its robust
    cost. Accept or reject through `torch.where`, with no host sync.
    Returns (state, initial cost, final cost, cost history)."""
    cost0 = cost(state)
    c = cost0
    lam = torch.full((), params.lam0, dtype=cost0.dtype, device=cost0.device)
    hist = []
    for _ in range(params.iters):
        cand = step(state, lam)
        new_cost = cost(cand)
        accept = new_cost < c
        state = tuple(torch.where(accept, n, o) for n, o in zip(cand, state))
        c = torch.where(accept, new_cost, c)
        lam = torch.where(
            accept,
            torch.clamp(lam * params.lam_down, min=1e-9),
            torch.clamp(lam * params.lam_up, max=1e6),
        )
        hist.append(c)
    return state, cost0, c, torch.stack(hist) if hist else cost0[None][:0]


def _bucket(n: int, floor: int = 16) -> int:
    """Smallest power-of-two capacity >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_graph(pg_R, pg_t, edges, *, device):
    """A growing pose graph padded to power-of-two capacities, as host
    tensors ready to stage onto `device` (`host_tensors`). `pg_R` /
    `pg_t`: lists or arrays of world->cam poses; `edges`: list of (i, j,
    R_ij, t_ij, weight)."""
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
    return PoseGraph(*host_tensors((R, t, node_mask, ei, ej, R_ij, t_ij, w, edge_mask), device))


def solve_padded(pg_R, pg_t, edges, params: PGParams = PGParams(), *, device, programs=None):
    """Solve a growing pose graph padded to power-of-two capacities
    (`pad_graph`). Returns (PoseGraph, info) with padded tensors on
    `device` -- slice [:len(pg_R)].

    Eager by default (the tools' entry point). With `programs` (a
    `slam/programs.Cache`, the SLAM loop layer's) the solve is the
    cache's program of its bucket and params: captured on a CUDA device
    and replayed, its padded graph staged from pinned host memory; its
    outputs are overwritten by the bucket's next solve."""
    g = pad_graph(pg_R, pg_t, edges, device=device)
    return run_solve(g, params, solve, "pose_graph", device=device, programs=programs)


def run_solve(g, params, solve_fn, name, *, device, programs):
    """`solve_fn(g, params)` on `device`: eagerly, or through the program
    of (name, node bucket, edge bucket, params) in `programs`."""
    if programs is None:
        return solve_fn(type(g)(*(x.to(device) for x in g)), params)
    key = (name, g.R.shape[0], g.edge_i.shape[0], params)
    out, cost0, cost1, hist = programs.get(key, functools.partial(_solve_flat, solve_fn,
                                                                  params=params))(g)
    return out, {"initial_cost": cost0, "final_cost": cost1, "cost_history": hist}


def _solve_flat(solve_fn, g, params):
    """`solve_fn`'s result as a tuple of tensors (a program returns no dict)."""
    out, info = solve_fn(g, params)
    return out, info["initial_cost"], info["final_cost"], info["cost_history"]


def solve(graph: PoseGraph, params: PGParams = PGParams()):
    """LM pose-graph optimization; returns (graph, info). The linear
    solver is dense up to params.pcg_threshold nodes, PCG above."""
    K = graph.R.shape[0]
    delta = linear_step(params, K)
    ei, ej = graph.edge_i, graph.edge_j

    def step(state, lam):
        R, t = state
        r, J, w, f = _edge_system(R, t, graph, params)
        return se3.left_update(delta(r, J, w, f, lam, ei, ej, K), R, t)

    def cost(state):
        return compute_cost(graph._replace(R=state[0], t=state[1]), params)

    (R, t), cost0, cost1, hist = levenberg_marquardt((graph.R, graph.t), step, cost, params)
    return graph._replace(R=R, t=t), {
        "initial_cost": cost0, "final_cost": cost1, "cost_history": hist,
    }
