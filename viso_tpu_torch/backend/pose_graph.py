"""SE(3) pose-graph optimization, the loop-closure backend (port of
`viso_tpu/backend/pose_graph.py`).

The residual of edge (i, j) with measured relative transform T_ij is
r = log(T_ij^-1 * T_i * T_j^-1) in se(3). LM with a dense (6K x 6K)
solve below `pcg_threshold` nodes and matrix-free block-Jacobi PCG
above it. Per-edge 6x12 Jacobians are forward-mode derivatives of the
left-perturbed residual (`torch.func.jvp`, where the JAX package uses
`jax.jacfwd` under `jax.vmap`). The JAX package scatter-adds them into
the system (`.at[].add`, which XLA sums in a fixed order); here no sum
is an atomic: the dense system is A^T W A with A placed by the one-hot
node-by-endpoint incidence (`incidence`, `dense_system`), and PCG's node
sums are products with it on the card and sums in the reference's order
on the CPU (`node_sum`), so a solve is a function of its padded graph,
eager or replayed. Edges and nodes are fixed-capacity masked tensors;
`solve_padded` pads a growing graph to power-of-two buckets as the JAX
package does (here it only keeps shapes in a few sizes). The LM loop
runs eagerly, with accept/reject on device values and no host sync.

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
    (`torch.func.vmap` over `torch.func.jvp`), so each column is one
    batched pass over the edges rather than E per-edge ones."""
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
    # 0 where masked, even where a masked edge's residual is not finite.
    w = torch.where(graph.edge_mask,
                    graph.edge_weight * robust.huber_weight(r_norm, params.huber), 0.0)
    K = graph.node_mask.shape[0]
    free = graph.node_mask & (torch.arange(K, device=r.device) >= params.num_fixed)
    return w, free.to(r.dtype)


def _edge_system(R, t, graph: PoseGraph, params: PGParams):
    """Shared LM linearization: residuals, per-edge Jacobians, robust
    weights and the gauge/free mask. Used by both linear solvers."""
    ei, ej = graph.edge_i, graph.edge_j
    r, J = edge_jacobians(R[ei], t[ei], R[ej], t[ej], graph.R_ij, graph.t_ij)
    return (r, J) + robust_weights(r, graph, params)


def incidence(slots, K: int, dtype):
    """The one-hot (K, 2E) node-by-slot matrix of the edges' endpoint slots
    cat(ei, ej) (2E,): a product with it places or sums each slot's rows
    at its node in a fixed order, with no atomics."""
    return (torch.arange(K, device=slots.device)[:, None] == slots).to(dtype)


def node_sum(slots, K: int, dtype, ordered=None):
    """x (2E, ...) -> (K, ...): the rows of each node's slots summed in a
    fixed order, with no atomics and no host read, so a solve is a
    function of its padded graph. Unordered (the card's default): one
    product with the one-hot incidence, a fixed-shape GEMM. Ordered (the
    CPU's): each node's slots left to right in slot order -- its edges as
    node i, then as node j, each in edge order, the order of the
    reference's two scatter-adds -- through a stable sort by node and
    `torch.segment_reduce` (on an H100 that op synchronises with the host,
    and the PCG solve ran 1.36x slower with it). The CPU tests hold the
    PCG against the reference, and its 96 CG iterations carry a last-bit
    difference in a node's sum on to the final cost."""
    if not (slots.device.type == "cpu" if ordered is None else ordered):
        P = incidence(slots, K, dtype)
        return lambda x: (P @ x.reshape(x.shape[0], -1)).view((K,) + x.shape[1:])
    by_node, order = torch.sort(slots, stable=True)
    nodes = torch.arange(K, device=slots.device)
    counts = torch.searchsorted(by_node, nodes, right=True) - torch.searchsorted(by_node, nodes)
    return lambda x: torch.segment_reduce(x[order], "sum", lengths=counts, unsafe=True)


def _sides(r, J, w):
    """r (E, m) and the Jacobian's two sides (2, E, m, d), wrt node i and
    node j, with the edges of weight 0 (masked, padded) zeroed: in a
    product with the incidence they add nothing, not even a NaN."""
    E, m, d2 = J.shape
    live = (w != 0)[:, None]
    Js = torch.where(live[..., None], J, 0.0).view(E, m, 2, d2 // 2)
    return torch.where(live, r, 0.0), Js.permute(2, 0, 1, 3).contiguous()


def dense_system(r, J, w, ei, ej, K: int):
    """The undamped normal equations of a graph with d-DoF nodes (J: (E,
    m, 2d)) in the flat (dK x dK) layout: H = A^T W A and b = -A^T W r,
    with A (E m, K d) the edge Jacobians placed at their nodes' columns
    by the incidence. Parallel edges add up; no atomics."""
    E, m, d2 = J.shape
    d = d2 // 2
    r, Js = _sides(r, J, w)
    P = incidence(torch.cat([ei, ej]), K, J.dtype)
    A = torch.einsum("kse,seac->eakc", P.view(K, 2, E), Js)
    Aw = (A * w[:, None, None, None]).reshape(E * m, K * d)
    A = A.reshape(E * m, K * d)
    return Aw.T @ A, -(Aw.T @ r.reshape(E * m))


def dense_delta(r, J, w, f, lam, ei, ej, K: int):
    """LM step of a graph with d-DoF nodes from the dense (dK x dK) damped
    normal equations (`dense_system`); fixed nodes get identity rows and a
    zero step. Returns (K, d), non-finite entries zeroed."""
    d = J.shape[-1] // 2
    H, b = dense_system(r, J, w, ei, ej, K)
    # Damping + gauge freeze, on the diagonal of the flat system (the
    # reference adds lam * scale * I to each (d x d) diagonal block).
    diag = H.diagonal().view(K, d)
    diag_scale = diag.sum(-1) / float(d) + 1e-6
    diag.add_((lam * diag_scale)[:, None])
    fd = f[:, None].expand(K, d).reshape(K * d)
    H = H * fd[:, None] * fd[None, :]
    H.diagonal().add_(1.0 - fd)
    # solve_ex does not raise on a singular system; the NaN step is zeroed.
    delta, _ = torch.linalg.solve_ex(H, b * fd)
    return _finite_step(delta.reshape(K, d), f)


def pcg_system(r, J, w, ei, ej, K: int):
    """PCG's right-hand side b = -J^T W r (K, d), block diagonal D_kk =
    sum J^T W J (K, d, d), and the undamped matvec v -> J^T W J v (K, d):
    each a sum over the nodes' slots (`node_sum`), never H itself."""
    E, m, d2 = J.shape
    d = d2 // 2
    r, Js = _sides(r, J, w)
    slots = torch.cat([ei, ej])
    total = node_sum(slots, K, J.dtype)
    Jw = Js * w[:, None, None]
    b = -total(torch.einsum("seai,ea->sei", Jw, r).reshape(2 * E, d))
    D = total(torch.einsum("seai,seaj->seij", Jw, Js).reshape(2 * E, d, d))

    def jtwj(v):
        y = torch.einsum("seab,seb->sea", Js, v[slots].view(2, E, d))
        y = (y[0] + y[1]) * w[:, None]
        return total(torch.einsum("seab,ea->seb", Js, y).reshape(2 * E, d))

    return b, D, jtwj


def pcg_delta(r, J, w, f, lam, ei, ej, K: int, iters: int):
    """Matrix-free LM step: block-Jacobi-preconditioned CG on the edge
    list, `iters` iterations. Never materializes H: each matvec is one
    gather, two batched products over both sides of the E edges and one
    sum over the nodes' slots (`pcg_system`)."""
    d = J.shape[-1] // 2
    dtype, dev = J.dtype, J.device
    b, D, jtwj = pcg_system(r, J, w, ei, ej, K)

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
        out = jtwj(v) + damp[:, None] * v
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
