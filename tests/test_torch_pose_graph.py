"""The SE(3) pose graph of the port against viso_tpu's (CPU): residuals,
the forward-mode edge Jacobians against `jax.jacfwd`, and LM solves on
the dense and the PCG path."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.backend import pose_graph as j_pg
from viso_tpu_torch.backend import pose_graph as t_pg
from viso_tpu_torch.data.synthetic import so3_exp

torch.set_num_threads(2)


def _rel(Ra, ta, Rb, tb):
    R = Ra @ Rb.T
    return R, ta - R @ tb


def _loop_graph(rng, K=40, loops=((0, 39), (1, 38), (5, 30))):
    """A noisy odometry chain around a circle plus exact loop edges, and
    the drifted initial poses the chain integrates to."""
    Rs, ts = [], []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = so3_exp([0.0, ang, 0.0]).T
        c = np.array([2 * np.sin(ang), 0.0, -2 * np.cos(ang)])
        Rs.append(R.astype(np.float32))
        ts.append((-R @ c).astype(np.float32))
    edges = []
    for k in range(1, K):
        Rm, tm = _rel(Rs[k - 1], ts[k - 1], Rs[k], ts[k])
        Rm = so3_exp(rng.normal(0, 0.01, 3)) @ Rm
        tm = tm + rng.normal(0, 0.02, 3)
        edges.append((k - 1, k, Rm.astype(np.float32), tm.astype(np.float32), 1.0))
    for i, j in loops:
        Rm, tm = _rel(Rs[i], ts[i], Rs[j], ts[j])
        edges.append((i, j, Rm.astype(np.float32), tm.astype(np.float32), 2.0))
    pR, pt = [Rs[0]], [ts[0]]
    for _, _, Rm, tm, _ in edges[: K - 1]:
        Ri = Rm.T
        pR.append((Ri @ pR[-1]).astype(np.float32))
        pt.append((Ri @ pt[-1] - Ri @ tm).astype(np.float32))
    return pR, pt, edges


def test_edge_jacobians_match_jacfwd():
    """Forward-mode Jacobians of the left-perturbed residual equal
    jax.jacfwd's to 1e-5 (entries up to ~3.4; measured 5.3e-7), including
    masked padding edges with identity poses."""
    pR, pt, edges = _loop_graph(np.random.default_rng(0))
    gt, _ = t_pg.solve_padded(pR, pt, edges, t_pg.PGParams(iters=0), device="cpu")
    gj, _ = j_pg.solve_padded(pR, pt, edges, j_pg.PGParams(iters=0))
    ei, ej = gt.edge_i, gt.edge_j
    r, J = t_pg.edge_jacobians(gt.R[ei], gt.t[ei], gt.R[ej], gt.t[ej], gt.R_ij, gt.t_ij)
    assert J.shape == (64, 6, 12) and J.dtype == torch.float32
    zeros = jnp.zeros((gj.edge_i.shape[0], 12))
    Jj = jax.vmap(jax.jacfwd(j_pg._edge_residual_perturbed))(
        zeros, gj.R[gj.edge_i], gj.t[gj.edge_i], gj.R[gj.edge_j], gj.t[gj.edge_j],
        gj.R_ij, gj.t_ij)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-5)
    np.testing.assert_allclose(t_pg.residuals(gt).numpy(), np.asarray(j_pg.residuals(gj)),
                               atol=1e-6)
    np.testing.assert_allclose(float(t_pg.compute_cost(gt)), float(j_pg.compute_cost(gj)),
                               rtol=1e-5)


@pytest.mark.parametrize("solver,threshold", [("dense", 320), ("auto", 8), ("pcg", 320)])
def test_solve_matches_reference(solver, threshold):
    """25 LM iterations from the drifted chain: poses within 1e-4 of the
    JAX solve on the dense path and the PCG path (measured 1.4e-6), the
    same final cost to 1e-4 relative; the loop edges pull the chain back
    (cost falls ~87x)."""
    pR, pt, edges = _loop_graph(np.random.default_rng(1))
    params = dict(iters=25, solver=solver, pcg_threshold=threshold)
    out, info = t_pg.solve_padded(pR, pt, edges, t_pg.PGParams(**params), device="cpu")
    outj, infoj = j_pg.solve_padded(pR, pt, edges, j_pg.PGParams(**params))
    K = len(pR)
    np.testing.assert_allclose(out.R[:K].numpy(), np.asarray(outj.R)[:K], atol=1e-4)
    np.testing.assert_allclose(out.t[:K].numpy(), np.asarray(outj.t)[:K], atol=1e-4)
    np.testing.assert_allclose(float(info["final_cost"]), float(infoj["final_cost"]), rtol=1e-4)
    assert float(info["final_cost"]) < 0.05 * float(info["initial_cost"])
    assert info["cost_history"].shape == (25,)
    # The gauge node stays where it was.
    np.testing.assert_array_equal(out.R[0].numpy(), pR[0])


def test_bucketing_and_masked_padding():
    assert [t_pg._bucket(n) for n in (1, 16, 17, 320, 321)] == [16, 16, 32, 512, 512]
    pR, pt, edges = _loop_graph(np.random.default_rng(2), K=20, loops=((0, 19),))
    g, _ = t_pg.solve_padded(pR, pt, edges, t_pg.PGParams(iters=3), device="cpu")
    assert g.R.shape == (32, 3, 3) and g.edge_i.shape == (32,)
    assert int(g.node_mask.sum()) == 20 and int(g.edge_mask.sum()) == 20
    # Padding nodes are never moved.
    np.testing.assert_array_equal(g.R[20:].numpy(), np.tile(np.eye(3, dtype=np.float32), (12, 1, 1)))


@pytest.fixture
def routes(monkeypatch):
    """The LM's linear solver as it runs: "pcg" or "dense" for each call
    of `pcg_delta` / `dense_delta` (one per LM iteration)."""
    taken = []
    for name in ("pcg", "dense"):
        real = getattr(t_pg, f"{name}_delta")

        def noted(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(t_pg, f"{name}_delta", noted)
    return taken


def test_pcg_scales_to_2048_nodes(routes):
    """tests/test_ba.py::test_pose_graph_pcg_scales_to_2048_nodes on the
    port: a 2048-node circle of radius 20 m, exact sequential edges, 4
    loop edges, each node's initial pose moved by a 2e-4 twist. The auto
    solver routes to PCG (8 LM iterations of 128 CG iterations, no dense
    step), the cost falls below 0.2 of its start and the worst rotation
    error below the initial one's, as the reference asserts (its errors
    in float64)."""
    from viso_tpu_torch.geometry import se3

    rng = np.random.default_rng(0)
    K = 2048
    ang = 2 * np.pi * np.arange(K) / K
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = 20 * np.sin(ang), 20 * (1 - np.cos(ang)), ang
    R_true, t_true = se3.se3_exp(torch.from_numpy(xi))
    ei = list(range(K - 1)) + [0, 1, 2, 3]
    ej = list(range(1, K)) + [K - 4, K - 3, K - 2, K - 1]
    R_ij, t_ij = se3.relative(R_true[ei], t_true[ei], R_true[ej], t_true[ej])
    # The reference's draws, node 1 to K - 1 in turn; node 0 is the gauge.
    dR, dt = se3.se3_exp(torch.from_numpy(rng.normal(0, 2e-4, (K - 1, 6)).astype(np.float32)))
    R0, t0 = se3.compose(dR, dt, R_true[1:], t_true[1:])
    R0, t0 = torch.cat([R_true[:1], R0]), torch.cat([t_true[:1], t0])
    E = len(ei)
    graph = t_pg.PoseGraph(R=R0, t=t0, node_mask=torch.ones(K, dtype=torch.bool),
                           edge_i=torch.tensor(ei), edge_j=torch.tensor(ej), R_ij=R_ij,
                           t_ij=t_ij, edge_weight=torch.ones(E), edge_mask=torch.ones(E, dtype=torch.bool))
    params = t_pg.PGParams(iters=8, pcg_iters=128)
    assert params.solver == "auto" and K > params.pcg_threshold
    out, info = t_pg.solve(graph, params)
    assert routes == ["pcg"] * 8
    assert float(info["final_cost"]) < float(info["initial_cost"]) * 0.2

    def rot_errors(R):
        """Degrees, in float64: a float32 trace resolves 0.02 degrees, the
        size of the initial errors."""
        dR = torch.einsum("kij,klj->kil", R.double(), R_true.double())
        return np.degrees(np.arccos(np.clip((torch.einsum("kii->k", dR).numpy() - 1) / 2, -1, 1)))

    assert rot_errors(out.R)[1:].max() < rot_errors(graph.R)[1:].max()


def test_cached_solve_routes_to_pcg_at_bucket_512_like_reference(routes):
    """A 300-node graph shaped like the 2048-node one above (exact
    sequential edges, 4 loop edges, a drifting start: `synthetic.
    ring_graph`) through the loop layer's path, `solve_padded(...,
    programs=Cache("cpu"))`, with the loop layer's parameters (25 LM
    iterations of 96 CG iterations): its program is the (512, 512)
    bucket's, every LM iteration takes the PCG route, and poses lie within
    1e-4 of the JAX package's `solve_padded` (the PCG tolerance above;
    measured 7.6e-6), the final cost within 1e-4 relative.

    On the noisy chain above (`_loop_graph` at 300 nodes, 4 loop edges)
    the packages part by 1.1e-4 in R and 2.4e-4 in t: after 96 CG
    iterations each stops 5e-4-7e-4 m from the dense solve's optimum, in a
    valley where the cost (0.002005 in both) no longer tells them apart."""
    from viso_tpu_torch.data.synthetic import ring_graph
    from viso_tpu_torch.slam import programs

    (pR, pt, edges), _ = ring_graph(300, seed=3)
    cache = programs.Cache("cpu")
    out, info = t_pg.solve_padded(pR, pt, edges, t_pg.PGParams(iters=25), device="cpu",
                                  programs=cache)
    outj, infoj = j_pg.solve_padded(pR, pt, edges, j_pg.PGParams(iters=25))
    assert [k[:3] for k in cache.programs] == [("pose_graph", 512, 512)]
    assert routes == ["pcg"] * 25
    K = len(pR)
    np.testing.assert_allclose(out.R[:K].numpy(), np.asarray(outj.R)[:K], atol=1e-4)
    np.testing.assert_allclose(out.t[:K].numpy(), np.asarray(outj.t)[:K], atol=1e-4)
    np.testing.assert_allclose(float(info["final_cost"]), float(infoj["final_cost"]), rtol=1e-4)
    assert float(info["final_cost"]) < 1e-4 * float(info["initial_cost"])


# -- the normal equations' assembly ------------------------------------------


def reference_assembly(r, J, w, ei, ej, K, v):
    """The JAX package's assembly by `.at[].add` (`_gn_step`,
    `_gn_step_pcg`), for d-DoF nodes (J: (E, m, 2d)): the undamped dense
    H in the flat (dK x dK) layout and its b, PCG's b and block diagonal
    D, and the undamped matvec J^T W J v."""
    r, J, w, ei, ej, v = (jnp.asarray(x) for x in (r, J, w, ei, ej, v))
    d = J.shape[-1] // 2
    Ji, Jj = J[..., :d], J[..., d:]
    Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
    H = jnp.zeros((K, K, d, d), J.dtype)
    H = H.at[ei, ei].add(jnp.einsum("eai,eaj->eij", Jiw, Ji))
    H = H.at[ej, ej].add(jnp.einsum("eai,eaj->eij", Jjw, Jj))
    H = H.at[ei, ej].add(jnp.einsum("eai,eaj->eij", Jiw, Jj))
    H = H.at[ej, ei].add(jnp.einsum("eai,eaj->eij", Jjw, Ji))
    b = jnp.zeros((K, d), J.dtype)
    b = b.at[ei].add(-jnp.einsum("eai,ea->ei", Jiw, r))
    b = b.at[ej].add(-jnp.einsum("eai,ea->ei", Jjw, r))
    D = jnp.zeros((K, d, d), J.dtype)
    D = D.at[ei].add(jnp.einsum("eai,eaj->eij", Jiw, Ji))
    D = D.at[ej].add(jnp.einsum("eai,eaj->eij", Jjw, Jj))
    y = (jnp.einsum("eab,eb->ea", Ji, v[ei]) + jnp.einsum("eab,eb->ea", Jj, v[ej])) * w[:, None]
    hv = jnp.zeros((K, d), J.dtype)
    hv = hv.at[ei].add(jnp.einsum("eab,ea->eb", Ji, y))
    hv = hv.at[ej].add(jnp.einsum("eab,ea->eb", Jj, y))
    return dict(H=H.transpose(0, 2, 1, 3).reshape(d * K, d * K), b_dense=b.reshape(-1),
                b=b, D=D, hv=hv)


def port_assembly(pg, r, J, w, ei, ej, K, v, route):
    """The port's assembly of the same quantities on one route: "dense",
    "pcg" (the CPU's ordered node sums) or "pcg-product" (the card's
    one-hot products, here on the CPU)."""
    if route == "dense":
        H, b = pg.dense_system(r, J, w, ei, ej, K)
        return dict(H=H, b_dense=b)
    node_sum = functools.partial(pg.node_sum, ordered=route == "pcg")
    with mock.patch.object(pg, "node_sum", node_sum):
        b, D, jtwj = pg.pcg_system(r, J, w, ei, ej, K)
        return dict(b=b, D=D, hv=jtwj(v))


def check_assembly(pg, r, J, w, ei, ej, K, route):
    """The port's assembly on `route` against the reference's, each
    quantity to 1e-5 of its largest entry."""
    v = torch.tensor(np.random.default_rng(7).normal(size=(K, J.shape[-1] // 2)),
                     dtype=torch.float32)
    ref = reference_assembly(r.numpy(), J.numpy(), w.numpy(), ei.numpy(), ej.numpy(), K,
                             v.numpy())
    got = port_assembly(pg, r, J, w, ei, ej, K, v, route)
    for name, x in got.items():
        want = np.asarray(ref[name])
        assert x.shape == want.shape and x.dtype == torch.float32, name
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(x.numpy() - want).max() <= 1e-5 * scale, name


def _assembly_graph():
    """`_loop_graph` (40 nodes padded to 64, 42 edges padded to 64) with
    two edges parallel to odometry edges (one each way) and one real edge
    masked; the masked edge's measurement is finite garbage, so the
    reference's assembly is finite too."""
    pR, pt, edges = _loop_graph(np.random.default_rng(2))
    i, j, Rm, tm, _ = edges[10]
    edges.append((i, j, (so3_exp([0.02, 0.0, 0.01]) @ Rm).astype(np.float32), tm + 0.05, 3.0))
    edges.append((j, i, Rm.T.copy(), (-Rm.T @ tm).astype(np.float32), 0.5))
    edges.append((3, 20, np.eye(3, dtype=np.float32), np.full(3, 7.0, np.float32), 1.0))
    gt = t_pg.pad_graph(pR, pt, edges, device="cpu")
    gj, _ = j_pg.solve_padded(pR, pt, edges, j_pg.PGParams(iters=0))
    masked = len(edges) - 1
    gt = gt._replace(edge_mask=gt.edge_mask.clone().index_fill_(0, torch.tensor(masked), False))
    gj = gj._replace(edge_mask=gj.edge_mask.at[masked].set(False))
    return gt, gj, masked


@pytest.mark.parametrize("route", ["dense", "pcg", "pcg-product"])
def test_assembly_matches_reference(route):
    """The dense H and b, PCG's b and D and one matvec, summed without
    atomics (`dense_system`, `pcg_system`), against the JAX package's
    `.at[].add` assembly of the same linearization (the reference's
    residuals, Jacobians and weights) on a graph with parallel edges, a
    masked edge, padded edges and padded nodes: to 1e-5 of each
    quantity's largest entry."""
    _, gj, _ = _assembly_graph()
    K = gj.R.shape[0]
    r, J, w, _ = (torch.tensor(np.asarray(x)) for x in
                  j_pg._edge_system(gj.R, gj.t, gj, j_pg.PGParams()))
    assert float(w[~torch.tensor(np.asarray(gj.edge_mask))].abs().max()) == 0.0
    check_assembly(t_pg, r, J, w, torch.tensor(np.asarray(gj.edge_i)),
                   torch.tensor(np.asarray(gj.edge_j)), K, route)


@pytest.mark.parametrize("ordered", [True, False])
def test_node_sum_against_scatter_add(ordered):
    """`node_sum` of the assembly graph's slot rows against the JAX
    package's `.at[].add` of the same rows: the ordered sum (the CPU's)
    bit for bit, the one-hot product (the card's) to 1e-6 of the largest
    entry; the dead slots' rows (masked and padded edges) zero, as they
    are in an assembly."""
    gt, _, _ = _assembly_graph()
    K = gt.R.shape[0]
    w = gt.edge_weight * gt.edge_mask
    slots = torch.cat([gt.edge_i, gt.edge_j])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(slots.shape[0], 6)) * np.exp(rng.normal(size=(slots.shape[0], 1)) * 3)
    x = torch.tensor(x, dtype=torch.float32) * (torch.cat([w, w]) != 0)[:, None]
    got = t_pg.node_sum(slots, K, torch.float32, ordered)(x)
    want = np.asarray(jnp.zeros((K, 6), jnp.float32).at[jnp.asarray(slots.numpy())].add(
        jnp.asarray(x.numpy())))
    if ordered:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("route", ["dense", "pcg", "pcg-product"])
def test_masked_edges_add_nothing(route):
    """A masked edge whose measurement is not finite (its residual and
    Jacobian NaN) adds nothing to the port's assembly, not even a NaN: the
    same sums, bit for bit, as with a finite measurement there."""
    gt, _, masked = _assembly_graph()
    K = gt.R.shape[0]
    bad = gt._replace(t_ij=gt.t_ij.clone().index_fill_(0, torch.tensor(masked), float("nan")))
    v = torch.ones((K, 6))
    out = []
    for g in (gt, bad):
        r, J, w, _ = t_pg._edge_system(g.R, g.t, g, t_pg.PGParams())
        out.append(port_assembly(t_pg, r, J, w, g.edge_i, g.edge_j, K, v, route))
    assert not torch.isfinite(t_pg._edge_system(bad.R, bad.t, bad, t_pg.PGParams())[1]).all()
    for name in out[0]:
        assert torch.isfinite(out[1][name]).all(), name
        assert torch.equal(out[0][name], out[1][name]), name


@pytest.mark.parametrize("name", ["pose_graph.py", "pose_graph_sim3.py"])
def test_no_atomic_assembly_in_sources(name):
    """The pose graphs' sources hold no scatter-add: no `index_add`,
    `index_put(..., accumulate=True)`, `scatter_add` or `scatter_reduce`,
    whose CUDA kernels sum with atomics in no fixed order."""
    import ast
    import pathlib

    src = (pathlib.Path(t_pg.__file__).parent / name).read_text()
    calls = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Call)]
    names = {n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", "")
             for n in calls}
    assert not names & {"index_add", "index_add_", "scatter_add", "scatter_add_",
                        "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"}
    assert not [n for n in calls if any(k.arg == "accumulate" for k in n.keywords)]
    for word in ("index_add", "scatter_add", "accumulate=True", "use_deterministic_algorithms"):
        assert word not in src, word
