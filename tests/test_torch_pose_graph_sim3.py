"""The Sim(3) pose graph of the port (viso_tpu_torch.backend.
pose_graph_sim3) against viso_tpu's, on the CPU: residuals and cost, the
forward-mode (E, 7, 14) Jacobians against `jax.jacfwd` (float32), LM
solves on the dense and the PCG path on tests/test_loop.py's scale-drift
problems (with that file's own bounds on the port's answers), and the
numpy cold start."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.backend import pose_graph_sim3 as j_pgs
from viso_tpu_torch.backend import pose_graph_sim3 as t_pgs
from viso_tpu_torch.data.synthetic import so3_exp
from viso_tpu_torch.geometry import sim3

torch.set_num_threads(2)


def drift_problem(K, drift_rate, n_loops=1, radius=10.0, noise=None):
    """tests/test_loop.py's `_sim3_drift_problem` (numpy): a circle with a
    per-step scale drift, scale-blind odometry edges (s = 1), `n_loops`
    loop edges with the true relative similarity, and the odometry chain
    integrated as the initial guess. `noise` (an rng) perturbs the
    odometry edges, so the residuals at the initial guess are not zero."""
    drift = drift_rate ** np.arange(K)
    R_gt, t_gt = [], []
    for th in np.linspace(0, 2 * np.pi, K, endpoint=False):
        c, s = np.cos(th), np.sin(th)
        Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        center = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))], np.float32)
        R_gt.append(Rwc)
        t_gt.append(-Rwc @ center)
    loc = [(float(drift[k]), R_gt[k], (drift[k] * t_gt[k]).astype(np.float32))
           for k in range(K)]

    def rel(a, b):
        return sim3.compose(*a, *sim3.inverse(*b))

    edges = []
    for k in range(1, K):
        _, R_r, t_r = rel(loc[k - 1], loc[k])
        if noise is not None:
            R_r = so3_exp(noise.normal(0, 0.01, 3)) @ R_r
            t_r = t_r + noise.normal(0, 0.05, 3)
        edges.append((k - 1, k, 1.0, R_r.astype(np.float32), t_r.astype(np.float32), 1.0))
    for li in range(n_loops):
        i, j = li, K - 1 - li
        s_r, R_r, t_r = rel(loc[i], loc[j])
        edges.append((i, j, float(s_r), R_r.astype(np.float32), t_r.astype(np.float32), 10.0))
    pg_s, pg_R, pg_t = [1.0], [R_gt[0]], [t_gt[0]]
    for k in range(1, K):
        sk, Rk, tk = sim3.compose(*sim3.inverse(1.0, edges[k - 1][3], edges[k - 1][4]),
                                  pg_s[-1], pg_R[-1], pg_t[-1])
        pg_s.append(float(sk))
        pg_R.append(Rk.astype(np.float32))
        pg_t.append(tk.astype(np.float32))
    return edges, pg_s, pg_R, pg_t, drift, (R_gt, t_gt)


def centers(s, R, t):
    """Metric camera centres c = -(1/s) R^T t (numpy)."""
    s, R, t = (np.asarray(x, np.float64) for x in (s, R, t))
    return -np.einsum("kji,kj->ki", R, t) / s[:, None]


def _graphs(K=24, seed=0, params=None):
    edges, pg_s, pg_R, pg_t, _, _ = drift_problem(K, 1.01, n_loops=2,
                                                  noise=np.random.default_rng(seed))
    gt, _ = t_pgs.solve_padded(pg_s, pg_R, pg_t, edges, t_pgs.PGParams(iters=0), device="cpu")
    gj, _ = j_pgs.solve_padded(pg_s, pg_R, pg_t, edges, j_pgs.PGParams(iters=0))
    return gt, gj


def test_residuals_and_cost_match_reference():
    """Residuals to 1e-5 (entries up to ~3.2; measured 3.8e-6), the robust
    cost to 1e-5 relative, masked padding edges zero."""
    gt, gj = _graphs()
    r = t_pgs.residuals(gt)
    assert r.shape == (32, 7) and r.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), np.asarray(j_pgs.residuals(gj)), atol=1e-5)
    assert float(torch.abs(r[~gt.edge_mask]).max()) == 0.0
    assert float(torch.abs(r).max()) > 0.05
    np.testing.assert_allclose(float(t_pgs.compute_cost(gt)), float(j_pgs.compute_cost(gj)),
                               rtol=1e-5)


def test_edge_jacobians_match_jacfwd():
    """(E, 7, 14) forward-mode Jacobians of the left-perturbed residual
    equal jax.jacfwd's to 1e-4 (entries up to ~12 through the scale
    weight and the 10 m circle; measured 3.8e-6), in float32 -- the
    scale-weight row and log(s) would promote the tangents to float64 if
    they met a Python float -- including masked padding edges with
    identity nodes."""
    gt, gj = _graphs()
    ei, ej = gt.edge_i, gt.edge_j
    r, J = t_pgs.edge_jacobians(gt.s[ei], gt.R[ei], gt.t[ei], gt.s[ej], gt.R[ej], gt.t[ej],
                                gt.s_ij, gt.R_ij, gt.t_ij, 5.0)
    assert J.shape == (32, 7, 14) and J.dtype == torch.float32 and r.dtype == torch.float32

    def res(xi2, si, Ri, ti, sj, Rj, tj, s_ij, R_ij, t_ij):
        return j_pgs._edge_residual_perturbed(xi2, si, Ri, ti, sj, Rj, tj, s_ij, R_ij, t_ij,
                                              5.0)

    i, j = gj.edge_i, gj.edge_j
    Jj = jax.vmap(jax.jacfwd(res))(jnp.zeros((32, 14)), gj.s[i], gj.R[i], gj.t[i], gj.s[j],
                                   gj.R[j], gj.t[j], gj.s_ij, gj.R_ij, gj.t_ij)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-4, rtol=1e-5)
    assert float(torch.abs(J).max()) > 10.0


@pytest.mark.parametrize("solver,threshold", [("dense", 320), ("auto", 8), ("pcg", 320)])
def test_solve_corrects_scale_drift_like_reference(solver, threshold):
    """tests/test_loop.py::test_sim3_pose_graph_corrects_scale_drift on
    both packages (60 nodes, 0.5 % scale drift per step, one loop edge),
    dense and PCG (192 CG iterations, as the reference's PCG test):
    node scales within 1e-4 and metric centres within 1e-2 m of the JAX
    solve (measured 1.2e-5 and 3.4e-3 m on a 10 m circle, float32); the
    port meets that test's bounds (cost falls 20x, end scale within 3 %
    of the true drift, centre error below 0.3 of the odometry's)."""
    K = 60
    edges, pg_s, pg_R, pg_t, drift, (R_gt, t_gt) = drift_problem(K, 1.005)
    params = dict(iters=30, solver=solver, pcg_threshold=threshold, pcg_iters=192)
    out, info = t_pgs.solve_padded(pg_s, pg_R, pg_t, edges, t_pgs.PGParams(**params),
                                   device="cpu")
    outj, infoj = j_pgs.solve_padded(pg_s, pg_R, pg_t, edges, j_pgs.PGParams(**params))
    s_out = out.s[:K].numpy()
    c_out = centers(s_out, out.R[:K].numpy(), out.t[:K].numpy())
    c_j = centers(np.asarray(outj.s)[:K], np.asarray(outj.R)[:K], np.asarray(outj.t)[:K])
    np.testing.assert_allclose(s_out, np.asarray(outj.s)[:K], atol=1e-4)
    assert np.abs(c_out - c_j).max() < 1e-2
    assert info["cost_history"].shape == (30,)
    assert float(info["final_cost"]) < 0.05 * float(info["initial_cost"])
    assert abs(s_out[-1] - drift[-1]) < 0.03 * drift[-1], (s_out[-1], drift[-1])
    c_gt = centers(np.ones(K), R_gt, t_gt)
    err_init = np.linalg.norm(centers(pg_s, pg_R, pg_t) - c_gt, axis=-1).max()
    err_out = np.linalg.norm(c_out - c_gt, axis=-1).max()
    assert err_out < 0.3 * err_init, (err_init, err_out)
    # The gauge node does not move.
    assert float(out.s[0]) == 1.0
    np.testing.assert_array_equal(out.R[0].numpy(), pg_R[0])


def test_cold_start_init_matches_reference():
    """The numpy cold start on both packages (256 nodes, 4 loop edges,
    one sequential edge removed as a placeholder gap): scales to 1e-6
    relative, poses to 1e-4."""
    edges, pg_s, pg_R, pg_t, _, _ = drift_problem(256, 1.002, n_loops=4, radius=20.0)
    edges = [e for e in edges if e[:2] != (99, 100)]
    s_t, R_t, t_t = t_pgs.cold_start_init(pg_s, pg_R, pg_t, edges)
    s_j, R_j, t_j = j_pgs.cold_start_init(pg_s, pg_R, pg_t, edges)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
    np.testing.assert_allclose(np.stack(R_t), np.stack(R_j), atol=1e-4)
    np.testing.assert_allclose(np.stack(t_t), np.stack(t_j), atol=1e-4)
    assert max(s_t) / min(s_t) > 1.2


def test_pcg_scales_to_2048_nodes():
    """tests/test_loop.py::test_sim3_pcg_scales_to_2048_nodes on the port:
    the auto solver routes a 2048-node graph to PCG after the cold start,
    the end-node scale lands within 10 % of the true drift and the centre
    error below 0.2 of the scale-blind odometry's."""
    K = 2048
    edges, pg_s, pg_R, pg_t, drift, (R_gt, t_gt) = drift_problem(K, 1.0005, n_loops=4,
                                                                 radius=40.0)
    s0, R0, t0 = t_pgs.cold_start_init(pg_s, pg_R, pg_t, edges)
    params = t_pgs.PGParams(iters=12, pcg_iters=256)
    assert params.solver == "auto" and K > params.pcg_threshold
    out, _ = t_pgs.solve_padded(s0, R0, t0, edges, params, device="cpu")
    s_out = out.s[:K].numpy()
    assert abs(s_out[-1] - drift[-1]) < 0.1 * drift[-1], (s_out[-1], drift[-1])
    c_gt = centers(np.ones(K), R_gt, t_gt)
    e0 = np.linalg.norm(centers(pg_s, pg_R, pg_t) - c_gt, axis=-1).max()
    e1 = np.linalg.norm(centers(s_out, out.R[:K].numpy(), out.t[:K].numpy()) - c_gt,
                        axis=-1).max()
    assert e1 < 0.2 * e0, (e0, e1)


def test_cached_solve_routes_to_pcg_at_bucket_512_like_reference(monkeypatch):
    """A 300-node Sim(3) graph shaped like the 2048-node one above (exact
    sequential edges with the true scale ratios, 4 loop edges, a drifting
    start in pose and scale: `synthetic.ring_graph`) through the loop
    layer's path, `solve_padded(..., programs=Cache("cpu"))`, with the loop
    layer's parameters (25 LM iterations of 96 CG iterations): its program
    is the (512, 512) bucket's, every LM iteration takes the PCG route, and
    node scales lie within 1e-4 and metric centres within 1e-2 m of the JAX
    package's `solve_padded` (this file's PCG tolerances; measured 1.5e-6
    and 8.7e-6 m)."""
    from viso_tpu_torch.backend import pose_graph as t_pg
    from viso_tpu_torch.data.synthetic import ring_graph
    from viso_tpu_torch.slam import programs

    routes = []
    for name in ("pcg", "dense"):
        real = getattr(t_pg, f"{name}_delta")

        def noted(*a, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(t_pg, f"{name}_delta", noted)
    K = 300
    args, _ = ring_graph(K, sim3=True, seed=3)
    cache = programs.Cache("cpu")
    out, info = t_pgs.solve_padded(*args, t_pgs.PGParams(), device="cpu", programs=cache)
    outj, infoj = j_pgs.solve_padded(*args, j_pgs.PGParams())
    assert [k[:3] for k in cache.programs] == [("pose_graph_sim3", 512, 512)]
    assert routes == ["pcg"] * 25
    s_out = out.s[:K].numpy()
    np.testing.assert_allclose(s_out, np.asarray(outj.s)[:K], atol=1e-4)
    c_j = centers(np.asarray(outj.s)[:K], np.asarray(outj.R)[:K], np.asarray(outj.t)[:K])
    assert np.abs(centers(s_out, out.R[:K].numpy(), out.t[:K].numpy()) - c_j).max() < 1e-2
    assert float(info["final_cost"]) < 1e-4 * float(info["initial_cost"])


def _assembly_graph():
    """tests/test_loop.py's drift problem at 24 nodes (padded to 32) with
    two edges parallel to odometry edges (one each way) and one real edge
    masked, its measurement finite garbage (27 edges padded to 32)."""
    edges, pg_s, pg_R, pg_t, _, _ = drift_problem(24, 1.01, n_loops=2,
                                                  noise=np.random.default_rng(3))
    i, j, s_m, Rm, tm, _ = edges[6]
    edges.append((i, j, s_m * 1.02, (so3_exp([0.0, 0.02, 0.01]) @ Rm).astype(np.float32),
                  tm + 0.05, 4.0))
    si, Ri, ti = sim3.inverse(s_m, Rm, tm)
    edges.append((j, i, float(si), Ri.astype(np.float32), ti.astype(np.float32), 0.5))
    edges.append((2, 15, 3.0, np.eye(3, dtype=np.float32), np.full(3, 7.0, np.float32), 1.0))
    gt = t_pgs.pad_graph(pg_s, pg_R, pg_t, edges, device="cpu")
    gj, _ = j_pgs.solve_padded(pg_s, pg_R, pg_t, edges, j_pgs.PGParams(iters=0))
    masked = len(edges) - 1
    gt = gt._replace(edge_mask=gt.edge_mask.clone().index_fill_(0, torch.tensor(masked), False))
    gj = gj._replace(edge_mask=gj.edge_mask.at[masked].set(False))
    return gt, gj, masked


@pytest.mark.parametrize("route", ["dense", "pcg", "pcg-product"])
def test_assembly_matches_reference(route):
    """tests/test_torch_pose_graph.py's assembly check with 7-DoF nodes:
    the dense H and b, PCG's b and D and one matvec, summed without atomics,
    against the JAX package's `.at[].add` assembly of its own Sim(3)
    linearization, on a graph with parallel, masked and padded edges and
    padded nodes, to 1e-5 of each quantity's largest entry."""
    from test_torch_pose_graph import check_assembly

    _, gj, _ = _assembly_graph()
    K = gj.R.shape[0]
    r, J, w, _ = (torch.tensor(np.asarray(x)) for x in
                  j_pgs._edge_system(gj.s, gj.R, gj.t, gj, j_pgs.PGParams(), K))
    assert J.shape[1:] == (7, 14)
    check_assembly(t_pgs.pose_graph, r, J, w, torch.tensor(np.asarray(gj.edge_i)),
                   torch.tensor(np.asarray(gj.edge_j)), K, route)


@pytest.mark.parametrize("route", ["dense", "pcg", "pcg-product"])
def test_masked_edges_add_nothing(route):
    """A masked Sim(3) edge whose measured scale is NaN adds nothing to the
    assembly, not even a NaN: bit-equal to a finite measurement there."""
    from test_torch_pose_graph import port_assembly

    gt, _, masked = _assembly_graph()
    K = gt.R.shape[0]
    bad = gt._replace(s_ij=gt.s_ij.clone().index_fill_(0, torch.tensor(masked), float("nan")))
    v = torch.ones((K, 7))
    out = []
    for g in (gt, bad):
        r, J, w, _ = t_pgs._edge_system(g.s, g.R, g.t, g, t_pgs.PGParams())
        assert torch.isfinite(J).all() == (g is gt)
        out.append(port_assembly(t_pgs.pose_graph, r, J, w, g.edge_i, g.edge_j, K, v, route))
    for name in out[0]:
        assert torch.isfinite(out[1][name]).all(), name
        assert torch.equal(out[0][name], out[1][name]), name
