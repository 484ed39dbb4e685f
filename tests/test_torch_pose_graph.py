"""The SE(3) pose graph of the port against viso_tpu's (CPU): residuals,
the forward-mode edge Jacobians against `jax.jacfwd`, and LM solves on
the dense and the PCG path."""

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
