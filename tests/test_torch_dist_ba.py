"""The port's landmark-sharded window BA (`viso_tpu_torch/parallel/`)
against the JAX package's `dist_ba` and against the port's single-device
solve, on the CPU.

World size 1 (no process group) runs in this process; larger worlds are
spawned gloo ranks (`tools/multiprocess_ba.launch`: one thread each, a
60 s group timeout, killed past 120 s). Inputs come from numpy seeds:
`tests/test_ba.py::synthetic_window`, built once and handed to every
rank. Tolerances are those of tests/test_dist_ba.py (a sharded solve sums
in another order than a single-device one): R 1e-4, t 1e-3, points 1e-2,
final cost 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from viso_tpu.backend import ba as j_ba
from viso_tpu.parallel import dist_ba as j_dist
from viso_tpu.parallel import mesh as j_mesh
from viso_tpu_torch.backend import ba
from viso_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from viso_tpu_torch.tools import multiprocess_ba

from tests.test_ba import pose_errors, synthetic_window

torch.set_num_threads(2)

R_TOL, T_TOL, P_TOL, COST_RTOL = 1e-4, 1e-3, 1e-2, 1e-3


def _arrays(prob_j) -> dict:
    return {k: np.asarray(getattr(prob_j, k)) for k in ("R", "t", "points", "obs_uv", "obs_mask")}


def _port(prob_j):
    return multiprocess_ba.problem_from_numpy(_arrays(prob_j), "cpu")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("C,L", [(5, 96), (4, 61), (16, 300)])
def test_world_one_sharded_solve_is_bit_equal(rng, C, L):
    """No process group: no padding, an identity reduction, and the
    result of `ba.solve_impl` bit for bit."""
    prob = _port(synthetic_window(rng, C=C, L=L)[0])
    params = ba.BAParams(iters=10, num_fixed=2)
    out_1, info_1 = ba.solve_impl(prob, params)
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    out_s, info_s = dist_ba.solve_sharded(prob, params, mesh)
    for name in ("R", "t", "points"):
        assert torch.equal(getattr(out_s, name), getattr(out_1, name)), name
    for key in info_1:
        assert torch.equal(info_s[key], info_1[key]), key


def test_four_gloo_ranks_match_jax_eight_devices(rng):
    """The JAX package's solve_sharded on its 8 virtual devices against the
    port over 4 spawned gloo ranks, and against the port's single solve;
    every rank ends with the same solution."""
    prob_j, _ = synthetic_window(rng, C=5, L=96)
    params_j = j_ba.BAParams(iters=10, num_fixed=2)
    out_j, info_j = j_dist.solve_sharded(prob_j, params_j, j_mesh.make_mesh())
    ranks = multiprocess_ba.launch(multiprocess_ba.ba_rank, 4, args=(_arrays(prob_j), 10, 2),
                                   device="cpu")
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3] and {r["world"] for r in ranks} == {4}
    for r in ranks:
        _close(r["R"], out_j.R, R_TOL)
        _close(r["t"], out_j.t, T_TOL)
        _close(r["points"], out_j.points, P_TOL)
        np.testing.assert_allclose(r["final_cost"], float(info_j["final_cost"]), rtol=COST_RTOL)
        assert r["num_obs"] == int(info_j["num_obs"])
        _close(r["R"], r["local_R"], R_TOL)
        _close(r["t"], r["local_t"], T_TOL)
        _close(r["points"], r["local_points"], P_TOL)
        np.testing.assert_allclose(r["final_cost"], r["local_final_cost"], rtol=COST_RTOL)
        for key in ("R", "t", "points"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
        assert r["final_cost"] == ranks[0]["final_cost"]
        # 2 reductions per LM iteration plus the initial and final cost's,
        # each of the sizes the reference psums; one point gather.
        loop = r["sizes"][1:-1]
        assert r["sizes"][0] == r["sizes"][-1] == 8 and len(loop) == 2 * 10
        assert sum(loop) == 10 * j_dist.psum_bytes_per_iter(5)
        assert r["gather_bytes"] == 96 * 3 * 4


def test_padding_over_two_ranks(rng):
    """61 landmarks over 2 ranks: one padded slot, stripped from the
    result; the solve converges and agrees with the single solve."""
    prob_j, (R_true, t_true, _) = synthetic_window(rng, C=4, L=61)
    ranks = multiprocess_ba.launch(multiprocess_ba.ba_rank, 2, args=(_arrays(prob_j), 6, 2),
                                   device="cpu")
    for r in ranks:
        assert r["points"].shape == (61, 3)
        assert r["final_cost"] < r["initial_cost"]
        assert pose_errors(r["R"], r["t"], R_true, t_true)[2:, 0].max() < 0.5
        np.testing.assert_allclose(r["final_cost"], r["local_final_cost"], rtol=COST_RTOL)
        _close(r["points"], r["local_points"], P_TOL)
    np.testing.assert_array_equal(ranks[0]["points"], ranks[1]["points"])


@pytest.mark.parametrize("L,multiple", [(61, 8), (64, 8), (96, 4), (5, 3)])
def test_pad_landmarks_matches_jax(rng, L, multiple):
    prob_j, _ = synthetic_window(rng, C=3, L=L)
    prob_j = prob_j._replace(point_mask=jnp.asarray(rng.uniform(size=L) > 0.2))
    pj = j_dist.pad_landmarks(prob_j, multiple)
    pt = dist_ba.pad_landmarks(_port(prob_j)._replace(point_mask=torch.from_numpy(
        np.asarray(prob_j.point_mask))), multiple)
    for name in ("R", "t", "points", "obs_uv", "obs_mask", "point_mask"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))


@pytest.mark.parametrize("C", [5, 16])
def test_bytes_and_calls_per_iteration(rng, C):
    """What the solver hands `all_reduce` per LM iteration: exactly
    PSUMS_PER_ITER calls of psum_bytes_per_iter(C) bytes, the JAX
    package's numbers (39,948 bytes at C=16)."""
    assert dist_ba.PSUMS_PER_ITER == j_dist.PSUMS_PER_ITER == 2
    assert dist_ba.psum_bytes_per_iter(C) == j_dist.psum_bytes_per_iter(C)
    assert dist_ba.psum_bytes_per_iter(16) == 39_948
    assert dist_ba.psum_bytes_per_iter(8) == 10_764
    prob = _port(synthetic_window(rng, C=C, L=40)[0])
    iters = 3
    params = ba.BAParams(iters=iters, num_fixed=2)
    solver = dist_ba.make_sharded_solver(mesh_mod.make_mesh(device="cpu"), params)
    solver(prob)
    calls, nbytes, ms = solver.stats.per_iter(iters)
    assert (calls, nbytes, ms) == (2, dist_ba.psum_bytes_per_iter(C), None)
    assert solver.stats.calls == 2 * iters + 2
    fused = 4 * (C * 36 + C * 6 + C * C * 36 + C * 6 + 1)
    assert solver.stats.sizes[1:-1] == [fused, 8] * iters


def test_solver_cached():
    """tests/test_dist_engine.py's check: one solver per (mesh, params),
    reused, another for other params."""
    mesh = mesh_mod.make_mesh(device="cpu")
    params = ba.BAParams(iters=2)
    s1 = dist_ba.make_sharded_solver(mesh, params)
    assert dist_ba.make_sharded_solver(mesh, params) is s1
    assert dist_ba.make_sharded_solver(mesh_mod.make_mesh(device="cpu"), params) is s1
    assert dist_ba.make_sharded_solver(mesh, ba.BAParams(iters=3)) is not s1


def test_make_mesh_and_blocks():
    for n in (None, 0, 1):
        assert mesh_mod.make_mesh(n, device="cpu") == mesh_mod.Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="world size 1"):
        mesh_mod.make_mesh(2, device="cpu")
    four = [mesh_mod.Mesh(None, r, 4, torch.device("cpu")) for r in range(4)]
    assert [mesh_mod.shard_landmarks(m, 64) for m in four] == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert mesh_mod.replicated(four[2], 64) == (0, 64)
    with pytest.raises(ValueError, match="do not split"):
        mesh_mod.shard_landmarks(four[0], 61)
    assert mesh_mod.LANDMARK_AXIS == j_mesh.LANDMARK_AXIS


def test_problem_on_another_device_is_refused(rng):
    prob = _port(synthetic_window(rng, C=3, L=16)[0])
    solver = dist_ba.make_sharded_solver(mesh_mod.Mesh(None, 0, 1, torch.device("cuda", 0)),
                                         ba.BAParams(iters=1))
    with pytest.raises(ValueError, match="problem on cpu"):
        solver(prob)
