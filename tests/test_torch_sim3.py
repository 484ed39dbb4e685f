"""Sim(3) geometry of the port (viso_tpu_torch.geometry.sim3) against
viso_tpu's, on the CPU: every function unbatched and over a leading batch
axis (the JAX function under jax.vmap), `compose` and `inverse` also on
numpy arrays and Python floats, as the SLAM worker calls them. Tolerance
1e-5 absolute and relative (float32 arithmetic in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.geometry import sim3 as j_sim3
from viso_tpu_torch.data.synthetic import so3_exp
from viso_tpu_torch.geometry import sim3

TOL = dict(rtol=1e-5, atol=1e-5)
B = 7


def _sims(rng, n):
    s = np.exp(rng.normal(0, 0.4, n)).astype(np.float32)
    R = np.stack([so3_exp(rng.normal(0, 0.8, 3)) for _ in range(n)]).astype(np.float32)
    t = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    return s, R, t


def _close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("batched", [False, True])
def test_compose_and_inverse_match_reference(rng, batched):
    a, b = _sims(rng, B), _sims(rng, B)
    if batched:
        want_c = jax.vmap(j_sim3.compose)(*a, *b)
        want_i = jax.vmap(j_sim3.inverse)(*a)
    else:
        a, b = tuple(x[0] for x in a), tuple(x[0] for x in b)
        want_c = j_sim3.compose(*a, *b)
        want_i = j_sim3.inverse(*a)
    _close(sim3.compose(*_t(*a), *_t(*b)), want_c)
    _close(sim3.inverse(*_t(*a)), want_i)
    # numpy arrays, as the worker's host bookkeeping passes them.
    _close(sim3.compose(*a, *b), want_c)
    _close(sim3.inverse(*a), want_i)


def test_compose_takes_python_floats(rng):
    """The worker composes the scale-blind forward increment (s = 1.0, a
    Python float) onto a node's solved similarity (s a Python float)."""
    s, R, t = (x[0] for x in _sims(rng, 1))
    R2 = so3_exp(rng.normal(0, 0.3, 3)).astype(np.float32)
    t2 = rng.normal(size=3).astype(np.float32)
    got = sim3.compose(1.0, R2, t2, float(s), R, t)
    want = j_sim3.compose(1.0, jnp.asarray(R2), jnp.asarray(t2), float(s), jnp.asarray(R),
                          jnp.asarray(t))
    assert isinstance(got[0], float)
    _close(got, want)
    got_inv = sim3.inverse(float(s), R, t)
    _close(got_inv, j_sim3.inverse(float(s), jnp.asarray(R), jnp.asarray(t)))


@pytest.mark.parametrize("batched", [False, True])
def test_left_update_and_log_match_reference(rng, batched):
    s, R, t = _sims(rng, B)
    delta = rng.normal(0, 0.3, (B, 7)).astype(np.float32)
    if batched:
        want_u = jax.vmap(j_sim3.left_update)(delta, s, R, t)
        want_l = jax.vmap(j_sim3.log_decomposed)(s, R, t)
    else:
        delta, s, R, t = delta[0], s[0], R[0], t[0]
        want_u = j_sim3.left_update(delta, s, R, t)
        want_l = j_sim3.log_decomposed(s, R, t)
    _close(sim3.left_update(*_t(delta, s, R, t)), want_u)
    got_l = sim3.log_decomposed(*_t(s, R, t))
    assert got_l.shape == (B, 7) if batched else got_l.shape == (7,)
    _close([got_l], [want_l])


def _cloud(rng, n, s, R, t):
    src = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    dst = (s * src @ R.T + t + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("batched", [False, True])
def test_umeyama_matches_reference(rng, batched):
    """Noisy clouds with a fifth of the points masked out (and moved far
    away, so a mask that leaked would show)."""
    n = 48
    sims = _sims(rng, B)
    clouds = [_cloud(rng, n, sims[0][b], sims[1][b], sims[2][b]) for b in range(B)]
    src = np.stack([c[0] for c in clouds])
    dst = np.stack([c[1] for c in clouds])
    mask = rng.uniform(size=(B, n)) > 0.2
    dst[~mask] += 50.0
    if batched:
        want = jax.vmap(j_sim3.umeyama_masked)(src, dst, mask)
    else:
        src, dst, mask = src[0], dst[0], mask[0]
        want = j_sim3.umeyama_masked(src, dst, mask)
    _close(sim3.umeyama_masked(*_t(src, dst, mask)), want)


def test_umeyama_recovers_a_known_similarity(rng):
    s0, R0 = 1.7, so3_exp([0.3, -0.5, 0.2]).astype(np.float32)
    t0 = np.array([0.5, -1.0, 2.0], np.float32)
    src = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    dst = (s0 * src @ R0.T + t0).astype(np.float32)
    s, R, t = sim3.umeyama_masked(*_t(src, dst, np.ones(64, bool)))
    assert abs(float(s) - s0) < 1e-4
    np.testing.assert_allclose(R.numpy(), R0, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), t0, atol=1e-4)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


@pytest.mark.parametrize("case", ["two points", "zero variance", "empty", "non-finite"])
def test_umeyama_degenerate_gives_identity(rng, case):
    src = rng.normal(size=(16, 3)).astype(np.float32)
    dst = src * 2.0 + 1.0
    mask = np.ones(16, bool)
    if case == "two points":
        mask[2:] = False
    elif case == "zero variance":
        src[:] = 3.0
    elif case == "empty":
        mask[:] = False
    else:
        dst[5] = np.nan
    s, R, t = sim3.umeyama_masked(*_t(src, dst, mask))
    js, jR, jt = j_sim3.umeyama_masked(src, dst, mask)
    assert float(s) == float(js) == 1.0
    np.testing.assert_array_equal(R.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(t.numpy(), np.zeros(3, np.float32))
    np.testing.assert_array_equal(np.asarray(jR), np.eye(3))
    np.testing.assert_array_equal(np.asarray(jt), np.zeros(3))
