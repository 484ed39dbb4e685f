"""Parity of the port's geometry core (se3, camera, robust, samplers)
with viso_tpu on the same numpy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viso_tpu.backend import robust as j_robust
from viso_tpu.geometry import camera as j_cam
from viso_tpu.geometry import sampling as j_smp
from viso_tpu.geometry import se3 as j_se3
from viso_tpu_torch.backend import robust as t_robust
from viso_tpu_torch.geometry import camera as t_cam
from viso_tpu_torch.geometry import sampling as t_smp
from viso_tpu_torch.geometry import se3 as t_se3

torch.set_num_threads(2)

# float32 elementwise math in both frameworks: agreement to a few ulps of
# O(1..100) values; 1e-5 absolute (relative for large values) covers it.
TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, tol=TOL, atol=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol if atol is None else atol)


def twists(rng, n=64):
    """Twists spanning the Taylor branch (theta^2 < 1e-4), generic angles,
    and near-pi rotations."""
    xi = rng.normal(0, 1.0, (n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-3                       # tiny rotations (Taylor)
    axes = rng.normal(size=(n // 8, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    xi[n // 4: n // 4 + n // 8, 3:] = axes * (np.pi - 1e-4)   # near pi
    return xi


@pytest.mark.parametrize("fn", ["so3_exp", "se3_exp", "hat"])
def test_exp_maps_match(rng, fn):
    xi = twists(rng)
    if fn == "so3_exp":
        close(t_se3.so3_exp(torch.from_numpy(xi[:, 3:])), j_se3.so3_exp(jnp.asarray(xi[:, 3:])))
    elif fn == "hat":
        close(t_se3.hat(torch.from_numpy(xi[:, :3])), j_se3.hat(jnp.asarray(xi[:, :3])))
    else:
        Rt, tt = t_se3.se3_exp(torch.from_numpy(xi))
        Rj, tj = j_se3.se3_exp(jnp.asarray(xi))
        close(Rt, Rj)
        close(tt, tj)


def test_logs_match(rng):
    xi = twists(rng)
    xi = xi[np.linalg.norm(xi[:, 3:], axis=-1) < 3.0]      # away from the pi cut
    R, t = j_se3.se3_exp(jnp.asarray(xi))
    R_np, t_np = np.array(R), np.array(t)
    # Log near theta = 0 and generic angles: f32 arccos loses ~1e-4 near
    # 1 in both packages alike; the two must still agree to 1e-5.
    close(t_se3.so3_log(torch.from_numpy(R_np)), j_se3.so3_log(R))
    close(t_se3.se3_log(torch.from_numpy(R_np), torch.from_numpy(t_np)),
          j_se3.se3_log(R, t))


@pytest.mark.parametrize("angle", [1e-3, 1.2])
@pytest.mark.parametrize("fn", ["se3_exp", "se3_log"])
def test_jacfwd_unbatched_matches_jax(fn, angle):
    """`torch.func.jacfwd` of se3_exp (wrt the twist) and se3_log (wrt R
    and t) at one unbatched float32 input returns float32 Jacobians equal
    to `jax.jacfwd` of the JAX package's functions to 1e-5, in the Taylor
    branch (rotation 1e-3 rad) and at a generic angle. A 0-dim angle met
    by a Python float promoted the forward tangent to float64, and the
    call raised a dtype error."""
    import jax

    xi = np.array([0.3, -0.2, 0.5, 0.6, -0.3, 0.2], np.float32)
    xi[3:] *= angle / np.linalg.norm(xi[3:])
    if fn == "se3_exp":
        got = torch.func.jacfwd(t_se3.se3_exp)(torch.from_numpy(xi))
        want = jax.jacfwd(j_se3.se3_exp)(jnp.asarray(xi))
    else:
        R, t = (np.asarray(x) for x in j_se3.se3_exp(jnp.asarray(xi)))
        got = torch.func.jacfwd(t_se3.se3_log, argnums=(0, 1))(torch.from_numpy(R),
                                                               torch.from_numpy(t))
        want = jax.jacfwd(j_se3.se3_log, argnums=(0, 1))(jnp.asarray(R), jnp.asarray(t))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.all(np.isfinite(_np(w)))
        close(g, w)


def test_group_ops_match(rng):
    xi = twists(rng, 32)
    R, t = (np.asarray(a) for a in j_se3.se3_exp(jnp.asarray(xi)))
    R2, t2 = R[::-1].copy(), t[::-1].copy()
    pts = rng.normal(0, 5, (32, 3)).astype(np.float32)
    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    J = jnp.asarray
    for a, b in zip(t_se3.compose(T(R), T(t), T(R2), T(t2)),
                    j_se3.compose(J(R), J(t), J(R2), J(t2))):
        close(a, b)
    for a, b in zip(t_se3.inverse(T(R), T(t)), j_se3.inverse(J(R), J(t))):
        close(a, b)
    for a, b in zip(t_se3.relative(T(R), T(t), T(R2), T(t2)),
                    j_se3.relative(J(R), J(t), J(R2), J(t2))):
        close(a, b)
    for a, b in zip(t_se3.left_update(T(xi), T(R), T(t)),
                    j_se3.left_update(J(xi), J(R), J(t))):
        close(a, b)
    close(t_se3.transform(T(R), T(t), T(pts)), j_se3.transform(J(R), J(t), J(pts)))
    close(t_se3.vee(T(R)), j_se3.vee(J(R)))


def test_camera_matches(rng):
    ti = t_cam.Intrinsics.create(718.856, 718.856, 607.1928, 185.2157)
    ji = j_cam.Intrinsics.create(718.856, 718.856, 607.1928, 185.2157)
    for lvl in range(4):
        for a, b in zip(ti.at_level(lvl), ji.at_level(lvl)):
            assert a == float(b)           # exactly the f32 values
    pts = rng.normal(0, 3, (256, 3)).astype(np.float32)
    pts[:8, 2] = [0.0, 1e-7, -1e-7, -2.0, 5.0, 1e-3, -1e-3, 1e-6]   # depth guards
    for lvl in (0, 2):
        uv_t, z_t = t_cam.project(torch.from_numpy(pts), ti.at_level(lvl))
        uv_j, z_j = j_cam.project(jnp.asarray(pts), ji.at_level(lvl))
        close(uv_t, uv_j)   # relative: pixel coords reach ~1e9 at z = 1e-6
        close(z_t, z_j)
    uv = rng.uniform(-20, 1300, (256, 2)).astype(np.float32)
    d = rng.uniform(0.5, 80, 256).astype(np.float32)
    close(t_cam.backproject(torch.from_numpy(uv), torch.from_numpy(d), ti),
          j_cam.backproject(jnp.asarray(uv), jnp.asarray(d), ji))
    close(t_cam.normalize(torch.from_numpy(uv), ti), j_cam.normalize(jnp.asarray(uv), ji))
    for border in (0.0, 4, 8):
        assert np.array_equal(
            _np(t_cam.is_inside(torch.from_numpy(uv), 376, 1240, border=border)),
            np.asarray(j_cam.is_inside(jnp.asarray(uv), 376, 1240, border=border)),
        )
    close(t_cam.viewing_cos(torch.from_numpy(pts)), j_cam.viewing_cos(jnp.asarray(pts)))


@pytest.mark.parametrize("name", ["huber_weight", "cauchy_weight", "tukey_weight",
                                  "tukey_cost", "huber_cost"])
def test_robust_kernels_match(rng, name):
    r = np.abs(rng.normal(0, 3, 512)).astype(np.float32)
    r[:4] = [0.0, 1.0, 2.5, 1e-13]
    close(getattr(t_robust, name)(torch.from_numpy(r), 2.5),
          getattr(j_robust, name)(jnp.asarray(r), 2.5))


def _windows(rng, n=48, rows=16, cols=16):
    win = rng.uniform(0, 255, (n, rows, cols)).astype(np.float32)
    base = rng.integers(0, 300, (n, 2)).astype(np.int32)
    centers = (base + rng.uniform(-2, rows + 2, (n, 2))).astype(np.float32)
    return win, base, centers


def test_hat_weights_match(rng):
    c = rng.uniform(-2, 18, (32, 8)).astype(np.float32)
    c[0, :4] = [0.0, 1.0, 15.0, 3.5]       # on grid rows and midpoints
    close(t_smp._hat_weights(torch.from_numpy(c), 16), j_smp._hat_weights(jnp.asarray(c), 16))
    close(t_smp._hat_weights_grad(torch.from_numpy(c), 16),
          j_smp._hat_weights_grad(jnp.asarray(c), 16))


@pytest.mark.parametrize("rows,cols", [(16, 16), (10, 10), (12, 140)])
def test_patch_samplers_match(rng, rows, cols):
    win, base, centers = _windows(rng, rows=rows, cols=cols)
    W, B, Cn = torch.from_numpy(win), torch.from_numpy(base), torch.from_numpy(centers)
    Wj, Bj, Cj = jnp.asarray(win), jnp.asarray(base), jnp.asarray(centers)
    for a, b in zip(t_smp._axis_coords(W, B, Cn, 4), j_smp._axis_coords(Wj, Bj, Cj, 4)):
        close(a, b)
    close(t_smp.sample_patch_grid(W, B, Cn, 4), j_smp.sample_patch_grid(Wj, Bj, Cj, 4))
    # Gradients are differences of gray levels up to 255, summed in
    # another order: 1e-5 of that full scale absolute (a few f32 ulps of
    # 255), 1e-5 relative.
    for a, b in zip(t_smp.sample_patch_grid_with_grad(W, B, Cn, 4),
                    j_smp.sample_patch_grid_with_grad(Wj, Bj, Cj, 4)):
        close(a, b, atol=255 * TOL)
    scale = rng.uniform(0.5, 1.5, len(win)).astype(np.float32)
    close(t_smp.sample_patch_grid_scaled(W, B, Cn, 4, torch.from_numpy(scale)),
          j_smp.sample_patch_grid_scaled(Wj, Bj, Cj, 4, jnp.asarray(scale)))
