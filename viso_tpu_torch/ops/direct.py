"""Sparse direct (photometric) pose estimation against frozen templates
(port of `viso_tpu/ops/direct.py`: the templated path the engine runs, and
`estimate_pose`).

Multi-level coarse-to-fine Gauss-Newton on SE(3) with 8x8-patch
photometric residuals. Templates (patches + frozen Jacobians) are built
once per keyframe; each GN iteration then needs only bilinear samples of
the current image's cached windows. Branchless: a fixed iteration count
with best-cost rollback, and a singular 6x6 solve zeroes the step.

A level's pass (`_level_pass_cached`) dispatches by the device of the
image, as K1 does:
  * CPU tensors take the plain PyTorch version, `level_pass_plain`;
  * CUDA tensors take K1's windows and then the hand-written kernel in
    `viso_tpu_torch/csrc/direct_gn.cu` (`launch_level_pass`): one launch a
    GN step and one for the final cost, with the step's `J6w @ rf` by
    cuBLAS between two launches -- or raise. There is no fallback. The
    kernel gives the plain pass's pose and cost to the bit (see the
    source, which names the library versions whose orders it repeats;
    `check_versions` warns on others). `launch.launches` counts the
    kernel's launches, and the engine's programs add a graph's launches at
    each replay (`slam/programs.COUNTERS`), as for K1. The engine refuses
    at construction on the card a track of more points than a launch takes
    (`check_track_points`).
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple

import torch

from viso_tpu_torch import _cuda
from viso_tpu_torch.geometry import camera as cam_mod
from viso_tpu_torch.geometry import extract, sampling, se3

SOURCE = _cuda.CSRC / "direct_gn.cu"
# What a launch takes: a cluster of at most 16 CTAs of at most 64 points
# each, windows of at most 24 x 24 in each CTA's shared memory, 8 x 8
# patches.
KERNEL_HALF_PATCH = 4
KERNEL_MAX_POINTS = 1024
KERNEL_MAX_WINDOW = 24
# The library versions whose summation orders the kernel repeats (the
# source's notes): torch's release, the CUDA it was built for, cuBLAS.
ORDERS_READ_ON = {"torch": "2.11", "cuda": "12.8", "cublas": "12.9.2"}


class DirectParams(NamedTuple):
    half_patch: int = 4
    iters: int = 10
    levels: int = 4
    huber_delta: float = 25.0  # gray levels
    min_depth: float = 1e-3
    lm_damping: float = 1e-4
    # Global affine illumination compensation (one closed-form gain/bias
    # pair over all valid patch pixels per iteration).
    affine: bool = True


def pixel_jacobian(p_cam, intr: cam_mod.Intrinsics):
    """d(u,v)/d(xi) for a left-perturbed world->cam pose: (..., 2, 6),
    twist [rho, phi] (translation first)."""
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    iz = 1.0 / torch.clamp(Z, min=1e-9)
    iz2 = iz * iz
    fx, fy = intr.fx, intr.fy
    zero = torch.zeros_like(X)
    row_u = torch.stack(
        [
            fx * iz,
            zero,
            -fx * X * iz2,
            -fx * X * Y * iz2,
            fx * (1.0 + X * X * iz2),
            -fx * Y * iz,
        ],
        dim=-1,
    )
    row_v = torch.stack(
        [
            zero,
            fy * iz,
            -fy * Y * iz2,
            -fy * (1.0 + Y * Y * iz2),
            fy * X * Y * iz2,
            fy * X * iz,
        ],
        dim=-1,
    )
    return torch.stack([row_u, row_v], dim=-2)


def _huber_weight(r, delta):
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-9))


class LevelTemplate(NamedTuple):
    """Frozen per-level tracking template: T (N, P, P) patches; J6
    (6, N*P*P) frozen photometric Jacobian; ok (N,) validity; d_ref (N,)
    reference depths (for the depth-ratio scale warp)."""
    T: torch.Tensor
    J6: torch.Tensor
    ok: torch.Tensor
    d_ref: torch.Tensor


def build_level_template(img_ref, points_w, point_mask, R_ref, t_ref,
                         intr_l, params: DirectParams) -> LevelTemplate:
    """Template patches + frozen Jacobians for one pyramid level."""
    half = params.half_patch
    H_img, W_img = img_ref.shape
    p_ref = se3.transform(R_ref, t_ref, points_w)
    uv_ref, d_ref = cam_mod.project(p_ref, intr_l)
    ref_ok = (d_ref > params.min_depth) & cam_mod.is_inside(
        uv_ref, H_img, W_img, border=half + 1
    ) & point_mask
    n_points = points_w.shape[0]
    win = min(2 * half + 2, *img_ref.shape)
    ref_win, ref_base = extract.extract_windows_fast(img_ref, uv_ref, win)
    T, gx, gy = sampling.sample_patch_grid_with_grad(
        ref_win, ref_base, uv_ref, half
    )
    Jpix = pixel_jacobian(p_ref, intr_l)                        # (N, 2, 6)
    patch_px = (2 * half) ** 2
    J6 = (
        gx[None] * Jpix[:, 0].T[:, :, None, None]
        + gy[None] * Jpix[:, 1].T[:, :, None, None]
    ).reshape(6, n_points * patch_px)
    return LevelTemplate(T=T, J6=J6, ok=ref_ok, d_ref=d_ref)


def _pass_window(shape, half: int):
    """(margin, win) of a level pass: the window is the patch plus a
    motion margin, the wider margin at coarse levels."""
    margin = 8 if min(shape) <= 200 else 4
    return margin, min(2 * half + 2 * margin, *shape)


def _level_pass_cached(img_cur, tmpl: LevelTemplate, points_w,
                       R0, t0, intr_l, params: DirectParams):
    """One pyramid level of direct GN against a frozen template.
    Returns (R, t, cost). CPU tensors take `level_pass_plain`; CUDA
    tensors the kernel (`launch_level_pass`), which raises on what it does
    not take."""
    if img_cur.device.type == "cpu":
        return level_pass_plain(img_cur, tmpl, points_w, R0, t0, intr_l, params)
    return launch_level_pass(img_cur, tmpl, points_w, R0, t0, intr_l, params)


def level_pass_plain(img_cur, tmpl: LevelTemplate, points_w,
                     R0, t0, intr_l, params: DirectParams):
    """Plain PyTorch version of the level pass: `params.iters` GN steps
    from (R0, t0) and the final iterate's cost, the best kept. Returns
    (R, t, cost)."""
    half = params.half_patch
    H_img, W_img = img_cur.shape
    margin, win = _pass_window(img_cur.shape, half)
    n_points = points_w.shape[0]
    patch_px = (2 * half) ** 2
    dtype, dev = img_cur.dtype, img_cur.device

    p0 = se3.transform(R0, t0, points_w)
    uv0, _ = cam_mod.project(p0, intr_l)
    cur_win, cur_base = extract.extract_windows_fast(img_cur, uv0, win)
    T, J6, ref_ok = tmpl.T, tmpl.J6, tmpl.ok
    # Upper scale clip from the cached window footprint: the in_win gate
    # needs half*scale + 1 <= half + margin - 1.
    scale_hi = min(2.0, (half + margin - 2) / half)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def compute_b(R, t):
        p_cur = se3.transform(R, t, points_w)
        uv_cur, d_cur = cam_mod.project(p_cur, intr_l)
        # Depth-ratio scale warp of the current patch footprint.
        scale = torch.clamp(
            tmpl.d_ref / torch.clamp(d_cur, min=params.min_depth), 0.5, scale_hi
        )
        ext = half * scale[:, None] + 1.0
        # The port's windows are exactly win x win (the TPU kernel's
        # aligned over-copy is not reproduced), so the extent is `win`.
        in_win = torch.all(
            (uv_cur - cur_base >= ext) & (uv_cur - cur_base <= win - ext - 1.0),
            dim=-1,
        )
        cur_ok = (
            (d_cur > params.min_depth)
            & cam_mod.is_inside(uv_cur, H_img, W_img, border=half + 1)
            & in_win
        )
        ok = (ref_ok & cur_ok).to(dtype)  # (N,)
        I = sampling.sample_patch_grid_scaled(cur_win, cur_base, uv_cur, half, scale)
        if params.affine:
            okm = ok[:, None, None]
            wsum = torch.clamp(torch.sum(okm) * T.shape[1] * T.shape[2], min=1.0)
            mT = torch.sum(T * okm) / wsum
            mI = torch.sum(I * okm) / wsum
            dT = (T - mT) * okm
            cov = torch.sum(dT * (I - mI))
            varT = torch.sum(dT * dT)
            a = torch.clamp(cov / torch.clamp(varT, min=1e-3), 0.5, 2.0)
            r = I - (a * T + (mI - a * mT))
        else:
            r = I - T
        w = _huber_weight(r, params.huber_delta) * ok[:, None, None]
        rf = r.reshape(n_points * patch_px)
        wf = w.reshape(n_points * patch_px)
        J6w = J6 * wf[None]                                  # (6, M)
        H = J6w @ J6.T
        b = -(J6w @ rf)
        # A pose that pushes (almost) every point out of view reads as
        # terrible, not perfect.
        n_valid = torch.sum(ok)
        mean = torch.sum(wf * rf * rf) / torch.clamp(torch.sum(wf), min=1.0)
        cost = torch.where(n_valid >= 10, mean, float("inf"))
        return H, b, cost

    R, t = R0, t0
    best_R, best_t = R0, t0
    best_cost = torch.full((), float("inf"), dtype=dtype, device=dev)
    for _ in range(params.iters):
        H, b, cost = compute_b(R, t)
        improved = cost < best_cost
        best_R = torch.where(improved, R, best_R)
        best_t = torch.where(improved, t, best_t)
        best_cost = torch.minimum(cost, best_cost)
        Hd = H + params.lm_damping * eye6 * (torch.trace(H) / 6.0 + 1.0)
        # solve_ex does not raise on a singular system (jnp.linalg.solve
        # returns non-finite values there); either way the step is zeroed.
        xi, _ = torch.linalg.solve_ex(Hd, b)
        xi = torch.where(torch.all(torch.isfinite(xi)), xi, 0.0)
        R, t = se3.left_update(xi, R, t)
    # Let the final iterate compete too.
    _, _, cost = compute_b(R, t)
    improved = cost < best_cost
    best_R = torch.where(improved, R, best_R)
    best_t = torch.where(improved, t, best_t)
    best_cost = torch.minimum(cost, best_cost)
    return best_R, best_t, best_cost


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.viso_direct_gn.argtypes = [p] * 14 + [i] * 7 + [f] * 8 + [p] * 4
    lib.viso_direct_gn.restype = i
    lib.viso_direct_gn_state_floats.argtypes = []
    lib.viso_direct_gn_state_floats.restype = i
    lib.viso_direct_gn_scratch_floats.argtypes = [i]
    lib.viso_direct_gn_scratch_floats.restype = ctypes.c_int64


def load_library():
    """Build (if needed) and load the kernel library; cached per process.
    The first load checks the library versions (`check_versions`)."""
    lib = _cuda.load_library(SOURCE, _bind)
    _versions_checked()
    return lib


def library_versions() -> dict:
    """This process's torch release (major.minor), the CUDA it was built
    for and the loaded cuBLAS (major.minor.patch, None where it cannot be
    read): the keys of `ORDERS_READ_ON`."""
    return {"torch": ".".join(torch.__version__.split("+")[0].split(".")[:2]),
            "cuda": torch.version.cuda, "cublas": _cuda.cublas_version()}


def check_versions(versions=None) -> dict:
    """Warn (RuntimeWarning) where `versions` (this process's by default)
    differ from `ORDERS_READ_ON`, the versions whose summation orders the
    kernel repeats: with others it may no longer give the plain pass's bits,
    and the card tests (`tests/test_torch_direct_kernel.py`) say whether it
    does. Returns the differing entries."""
    versions = library_versions() if versions is None else versions
    other = {k: v for k, v in versions.items() if v != ORDERS_READ_ON[k]}
    if other:
        warnings.warn(f"direct_gn repeats the summation orders of {ORDERS_READ_ON}; this "
                      f"process has {other}: the kernel may not be bit-equal to the plain "
                      "level pass, run tests/test_torch_direct_kernel.py on the card",
                      RuntimeWarning, stacklevel=3)
    return other


@functools.cache
def _versions_checked():
    return check_versions()


def check_track_points(n: int):
    """Raise ValueError unless the kernel takes a track of `n` points: 2 to
    KERNEL_MAX_POINTS at level 0, whose count every coarser level keeps or
    quarters from 512 up (`_level_points`)."""
    if not 2 <= n <= KERNEL_MAX_POINTS:
        raise ValueError(f"the direct GN kernel takes 2 to {KERNEL_MAX_POINTS:,} points a "
                         f"level (a cluster of 16 CTAs of 64), got {n}")


def _check(t, dtype, shape, what):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def launch(windows, base, image_hw, tmpl: LevelTemplate, points_w, R0, t0, intr_l,
           params: DirectParams):
    """The GN steps of one level pass on inputs as `launch_level_pass`
    checked and extracted them (it does not check them again): K1's windows
    (n, win, win) f32 at origins base (n, 2) int32 of an image of
    `image_hw` (H, W). `params.iters + 1` launches of the kernel, and
    between two of them the step's `J6w @ rf` (the one product of the pass
    left to cuBLAS, so that it is the plain pass's to the bit). Returns
    (R, t, cost); raises when a launch is refused."""
    n = points_w.shape[0]
    H_img, W_img = image_hw
    margin, win = _pass_window(image_hw, params.half_patch)
    dev = windows.device
    lib = load_library()
    m = n * (2 * params.half_patch) ** 2
    f32 = dict(dtype=torch.float32, device=dev)
    state = torch.empty(lib.viso_direct_gn_state_floats(), **f32)
    scratch = torch.empty(lib.viso_direct_gn_scratch_floats(n), **f32)
    # J6w and rf as the plain pass has them: fresh (6, M) and (M,) tensors.
    J6w = torch.empty((6, m), **f32)
    rf = torch.empty(m, **f32)
    R = torch.empty((3, 3), **f32)
    t = torch.empty(3, **f32)
    cost = torch.empty((), **f32)
    scale_hi = min(2.0, (params.half_patch + margin - 2) / params.half_patch)
    ptrs = [windows, base, tmpl.T, tmpl.J6, tmpl.ok, tmpl.d_ref, points_w, R0, t0]
    Jr = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for step in range(params.iters + 1):
            err = lib.viso_direct_gn(
                *(x.data_ptr() for x in ptrs), None if Jr is None else Jr.data_ptr(),
                state.data_ptr(), scratch.data_ptr(), J6w.data_ptr(), rf.data_ptr(),
                n, win, H_img, W_img, params.iters, int(params.affine), step,
                intr_l.fx, intr_l.fy, intr_l.cx, intr_l.cy, params.min_depth,
                params.huber_delta, params.lm_damping, scale_hi,
                R.data_ptr(), t.data_ptr(), cost.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(f"direct_gn kernel launch failed: CUDA error {err}")
            launch.launches += 1
            if step < params.iters:
                Jr = J6w @ rf
    return R, t, cost


launch.launches = 0


def launch_level_pass(img_cur, tmpl: LevelTemplate, points_w, R0, t0, intr_l,
                      params: DirectParams):
    """The level pass on the card: K1's windows of the current level at
    the points' projections from (R0, t0), computed as the plain pass
    computes them, then the GN kernel (`launch`). Returns (R (3, 3),
    t (3,), cost ()), as `level_pass_plain`, to the bit.

    img_cur f32 (H, W); tmpl's T f32 (N, 8, 8), J6 f32 (6, N * 64), ok
    bool (N,), d_ref f32 (N,); points_w f32 (N, 3); R0 f32 (3, 3), t0 f32
    (3,): all on one CUDA device (the kernel is handed contiguous copies).
    Raises before any launch on any other input, on half_patch other than
    4, fewer than 2 or more than 1,024 points or a window over 24, and
    when a launch is refused."""
    half = params.half_patch
    if half != KERNEL_HALF_PATCH:
        raise ValueError(f"the kernel takes half_patch {KERNEL_HALF_PATCH}, got {half}")
    n = points_w.shape[0]
    check_track_points(n)
    if params.iters < 0:
        raise ValueError(f"iters must be at least 0, got {params.iters}")
    if img_cur.dim() != 2 or img_cur.dtype != torch.float32:
        raise ValueError(f"image must be float32 (H, W), got {img_cur.dtype} "
                         f"{tuple(img_cur.shape)}")
    _, win = _pass_window(img_cur.shape, half)
    if not 2 <= win <= KERNEL_MAX_WINDOW:
        raise ValueError(f"the kernel takes windows of 2 to {KERNEL_MAX_WINDOW}, got {win}")
    dense = LevelTemplate(*(x.contiguous() for x in tmpl))
    pts, R0c, t0c = points_w.contiguous(), R0.contiguous(), t0.contiguous()
    P = 2 * half
    _check(pts, torch.float32, (n, 3), "points_w")
    _check(dense.T, torch.float32, (n, P, P), "template T")
    _check(dense.J6, torch.float32, (6, n * P * P), "template J6")
    _check(dense.ok, torch.bool, (n,), "template ok")
    _check(dense.d_ref, torch.float32, (n,), "template d_ref")
    _check(R0c, torch.float32, (3, 3), "R0")
    _check(t0c, torch.float32, (3,), "t0")
    tensors = (img_cur, pts, *dense, R0c, t0c)
    dev = img_cur.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"the level pass kernel needs CUDA tensors on one device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    # The windows' centres from the tensors as given, as the plain pass
    # computes them.
    uv0, _ = cam_mod.project(se3.transform(R0, t0, points_w), intr_l)
    windows, base = extract.extract_windows_fast(img_cur, uv0, win)
    return launch(windows, base, tuple(img_cur.shape), dense, pts, R0c, t0c, intr_l, params)


def estimate_pose(pyr_ref, pyr_cur, R_ref, t_ref, points_w, point_mask,
                  intr: cam_mod.Intrinsics, R0, t0, params: DirectParams = DirectParams()):
    """Multi-level direct pose estimation of the current frame against a
    reference frame (viso.cpp:760-766): `build_templates` from the
    reference pyramid at its world->camera pose (R_ref, t_ref), then
    `estimate_pose_templated` from the initial guess (R0, t0).
    points_w (N, 3) world points, point_mask (N,). Returns (R, t,
    final_cost)."""
    templates = build_templates(pyr_ref, R_ref, t_ref, points_w, point_mask, intr, params)
    return estimate_pose_templated(templates, pyr_cur, points_w, intr, R0, t0, params)


def _level_points(points_w, point_mask, level: int):
    """A quarter of the points at coarse levels (>= 2) of a large set."""
    if level >= 2 and points_w.shape[0] >= 512:
        return points_w[::4], None if point_mask is None else point_mask[::4]
    return points_w, point_mask


def build_templates(pyr_ref, R_ref, t_ref, points_w, point_mask,
                    intr: cam_mod.Intrinsics, params: DirectParams = DirectParams()):
    """Frozen multi-level tracking templates (tuple indexed by level)."""
    levels = min(params.levels, len(pyr_ref))
    out = []
    for level in range(levels):
        pts_l, mask_l = _level_points(points_w, point_mask, level)
        out.append(
            build_level_template(
                pyr_ref[level], pts_l, mask_l, R_ref, t_ref,
                intr.at_level(level), params,
            )
        )
    return tuple(out)


def estimate_pose_templated(templates, pyr_cur, points_w, intr: cam_mod.Intrinsics,
                            R0, t0, params: DirectParams = DirectParams()):
    """Multi-level direct pose estimation against frozen templates.
    Returns (R, t, final_cost)."""
    R, t = R0, t0
    cost = None
    levels = min(params.levels, len(pyr_cur), len(templates))
    for level in range(levels - 1, -1, -1):
        pts_l, _ = _level_points(points_w, None, level)
        R, t, cost = _level_pass_cached(
            pyr_cur[level], templates[level], pts_l, R, t,
            intr.at_level(level), params,
        )
    return R, t, cost
