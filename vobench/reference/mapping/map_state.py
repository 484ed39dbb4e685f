"""Frozen copy of `viso_tpu_torch/mapping/map_state.py` for the benchmark's plain
reference (imports rewritten to `vobench.reference`; window copies by
`vobench/reference/geometry/extract.py`'s plain indexing). The original
docstring follows.

Fixed-capacity structure-of-arrays map (port of
`viso_tpu/mapping/map_state.py`).

Keyframes live in K fixed slots, landmarks in L fixed slots with a
validity mask, observations in a dense (K, L) masked grid, and keyframe
pyramids stacked per level as (K, h_l, w_l). Mutations return a new
MapState and leave their input untouched (the engine's BA adoption gate
selects between the old and the new map); a field that an operation does
not change is shared, not copied.

VO has no learned weights: this map state is what carries a run, and
`from_numpy` / `to_numpy` move it between packages and devices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MapState(NamedTuple):
    kf_R: torch.Tensor        # (K, 3, 3) world->cam
    kf_t: torch.Tensor        # (K, 3)
    kf_mask: torch.Tensor     # (K,) bool, slot in use
    kf_frame_id: torch.Tensor  # (K,) int32 source frame index
    kf_pyr: tuple             # per level: (K, h_l, w_l) float32
    points: torch.Tensor      # (L, 3) world
    point_mask: torch.Tensor  # (L,) bool
    obs_uv: torch.Tensor      # (K, L, 2) pixel coords at level 0
    obs_mask: torch.Tensor    # (K, L) bool

    @property
    def num_keyframes(self):
        return torch.sum(self.kf_mask)

    @property
    def num_points(self):
        return torch.sum(self.point_mask)


def empty(K: int, L: int, img_shape, num_levels: int = 4, *, device) -> MapState:
    H, W = img_shape
    f32 = dict(dtype=torch.float32, device=device)
    pyr = tuple(
        torch.zeros((K, H // 2**lvl, W // 2**lvl), **f32)
        for lvl in range(num_levels)
    )
    return MapState(
        kf_R=torch.eye(3, **f32).repeat(K, 1, 1),
        kf_t=torch.zeros((K, 3), **f32),
        kf_mask=torch.zeros(K, dtype=torch.bool, device=device),
        kf_frame_id=torch.full((K,), -1, dtype=torch.int32, device=device),
        kf_pyr=pyr,
        points=torch.zeros((L, 3), **f32),
        point_mask=torch.zeros(L, dtype=torch.bool, device=device),
        obs_uv=torch.zeros((K, L, 2), **f32),
        obs_mask=torch.zeros((K, L), dtype=torch.bool, device=device),
    )


def row(x, idx):
    """`x[idx]` along dim 0 for an int or a 0-d integer tensor.

    A program's slot arguments are 0-d tensors on the device (the
    counterpart of the JAX jit's traced arguments). Indexing with a 0-d
    tensor reads it on the host (`x[t]` calls `.item()`); `index_select`
    keeps it on the device."""
    if isinstance(idx, torch.Tensor):
        return x.index_select(0, idx.reshape(1))[0]
    return x[idx]


def _device_index(idx):
    """An advanced index with each 0-d tensor made 1-element, so that
    indexing leaves it on the device (it broadcasts as the int would)."""
    if isinstance(idx, tuple):
        return tuple(_device_index(i) for i in idx)
    if isinstance(idx, torch.Tensor) and idx.dim() == 0:
        return idx.reshape(1)
    return idx


def _set(x, idx, value):
    """Functional x.at[idx].set(value).

    A Python scalar goes in with fill_ on the slot's view: item assignment
    of a host scalar into a CUDA tensor copies it from the host and
    synchronises. A 0-d tensor slot writes through `index_fill_` /
    `index_copy_`, which keep it on the device.
    """
    y = x.clone()
    if isinstance(idx, torch.Tensor) and idx.dim() == 0:
        rows = idx.reshape(1)
        if isinstance(value, (bool, int, float)):
            y.index_fill_(0, rows, value)
        else:
            y.index_copy_(0, rows, value.to(y.dtype).expand(y.shape[1:]).unsqueeze(0))
    elif isinstance(value, (bool, int, float)):
        y[int(idx)].fill_(value)
    else:
        y[_device_index(idx)] = value
    return y


def insert_keyframe(m: MapState, slot: int, R, t, frame_id: int, pyramid) -> MapState:
    """Place a keyframe in `slot`, clearing that slot's observations."""
    return m._replace(
        kf_R=_set(m.kf_R, slot, R),
        kf_t=_set(m.kf_t, slot, t),
        kf_mask=_set(m.kf_mask, slot, True),
        kf_frame_id=_set(m.kf_frame_id, slot, frame_id),
        kf_pyr=tuple(_set(s, slot, lvl) for s, lvl in zip(m.kf_pyr, pyramid)),
        obs_uv=_set(m.obs_uv, slot, 0.0),
        obs_mask=_set(m.obs_mask, slot, False),
    )


def evict_keyframe(m: MapState, slot: int) -> MapState:
    """Free a keyframe slot and drop its observations; landmarks that lose
    their last observation are freed too."""
    obs_mask = _set(m.obs_mask, slot, False)
    return m._replace(
        kf_mask=_set(m.kf_mask, slot, False),
        kf_frame_id=_set(m.kf_frame_id, slot, -1),
        obs_mask=obs_mask,
        point_mask=m.point_mask & torch.any(obs_mask, dim=0),
    )


def set_observations(m: MapState, kf_slot: int, lm_idx, uv, valid) -> MapState:
    """Write observations of landmarks `lm_idx` (M,) in keyframe `kf_slot`."""
    idx = _device_index((kf_slot, lm_idx))
    old_uv = m.obs_uv[idx]
    old_mask = m.obs_mask[idx]
    return m._replace(
        obs_uv=_set(
            m.obs_uv, (kf_slot, lm_idx), torch.where(valid[:, None], uv, old_uv)
        ),
        obs_mask=_set(m.obs_mask, (kf_slot, lm_idx), old_mask | valid),
    )


def allocate_landmarks(m: MapState, pts, valid):
    """Allocate slots for up to M new landmarks.

    pts (M, 3), valid (M,). Returns (MapState, slots (M,), ok (M,)); ok
    additionally excludes allocations beyond the free capacity. Free slots
    are taken in index order (a stable argsort puts False first).
    """
    M = pts.shape[0]
    order = torch.argsort(m.point_mask.to(torch.uint8), stable=True)
    slots = order[:M]
    slot_is_free = ~m.point_mask[slots]
    ok = valid & slot_is_free
    points = _set(m.points, slots, torch.where(ok[:, None], pts, m.points[slots]))
    point_mask = _set(m.point_mask, slots, m.point_mask[slots] | ok)
    return m._replace(points=points, point_mask=point_mask), slots, ok


def update_from_ba(m: MapState, R, t, points) -> MapState:
    """Write back BA-optimized poses/points (masked slots untouched)."""
    return m._replace(
        kf_R=torch.where(m.kf_mask[:, None, None], R, m.kf_R),
        kf_t=torch.where(m.kf_mask[:, None], t, m.kf_t),
        points=torch.where(m.point_mask[:, None], points, m.points),
    )


def _where(cond, x, y):
    if x is y:
        return x
    if isinstance(x, tuple):
        return tuple(_where(cond, p, q) for p, q in zip(x, y))
    return torch.where(cond, x, y)


def select(cond, a: MapState, b: MapState) -> MapState:
    """Field-wise torch.where(cond, a, b); a field both share is kept. A
    Python bool picks one map."""
    if isinstance(cond, bool):
        return a if cond else b
    return MapState(*(_where(cond, x, y) for x, y in zip(a, b)))


def as_photo_ba_problem(m: MapState, intr, level: int = 1, half_patch: int = 2):
    """View the window as a backend.ba_photometric.PhotoBAProblem on
    pyramid `level`. Each landmark's 4x4 template is sampled from its
    anchor -- the observing keyframe with the smallest source frame id
    (slots are round-robin, so slot order is not age order; a tie goes to
    the first slot, as `jnp.argmin`) -- at the recorded observation pixel,
    not at the point's projection. Returns (PhotoBAProblem,
    level_intrinsics)."""
    from vobench.reference.backend import ba_photometric as pba
    from vobench.reference.geometry import sampling

    images = m.kf_pyr[level]
    L = m.points.shape[0]
    age = torch.where(m.obs_mask, m.kf_frame_id[:, None], 2**30)   # (K, L)
    anchor_idx = torch.argmin(age, dim=0)                          # (L,)
    uv_anchor = m.obs_uv[anchor_idx, torch.arange(L, device=images.device)] * 0.5**level
    offs = sampling.patch_offsets(half_patch, uv_anchor.dtype, uv_anchor.device)
    template = sampling.bilinear_indexed(
        images, anchor_idx, uv_anchor[:, None, :] + offs.reshape(-1, 2)[None]
    )
    prob = pba.PhotoBAProblem(
        R=m.kf_R,
        t=m.kf_t,
        points=m.points,
        images=images,
        template=template,
        anchor_idx=anchor_idx,
        obs_mask=m.obs_mask,
        cam_mask=m.kf_mask,
        point_mask=m.point_mask,
    )
    return prob, intr.at_level(level)


def as_ba_problem(m: MapState, intr):
    """View the window as a backend.ba.BAProblem (normalized obs coords)."""
    from vobench.reference.backend import ba
    from vobench.reference.geometry import camera as cam_mod

    return ba.BAProblem(
        R=m.kf_R,
        t=m.kf_t,
        points=m.points,
        obs_uv=cam_mod.normalize(m.obs_uv, intr),
        obs_mask=m.obs_mask,
        cam_mask=m.kf_mask,
        point_mask=m.point_mask,
    )


def from_numpy(arrays: dict, device) -> MapState:
    """MapState from a dict of numpy arrays keyed by field name (kf_pyr a
    sequence of per-level arrays) -- e.g. a JAX MapState pulled with
    np.asarray per field."""
    fields = {}
    for name in MapState._fields:
        v = arrays[name]
        if name == "kf_pyr":
            fields[name] = tuple(
                torch.tensor(np.asarray(lvl), device=device) for lvl in v
            )
        else:
            fields[name] = torch.tensor(np.asarray(v), device=device)
    return MapState(**fields)


def to_numpy(m: MapState) -> dict:
    """Dict of numpy arrays, the inverse of `from_numpy`."""
    out = {}
    for name, v in zip(MapState._fields, m):
        if name == "kf_pyr":
            out[name] = tuple(lvl.detach().cpu().numpy() for lvl in v)
        else:
            out[name] = v.detach().cpu().numpy()
    return out
