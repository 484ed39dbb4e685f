"""The benchmark's input generator: textured corridors rendered on the
device, and the drive through them.

A scene is a corridor of textured planes (two side walls and a ground
plane, no end wall: the background stands for the sky), each with a
texture of `tex_size` pixels at `tex_scale` pixels a metre drawn from the
seed. Rendering follows `viso_tpu_torch.data.synthetic.PlaneScene.render`:
each pixel's ray meets every plane, the nearest hit in front of the
camera wins, and its texture is sampled bilinearly; where no plane is hit
the pixel takes the background. The textures here are periodic and wrap
at exactly their size, so the corridor repeats every
`tex_size / tex_scale` metres along z.

The drive (`Drive`) moves forward along z at `step_m` a frame with a
sinusoidal lateral weave whose period is a whole number of texture
periods and yaw along the path. Its images therefore repeat exactly after
`period_frames` frames: the harness renders that one period and feeds
frame `i mod period_frames` against the ground truth of frame `i`, which
goes on along z.

Everything is computed on the device of the textures, in float64 for the
geometry; images come back as uint8, truncated as `np.astype` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

# The corridor (`synthetic.corridor_scene`'s walls and ground): (point, normal, e1, e2).
CORRIDOR = (
    ((-4.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),   # left wall
    ((4.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)),   # right wall
    ((0.0, 1.5, 0.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),   # ground
)
BACKGROUND = 20.0


def periodic_texture(generator, size: int, octaves: int = 5, device=None):
    """A smooth random texture (size, size) in [0, 255] float32 that wraps
    at exactly `size` pixels: multi-octave uniform noise on periodic grids
    of max(1, size / (4 * 2**o)) cells, each upsampled bicubically with circular
    padding and weighted 2**o (`synthetic.smooth_texture`'s recipe, made
    periodic)."""
    img = torch.zeros((size, size), dtype=torch.float32, device=device)
    for o in range(octaves):
        s = 4 * 2**o
        g = max(1, size // s)
        base = torch.rand((g, g), generator=generator, device=device)
        wrap = torch.remainder(torch.arange(-2, g + 2, device=device), g)
        pad = base[wrap][:, wrap][None, None]
        up = F.interpolate(pad, scale_factor=s, mode="bicubic", align_corners=False)
        img += up[0, 0, 2 * s:2 * s + size, 2 * s:2 * s + size] * 2.0**o
    img -= img.min()
    img *= 255.0 / torch.clamp(img.max(), min=1e-6)
    return img


def textures(seed: int, n: int, size: int, device):
    """`n` periodic textures drawn from `seed` on `device` (n, size, size)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.stack([periodic_texture(gen, size, device=device) for _ in range(n)])


def sample_wrap(tex, v, u):
    """Bilinear samples of `tex` (h, w) at rows v and columns u (float64),
    the texture repeating with period (h, w): `map_coordinates(order=1,
    mode="grid-wrap")`."""
    h, w = tex.shape
    v0, u0 = torch.floor(v), torch.floor(u)
    fv, fu = (v - v0).to(torch.float32), (u - u0).to(torch.float32)
    r0 = torch.remainder(v0.long(), h)
    c0 = torch.remainder(u0.long(), w)
    r1 = torch.remainder(r0 + 1, h)
    c1 = torch.remainder(c0 + 1, w)
    top = tex[r0, c0] * (1 - fu) + tex[r0, c1] * fu
    bot = tex[r1, c0] * (1 - fu) + tex[r1, c1] * fu
    return top * (1 - fv) + bot * fv


def render(planes, tex, tex_scale: float, intr, R, t, h: int, w: int,
           background: float = BACKGROUND, extent: float = 1e9):
    """Image (h, w) float32 of the planes seen from world->cam (R, t): for
    each pixel the nearest plane hit in front of the camera, its texture
    sampled bilinearly with wrap; `background` where no plane is hit.
    `planes` as CORRIDOR, `tex` (len(planes), th, tw), `intr` (fx, fy,
    cx, cy)."""
    dev = tex.device
    f64 = dict(dtype=torch.float64, device=dev)
    R = torch.as_tensor(np.asarray(R, np.float64), **f64)
    t = torch.as_tensor(np.asarray(t, np.float64), **f64)
    fx, fy, cx, cy = (float(v) for v in intr)
    vs, us = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    rays_c = torch.stack([(us - cx) / fx, (vs - cy) / fy, torch.ones_like(us)], -1).reshape(-1, 3)
    origin = -R.T @ t
    rays_w = rays_c @ R
    img = torch.full((h * w,), background, dtype=torch.float32, device=dev)
    depth = torch.full((h * w,), math.inf, **f64)
    th, tw = tex.shape[-2:]
    for k, (p0, n, e1, e2) in enumerate(planes):
        p0, n, e1, e2 = (torch.tensor(x, **f64) for x in (p0, n, e1, e2))
        denom = rays_w @ n
        s = ((p0 - origin) @ n) / denom
        pts = origin + s[:, None] * rays_w
        rel = pts - p0
        a, b = rel @ e1, rel @ e2
        z_cam = (pts - origin) @ R[2]
        hit = ((s > 1e-6) & (z_cam > 1e-6) & (a.abs() < extent) & (b.abs() < extent)
               & (z_cam < depth))
        a = torch.where(hit, a, 0.0)
        b = torch.where(hit, b, 0.0)
        vals = sample_wrap(tex[k], b * tex_scale + th / 2.0, a * tex_scale + tw / 2.0)
        img = torch.where(hit, vals, img)
        depth = torch.where(hit, z_cam, depth)
    return img.reshape(h, w)


def to_u8(img):
    """uint8 as `np.clip(img, 0, 255).astype(np.uint8)` gives it."""
    return torch.clamp(img, 0.0, 255.0).to(torch.uint8)


def yaw_matrix(psi):
    """Rotation about the camera's y axis by psi (cam->world)."""
    c, s = math.cos(psi), math.sin(psi)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


@dataclass(frozen=True)
class Drive:
    """Forward motion along z with a lateral weave x = A sin(2 pi z / L),
    L = period_frames * step_m, and yaw along the path."""

    step_m: float
    period_frames: int
    weave_m: float
    tex_size: int
    tex_scale: float

    def __post_init__(self):
        step_px = self.step_m * self.tex_scale
        period_px = self.period_frames * step_px
        if abs(step_px - round(step_px)) > 1e-9 or round(period_px) % self.tex_size:
            raise ValueError("the weave's period must be a whole number of texture periods, "
                             "and a step a whole number of texture pixels")

    def centre_yaw(self, i: int, wrap: bool):
        """Camera centre (3,) and yaw of frame i; with `wrap`, z taken
        modulo the corridor's period (the same image, exactly)."""
        L = self.period_frames * self.step_m
        k = i % self.period_frames
        phase = 2 * math.pi * k / self.period_frames
        x = self.weave_m * math.sin(phase)
        psi = math.atan(self.weave_m * 2 * math.pi / L * math.cos(phase))
        if wrap:
            step_px = round(self.step_m * self.tex_scale)
            z = (k * step_px % self.tex_size) / self.tex_scale
        else:
            z = i * self.step_m
        return np.array([x, 0.0, z]), psi

    def pose(self, i: int, wrap: bool = False):
        """World->cam (R (3, 3), t (3,)) float64 of frame i."""
        c, psi = self.centre_yaw(i, wrap)
        R = yaw_matrix(psi).T
        return R, -R @ c

    def poses(self, frames, wrap: bool = False):
        Rs, ts = zip(*(self.pose(int(i), wrap) for i in frames))
        return np.stack(Rs), np.stack(ts)


def right_pose(R, t, baseline: float):
    """The right camera of a rig: the same R, the centre moved by
    `baseline` along the left camera's x axis."""
    c = -R.T @ t + R.T @ np.array([baseline, 0.0, 0.0])
    return R, -R @ c


def render_period(drive: Drive, tex, intr, h: int, w: int, baseline=None, batch: int = 16):
    """One period of the drive's frames as uint8 on the device of `tex`:
    (P, h, w), or (P, 2, h, w) left and right with a `baseline`."""
    out = []
    for i in range(drive.period_frames):
        R, t = drive.pose(i, wrap=True)
        views = [(R, t)] if baseline is None else [(R, t), right_pose(R, t, baseline)]
        imgs = [to_u8(render(CORRIDOR, tex, drive.tex_scale, intr, Rv, tv, h, w))
                for Rv, tv in views]
        out.append(imgs[0] if baseline is None else torch.stack(imgs))
    return torch.stack(out)
