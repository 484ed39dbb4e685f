"""Synthetic photometric scenes with exact ground truth (numpy and scipy
only; port of `viso_tpu/data/synthetic.py`, whose trajectories call the
JAX `so3_exp`).

Textured planes with known poses, depths and intrinsics give
photometrically consistent sequences with exact ground truth: the
corridor and room scenes, forward and orbit trajectories, mono sequences
and stereo pairs, exact depths along pixel rays, and a per-frame
photometric degradation (`PhotometricNuisance`).

Host-side NumPy: data generation is not a hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.ndimage import map_coordinates, zoom

from viso_tpu_torch.geometry import camera


def so3_exp(w):
    """Rodrigues in float32: axis-angle (3,) -> rotation (3, 3).

    The same formula and small-angle switch as the tensor `se3.so3_exp`
    (Taylor coefficients below theta^2 = 1e-4), so trajectories match the
    JAX package's to float32 rounding.
    """
    f32 = np.float32
    w = np.asarray(w, f32)
    theta_sq = f32(np.sum(w * w))
    theta = np.sqrt(theta_sq + f32(1e-8))
    if theta_sq < 1e-4:
        A = f32(1.0) - theta_sq / f32(6.0)
        B = f32(0.5) - theta_sq / f32(24.0)
    else:
        A = np.sin(theta) / theta
        B = (f32(1.0) - np.cos(theta)) / (theta_sq + f32(1e-8))
    W = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], f32
    )
    return np.eye(3, dtype=f32) + A * W + B * (W @ W)


def smooth_texture(rng, h, w, octaves=5, scale=255.0):
    """Multi-octave smooth random texture with rich gradients."""
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2**o
        base = rng.uniform(0, 1, size=(max(2, h // (4 * s)) + 2, max(2, w // (4 * s)) + 2))
        z = zoom(base, (h / base.shape[0], w / base.shape[1]), order=3)
        img += z[:h, :w] * (2.0**o)
    img -= img.min()
    img *= scale / max(img.max(), 1e-6)
    return img.astype(np.float32)


@dataclass
class Plane:
    """Textured plane: point p0, unit normal n, in-plane axes (e1, e2)."""

    p0: np.ndarray
    n: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    texture: np.ndarray
    tex_scale: float = 40.0   # texture pixels per world unit
    extent: float = 1e9       # half-size along e1/e2


def frontal_plane(texture, z=8.0, tex_scale=40.0, extent=1e9):
    return Plane(
        p0=np.array([0.0, 0.0, z]),
        n=np.array([0.0, 0.0, -1.0]),
        e1=np.array([1.0, 0.0, 0.0]),
        e2=np.array([0.0, 1.0, 0.0]),
        texture=texture,
        tex_scale=tex_scale,
        extent=extent,
    )


def ground_plane(texture, y=1.5, tex_scale=40.0, extent=1e9):
    """y points down in camera convention, so the ground is at +y."""
    return Plane(
        p0=np.array([0.0, y, 0.0]),
        n=np.array([0.0, -1.0, 0.0]),
        e1=np.array([1.0, 0.0, 0.0]),
        e2=np.array([0.0, 0.0, 1.0]),
        texture=texture,
        tex_scale=tex_scale,
        extent=extent,
    )


@dataclass
class PlaneScene:
    planes: list = field(default_factory=list)
    background: float = 20.0

    def render(self, intr: camera.Intrinsics, R, t, h, w):
        """Render the scene into a camera at world->cam pose (R, t).

        Returns (image (h, w) float32, depth (h, w) float32; depth=inf
        where no plane is hit).
        """
        R = np.asarray(R, np.float64)
        t = np.asarray(t, np.float64)
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)
        vs, us = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        rays_c = np.stack(
            [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1
        ).reshape(-1, 3)
        origin = -R.T @ t
        rays_w = rays_c @ R  # R^T @ ray per row
        img = np.full(h * w, self.background, np.float32)
        depth = np.full(h * w, np.inf, np.float32)
        for plane in self.planes:
            denom = rays_w @ plane.n
            num = (plane.p0 - origin) @ plane.n
            with np.errstate(divide="ignore", invalid="ignore"):
                s = num / denom
            pts = origin + s[:, None] * rays_w
            rel = pts - plane.p0
            a = rel @ plane.e1
            b = rel @ plane.e2
            # Depth along the camera z axis.
            z_cam = (pts - origin) @ R[2]
            hit = (
                (s > 1e-6)
                & (z_cam > 1e-6)
                & (np.abs(a) < plane.extent)
                & (np.abs(b) < plane.extent)
                & (z_cam < depth)
            )
            th, tw = plane.texture.shape
            tu = a * plane.tex_scale + tw / 2.0
            tv = b * plane.tex_scale + th / 2.0
            vals = map_coordinates(
                plane.texture, [tv, tu], order=1, mode="wrap"
            ).astype(np.float32)
            img = np.where(hit, vals, img)
            depth = np.where(hit, z_cam.astype(np.float32), depth)
        return img.reshape(h, w), depth.reshape(h, w)

    def depth_at(self, intr, R, t, uv):
        """Exact depths (N,) for pixel coords uv (N, 2) in camera (R, t);
        inf where no plane is hit."""
        R = np.asarray(R, np.float64)
        t = np.asarray(t, np.float64)
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)
        uv = np.asarray(uv, np.float64)
        rays_c = np.stack(
            [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1
        )
        origin = -R.T @ t
        rays_w = rays_c @ R
        depth = np.full(len(uv), np.inf, np.float64)
        for plane in self.planes:
            denom = rays_w @ plane.n
            num = (plane.p0 - origin) @ plane.n
            with np.errstate(divide="ignore", invalid="ignore"):
                s = num / denom
            pts = origin + s[:, None] * rays_w
            rel = pts - plane.p0
            a = rel @ plane.e1
            b = rel @ plane.e2
            z_cam = (pts - origin) @ R[2]
            hit = (
                (s > 1e-6)
                & (z_cam > 1e-6)
                & (np.abs(a) < plane.extent)
                & (np.abs(b) < plane.extent)
                & (z_cam < depth)
            )
            depth = np.where(hit, z_cam, depth)
        return depth


def corridor_scene(rng, tex_size=768, far_z=30.0):
    """Two side walls + ground + far wall: rich non-planar structure.

    far_z: distance of the end wall — sequences that drive forward must
    keep the camera comfortably in front of it (a camera at z >= far_z
    passes through the wall and sees only background).
    """
    scene = PlaneScene()
    far = frontal_plane(smooth_texture(rng, tex_size, tex_size), z=far_z)
    left = Plane(
        p0=np.array([-4.0, 0.0, 0.0]),
        n=np.array([1.0, 0.0, 0.0]),
        e1=np.array([0.0, 0.0, 1.0]),
        e2=np.array([0.0, 1.0, 0.0]),
        texture=smooth_texture(rng, tex_size, tex_size),
    )
    right = Plane(
        p0=np.array([4.0, 0.0, 0.0]),
        n=np.array([-1.0, 0.0, 0.0]),
        e1=np.array([0.0, 0.0, 1.0]),
        e2=np.array([0.0, 1.0, 0.0]),
        texture=smooth_texture(rng, tex_size, tex_size),
    )
    ground = ground_plane(smooth_texture(rng, tex_size, tex_size), y=1.5)
    scene.planes = [far, left, right, ground]
    return scene


def room_scene(rng, tex_size=640, half=6.0):
    """Closed box (4 walls + ground) for loop-closure trajectories."""
    scene = PlaneScene()

    def wall(p0, n, e1, e2):
        return Plane(
            p0=np.array(p0, float), n=np.array(n, float),
            e1=np.array(e1, float), e2=np.array(e2, float),
            texture=smooth_texture(rng, tex_size, tex_size),
        )

    scene.planes = [
        wall([0, 0, half], [0, 0, -1], [1, 0, 0], [0, 1, 0]),    # front
        wall([0, 0, -half], [0, 0, 1], [1, 0, 0], [0, 1, 0]),    # back
        wall([-half, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0]),    # left
        wall([half, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 1, 0]),    # right
        ground_plane(smooth_texture(rng, tex_size, tex_size), y=1.5),
    ]
    return scene


def orbit_trajectory(n_frames, radius=2.0, total_angle=2 * np.pi, center=(0.0, 0.0, 0.0)):
    """Camera orbiting `center`, always facing outward: revisits its start.

    Returns world->cam (R, t) arrays; frame n_frames-1 is (nearly) back at
    the start pose -- the canonical loop-closure trajectory.
    """
    Rs, ts = [], []
    c0 = np.asarray(center, float)
    for i in range(n_frames):
        ang = total_angle * i / max(n_frames - 1, 1)
        # Camera position on the circle; optical axis tangent to it.
        pos = c0 + radius * np.array([np.sin(ang), 0.0, -np.cos(ang)])
        R = so3_exp([0.0, ang, 0.0]).T
        t = -R @ pos
        Rs.append(R.astype(np.float32))
        ts.append(t.astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def ring_graph(K, sim3=False, seed=0):
    """A K-node pose graph shaped like the reference's 2048-node PCG tests
    (`tests/test_ba.py`, `tests/test_loop.py`): nodes on a 2.5 m circle
    (the SLAM orbit's radius) facing along it, exact sequential edges, 4
    exact loop edges (i, K - 4 + i), and an initial guess the truth moved
    by a random walk (1e-3 a step in rotation and translation and, for
    Sim(3) nodes, in log scale, whose truth drifts 0.05 % a node). Node 0
    stays at its truth (the gauge).

    Returns (args, centres): `args` the leading arguments of
    `pose_graph.solve_padded` (R, t, edges) or of
    `pose_graph_sim3.solve_padded` (s, R, t, edges), as numpy; `centres`
    the true camera centres (K, 3)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(K) / K
    R = np.stack([so3_exp([0.0, a, 0.0]).T for a in ang])
    c = 2.5 * np.stack([np.sin(ang), np.zeros(K), -np.cos(ang)], -1)
    s = 1.0005 ** np.arange(K) if sim3 else np.ones(K)
    t = -np.einsum("kij,kj->ki", R, c) * s[:, None]
    edges = []
    for i, j in [(k - 1, k) for k in range(1, K)] + [(i, K - 4 + i) for i in range(4)]:
        # S_i o S_j^-1
        s_ij, R_ij = s[i] / s[j], R[i] @ R[j].T
        e = (i, j, R_ij.astype(np.float32), (t[i] - s_ij * R_ij @ t[j]).astype(np.float32), 1.0)
        edges.append(e[:2] + (float(s_ij),) + e[2:] if sim3 else e)
    walk = np.cumsum(rng.normal(0, 1e-3, (K, 7)), axis=0)
    walk[0] = 0.0
    dR = np.stack([so3_exp(w) for w in walk[:, :3]])
    ds = np.exp(walk[:, 6]) if sim3 else np.ones(K)
    R0 = list(np.einsum("kij,kjl->kil", dR, R).astype(np.float32))
    t0 = list((ds[:, None] * np.einsum("kij,kj->ki", dR, t) + walk[:, 3:6]).astype(np.float32))
    args = ([float(x) for x in ds * s], R0, t0, edges) if sim3 else (R0, t0, edges)
    return args, c


def forward_trajectory(n_frames, step=0.15, yaw_rate=0.0):
    """World->cam pose sequence moving forward (+z) with optional yaw."""
    Rs, ts = [], []
    R_wc = np.eye(3)
    c = np.zeros(3)
    for i in range(n_frames):
        yaw = yaw_rate
        Rz = so3_exp([0.0, yaw, 0.0])
        if i > 0:
            R_wc = R_wc @ Rz
            c = c + R_wc @ np.array([0.0, 0.0, step])
        R = R_wc.T
        t = -R @ c
        Rs.append(R.astype(np.float32))
        ts.append(t.astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def make_stereo_pair(scene, intr, R, t, h, w, baseline=0.54):
    """Left image at (R, t); right camera displaced by +baseline along x."""
    img_l, depth_l = scene.render(intr, R, t, h, w)
    # Right camera pose: same R, center shifted by baseline along cam x.
    c_l = -np.asarray(R).T @ np.asarray(t)
    c_r = c_l + np.asarray(R).T @ np.array([baseline, 0.0, 0.0])
    t_right = -np.asarray(R) @ c_r
    img_r, _ = scene.render(intr, R, t_right, h, w)
    return img_l, img_r, depth_l


def render_sequence(scene, intr, Rs, ts, h, w):
    """Mono frames (float32 (h, w) each) rendered at the poses (Rs, ts)."""
    return [scene.render(intr, R, t, h, w)[0] for R, t in zip(Rs, ts)]


class PhotometricNuisance:
    """Per-frame photometric degradation: a smoothly drifting exposure
    gain/bias (an auto-exposure-style random walk), Gaussian sensor noise
    and mild defocus blur -- a real sensor's violations of the brightness
    constancy that direct tracking assumes.

    Stereo: call `step` once per frame and `apply` to both images (a rig's
    two imagers share exposure control; noise is drawn per image).
    """

    def __init__(self, rng, gain_sigma=0.02, bias_sigma=1.0,
                 gain_range=(0.7, 1.4), bias_range=(-25.0, 25.0),
                 noise_std=3.0, blur_sigma=0.6):
        self.rng = rng
        self.gain = 1.0
        self.bias = 0.0
        self.gain_sigma = gain_sigma
        self.bias_sigma = bias_sigma
        self.gain_range = gain_range
        self.bias_range = bias_range
        self.noise_std = noise_std
        self.blur_sigma = blur_sigma

    def step(self):
        """Advance the exposure random walk one frame."""
        self.gain = float(np.clip(
            self.gain * np.exp(self.rng.normal(0.0, self.gain_sigma)), *self.gain_range
        ))
        self.bias = float(np.clip(
            self.bias + self.rng.normal(0.0, self.bias_sigma), *self.bias_range
        ))

    def apply(self, img):
        """Degrade one image with the current exposure state."""
        from scipy.ndimage import gaussian_filter

        out = np.asarray(img, np.float32)
        if self.blur_sigma > 0:
            out = gaussian_filter(out, self.blur_sigma)
        out = out * self.gain + self.bias
        if self.noise_std > 0:
            out = out + self.rng.normal(0.0, self.noise_std, out.shape)
        return np.clip(out, 0.0, 255.0).astype(np.float32)
