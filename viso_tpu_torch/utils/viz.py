"""Visualization: debug overlays, trajectory and map rendering (port of
`viso_tpu/utils/viz.py`).

Headless: keypoint and track overlays as RGB arrays, a top-down
trajectory and map as PNG (matplotlib, imported inside the two plotting
functions, which raise ImportError where it is absent), and a
self-contained HTML 3-D map viewer.
"""

from __future__ import annotations

import numpy as np


def to_rgb(img):
    """Grayscale (H, W) float -> uint8 RGB."""
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_keypoints(img, uv, mask=None, color=(0, 255, 0), radius=2):
    """Draw keypoint squares (the reference draws cv::rectangle overlays,
    viso.cpp:123-135). Returns an RGB uint8 image."""
    rgb = to_rgb(img) if img.ndim == 2 else np.array(img, dtype=np.uint8)
    H, W = rgb.shape[:2]
    uv = np.asarray(uv)
    mask = np.ones(len(uv), bool) if mask is None else np.asarray(mask)
    for (u, v), ok in zip(uv, mask):
        if not ok:
            continue
        u, v = int(round(u)), int(round(v))
        if not (radius <= u < W - radius and radius <= v < H - radius):
            continue
        rgb[v - radius : v + radius + 1, u - radius] = color
        rgb[v - radius : v + radius + 1, u + radius] = color
        rgb[v - radius, u - radius : u + radius + 1] = color
        rgb[v + radius, u - radius : u + radius + 1] = color
    return rgb


def draw_tracks(img, uv0, uv1, mask=None, color=(255, 200, 0)):
    """Draw flow segments from uv0 to uv1 (init overlay, viso.cpp:56-75)."""
    rgb = to_rgb(img) if np.asarray(img).ndim == 2 else np.array(img, np.uint8)
    H, W = rgb.shape[:2]
    uv0 = np.asarray(uv0)
    uv1 = np.asarray(uv1)
    mask = np.ones(len(uv0), bool) if mask is None else np.asarray(mask)
    for (a, b), ok in zip(zip(uv0, uv1), mask):
        if not ok:
            continue
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
        us = np.linspace(a[0], b[0], n).round().astype(int)
        vs = np.linspace(a[1], b[1], n).round().astype(int)
        keep = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
        rgb[vs[keep], us[keep]] = color
    return rgb


def plot_trajectory(est_R, est_t, gt_R=None, gt_t=None, path=None, title=""):
    """Top-down (x-z) trajectory plot; saves PNG if path given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from viso_tpu_torch.utils.metrics import camera_centers

    fig, ax = plt.subplots(figsize=(7, 7))
    c = camera_centers(np.asarray(est_R), np.asarray(est_t))
    ax.plot(c[:, 0], c[:, 2], "b-", lw=1.2, label="estimate")
    if gt_R is not None:
        g = camera_centers(np.asarray(gt_R), np.asarray(gt_t))
        ax.plot(g[:, 0], g[:, 2], "k--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_map_topdown(points, point_mask, kf_R=None, kf_t=None, path=None):
    """Top-down map scatter + camera frusta markers (main.cpp:56-103)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from viso_tpu_torch.utils.metrics import camera_centers

    fig, ax = plt.subplots(figsize=(7, 7))
    p = np.asarray(points)[np.asarray(point_mask)]
    ax.scatter(p[:, 0], p[:, 2], s=1, c="gray", label="landmarks")
    if kf_R is not None:
        c = camera_centers(np.asarray(kf_R), np.asarray(kf_t))
        ax.plot(c[:, 0], c[:, 2], "b^-", ms=5, label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


_VIEWER_JS = """
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = 0.6, pitch = 0.4, dist = DIST0, cx = 0, cy = 0;
let drag = null, pan = false;
function resize() { cv.width = innerWidth; cv.height = innerHeight; draw(); }
function project(p) {
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x = p[0] - CENTER[0], y = p[1] - CENTER[1], z = p[2] - CENTER[2];
  let x1 = cy_ * x + sy * z, z1 = -sy * x + cy_ * z;
  let y2 = cp * y - sp * z1, z2 = sp * y + cp * z1;
  const zc = z2 + dist;
  if (zc < 0.1) return null;
  const f = 0.9 * Math.min(cv.width, cv.height);
  return [cv.width / 2 + f * (x1 + cx) / zc, cv.height / 2 + f * (y2 + cy) / zc, zc];
}
function draw() {
  ctx.fillStyle = '#101018'; ctx.fillRect(0, 0, cv.width, cv.height);
  for (const p of POINTS) {
    const q = project(p);
    if (!q) continue;
    const s = Math.max(1, 3.5 - q[2] * 0.08);
    ctx.fillStyle = '#d8d8e8'; ctx.fillRect(q[0], q[1], s, s);
  }
  ctx.strokeStyle = '#4ea1ff'; ctx.lineWidth = 2; ctx.beginPath();
  let started = false;
  for (const p of TRAJ) {
    const q = project(p);
    if (!q) { started = false; continue; }
    if (!started) { ctx.moveTo(q[0], q[1]); started = true; }
    else ctx.lineTo(q[0], q[1]);
  }
  ctx.stroke();
  if (TRAJ.length) {
    const q = project(TRAJ[TRAJ.length - 1]);
    if (q) { ctx.fillStyle = '#ff5a5a'; ctx.beginPath();
             ctx.arc(q[0], q[1], 5, 0, 7); ctx.fill(); }
  }
  ctx.fillStyle = '#9aa'; ctx.font = '12px monospace';
  ctx.fillText(`${POINTS.length} landmarks | ${TRAJ.length} poses | ` +
               'drag: orbit, shift-drag: pan, wheel: zoom', 8, 16);
}
cv.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; pan = e.shiftKey; });
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (pan) { cx += dx * dist * 0.0015; cy += dy * dist * 0.0015; }
  else { yaw += dx * 0.008; pitch += dy * 0.008; }
  draw();
});
cv.addEventListener('wheel', e => { dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); });
addEventListener('resize', resize);
resize();
"""


def export_map_html(points, point_mask, traj_centers, path,
                    title="viso_tpu map"):
    """Interactive 3-D map viewer as ONE self-contained HTML file.

    The reference's Pangolin window (main.cpp:56-103: white map points +
    camera path, mouse-orbit camera) as a zero-dependency artifact this
    headless environment can produce: landmarks + trajectory embedded as
    JSON, rendered with a ~60-line canvas projector (drag = orbit,
    shift-drag = pan, wheel = zoom). Open in any browser.
    """
    import json

    pts = np.asarray(points, np.float32)
    mask = np.asarray(point_mask, bool)
    pts = pts[mask]
    traj = np.asarray(traj_centers, np.float32).reshape(-1, 3)
    all_pts = np.concatenate([pts, traj], axis=0) if len(pts) else traj
    if len(all_pts):
        center = np.median(all_pts, axis=0)
        spread = float(
            np.percentile(np.linalg.norm(all_pts - center, axis=1), 90)
        )
    else:
        center, spread = np.zeros(3), 1.0
    js = (
        f"const POINTS = {json.dumps(np.round(pts, 3).tolist())};\n"
        f"const TRAJ = {json.dumps(np.round(traj, 3).tolist())};\n"
        f"const CENTER = {json.dumps(center.round(3).tolist())};\n"
        f"const DIST0 = {max(2.5 * spread, 1.0):.3f};\n" + _VIEWER_JS
    )
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title>"
        "<style>body{margin:0;overflow:hidden}canvas{display:block}</style>"
        "</head><body><canvas id='c'></canvas>"
        f"<script>{js}</script></body></html>"
    )
    with open(path, "w") as f:
        f.write(html)
    return path
