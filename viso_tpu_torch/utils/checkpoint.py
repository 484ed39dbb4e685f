"""Checkpoint / resume for map state, SLAM state and trajectories (port
of `viso_tpu/utils/checkpoint.py`).

The format is the JAX package's: one compressed .npz of numpy arrays plus
a JSON `_meta` record, with the same keys, so a checkpoint written by
either package loads in the other. Descriptors are stored as float32
(npz has no bfloat16) and restored to bfloat16 on the device.

A SLAM checkpoint holds a StereoSLAM or a MonoSLAM (`kind` in `_meta`);
a monocular one adds the Sim(3) graph's node scales (`pg_s`) and edge
scale ratios (`edge_s`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from viso_tpu_torch.mapping import map_state
from viso_tpu_torch.mapping.map_state import MapState

_FORMAT_VERSION = 1

_MAP_KEYS = ("kf_R", "kf_t", "kf_mask", "kf_frame_id", "points", "point_mask",
             "obs_uv", "obs_mask")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _meta_array(meta: dict):
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _write(path: str, arrays: dict):
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    # numpy appends .npz to the temporary name.
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _read(path: str):
    data = np.load(path)
    meta = json.loads(bytes(data["_meta"]).decode())
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    return data, meta


def _map_arrays(m: MapState) -> dict:
    arrays = {k: _host(getattr(m, k)) for k in _MAP_KEYS}
    for lvl, img in enumerate(m.kf_pyr):
        arrays[f"kf_pyr_{lvl}"] = _host(img)
    return arrays


def _map_from(data, num_levels: int, device) -> MapState:
    fields = {k: data[k] for k in _MAP_KEYS}
    fields["kf_pyr"] = [data[f"kf_pyr_{lvl}"] for lvl in range(num_levels)]
    return map_state.from_numpy(fields, device)


def save_map(path: str, m: MapState, extra: dict | None = None):
    """Serialize a MapState (+ optional JSON-able metadata) to .npz."""
    arrays = _map_arrays(m)
    arrays["_meta"] = _meta_array(
        {"version": _FORMAT_VERSION, "num_levels": len(m.kf_pyr), "extra": extra or {}}
    )
    _write(path, arrays)


def load_map(path: str, *, device):
    """Load a MapState checkpoint onto `device`. Returns (MapState,
    extra_metadata)."""
    data, meta = _read(path)
    return _map_from(data, meta["num_levels"], device), meta["extra"]


def _stack(rows, shape):
    return np.stack(rows) if rows else np.zeros((0,) + shape)


def save_slam(path: str, slam, extra: dict | None = None):
    """Full SLAM checkpoint (StereoSLAM or MonoSLAM): map window, live pose
    and motion model, pose graph (with node scales and edge scale ratios
    for the mono Sim(3) graph) and loop database. `load_slam` resumes a
    run that keeps tracking and keeps closing loops against
    pre-checkpoint places.

    Per-frame results recorded before the checkpoint are not stored
    (write the trajectory separately with save_trajectory); the resumed
    engine records from the checkpoint onward.
    """
    from viso_tpu_torch.slam.mono_full import MonoSLAM

    slam.join()
    db = slam.loop_db
    edges = slam.pg_edges
    mono = isinstance(slam, MonoSLAM)
    # Mono edges are (i, j, s_ij, R, t, w), stereo ones (i, j, R, t, w).
    rt = 3 if mono else 2
    arrays = _map_arrays(slam.map)
    arrays.update({
        "R": _host(slam.R), "t": _host(slam.t),
        "prev_R": _host(slam.prev_R), "prev_t": _host(slam.prev_t),
        "vel_xi": _host(slam.vel_xi),
        "pg_raw_R": _stack(slam.pg_raw_R, (3, 3)),
        "pg_raw_t": _stack(slam.pg_raw_t, (3,)),
        "pg_R": _stack(slam.pg_R, (3, 3)),
        "pg_t": _stack(slam.pg_t, (3,)),
        "pg_frame": np.asarray(slam.pg_frame, np.int64),
        "edge_i": np.asarray([e[0] for e in edges], np.int64),
        "edge_j": np.asarray([e[1] for e in edges], np.int64),
        "edge_R": _stack([e[rt] for e in edges], (3, 3)),
        "edge_t": _stack([e[rt + 1] for e in edges], (3,)),
        "edge_w": np.asarray([e[-1] for e in edges], np.float32),
        "db_desc": _host(db.desc.float()),
        "db_desc_mask": _host(db.desc_mask),
        "db_kp_uv": db.kp_uv, "db_points_w": db.points_w,
        "db_points_ok": db.points_ok, "db_R": db.R, "db_t": db.t,
        "db_frame_id": db.frame_id, "db_node_id": db.node_id,
        "db_path_len": db.path_len, "db_rot_len": db.rot_len,
        "db_seam_t": db.seam_t, "db_seam_r": db.seam_r,
        "db_insert_seq": db.insert_seq,
    })
    if mono:
        arrays["pg_s"] = np.asarray(slam.pg_s, np.float32)
        arrays["edge_s"] = np.asarray([e[2] for e in edges], np.float32)
    arrays["_meta"] = _meta_array({
        "version": _FORMAT_VERSION,
        "num_levels": len(slam.map.kf_pyr),
        "frame_idx": slam.frame_idx,
        "last_kf_frame": slam.last_kf_frame,
        "kf_order": list(slam.kf_order),
        "path_len": slam._path_len,
        "rot_len": slam._rot_len,
        "seam_trans": slam._seam_trans,
        "seam_rot": slam._seam_rot,
        "kind": "mono" if mono else "stereo",
        "db_total": db.total,
        "loops": slam.loops,
        "extra": extra or {},
    })
    _write(path, arrays)


def load_slam(path: str, config, loop_params=None, *, device):
    """Restore a StereoSLAM or MonoSLAM (by the checkpoint's `kind`) from a
    save_slam checkpoint onto `device`.

    `config` / `loop_params` must match the capacities the checkpoint was
    written with. Returns (slam, extra_metadata).
    """
    from viso_tpu_torch.slam.full import StereoSLAM
    from viso_tpu_torch.slam.mono_full import MonoSLAM

    data, meta = _read(path)
    mono = meta.get("kind") == "mono"
    slam = (MonoSLAM if mono else StereoSLAM)(config, loop_params, device=device)

    def dev(a):
        return torch.tensor(np.asarray(a), device=slam.device)

    slam.map = _map_from(data, meta["num_levels"], slam.device)
    slam.R, slam.t = dev(data["R"]), dev(data["t"])
    slam.prev_R, slam.prev_t = dev(data["prev_R"]), dev(data["prev_t"])
    if "vel_xi" in data:
        slam.vel_xi = dev(data["vel_xi"])
    slam.frame_idx = meta["frame_idx"]
    slam.last_kf_frame = meta["last_kf_frame"]
    slam.kf_order = list(meta["kf_order"])
    slam.state = "tracking" if slam.kf_order else "init"
    slam.pg_raw_R = list(data["pg_raw_R"])
    slam.pg_raw_t = list(data["pg_raw_t"])
    slam.pg_R = list(data["pg_R"])
    slam.pg_t = list(data["pg_t"])
    slam.pg_frame = [int(f) for f in data["pg_frame"]]

    def edge(k):
        s_ij = (float(data["edge_s"][k]),) if mono else ()
        return (int(data["edge_i"][k]), int(data["edge_j"][k]), *s_ij, data["edge_R"][k],
                data["edge_t"][k], float(data["edge_w"][k]))

    slam.pg_edges = [edge(k) for k in range(len(data["edge_i"]))]
    if mono:
        slam.pg_s = [float(v) for v in data["pg_s"]]
    slam._seam_trans = meta.get("seam_trans", 0.0)
    slam._seam_rot = meta.get("seam_rot", 0.0)
    slam.loops = list(meta["loops"])
    slam._path_len = meta["path_len"]
    slam._rot_len = meta["rot_len"]
    slam._next_node = len(slam.pg_raw_R)
    db = slam.loop_db
    # The device tensors are written in place: detection's programs read
    # them where they lie.
    db.desc.copy_(dev(data["db_desc"]).to(torch.bfloat16))
    db.desc_mask.copy_(dev(data["db_desc_mask"]))
    for name in ("kp_uv", "points_w", "points_ok", "R", "t", "frame_id", "node_id",
                 "path_len", "rot_len", "insert_seq"):
        setattr(db, name, data["db_" + name].copy())
    if "db_seam_t" in data:
        db.seam_t = data["db_seam_t"].copy()
        db.seam_r = data["db_seam_r"].copy()
    # Device mirrors of the landmark geometry, read by detection.
    db.points_w_dev.copy_(dev(db.points_w.astype(np.float32)))
    db.points_ok_dev.copy_(dev(db.points_ok))
    db.total = meta["db_total"]
    if slam.kf_order:
        slam._refresh_templates(slam.kf_order[-1])
    return slam, meta["extra"]


def save_trajectory(path: str, R, t, fmt: str = "kitti"):
    """Write a trajectory in KITTI format (cam->world [R|t] rows)."""
    R = _host(R)
    t = _host(t)
    rows = []
    for k in range(len(R)):
        P = np.concatenate([R[k].T, (-R[k].T @ t[k])[:, None]], axis=1)
        rows.append(" ".join(f"{v:.9e}" for v in P.reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def load_trajectory(path: str):
    """Read a KITTI-format trajectory -> (R, t) world->cam."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    R = np.transpose(data[:, :, :3], (0, 2, 1))
    t = -np.einsum("nij,nj->ni", R, data[:, :, 3])
    return R.astype(np.float32), t.astype(np.float32)
