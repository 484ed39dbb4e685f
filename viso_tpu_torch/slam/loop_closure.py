"""Loop-closure detection for the SLAM layer (port of
`viso_tpu/slam/loop_closure.py`).

  1. Every keyframe adds a fixed-size steered-BRIEF descriptor set to a
     fixed-capacity database (bfloat16 on the device, as the JAX package
     stores it), so scoring against every stored keyframe is one batched
     matmul.
  2. The candidate is the eligible keyframe (outside a temporal guard
     window) with the most mutual ratio-test matches.
  3. Geometric verification: PnP RANSAC of the candidate's stored 3-D
     landmarks against the current keyframe's matched 2-D features.
  4. A host-side gate bounds the implied correction by the drift accrued
     since the candidate was stored; a verified edge joins the pose graph.

Steps 2-3 are one device pass (`_detect`) returning a 16-float packed
vector that the caller copies to the host once. The JAX package jits it
as one program; here it runs as a few (`slam/programs.Cache`: captured
as CUDA graphs on a CUDA database and replayed), one per segment between
the calls that read the device on the host: the hypotheses' draw from
the database's generator, and the PnP DLT's `eigh` and `svd` (and the
Umeyama fit's `svd`), which check their solver status on the host on
CUDA and run eagerly between the replays, so the arithmetic is the
eager function's (`_detect_fused_kernel`) bit for bit. The JAX package
skips PnP under `lax.cond` when the match gates fail; a graph cannot
branch on a device value, so here PnP always runs and its result is
selected with `torch.where` (the packed vector is the same).

Hypotheses for RANSAC come from the database's `torch.Generator`, by the
rule of the JAX package's `jax.random.categorical` draw; the streams
differ, so runs agree with the JAX package in outcome, not bit for bit.
The Sim(3) variant (`detect_fused_sim3`, monocular SLAM) also fits the
relative similarity of the two keyframes' local metrics (a masked
Umeyama over the PnP inliers) in the same device function, and returns a
29-float packed vector.
"""

from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from viso_tpu_torch.geometry import camera as cam_mod
from viso_tpu_torch.geometry import se3, sim3
from viso_tpu_torch.mapping.map_state import row
from viso_tpu_torch.ops import descriptors, pnp, ransac
from viso_tpu_torch.slam import programs as prog_mod

# VISO_LOOP_DEBUG=1 prints every candidate's gate record to stderr.
_DEBUG_ENV = os.environ.get("VISO_LOOP_DEBUG") == "1"


@dataclass
class LoopParams:
    capacity: int = 256            # stored keyframes
    num_features: int = 256        # descriptors per keyframe
    guard: int = 30                # skip this many most-recent keyframes
    min_matches: int = 40          # descriptor matches to be a candidate
    min_inliers: int = 30          # PnP inliers to accept
    # Reprojection gate in pixels (normalized per camera at detect time):
    # re-detected FAST corners land 1-2 px apart across views.
    pnp_threshold_px: float = 4.0
    # Drift-scaled plausibility gate on the implied correction: a true
    # loop may disagree with odometry by the drift accrued since the
    # candidate was stored,
    #   trans: base_correction_m  + trans_drift_rate * path_since_cand
    #   rot:   base_correction_rad + rot_drift_rate  * rot_since_cand
    # clamped above by the hard ceilings max_correction_m / rad.
    base_correction_m: float = 0.3
    base_correction_rad: float = 0.05
    trans_drift_rate: float = 0.05     # m disagreement per m traveled
    rot_drift_rate: float = 0.05       # rad per rad integrated rotation
    max_correction_m: float = 10.0
    max_correction_rad: float = 1.2
    # A loop crossing a dead-reckoning seam relaxes to the hard ceilings
    # when its PnP evidence is at least this multiple of min_inliers.
    # 0 disables.
    seam_evidence_factor: float = 1.5
    # Overwhelming evidence (inliers >= this multiple of min_inliers)
    # overrides the scaled bound up to the hard ceilings. 0 (off) by
    # default: self-similar texture yields strong aliased fits.
    evidence_override: float = 0.0
    # Graded evidence scaling of the drift budget: multiplied by
    # clamp(inliers / min_inliers, 1, this cap). 0 disables.
    evidence_boost_cap: float = 1.6
    # Pose-graph optimization fires at most once per this many keyframe
    # insertions (loop edges join the graph at once and are incorporated
    # at the next event).
    min_event_gap_kf: int = 3
    # Retention once the database is full: the most recent
    # `retain_recent` insertions are never evicted; beyond them the most
    # spatially redundant entry is recycled.
    retain_recent: int = 64


class LoopCandidate(NamedTuple):
    db_index: int       # caller-supplied external id (pose-graph node)
    matches: int
    inliers: int
    R_rel: np.ndarray   # measured T_cur * T_cand^-1
    t_rel: np.ndarray
    # Monocular: measured relative scale (Sim3 edge; 1.0 for stereo).
    s_rel: float = 1.0


def _np(x):
    """Host numpy copy of a tensor (blocking for a CUDA tensor) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LoopDatabase:
    """Fixed-capacity store of keyframe descriptor sets and geometry.

    When full, eviction is two-tier: the most recent `retain_recent`
    insertions are protected, and among the rest the most spatially
    redundant entry is recycled (smallest sum of the two nearest
    camera-centre distances, with a small seeded jitter to break exact
    ties), so old, spatially distinct places survive. Entries carry the
    caller's `node_id`, so candidates stay addressable after slots are
    recycled. Device tensors (descriptors, landmark mirrors) are updated
    in place; the host mirrors are numpy.
    """

    def __init__(self, params: LoopParams, seed: int = 0, *, device, programs=None):
        p = params
        self.params = p
        self.device = torch.device(device)
        dev = self.device
        self.desc = torch.zeros(
            (p.capacity, p.num_features, descriptors.DESC_BITS),
            dtype=torch.bfloat16, device=dev,
        )
        self.desc_mask = torch.zeros((p.capacity, p.num_features), dtype=torch.bool,
                                     device=dev)
        self.kp_uv = np.zeros((p.capacity, p.num_features, 2), np.float32)
        self.points_w = np.zeros((p.capacity, p.num_features, 3), np.float32)
        self.points_ok = np.zeros((p.capacity, p.num_features), bool)
        # Device mirrors of the landmark geometry: detection verifies on
        # the device, so candidate landmarks must already live there.
        self.points_w_dev = torch.zeros((p.capacity, p.num_features, 3),
                                        dtype=torch.float32, device=dev)
        self.points_ok_dev = torch.zeros((p.capacity, p.num_features), dtype=torch.bool,
                                         device=dev)
        self.R = np.zeros((p.capacity, 3, 3), np.float32)
        self.t = np.zeros((p.capacity, 3), np.float32)
        self.frame_id = np.full(p.capacity, -1, np.int64)
        self.node_id = np.full(p.capacity, -1, np.int64)
        # Odometry arc-length integrals (m, rad) at insertion time: the
        # drift-scaled gate's clock.
        self.path_len = np.zeros(p.capacity, np.float32)
        self.rot_len = np.zeros(p.capacity, np.float32)
        # Dead-reckoning seam allowances (m, rad) at insertion time.
        self.seam_t = np.zeros(p.capacity, np.float32)
        self.seam_r = np.zeros(p.capacity, np.float32)
        # Optional gate diagnostics: set to a list to record every
        # candidate's gate inputs and decision.
        self.debug: Optional[list] = None
        self.total = 0
        self.insert_seq = np.full(p.capacity, -1, np.int64)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self._evict_rng = np.random.default_rng(seed + 0x5EED)
        # Detection's programs (the owner's cache, shared with its other
        # programs, or one of its own); the device tensors above are
        # written in place and read where they lie.
        self.programs = programs if programs is not None else prog_mod.Cache(dev)
        self.programs.own(self.desc, self.desc_mask, self.points_w_dev, self.points_ok_dev)

    @property
    def count(self) -> int:
        """Live entries (== capacity once the ring has wrapped)."""
        return min(self.total, self.params.capacity)

    def _put(self, dst, x):
        """dst.copy_(x) without a host sync (x on the device, in pinned
        host memory, or a numpy array)."""
        dst.copy_(torch.as_tensor(x), non_blocking=True)

    def add(self, img_smooth, kps, kp_mask, points_w, points_ok, R, t,
            frame_id, node_id=-1, path_len=0.0, rot_len=0.0, desc=None,
            seam_t=0.0, seam_r=0.0):
        """Store a keyframe: descriptors at `kps` (or the precomputed
        `desc`), its pose, the 3-D landmarks of those keypoints
        (points_ok marks which), the caller's `node_id` and the odometry
        integrals at insertion. Arrays may be tensors (on the device or
        on the host) or numpy. Returns the slot written."""
        if self.total < self.params.capacity:
            i = self.total
        else:
            i = self._evict_slot()
        if desc is None:
            desc = descriptors.compute(
                torch.as_tensor(img_smooth, device=self.device),
                torch.as_tensor(kps, device=self.device),
                torch.as_tensor(kp_mask, device=self.device),
            )
        self._put(self.desc[i], desc)
        self._put(self.desc_mask[i], kp_mask)
        self._put(self.points_w_dev[i], points_w)
        self._put(self.points_ok_dev[i], points_ok)
        self.kp_uv[i] = _np(kps)
        self.points_w[i] = _np(points_w)
        self.points_ok[i] = _np(points_ok)
        self.R[i] = _np(R)
        self.t[i] = _np(t)
        self.frame_id[i] = frame_id
        self.node_id[i] = node_id if node_id >= 0 else self.total
        self.path_len[i] = path_len
        self.rot_len[i] = rot_len
        self.seam_t[i] = seam_t
        self.seam_r[i] = seam_r
        self.insert_seq[i] = self.total
        self.total += 1
        return i

    def _evict_slot(self) -> int:
        """The slot to recycle: the most spatially redundant entry outside
        the protected recent tier (redundancy measured against the
        long-term set only)."""
        p = self.params
        seq = self.insert_seq
        protected = seq > self.total - 1 - p.retain_recent
        evictable = np.nonzero(~protected)[0]
        if len(evictable) == 0:
            # retain_recent >= capacity: pure recency ring.
            return int(np.argmin(seq))
        if len(evictable) == 1:
            return int(evictable[0])
        centers = -np.einsum("nji,nj->ni", self.R, self.t)
        c_ev = centers[evictable]
        d = np.linalg.norm(c_ev[:, None, :] - c_ev[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        ds = np.sort(d, axis=1)
        # Removal harm ~ the gap the eviction opens.
        harm = ds[:, 0] + ds[:, 1]
        # Multiplicative jitter breaks exact ties of uniform spacing.
        harm = harm * (1.0 + 0.01 * self._evict_rng.random(len(evictable)))
        return int(evictable[int(np.argmin(harm))])

    def _eligible(self):
        p = self.params
        # Temporal guard: skip the `guard` most recent insertions.
        return (self.insert_seq >= 0) & (self.insert_seq <= self.total - 1 - p.guard)

    def detect(self, img_smooth, kps, kp_mask, R_cur, t_cur, intr,
               path_len=None, rot_len=None) -> Optional[LoopCandidate]:
        """Look for a verified loop closure for the current keyframe."""
        kps = torch.as_tensor(kps, device=self.device)
        kp_mask = torch.as_tensor(kp_mask, device=self.device)
        desc_q = descriptors.compute(
            torch.as_tensor(img_smooth, device=self.device), kps, kp_mask
        )
        return self.detect_fused(desc_q, kps, kp_mask, R_cur, t_cur, intr,
                                 path_len=path_len, rot_len=rot_len)

    def detect_fused(self, desc_q, kps, kp_mask, R_cur, t_cur, intr,
                     path_len=None, rot_len=None, seam_t=None,
                     seam_r=None) -> Optional[LoopCandidate]:
        """Loop detection with precomputed query descriptors: one device
        pass (`_detect_fused_kernel`) and one copy of its packed result to
        the host, then the host gate."""
        packed = self._detect_packed((desc_q, kp_mask, kps), intr)
        if packed is None:
            return None
        return self._gate_packed(
            packed, R_cur, t_cur, path_len, rot_len, seam_t, seam_r
        )

    def detect_fused_sim3(self, desc_q, kps, kp_mask, pts_q, pts_q_ok, R_cur, t_cur,
                          intr, path_len=None, rot_len=None, seam_t=None,
                          seam_r=None) -> Optional[LoopCandidate]:
        """Monocular loop detection: `detect_fused` plus a masked-Umeyama
        relative Sim(3) between the candidate's and the current segment's
        local metrics, so the edge carries their scale ratio. `pts_q`
        (the current keyframe's landmarks, in keypoint order) and
        `pts_q_ok` stay on the device; `R_cur`, `t_cur` are the host's
        odometry pose. One device pass, one copy to the host."""
        pose = [x if isinstance(x, torch.Tensor)
                else prog_mod.host_tensors([np.ascontiguousarray(x)], self.device)[0]
                for x in (R_cur, t_cur)]
        query = (desc_q, kp_mask, kps, pts_q, pts_q_ok, *pose)
        packed = self._detect_packed(query, intr)
        if packed is None:
            return None
        cand = self._gate_packed(packed, R_cur, t_cur, path_len, rot_len, seam_t, seam_r)
        if cand is None:
            return None
        s_g = float(packed[16])
        # A fit implying more than 0.7 of log-scale disagreement marks a
        # degenerate geometry (a near-planar inlier set), not drift.
        if abs(np.log(max(s_g, 1e-6))) > 0.7:
            if _DEBUG_ENV:
                print(f"[loop-stage] implausible scale ratio {s_g:.3f}", file=sys.stderr)
            return None
        # The Umeyama G is the graph edge's measurement S_cand o S_cur^-1
        # (cam_cur-local -> cam_cand-local).
        return cand._replace(s_rel=s_g, R_rel=packed[17:26].reshape(3, 3).astype(np.float32),
                             t_rel=packed[26:29].astype(np.float32))

    def _detect_packed(self, query, intr):
        """The detection's segments over the database (hypotheses drawn from
        its generator, `pnp.draw_hypotheses`), through its programs, and one
        copy of the packed result to the host; None when no entry is
        outside the temporal guard."""
        p = self.params
        eligible = self._eligible()
        if not eligible.any():
            return None
        thresh = (p.pnp_threshold_px / float(intr.fx)) ** 2
        db = (self.desc, self.desc_mask, self.points_w_dev, self.points_ok_dev)
        eligible = prog_mod.host_tensors([eligible], self.device)[0]
        packed = _detect(self.programs.run, query, db, eligible, intr, thresh, p.min_matches,
                         p.min_inliers, functools.partial(pnp.draw_hypotheses, self.generator))
        return packed.cpu().numpy()

    def _gate_packed(self, packed, R_cur, t_cur, path_len, rot_len,
                     seam_t=None, seam_r=None):
        """Host-side gating of a packed detection result: match and
        inlier thresholds, then the drift-scaled plausibility bound on
        the implied correction (numpy, as in the JAX package)."""
        p = self.params
        best_matches = int(packed[0])
        best = int(packed[1])
        n_3d = int(packed[2])
        n_inl = int(packed[3])
        R_meas = packed[4:13].reshape(3, 3).astype(np.float32)
        t_meas = packed[13:16].astype(np.float32)
        if best_matches < p.min_matches:
            if _DEBUG_ENV:
                print(f"[loop-stage] best_matches={best_matches} < "
                      f"min_matches={p.min_matches} (cand node "
                      f"{int(self.node_id[best])})", file=sys.stderr)
            return None
        if n_3d < p.min_inliers:
            if _DEBUG_ENV:
                print(f"[loop-stage] matched-with-3d={n_3d} < "
                      f"min_inliers={p.min_inliers}", file=sys.stderr)
            return None
        if n_inl < p.min_inliers:
            if _DEBUG_ENV:
                print(f"[loop-stage] pnp_inliers={n_inl} < "
                      f"min_inliers={p.min_inliers}", file=sys.stderr)
            return None
        R_cur = _np(R_cur)
        t_cur = _np(t_cur)
        R_db, t_db = self.R[best], self.t[best]
        # Measured relative: T_meas o T_db^-1.
        R_rel = R_meas @ R_db.T
        t_rel = t_meas - R_rel @ t_db
        # Plausibility: measured relative vs the current odometry
        # estimate; the disagreement is accumulated drift unless it
        # exceeds the bounds (a visually aliased false positive).
        R_est = R_cur @ R_db.T
        t_est = t_cur - R_est @ t_db
        dR = R_rel.T @ R_est
        dt = R_rel.T @ (t_est - t_rel)
        d_trans = float(np.linalg.norm(dt))
        d_rot = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        if path_len is not None:
            dpath = max(0.0, float(path_len) - float(self.path_len[best]))
        else:
            dpath = None
        if rot_len is not None:
            drot_i = max(0.0, float(rot_len) - float(self.rot_len[best]))
        else:
            drot_i = None
        bound_m = p.max_correction_m
        bound_rad = p.max_correction_rad
        if dpath is not None:
            bound_m = min(bound_m, p.base_correction_m + p.trans_drift_rate * dpath)
        if drot_i is not None:
            bound_rad = min(bound_rad, p.base_correction_rad + p.rot_drift_rate * drot_i)
        # Dead-reckoning seams since the candidate was stored enter the
        # budget at full magnitude (capped by the hard ceilings).
        if seam_t is not None:
            bound_m = min(
                p.max_correction_m,
                bound_m + max(0.0, float(seam_t) - float(self.seam_t[best])),
            )
        if seam_r is not None:
            bound_rad = min(
                p.max_correction_rad,
                bound_rad + max(0.0, float(seam_r) - float(self.seam_r[best])),
            )
        # Graded evidence boost of the drift budget, capped.
        if p.evidence_boost_cap > 0 and p.min_inliers > 0:
            boost = max(1.0, min(p.evidence_boost_cap, n_inl / p.min_inliers))
            bound_m = min(p.max_correction_m, bound_m * boost)
            bound_rad = min(p.max_correction_rad, bound_rad * boost)
        # Overwhelming evidence overrides the scaled bound (off by default).
        if p.evidence_override > 0 and n_inl >= p.evidence_override * p.min_inliers:
            bound_m = p.max_correction_m
            bound_rad = p.max_correction_rad
        # Seam-crossing loops: trust strong geometric evidence up to the
        # hard ceilings.
        if (
            p.seam_evidence_factor > 0
            and seam_t is not None
            and float(seam_t) - float(self.seam_t[best]) > 1e-6
            and n_inl >= p.seam_evidence_factor * p.min_inliers
        ):
            bound_m = p.max_correction_m
            bound_rad = p.max_correction_rad
        accept = d_trans <= bound_m and d_rot <= bound_rad
        if self.debug is not None or _DEBUG_ENV:
            rec = dict(
                cand_node=int(self.node_id[best]),
                matches=best_matches, inliers=n_inl,
                d_trans=d_trans, d_rot=d_rot,
                dpath=dpath, drot=drot_i,
                bound_m=bound_m, bound_rad=bound_rad, accept=accept,
            )
            if self.debug is not None:
                self.debug.append(rec)
            if _DEBUG_ENV:
                print(f"[loop-gate] {rec}", file=sys.stderr)
        if not accept:
            return None
        return LoopCandidate(
            db_index=int(self.node_id[best]),
            matches=best_matches,
            inliers=n_inl,
            R_rel=np.asarray(R_rel),
            t_rel=np.asarray(t_rel),
        )


def _match_counts(desc_q, mask_q, desc_db, mask_db):
    """Number of mutual ratio-test matches against each stored keyframe."""
    _, _, ok = descriptors.match(desc_q, mask_q, desc_db, mask_db)
    return torch.sum(ok, dim=-1)


def _match_stage(desc_q, mask_q, kps_q, desc_db, mask_db, pts_db, pts_ok_db, eligible, *,
                 intr, min_matches, min_inliers):
    """Capacity-wide match scoring, the best candidate and the per-match
    association. Returns (head3 = [best_matches, best_slot,
    n_matched_with_3d], is_cand, match mask, matched candidate landmarks,
    normalized query keypoints); is_cand says whether the match gates
    passed."""
    counts = _match_counts(desc_q, mask_q, desc_db, mask_db)
    counts = torch.where(eligible, counts, -1)
    best = torch.argmax(counts)
    idx2, _, ok = descriptors.match(desc_q, mask_q, row(desc_db, best),
                                    row(mask_db, best))
    ok = ok & row(pts_ok_db, best)[idx2]
    n_3d = torch.sum(ok)
    pts3d = row(pts_db, best)[idx2]
    x = cam_mod.normalize(kps_q, intr)
    n_best = row(counts, best)
    is_cand = (n_best >= min_matches) & (n_3d >= min_inliers)
    head3 = torch.stack([n_best.to(torch.float32), best.to(torch.float32),
                         n_3d.to(torch.float32)])
    return head3, is_cand, ok, pts3d, x


def _dlt_stage(pts3d, x, idx):
    """The hypotheses' DLT systems (`pnp.dlt_system`) from their indices."""
    return pnp.dlt_system(pts3d[idx], x[idx])


def _pnp_head(head3, is_cand, res):
    """[best_matches, best_slot, n_matched_with_3d, pnp_inliers (0 without
    a candidate)]."""
    return torch.cat([head3, torch.where(is_cand, res.num_inliers, 0).to(torch.float32)[None]])


def _pnp_stage(U, s, Vt, tvec, pts3d, x, ok, is_cand, head3, *, thresh):
    """The hypotheses' poses from their SVDs, MSAC and the refinement
    (`pnp.score_and_refine`); the 16-float packed vector."""
    res = pnp.score_and_refine(*pnp.dlt_finish(U, s, Vt, tvec), pts3d, x, ok,
                               threshold=thresh)
    R, t = _select_pnp(is_cand, res)
    return torch.cat([_pnp_head(head3, is_cand, res), R.reshape(-1), t])


def _pnp_sim3_stage(U, s, Vt, tvec, pts3d, x, ok, is_cand, head3, pts_q, pts_q_ok, R_cur,
                    t_cur, *, thresh):
    """`_pnp_stage`, then the masked Umeyama's moments up to its SVD: the
    PnP inliers' camera-frame coordinates, the current keyframe's
    landmarks through its odometry pose onto the candidate's through the
    PnP pose. Returns (packed 16, covariance, moments)."""
    res = pnp.score_and_refine(*pnp.dlt_finish(U, s, Vt, tvec), pts3d, x, ok,
                               threshold=thresh)
    R, t = _select_pnp(is_cand, res)
    p_i = se3.transform(res.R, res.t, pts3d)
    p_j = se3.transform(R_cur, t_cur, pts_q)
    cov, moments = sim3.umeyama_moments(p_j, p_i, res.inliers & ok & pts_q_ok)
    return torch.cat([_pnp_head(head3, is_cand, res), R.reshape(-1), t]), cov, moments


def _umeyama_stage(U, D, Vt, moments, is_cand, packed16):
    """The Umeyama similarity from its SVD, (1, I, 0) without a candidate;
    the 29-float packed vector."""
    s_g, R_g, t_g = sim3.umeyama_finish(U, D, Vt, *moments)
    eye = torch.eye(3, dtype=torch.float32, device=R_g.device)
    s_g = torch.where(is_cand, s_g, 1.0)
    R_g = torch.where(is_cand, R_g, eye)
    t_g = torch.where(is_cand, t_g, 0.0)
    return torch.cat([packed16, s_g[None], R_g.reshape(-1), t_g])


def _detect(run, query, db, eligible, intr, thresh, min_matches, min_inliers, draw):
    """The device side of a detection: segments (`run(name, fn, statics,
    *args)`: eagerly, or as captured programs) between the calls that
    read the device on the host: the hypotheses' draw (`draw(mask)`, the
    database's generator) and the solvers that check their status on the
    host on CUDA (`eigh`, `svd`). `query` is (desc, mask, kps) for
    stereo, with (landmarks, their mask, R_cur, t_cur) after them for the
    Sim(3) variant. Returns the packed vector (16 or 29 floats)."""
    head3, is_cand, ok, pts3d, x = run(
        "detect_match", _match_stage,
        dict(intr=intr, min_matches=min_matches, min_inliers=min_inliers),
        *query[:3], *db, eligible)
    AtA, Xh = run("detect_dlt", _dlt_stage, {}, pts3d, x, draw(ok))
    _, vecs = torch.linalg.eigh(AtA)
    M, tvec = run("detect_dlt_sign", pnp.dlt_sign, {}, vecs, Xh)
    U, s, Vt = torch.linalg.svd(M)
    args = (U, s, Vt, tvec, pts3d, x, ok, is_cand, head3)
    if len(query) == 3:
        return run("detect_pnp", _pnp_stage, dict(thresh=thresh), *args)
    packed16, cov, moments = run("detect_pnp_sim3", _pnp_sim3_stage, dict(thresh=thresh),
                                 *args, *query[3:])
    U, D, Vt = torch.linalg.svd(cov)
    return run("detect_umeyama", _umeyama_stage, {}, U, D, Vt, moments, is_cand, packed16)


def _verify(desc_q, mask_q, kps_q, desc_db, mask_db, pts_db, pts_ok_db, eligible, intr,
            thresh, min_matches, min_inliers, draw):
    """Match scoring, the best candidate, the association and PnP RANSAC
    (hypotheses from `draw(mask)`), eagerly. PnP always runs; `is_cand`
    says whether the match gates passed. Returns (head, is_cand, PnP
    result, match mask, matched candidate landmarks), head =
    [best_matches, best_slot, n_matched_with_3d, pnp_inliers (0 without a
    candidate)]."""
    head3, is_cand, ok, pts3d, x = _match_stage(
        desc_q, mask_q, kps_q, desc_db, mask_db, pts_db, pts_ok_db, eligible, intr=intr,
        min_matches=min_matches, min_inliers=min_inliers)
    res = pnp.pnp_ransac_from_indices(draw(ok), pts3d, x, ok, threshold=thresh)
    return _pnp_head(head3, is_cand, res), is_cand, res, ok, pts3d


def _select_pnp(is_cand, res):
    """The PnP pose, or the identity and zero without a candidate, as the
    JAX package's skipped branch returns."""
    eye = torch.eye(3, dtype=torch.float32, device=res.R.device)
    return torch.where(is_cand, res.R, eye), torch.where(is_cand, res.t, 0.0)


def _detect_fused_kernel(desc_q, mask_q, kps_q, desc_db, mask_db, pts_db,
                         pts_ok_db, eligible, intr, thresh, min_matches,
                         min_inliers, draw):
    """The whole device side of a detection, eagerly (`_detect`). Returns
    the 16-float packed vector [best_matches, best_slot,
    n_matched_with_3d, pnp_inliers, R(9), t(3)]."""
    return _detect(ransac.eager, (desc_q, mask_q, kps_q),
                   (desc_db, mask_db, pts_db, pts_ok_db),
                   eligible, intr, thresh, min_matches, min_inliers, draw)


def _detect_fused_sim3_kernel(desc_q, mask_q, kps_q, pts_q, pts_q_ok, R_cur, t_cur,
                              desc_db, mask_db, pts_db, pts_ok_db, eligible, intr,
                              thresh, min_matches, min_inliers, draw):
    """Monocular variant of `_detect_fused_kernel`: also fits the relative
    Sim(3) between the candidate's and the current segment's local
    metrics, a masked Umeyama over the PnP inliers' camera-frame
    coordinates (the current keyframe's landmarks through its odometry
    pose onto the candidate's landmarks through the PnP pose: the same
    points in the same camera, in two scales). Packed: [matches, slot,
    n3d, inliers, R_pnp(9), t_pnp(3), s_g, R_g(9), t_g(3)] (29 floats);
    (1, I, 0) for the fit without a candidate."""
    return _detect(ransac.eager, (desc_q, mask_q, kps_q, pts_q, pts_q_ok, R_cur, t_cur),
                   (desc_db, mask_db, pts_db, pts_ok_db), eligible, intr, thresh,
                   min_matches, min_inliers, draw)
