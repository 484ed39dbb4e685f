"""The headline StereoVO run (chip_smoke phase 4, `bench.py:116-166`)
through the JAX package or the port, on the CPU.

    JAX_PLATFORMS=cpu python tests/headline_parity.py --package jax --deterministic > jax.json
    JAX_PLATFORMS=cpu python tests/headline_parity.py --package port --deterministic > port.json
    python tests/headline_parity.py --compare jax.json port.json

The frames are phase 4's: the rng-42 corridor at 376x1240, 44 frames at
0.8 m (`chip_smoke.render_headline`), with `chip_smoke.headline_config`
uncut; `--deterministic` sets `stats_deterministic=True`. `--threads N`
runs the port on N torch threads, and the JAX package with XLA's CPU
client on N threads (1: `--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1`; other counts leave XLA's default pool).
Prints one JSON line: the keyframe indices, the ATE (Umeyama, no scale,
as `chip_smoke.ate_of`), every frame's camera centre and the seconds.
`--compare A B` prints the per-frame camera-centre gaps of two such
lines and whether their keyframes agree. A run takes 1-3 min on 8 cores.

    JAX_PLATFORMS=cpu python tests/headline_parity.py --stages 4

feeds the port the JAX package's inputs stage by stage, under
`stats_deterministic`: frame 0's stereo keyframe program (its FAST
detection, stereo match and allocated landmarks) and the template
program, then at each of frames 1-4 the track program whole and each of
its stages (pyramid, direct Gauss-Newton level by level, the reference
keyframes, LK alignment, the 4-step PnP refine, the acceleration gate's
two norms), each against the JAX package's; one JSON line per frame;
and the port's engine seeded with the JAX engine's state after frame 0
(map, templates, active slots) over frames 1-4, its camera-centre gaps
to the JAX engine's (about 1 min).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def render(n_frames=None):
    """Phase 4's frames (the first `n_frames`), rendered by the port's
    numpy renderer (the same images feed both packages), and ground truth."""
    import chip_smoke
    from viso_tpu_torch.data import synthetic
    from viso_tpu_torch.geometry import camera

    scene, intr, Rs, ts = chip_smoke.headline_scene(synthetic, camera)
    Rs, ts = Rs[:n_frames], ts[:n_frames]
    return (chip_smoke.render_frames(synthetic, scene, intr, chip_smoke.H, chip_smoke.W,
                                     Rs, ts), Rs, ts)


def config(package, deterministic):
    """Phase 4's configuration in `package`."""
    import chip_smoke

    if package == "jax":
        from viso_tpu.slam.engine import VOConfig
    else:
        from viso_tpu_torch.slam.engine import VOConfig
    cfg = chip_smoke.headline_config(VOConfig)
    return dataclasses.replace(cfg, stats_deterministic=True) if deterministic else cfg


def make_engine(package, cfg):
    if package == "jax":
        from viso_tpu.slam.engine import StereoVO
        return StereoVO(cfg)
    from viso_tpu_torch.slam.engine import StereoVO
    return StereoVO(cfg, device="cpu")


def run(package, deterministic):
    from viso_tpu_torch.utils import metrics

    frames, Rs, ts = render()
    cfg = config(package, deterministic)
    t0 = time.perf_counter()
    vo = make_engine(package, cfg)
    for il, ir in frames:
        vo.process(il, ir)
    R, t = (np.asarray(x) for x in vo.trajectory())
    kfs = [i for i, r in enumerate(vo.results) if r.is_keyframe]
    vo.close()
    c = metrics.camera_centers(R, t)
    c_gt = metrics.camera_centers(Rs, ts)
    ate = float(metrics.ate_rmse(c, c_gt, align=True, with_scale=False))
    return dict(package=package, deterministic=deterministic, keyframes=kfs, ate_m=ate,
                centres=c.tolist(), centre_err_m=np.linalg.norm(c - c_gt, axis=-1).tolist(),
                seconds=time.perf_counter() - t0)


def compare(a, b):
    gap = np.linalg.norm(np.asarray(a["centres"]) - np.asarray(b["centres"]), axis=-1)
    print(f"keyframes equal: {a['keyframes'] == b['keyframes']} "
          f"({a['keyframes']} / {b['keyframes']})")
    print(f"ATE {a['ate_m']:.6f} / {b['ate_m']:.6f} m")
    for i, g in enumerate(gap):
        print(f"frame {i:2d}: gap {g:.3g} m, centre error {a['centre_err_m'][i]:.4g} / "
              f"{b['centre_err_m'][i]:.4g} m")
    return gap


def jax_track_inputs(frames, cfg, n_tracked):
    """The JAX package's deterministic run over frames 0..n_tracked: the
    track program's inputs (map, templates, active slots, image, R, t,
    vel_xi) and outputs at each of frames 1..n_tracked."""
    from viso_tpu.slam.engine import StereoVO

    vo = StereoVO(cfg)
    track = vo._kernels["track"] = vo._build_track_kernel()
    calls = []

    def recorded(*a):
        out = track(*a)
        calls.append((a, out))
        return out

    vo._kernels["track"] = recorded
    for il, ir in frames[: n_tracked + 1]:
        vo.process(il, ir)
    centres = camera_centres(vo)
    vo.close()
    return calls, centres


def camera_centres(vo):
    """Every frame's camera centre of an engine of either package."""
    from viso_tpu_torch.utils import metrics

    return metrics.camera_centers(*(np.asarray(x) for x in vo.trajectory()))


def seeded_gaps(frames, cfg, calls, centres_jax):
    """The port's StereoVO seeded with the JAX engine's state after frame
    0 (its map, templates and active slots: the first track call's
    inputs), over the same frames: each frame's camera-centre gap to the
    JAX engine's (m)."""
    from viso_tpu_torch.mapping import map_state as t_ms
    from viso_tpu_torch.slam.engine import StereoVO

    m, tmpl, active = calls[0][0][:3]
    vo = StereoVO(cfg, device="cpu")
    try:
        vo.process(*frames[0])
        vo.map = t_ms.from_numpy(
            {name: (tuple(np.asarray(a) for a in v) if name == "kf_pyr" else np.asarray(v))
             for name, v in zip(m._fields, m)}, "cpu")
        vo._templates, vo._active_idx = to_port(tuple(tmpl)), to_port(active)
        for f in frames[1:]:
            vo.process(*f)
        return np.linalg.norm(camera_centres(vo) - centres_jax, axis=-1).tolist()
    finally:
        vo.close()


def jax_keyframe_inputs(frames, cfg):
    """The JAX package's frame 0: the stereo keyframe program's and the
    template program's inputs and outputs."""
    from viso_tpu.slam.engine import StereoVO

    vo = StereoVO(cfg)
    calls = {}
    for name, build in (("stereo_kf", vo._build_stereo_kf_kernel),
                        ("templates", vo._build_template_kernel)):
        def recorded(*a, _fn=build(), _name=name):
            out = _fn(*a)
            calls[_name] = (a, out)
            return out

        vo._kernels[name] = recorded
    vo.process(*frames[0])
    vo.close()
    return calls


def with_ssd(mod):
    """`mod.match` (either package's `ops/stereo.py`) built from its own
    source, returning also its SSD over the disparities and its integer
    argmin: (disparity, cost, ok, ssd, best), undecorated."""
    import inspect

    fn = mod.match
    src = inspect.getsource(getattr(fn, "__wrapped__", fn))
    src = "\n".join(line for line in src.splitlines() if not line.startswith("@"))
    src = src.replace("return disparity, best_cost, ok",
                      "return disparity, best_cost, ok, ssd, best")
    ns = dict(vars(mod))
    exec(src, ns)
    return ns["match"]


def keyframe_stages():
    """Frame 0 of the deterministic headline: the port's stereo keyframe
    program, its detection and stereo match, and its template program,
    each fed the JAX package's inputs, against the JAX package's."""
    import jax
    import jax.numpy as jnp

    from viso_tpu.ops import fast as j_fast
    from viso_tpu.ops import stereo as j_stereo
    from viso_tpu_torch.mapping import map_state as t_ms
    from viso_tpu_torch.ops import stereo as t_stereo
    from viso_tpu_torch.slam.engine import StereoVO

    frames, _, _ = render(1)
    jcfg, tcfg = config("jax", True), config("port", True)
    calls = jax_keyframe_inputs(frames, jcfg)
    tvo = StereoVO(tcfg, device="cpu")

    def port_map(m):
        return t_ms.from_numpy(
            {name: (tuple(np.asarray(a) for a in v) if name == "kf_pyr" else np.asarray(v))
             for name, v in zip(m._fields, m)}, "cpu")

    (m, slot, evict, R, t, fid, pyr, il, ir, ok_al, refd, have), m_j = calls["stereo_kf"]
    m_t = tvo._stereo_kf_program(port_map(m), int(slot), bool(evict), to_port(R), to_port(t),
                                 int(fid), to_port(tuple(pyr)), to_port(il), to_port(ir),
                                 to_port(ok_al), to_port(refd), bool(have))
    jm = {k: np.asarray(v) for k, v in zip(m_j._fields, m_j) if k != "kf_pyr"}
    tm = t_ms.to_numpy(m_t)
    both = jm["point_mask"] & tm["point_mask"]
    rec = dict(stage="stereo_kf", points_jax=int(jm["point_mask"].sum()),
               points_port=int(tm["point_mask"].sum()), points_both=int(both.sum()),
               max_point_m=float(np.abs(jm["points"] - tm["points"])[both].max()),
               obs_equal=bool(np.array_equal(jm["obs_mask"], tm["obs_mask"])),
               max_obs_uv_px=float(np.abs(jm["obs_uv"] - tm["obs_uv"])[jm["obs_mask"]
                                                                      & tm["obs_mask"]].max()))
    # Its detection and stereo match on the same pyramid.
    per_cell = max(1, jcfg.num_features // (jcfg.detect_grid[0] * jcfg.detect_grid[1]))
    uv_j, sc_j, dm_j = j_fast.detect_grid_pyramid(
        pyr, threshold=jcfg.fast_threshold, grid=jcfg.detect_grid, per_cell=per_cell,
        levels=jcfg.detect_levels)
    uv_t, sc_t, dm_t = tvo._detect(to_port(tuple(pyr)))
    rec["detect"] = dict(uv_equal=bool(np.array_equal(uv_t.numpy(), np.asarray(uv_j))),
                         score_max=float(np.abs(sc_t.numpy() - np.asarray(sc_j)).max()),
                         mask_equal=bool(np.array_equal(dm_t.numpy(), np.asarray(dm_j))))
    sp_j = j_stereo.StereoParams(max_disparity=jcfg.max_disparity)
    sp_t = t_stereo.StereoParams(max_disparity=tcfg.max_disparity)
    args_t = [to_port(il).float(), to_port(ir).float(), to_port(uv_j)]
    d_j, c_j, ok_j, ssd_j, best_j = (np.asarray(x) for x in jax.jit(
        with_ssd(j_stereo), static_argnames=("params",))(
            il.astype(jnp.float32), ir.astype(jnp.float32), uv_j, dm_j, sp_j))
    d_t, c_t, ok_t, ssd_t, best_t = (x.numpy() for x in with_ssd(t_stereo)(
        *args_t, to_port(dm_j), sp_t))
    # The same formula in float64: where each package's rounding takes it.
    d_64, _, _, ssd_64, best_64 = (x.numpy() for x in with_ssd(t_stereo)(
        *(a.double() for a in args_t), to_port(dm_j), sp_t))
    okb = ok_j & ok_t
    flips = [int(i) for i in np.flatnonzero(okb & (best_j != best_t))]

    def costs(ssd, i):
        return [round(float(c), 5) for c in ssd[i, best_64[i] - 1:best_64[i] + 2]]

    rec["stereo"] = dict(
        ok_jax=int(ok_j.sum()), ok_port=int(ok_t.sum()), ok_both=int(okb.sum()),
        max_disp_px=float(np.abs(d_t - d_j)[okb].max()),
        f64_max_px=(float(np.abs(d_j - d_64)[okb].max()), float(np.abs(d_t - d_64)[okb].max())),
        f64_mean_px=(float(np.abs(d_j - d_64)[okb].mean()),
                     float(np.abs(d_t - d_64)[okb].mean())),
        argmin_flips=len(flips),
        flipped=[dict(keypoint=i, best=(int(best_j[i]), int(best_t[i]), int(best_64[i])),
                      disparity=(float(d_j[i]), float(d_t[i]), float(d_64[i])),
                      costs_from=int(best_64[i]) - 1, costs_jax=costs(ssd_j, i),
                      costs_port=costs(ssd_t, i), costs_f64=costs(ssd_64, i))
                 for i in flips])
    # The template program on the JAX map after the keyframe.
    (m2, slot2), (tmpl_j, act_j) = calls["templates"]
    tmpl_t, act_t = tvo._templates_program(port_map(m2), int(slot2))
    rec["templates"] = dict(
        active_equal=bool(np.array_equal(act_t.numpy(), np.asarray(act_j))),
        levels=[dict(ok_equal=bool(np.array_equal(a.ok.numpy(), np.asarray(b.ok))),
                     T=float(np.abs(a.T.numpy() - np.asarray(b.T)).max()),
                     J6=float(np.abs(a.J6.numpy() - np.asarray(b.J6)).max()),
                     J6_scale=float(np.abs(np.asarray(b.J6)).max()),
                     d_ref=float(np.abs(a.d_ref.numpy() - np.asarray(b.d_ref)).max()))
                for a, b in zip(tmpl_t, tmpl_j)])
    print(json.dumps(rec), flush=True)
    tvo.close()
    return rec


def to_port(x):
    """A JAX value (array, NamedTuple of arrays, tuple) as torch tensors."""
    import torch

    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_port(v) for v in x))
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    return torch.tensor(np.asarray(x))


def gap_of(Ra, ta, Rb, tb):
    """(camera-centre gap in m, rotation gap in degrees) of two poses."""
    Ra, ta, Rb, tb = (np.asarray(x, np.float64) for x in (Ra, ta, Rb, tb))
    c = np.linalg.norm(-Ra.T @ ta + Rb.T @ tb)
    D = Ra @ Rb.T
    s = np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return float(c), float(np.degrees(np.arcsin(min(1.0, np.linalg.norm(s) / 2))))


def stages(n_tracked):
    """Frames 1..n_tracked of the deterministic headline: each stage of
    the port's track program fed the JAX package's inputs of that stage,
    against the JAX package's stage. Prints one line per stage and frame
    and returns the records."""
    import jax.numpy as jnp
    import torch

    from viso_tpu.geometry import camera as j_cam
    from viso_tpu.geometry import se3 as j_se3
    from viso_tpu.ops import align as j_align
    from viso_tpu.ops import direct as j_direct
    from viso_tpu.ops import pnp as j_pnp
    from viso_tpu.ops import pyramid as j_pyr
    from viso_tpu_torch.geometry import camera as t_cam
    from viso_tpu_torch.geometry import se3 as t_se3
    from viso_tpu_torch.mapping import map_state as t_ms
    from viso_tpu_torch.ops import align as t_align
    from viso_tpu_torch.ops import direct as t_direct
    from viso_tpu_torch.ops import pnp as t_pnp
    from viso_tpu_torch.ops import pyramid as t_pyr
    from viso_tpu_torch.slam.engine import StereoVO

    frames, _, _ = render(n_tracked + 1)
    jcfg, tcfg = config("jax", True), config("port", True)
    calls, centres_jax = jax_track_inputs(frames, jcfg, n_tracked)
    print(json.dumps(dict(stage="engine seeded with the JAX state after frame 0",
                          gaps_m=seeded_gaps(frames, tcfg, calls, centres_jax))), flush=True)
    tvo = StereoVO(tcfg, device="cpu")
    j_intr = jcfg.intrinsics()
    t_intr = tvo.intr
    dp_j = j_direct.DirectParams(iters=jcfg.direct_iters)
    dp_t = t_direct.DirectParams(iters=tcfg.direct_iters)
    records = []

    def np_(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for k, ((m, tmpl, active, img, R, t, vel), out_j) in enumerate(calls, start=1):
        m_t = t_ms.from_numpy(
            {name: (tuple(np.asarray(a) for a in v) if name == "kf_pyr" else np.asarray(v))
             for name, v in zip(m._fields, m)}, "cpu")
        tmpl_t, act_t, img_t = to_port(tmpl), to_port(active), to_port(img)
        R_t, t_t, vel_t = to_port(R), to_port(t), to_port(vel)
        rec = dict(frame=k)
        # The whole program.
        out_t = tvo._track(m_t, tmpl_t, act_t, img_t, R_t, t_t, vel_t)
        rec["program"] = gap_of(out_t[0], out_t[1], out_j[0], out_j[1])
        # Pyramid.
        pyr_j = j_pyr.build_pyramid(img.astype(jnp.float32), jcfg.pyramid_levels)
        pyr_t = t_pyr.build_pyramid(img_t.to(torch.float32), tcfg.pyramid_levels)
        rec["pyramid"] = max(float(np.abs(np_(a) - np.asarray(b)).max())
                             for a, b in zip(pyr_t, pyr_j))
        pyr_jt = to_port(tuple(pyr_j))
        # Warm start.
        xi_j = jnp.asarray(tvo._clamp_twist(vel_t).numpy())
        dR, dt = j_se3.se3_exp(xi_j)
        R0_j, t0_j = j_se3.compose(dR, dt, R, t)
        pts_a_j = m.points[active]
        pts_a_t = to_port(pts_a_j)
        # Direct GN, level by level, each level fed the JAX pose of the
        # level before.
        Rl, tl = R0_j, t0_j
        levels = []
        for level in range(min(dp_j.levels, len(pyr_j), len(tmpl)) - 1, -1, -1):
            pts_l, _ = j_direct._level_points(pts_a_j, None, level)
            Rn_j, tn_j, c_j = j_direct._level_pass_cached(
                pyr_j[level], tmpl[level], pts_l, Rl, tl, j_intr.at_level(level), dp_j)
            pts_lt, _ = t_direct._level_points(pts_a_t, None, level)
            Rn_t, tn_t, c_t = t_direct._level_pass_cached(
                pyr_jt[level], tmpl_t[level], pts_lt, to_port(Rl), to_port(tl),
                t_intr.at_level(level), dp_t)
            levels.append(gap_of(Rn_t, tn_t, Rn_j, tn_j)
                          + (float(c_t), float(c_j)))
            Rl, tl = Rn_j, tn_j
        rec["direct_levels"] = levels
        R_d, t_d = Rl, tl
        # LK alignment to the best-viewing keyframe at the JAX direct pose.
        p_cam = j_se3.transform(R_d, t_d, pts_a_j)
        uv_pred, depth = j_cam.project(p_cam, j_intr)
        visible = (m.point_mask[active] & (depth > 0.1)
                   & j_cam.is_inside(uv_pred, jcfg.height, jcfg.width, border=8))
        k_idx_j, _ = j_align.select_reference_keyframes(
            pts_a_j, m.kf_R, m.kf_t, m.kf_mask, m.obs_mask[:, active])
        k_idx_t, _ = t_align.select_reference_keyframes(
            pts_a_t, m_t.kf_R, m_t.kf_t, m_t.kf_mask, m_t.obs_mask[:, act_t])
        rec["reference_keyframes_equal"] = bool(np.array_equal(np_(k_idx_t), np_(k_idx_j)))
        amask = visible & m.obs_mask[k_idx_j, active]
        uv_ref = m.obs_uv[k_idx_j, active]
        ref_j, _, ok_j = j_align.align(m.kf_pyr, k_idx_j, uv_ref, pyr_j, uv_pred, amask,
                                       j_align.AlignParams(iters=jcfg.align_iters))
        ref_t, _, ok_t = t_align.align(m_t.kf_pyr, to_port(k_idx_j), to_port(uv_ref), pyr_jt,
                                       to_port(uv_pred), to_port(amask),
                                       t_align.AlignParams(iters=tcfg.align_iters))
        both = np_(ok_t) & np_(ok_j)
        dpx = np.abs(np_(ref_t) - np_(ref_j)).max(-1)[both]
        rec["align"] = dict(ok_port=int(np_(ok_t).sum()), ok_jax=int(np_(ok_j).sum()),
                            ok_both=int(both.sum()),
                            max_px=float(dpx.max()) if dpx.size else 0.0,
                            median_px=float(np.median(dpx)) if dpx.size else 0.0)
        # The 4-step PnP refine on the JAX alignment.
        x_ref = j_cam.normalize(ref_j, j_intr)
        huber = jcfg.ransac_threshold_px / jcfg.fx
        R_fj, t_fj = j_pnp.refine_pose(R_d, t_d, pts_a_j, x_ref, ok_j.astype(jnp.float32),
                                       huber=huber, iters=4)
        R_ft, t_ft = t_pnp.refine_pose(to_port(R_d), to_port(t_d), pts_a_t, to_port(x_ref),
                                       to_port(ok_j).to(torch.float32), huber=huber, iters=4)
        rec["refine"] = gap_of(R_ft, t_ft, R_fj, t_fj)
        # The acceleration gate on the JAX refined pose.
        gates = []
        for se3_, Rf, tf, Rp, tp, v, clamp, norm in (
                (j_se3, R_fj, t_fj, R, t, vel, None, jnp.linalg.norm),
                (t_se3, to_port(R_fj), to_port(t_fj), R_t, t_t, vel_t, tvo._clamp_twist,
                 torch.linalg.norm)):
            dRm, dtm = se3_.relative(Rf, tf, Rp, tp)
            xi = se3_.se3_log(dRm, dtm)
            xi = clamp(xi) if clamp else jnp.asarray(tvo._clamp_twist(to_port(xi)).numpy())
            dev = xi - v
            gates.append((float(norm(dev[3:])), float(norm(dev[:3]))))
        rec["accel_gate"] = dict(jax=gates[0], port=gates[1],
                                 limits=(tcfg.max_accel_rotation, tcfg.max_accel_translation),
                                 n_tracked=(int(np_(out_t[4])[0]), int(np.asarray(out_j[4])[0])))
        print(json.dumps(rec), flush=True)
        records.append(rec)
    tvo.close()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "port"))
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    ap.add_argument("--stages", type=int, metavar="N", default=0,
                    help="compare the track program's stages on frames 1..N")
    args = ap.parse_args(argv)
    if args.stages:
        import torch

        torch.set_num_threads(args.threads or torch.get_num_threads())
        keyframe_stages()
        stages(args.stages)
        return 0
    if args.compare:
        a, b = (json.loads(Path(p).read_text().strip().splitlines()[-1]) for p in args.compare)
        compare(a, b)
        return 0
    if args.package is None:
        ap.error("--package or --compare is required")
    if args.threads == 1 and args.package == "jax":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_cpu_multi_thread_eigen=false"
                                   " intra_op_parallelism_threads=1")
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    r = run(args.package, args.deterministic)
    r["threads"] = args.threads or torch.get_num_threads()
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
