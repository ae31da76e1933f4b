"""Recognition-rate study on the PyTorch port: engine equivalence at
dataset scale. The port's counterpart of tools/eval_recognition.py: the
same trials from the same seeds, the same flags (plus --device), the same
JSON (tools/merge_eval.py reads it unchanged) and the same table.

Match rate and pose error of the engines — block/fast (exact), reference
(exact, readable), correlation (α within one bin) and the fast engine with
rescoring, normal smoothing (order 0 and 1) and ICP — over

    seeds × noise levels × occlusion levels  (+ distractor objects),

on synthetic scenes with exact ground truth (the reference's UWA
error-vs-occlusion analysis, pcl/alignment/analyze_mian.py:75-195). Each
match runs at fixed capacities probed at both noise extremes
(drost._match_core, as the JAX tool's drost._match_jit); a voxel grid that
drops points or a vote buffer that overflows is reported, the first
aborting the run.

Usage:
  python tools/eval_recognition_torch.py [--seeds N] [--quick] [--out PATH]
      [--noises 0,0.5] [--occs 0,0.3] [--engines fast,reference]
A caller that wants the CPU passes --device cpu.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import objective_slam_tpu_torch as pt  # noqa: E402
from objective_slam_tpu_torch._common import default_device  # noqa: E402
from objective_slam_tpu_torch.models import drost  # noqa: E402
from objective_slam_tpu_torch.ops import transforms as tr, \
    voting_block  # noqa: E402
from objective_slam_tpu_torch.utils import pointcloud as pc, \
    synthetic  # noqa: E402

ENGINES = ["fast", "reference", "correlation", "fast+rescore",
           "fast+smooth", "fast+smooth1", "fast+icp", "fast+smooth+icp",
           "fast+smooth1+icp"]


def build_trial(rng, mp_raw, mn_raw, *, n_total, occlusion, noise_rel,
                leaf, n_distractor=2):
    """One scene: planar clutter, distractor blobs and a (possibly
    occluded) planted model instance with Gaussian point noise
    (eval_recognition.py:33-89); the same arrays as the JAX tool's for the
    same rng state. Returns (scene_pts, scene_nrm, T_true)."""
    # Occlusion: a half-space cut through the model centroid along a
    # random direction removes `occlusion` of its points.
    keep = np.ones(len(mp_raw), bool)
    if occlusion > 0:
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        proj = (mp_raw - mp_raw.mean(axis=0)) @ d
        keep = proj <= np.quantile(proj, 1.0 - occlusion)
    mp_cut, mn_cut = mp_raw[keep], mn_raw[keep]

    # Distractors: blobs with other bump statistics, placed away.
    parts_p, parts_n = [], []
    for b in range(n_distractor):
        dp, dn = synthetic.blob_cloud(rng, 2000, bumps=0.15 + 0.2 * b)
        q = synthetic.random_rotation_quat(rng)
        R = synthetic.quat_to_matrix(q)
        off = rng.uniform(-3.0, 5.0, size=3)
        parts_p.append(dp * (0.8 + 0.4 * b) @ R.T + off)
        parts_n.append(dn @ R.T)

    # Planar clutter fills the remaining budget.
    n_clutter = n_total - len(mp_cut) - sum(len(p) for p in parts_p)
    per = max(n_clutter // 6, 1)
    for b in range(6):
        cnt = per if b < 5 else n_clutter - 5 * per
        u = rng.uniform(-1.5, 1.5, size=(cnt, 2))
        z = rng.normal(scale=0.01, size=(cnt, 1))
        pts = np.concatenate([u, z], axis=1)
        q = synthetic.random_rotation_quat(rng)
        R = synthetic.quat_to_matrix(q)
        off = rng.uniform(-3.0, 5.0, size=3)
        parts_p.append(pts @ R.T + off)
        parts_n.append(np.tile(R[:, 2], (cnt, 1)))

    cp = np.concatenate(parts_p).astype(np.float32)
    cn = np.concatenate(parts_n).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    scene, scene_n, T_true = synthetic.plant_model(rng, mp_cut, mn_cut,
                                                   cp, cn)
    if noise_rel > 0:
        sigma = noise_rel * leaf
        scene = scene + rng.normal(scale=sigma,
                                   size=scene.shape).astype(np.float32)
        scene_n = scene_n + rng.normal(
            scale=noise_rel * 0.5, size=scene_n.shape).astype(np.float32)
        scene_n /= np.linalg.norm(scene_n, axis=1, keepdims=True)
    return scene, scene_n, T_true


def trial_seed(noise, occ, s) -> int:
    """The JAX tool's per-trial seed (Python's hash of a tuple of ints does
    not depend on PYTHONHASHSEED)."""
    return hash((int(noise * 100), int(occ * 100), s)) % 2**31


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default="eval_results.json")
    ap.add_argument("--noises", type=str, default=None,
                    help="CSV noise levels (in units of leaf); seeds stay "
                         "those of the full sweep")
    ap.add_argument("--occs", type=str, default=None,
                    help="CSV occlusion fractions (same purpose)")
    ap.add_argument("--engines", type=str, default=None,
                    help="CSV engine subset; the fast-vs-correlation "
                         "agreement row needs both")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def run(args, dev, log=sys.stderr):
    """The grid on `dev`. Returns (JSON dict, engines, noises, occs)."""
    t0 = time.time()
    if args.quick:
        n_model_raw, n_total, seeds = 2500, 8000, min(args.seeds, 4)
        noises = [0.0, 0.5]
        occs = [0.0, 0.3]
    else:
        n_model_raw, n_total, seeds = 6000, 30000, args.seeds
        noises = [0.0, 0.25, 0.5]
        occs = [0.0, 0.3, 0.5]
    if args.noises is not None:
        noises = [float(x) for x in args.noises.split(",")]
    if args.occs is not None:
        occs = [float(x) for x in args.occs.split(",")]

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng0 = np.random.default_rng(12345)
    mp_raw, mn_raw = synthetic.blob_cloud(rng0, n_model_raw)
    cfg0 = pt.PPFConfig(max_poses=512, ref_point_df=5, engine="correlation")
    d_dist = cfg0.tau_d * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    desc = pt.build_model_description(mp, mn, cfg0, d_dist=d_dist,
                                      device=dev)
    leaf = d_dist

    # "+smooth" / "+smooth1": the fast engine on a scene whose noisy
    # normals were smoothed first (pc.smooth_normals_grid order 0, the box
    # mean, or order 1, the bias-cancelling linear fit); "+icp": refined
    # against every fourth raw point, as the CLI and the bench refine.
    engines = list(ENGINES)
    if args.engines is not None:
        engines = [e for e in engines if e in args.engines.split(",")]
    cfgs = {e: pt.PPFConfig(max_poses=512, ref_point_df=5,
                            engine=e.split("+")[0],
                            rescore_poses="+rescore" in e,
                            refine_icp="+icp" in e)
            for e in engines}

    # Voxel capacity from the occupancy at both noise extremes (noise
    # inflates the occupied cells), padded 15% and rounded to 128; a run
    # whose grid drops points fails.
    occ_probe = []
    for s in range(2):
        for noise_probe in (0.0, max(noises)):
            rng = np.random.default_rng(1000 + s)
            sp, sn, _ = build_trial(rng, mp_raw, mn_raw, n_total=n_total,
                                    occlusion=0.0, noise_rel=noise_probe,
                                    leaf=leaf)
            occ_probe.append(
                int(pc.voxel_downsample_np(sp, sn, leaf)[0].shape[0]))
    vox_capacity = ((int(max(occ_probe) * 1.15) + 127) // 128) * 128
    print(f"[eval] voxel occupancies {occ_probe} -> capacity {vox_capacity}",
          file=log, flush=True)

    # Vote capacity from the vote-heaviest corners (no occlusion, both
    # noise extremes), padded 2x.
    probe_caps = []
    for s in range(2):
        for noise_probe in (0.0, max(noises)):
            rng = np.random.default_rng(1000 + s)
            sp, sn, _ = build_trial(rng, mp_raw, mn_raw, n_total=n_total,
                                    occlusion=0.0, noise_rel=noise_probe,
                                    leaf=leaf)
            vox = pc.voxel_downsample(on(sp), on(sn), leaf,
                                      capacity=vox_capacity)
            if bool(vox.dropped):
                raise RuntimeError("voxel capacity dropped points in the "
                                   "cap probe")
            tot, rows, _ = drost._count_votes(desc, vox.points, vox.normals,
                                              cfg0.ref_point_df,
                                              cfg0.d_angle)
            probe_caps.append((tot, rows))
    n_ref = (vox_capacity + cfg0.ref_point_df - 1) // cfg0.ref_point_df
    cap_block = drost._next_cap(
        2 * max(r for _, r in probe_caps) * 128
        + voting_block.CHUNK_ROWS * n_ref * 128)
    cap_ref = drost._next_cap(2 * max(t for t, _ in probe_caps))
    caps = {e: {"fast": cap_block, "reference": cap_ref,
                "correlation": 0}[e.split("+")[0]] for e in engines}
    print(f"[eval] caps: block {cap_block}, reference {cap_ref}",
          file=log, flush=True)

    results = []
    budget = math.radians(cfg0.validation_rotation_threshold_deg)
    for noise in noises:
        for occ in occs:
            for s in range(seeds):
                rng = np.random.default_rng(trial_seed(noise, occ, s))
                sp, sn, T_true = build_trial(
                    rng, mp_raw, mn_raw, n_total=n_total, occlusion=occ,
                    noise_rel=noise, leaf=leaf)
                sp_d, sn_d = on(sp), on(sn)
                vox = pc.voxel_downsample(sp_d, sn_d, leaf,
                                          capacity=vox_capacity)
                if bool(vox.dropped):
                    raise RuntimeError(f"voxel capacity dropped points "
                                       f"({noise}, {occ}, {s})")
                smoothed = {}

                def smooth_variant(order):
                    if order not in smoothed:
                        nrm = pc.smooth_normals_grid(sp_d, sn_d, leaf,
                                                     order=order)
                        smoothed[order] = (nrm, pc.voxel_downsample(
                            sp_d, nrm, leaf, capacity=vox_capacity))
                    return smoothed[order]

                poses = {}
                for e in engines:
                    if "+smooth1" in e:
                        sn_e, vox_e = smooth_variant(1)
                    elif "+smooth" in e:
                        sn_e, vox_e = smooth_variant(0)
                    else:
                        sn_e, vox_e = sn_d, vox
                    icp_p = sp_d[::4] if cfgs[e].refine_icp else None
                    icp_n = sn_e[::4] if cfgs[e].refine_icp else None
                    res = drost._match_core(
                        desc, vox_e.points, vox_e.normals,
                        ref_point_df=cfgs[e].ref_point_df, vote_cap=caps[e],
                        config=cfgs[e], icp_points=icp_p, icp_normals=icp_n)
                    pose = res.pose.cpu()
                    td, rd = (float(x) for x in
                              tr.ht_dist(pose, torch.from_numpy(T_true)))
                    poses[e] = pose
                    results.append({
                        "noise": noise, "occ": occ, "seed": s, "engine": e,
                        "trans_err": td, "rot_err_deg": math.degrees(rd),
                        "match": bool(td < 0.1 * desc.diameter
                                      and rd < budget),
                        "overflowed": bool(res.overflowed),
                    })
                if not {"fast", "correlation"} <= set(engines):
                    continue
                tdx, rdx = (float(x) for x in tr.ht_dist(
                    poses["fast"], poses["correlation"]))
                results.append({
                    "noise": noise, "occ": occ, "seed": s,
                    "engine": "agree_fast_corr",
                    "trans_err": tdx, "rot_err_deg": math.degrees(rdx),
                    "match": bool(tdx < 0.1 * desc.diameter
                                  and rdx < budget),
                    "overflowed": False,
                })
            done = sum(1 for r in results if r["engine"] == "fast")
            print(f"[eval] noise={noise} occ={occ} done "
                  f"({time.time()-t0:.0f}s, {done} trials)",
                  file=log, flush=True)

    out = {"model_points": int(desc.n_points), "diameter": desc.diameter,
           "seeds": seeds, "n_total": n_total, "results": results}
    return out, engines, noises, occs


def table(results, engines, noises, occs):
    """The summary table's lines: match rate and median rotation error per
    (noise, occlusion) and engine, then the overflow count."""
    cols = engines + (["agree_fast_corr"]
                      if {"fast", "correlation"} <= set(engines) else [])
    lines = [f"{'noise':>6} {'occ':>5} | " + " | ".join(
        f"{e:>12}" for e in cols)]
    for noise in noises:
        for occ in occs:
            row = []
            for e in cols:
                sel = [r for r in results
                       if r["engine"] == e and r["noise"] == noise
                       and r["occ"] == occ]
                rate = sum(r["match"] for r in sel) / max(len(sel), 1)
                rerr = float(np.median([r["rot_err_deg"] for r in sel]))
                row.append(f"{rate*100:5.1f}% {rerr:4.1f}d")
            lines.append(f"{noise:>6} {occ:>5} | " + " | ".join(
                f"{c:>12}" for c in row))
    lines.append(f"overflows: {sum(r['overflowed'] for r in results)}")
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()
    out, engines, noises, occs = run(args, dev)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print("\n".join(table(out["results"], engines, noises, occs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
