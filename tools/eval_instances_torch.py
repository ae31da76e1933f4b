"""Multi-instance (bin-picking) recall/precision study on the PyTorch
port: the port's counterpart of tools/eval_instances.py (same scenes from
the same seeds, flags and JSON keys; `--device` in place of `--tpu`).

The reference returns only the single argmax winner (model.cu:293-295)
even though its candidate list holds every instance's Hough peak;
`drost.extract_instances` recovers all of them by greedy translation-NMS
over the clustered candidates. Scenes with k planted instances among
planar clutter; recall (planted instances recovered) and precision
(extracted poses that are real instances) per k, over seeds.

Usage:
  python tools/eval_instances_torch.py [--seeds 8] [--ks 2,4,6] [--out PATH]
  python tools/eval_instances_torch.py --quick      # 2 seeds, k = 2, small
A caller that wants the CPU passes --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import objective_slam_tpu_torch as pt  # noqa: E402
from objective_slam_tpu_torch._common import default_device  # noqa: E402
from objective_slam_tpu_torch.models import drost  # noqa: E402
from objective_slam_tpu_torch.utils import pointcloud as pc, synthetic, \
    validation  # noqa: E402


def build_scene(rng, mp_raw, mn_raw, k, n_total, n_inst_pts):
    """k instances among surface-like planar clutter (eval_instances.py:
    30-86): the same arrays as the JAX tool's for the same rng state."""
    n_clutter = n_total - k * n_inst_pts
    per = n_clutter // 8
    cps, cns = [], []
    for b in range(8):
        cnt = per if b < 7 else n_clutter - 7 * per
        u = rng.uniform(-1.5, 1.5, size=(cnt, 2))
        z = rng.normal(scale=0.01, size=(cnt, 1))
        pts = np.concatenate([u, z], axis=1)
        q = synthetic.random_rotation_quat(rng)
        R = synthetic.quat_to_matrix(q)
        offset = rng.uniform(-3.0, 5.0, size=3)
        cps.append(pts @ R.T + offset)
        nrm = np.tile(R[:, 2], (cnt, 1)) + rng.normal(scale=0.02,
                                                      size=(cnt, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        cns.append(nrm)
    sp = np.concatenate(cps).astype(np.float32)
    sn = np.concatenate(cns).astype(np.float32)

    diam = float(np.linalg.norm(mp_raw.max(0) - mp_raw.min(0)))
    truths, centers = [], []
    for _ in range(k):
        sel = rng.choice(len(mp_raw), size=n_inst_pts, replace=False)
        # Bounded rejection sampling: after each failed batch of 2,000
        # candidates the separation relaxes 10%, never below 0.75·diam
        # (above extract_instances' 0.7·diam NMS radius); after 50 batches
        # the farthest candidate seen is taken.
        sep = diam
        t, best, best_d = None, None, -1.0
        for _batch in range(50):
            cand = rng.uniform(-2.8, 2.8, size=(2000, 3)).astype(np.float32)
            dmin = np.full(len(cand), np.inf)
            for c in centers:
                dmin = np.minimum(dmin, np.linalg.norm(cand - c, axis=1))
            i = int(np.argmax(dmin))
            if dmin[i] > sep:
                t = cand[i]
                break
            if dmin[i] > best_d:
                best_d, best = float(dmin[i]), cand[i]
            sep = max(0.9 * sep, 0.75 * diam)
        if t is None:
            t = best
        centers.append(t)
        sp, sn, T = synthetic.plant_model(rng, mp_raw[sel], mn_raw[sel],
                                          sp, sn, translation=t)
        truths.append(T)
    return sp, sn, truths


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--ks", type=str, default="2,4,6")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default="eval_instances.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def run(args, dev, log=sys.stderr):
    """The study on `dev`. Returns the summary dict (with its rows)."""
    ks = [int(x) for x in args.ks.split(",")]
    n_model_raw, n_total, n_inst_pts = 20_000, 80_000, 10_000
    if args.quick:
        args.seeds, ks = 2, [2]
        n_model_raw, n_total, n_inst_pts = 2_000, 8_000, 1_000

    t0 = time.time()
    rng0 = np.random.default_rng(99)
    mp_raw, mn_raw = synthetic.blob_cloud(rng0, n_model_raw)
    # Multi-instance prescription: center-cell clustering and a top-K
    # budget that holds every instance's candidate cells.
    cfg = pt.PPFConfig(max_poses=1024, ref_point_df=5,
                       cluster_center_cell=True)
    d_dist = cfg.tau_d * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    desc = pt.build_model_description(mp, mn, cfg, d_dist=d_dist,
                                      device=dev)
    scene_leaf = 0.5 * d_dist

    # One voxel capacity for the whole sweep, probed at both k extremes
    # (low k: more clutter, high k: more instance surface), padded 15% and
    # rounded to 128.
    probe = [pc.voxel_downsample_np(
        *build_scene(np.random.default_rng(10_000 * k + s),
                     mp_raw, mn_raw, k, n_total, n_inst_pts)[:2],
        scene_leaf)[0].shape[0]
        for k in {min(ks), max(ks)} for s in range(2)]
    capacity = ((int(max(probe) * 1.15) + 127) // 128) * 128
    print(f"[inst] probed occupancies {probe}, capacity {capacity}",
          file=log, flush=True)

    rows = []
    for k in ks:
        for s in range(args.seeds):
            rng = np.random.default_rng(10_000 * k + s)
            sp, sn, truths = build_scene(rng, mp_raw, mn_raw, k,
                                         n_total, n_inst_pts)
            vox = pc.voxel_downsample(torch.from_numpy(sp).to(dev),
                                      torch.from_numpy(sn).to(dev),
                                      scene_leaf, capacity=capacity)
            if bool(vox.dropped):
                raise RuntimeError(f"voxel capacity {capacity} dropped "
                                   f"points (k={k}, seed={s})")
            res = drost.match(desc, vox.points, vox.normals, cfg)
            poses, _ = drost.extract_instances(res, desc.diameter,
                                               max_instances=2 * k)
            matched_truth = [any(
                validation.validate_pose(p, T, desc.diameter, cfg).match
                for p in poses) for T in truths]
            pose_real = [any(
                validation.validate_pose(p, T, desc.diameter, cfg).match
                for T in truths) for p in poses]
            rows.append({
                "k": k, "seed": s,
                "recall": float(np.mean(matched_truth)),
                "precision": float(np.mean(pose_real)) if poses else 1.0,
                "n_extracted": len(poses),
                "overflowed": bool(res.overflowed),
                "topk_saturated": bool(res.topk_saturated),
            })
            print(f"[inst] k={k} seed={s}: recall "
                  f"{rows[-1]['recall']:.2f} precision "
                  f"{rows[-1]['precision']:.2f} extracted {len(poses)} "
                  f"({time.time() - t0:.0f}s)", file=log, flush=True)

    summary = {"seeds": args.seeds, "per_k": {}}
    for k in ks:
        sel = [r for r in rows if r["k"] == k]
        summary["per_k"][str(k)] = {
            "recall": float(np.mean([r["recall"] for r in sel])),
            "precision": float(np.mean([r["precision"] for r in sel])),
            "perfect_scenes": int(sum(r["recall"] == 1.0 for r in sel)),
            "n_scenes": len(sel),
        }
    summary["rows"] = rows
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()
    summary = run(args, dev)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({key: v for key, v in summary.items()
                      if key != "rows"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
