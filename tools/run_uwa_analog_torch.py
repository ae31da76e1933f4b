"""UWA-analog occlusion benchmark on the PyTorch/CUDA port: generate →
CLI runs (objective_slam_tpu_torch.cli) → tools/analyze_uwa.py.

The port's counterpart of tools/run_uwa_analog.py (its scene loop,
:204-443), with the same argv per mode (:301-337), the same per-scene logs
and occlusion.txt, so that analyze_uwa.py reads them as it reads the JAX
CLI's. Models and scenes come from the port's utils/synthetic
(uwa_analog_models, uwa_real_models, uwa_analog_scene), the same arrays
as the JAX harness's for the same seed.

  --models synthetic  four procedural closed meshes scaled to the UWA
                      diameters (chef, trex, para, chicken)
  --models real       four laser-scanned bone meshes (skull, pelvis,
                      humerus, scapula; the package's copy of dm_control's
                      STL files under objective_slam_tpu_torch/assets/, or
                      --mesh_dir), with the correlation engine,
                      point-to-plane ICP and the normal-aware voxel grid

Per scene, ONE CLI call matches all four models, writes
<run_name>/rs<scene>_0.log and prints four 0/1 match bits. At the end
analyze_uwa computes match rates and error-vs-occlusion curves, and a
summary<_run_name>.json is written.

Usage (on the card; a caller that wants the CPU passes device="cpu" to
main):
  python3 tools/run_uwa_analog_torch.py --scenes 30 [--models real]
  python3 tools/run_uwa_analog_torch.py --quick      # 2 scenes
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import analyze_uwa  # noqa: E402

from objective_slam_tpu_torch import cli  # noqa: E402
from objective_slam_tpu_torch.utils import ply, pointcloud as pc, \
    synthetic, validation  # noqa: E402

# Occlusion bins of the recognition-rate curve (run_uwa_analog.py:362).
OCC_BINS = [(0, 50), (50, 65), (65, 80), (80, 101)]


def scene_log_bits(log_path: Path, n_models: int) -> list[int] | None:
    """Match bits from a COMPLETE scene log (one Match line per model), or
    None if the log is missing or partial (an interrupted run): the
    --resume gate (run_uwa_analog.py:122-133)."""
    if not log_path.exists():
        return None
    found = re.findall(r"Match \(trans, rot\): (\d), (\d)",
                       log_path.read_text())
    if len(found) != n_models:
        return None
    return [int(a) & int(b) for a, b in found]


def build_models(kind: str, mesh_dir):
    """({name: (verts, faces | None)}, {name: normals}) of the synthetic or
    the real-mesh models. The real models' diameters are registered in
    analyze_uwa.MODEL_DIAMS, whose thresholds the analysis applies per
    model (run_uwa_analog.py:116)."""
    if kind == "real":
        models, normals = synthetic.uwa_real_models(mesh_dir)
        analyze_uwa.MODEL_DIAMS.update(synthetic.REAL_MODEL_DIAMS)
    else:
        models = synthetic.uwa_analog_models()
        normals = {n: pc.mesh_vertex_normals(v, f)
                   for n, (v, f) in models.items()}
    return models, normals


def cli_argv(kind, scene_path, model_paths, truth_paths, scene_leaf,
             capacity, max_poses, rescore, log_path):
    """The CLI's argv for one scene (run_uwa_analog.py:301-337)."""
    real = kind == "real"
    n = len(model_paths)
    return [
        "--scene_files", str(scene_path),
        "--model_files", ",".join(model_paths),
        "--tau_d", ",".join(["0.1"] * n),
        "--scene_leaf_size", str(scene_leaf),
        "--scene_capacity", str(capacity),
        "--ref_point_df", "1",
        "--icp_iterations", "12",
        "--icp_max_dist_factor", "1.0",
        # Real bones have near-planar blades (scapula): point-to-plane ICP
        # stops the in-plane slide of point-to-point ICP.
        "--icp_point_to_plane", "true" if real else "false",
        # Thin real geometry collapses under a centroid voxel grid; the
        # normal octant in the cell key keeps one point per side.
        "--normal_aware_downsample", "true" if real else "false",
        # Real-scan descriptions are large (skull: ~15k occupied keys); the
        # correlation engine's runs_cap is set above the scene's occupied
        # cells so that the sweep stays in one capacity bucket.
        *(["--engine", "correlation",
           "--runs_cap", str(capacity * capacity // 4)] if real else []),
        "--max_poses", str(max_poses),
        *(["--rescore_poses", "true"] if rescore else []),
        "--validation_files", ",".join(truth_paths),
        "--loglevel", "info",
        "--logfile", str(log_path),
    ]


def summarize(out: Path, run_dir: Path, names, n_scenes, sfx, t0):
    """analyze_uwa over the run's logs, then the summary of
    run_uwa_analog.py:345-409: the match rate, per model, per occlusion
    bin and per (model, bin), and every trial."""
    rcode = analyze_uwa.main([str(out / "occlusion.txt"), str(run_dir),
                              "--plot", str(out / f"uwa_analog{sfx}")])
    if rcode != 0:
        raise RuntimeError(f"analyze_uwa exited with {rcode}")
    data = analyze_uwa.read_occlusion_txt(out / "occlusion.txt")
    analyze_uwa.read_run_dir(data, run_dir)
    occl, nd, rot, match = analyze_uwa.analyze(data)
    trials = []
    for r in data:
        if len(r) <= 3 or r[1] not in analyze_uwa.MODEL_DIAMS:
            continue
        te, re_ = r[3]
        re_w = re_ if re_ <= np.pi else 2 * np.pi - re_
        trials.append({
            "scene": r[0], "model": r[1], "occlusion": float(r[2]),
            "trans_err": float(te), "rot_err_deg": float(np.degrees(re_w)),
            "match": bool(te <= 0.3 * analyze_uwa.MODEL_DIAMS[r[1]]
                          and re_w <= analyze_uwa.TWELVE_DEG)})
    per_model = {}
    for n in names:
        m = [t["match"] for t in trials if t["model"] == n]
        per_model[n] = {"n": len(m),
                        "match_rate": float(np.mean(m)) if m else 0.0}
    curve = []
    for lo, hi in OCC_BINS:
        sel = (occl >= lo) & (occl < hi)
        if sel.sum():
            curve.append({"occ_bin": f"{lo}-{hi}", "n": int(sel.sum()),
                          "match_rate": float(match[sel].mean()),
                          "median_rot_deg": float(np.degrees(
                              np.median(rot[sel])))})
    cross = {}
    for n in names:
        cross[n] = {}
        for lo, hi in OCC_BINS:
            sel = [t for t in trials
                   if t["model"] == n and lo <= t["occlusion"] < hi]
            if sel:
                cross[n][f"{lo}-{hi}"] = {
                    "n": len(sel),
                    "match_rate": float(np.mean([t["match"] for t in sel])),
                    "median_rot_deg": float(np.median(
                        [t["rot_err_deg"] for t in sel]))}
    return {
        "scenes": n_scenes, "models": list(names),
        "match_rate": float(match.mean()),
        "per_model": per_model, "occlusion_curve": curve,
        "per_model_by_occ_bin": cross,
        "trials": trials,
        "trans_err_diam_median": float(np.median(nd)),
        "rot_err_rad_median": float(np.median(rot)),
        "wall_s": time.time() - t0,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outdir", type=str,
                    default=str(ROOT / "build" / "uwa_analog"))
    ap.add_argument("--scenes", type=int, default=30)
    ap.add_argument("--quick", action="store_true", help="2 scenes")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--resume", action="store_true",
                    help="skip scenes whose log is already complete")
    ap.add_argument("--models", choices=["synthetic", "real"],
                    default="synthetic")
    ap.add_argument("--mesh_dir", type=str,
                    default=str(synthetic.REAL_MESH_DIR),
                    help="directory of the four STL meshes of --models real")
    ap.add_argument("--run_name", type=str, default="run1",
                    help="log subdirectory and summary suffix, so that "
                         "variants run side by side on the same scenes")
    ap.add_argument("--max_poses", type=int, default=1024)
    ap.add_argument("--rescore", action="store_true",
                    help="pass --rescore_poses true")
    args = ap.parse_args(argv)
    if args.quick:
        args.scenes = 2
    return args


def sweep(args, device=None) -> dict:
    """The sweep of parse_args' `args`: every scene through the CLI, then
    the analysis. The CLI runs on the current CUDA device unless `device`
    says otherwise. Returns the summary, every scene's bits included, and
    writes it to summary<_run_name>.json."""
    t0 = time.time()
    out = Path(args.outdir)
    run_dir = out / args.run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    sfx = "" if args.run_name == "run1" else f"_{args.run_name}"

    models, normals = build_models(args.models, args.mesh_dir)
    names = list(models)
    model_paths = []
    for n, (v, f) in models.items():
        p = out / f"{n}_model.ply"
        ply.write_ply(p, v, normals[n], faces=f)
        model_paths.append(str(p))
        print(f"[uwa-analog] model {n}: {len(v)} verts, "
              f"diam {analyze_uwa.MODEL_DIAMS[n]:.1f}",
              file=sys.stderr, flush=True)

    scale = max(analyze_uwa.MODEL_DIAMS[n] for n in names)
    scene_leaf = synthetic.SCENE_LEAF_FACTOR * scale
    rng = np.random.default_rng(args.seed)
    diams = synthetic.REAL_MODEL_DIAMS if args.models == "real" else None
    scenes = []
    occl_lines = ["scene model occlusion"]
    for s in range(args.scenes):
        sp, sn, truths = synthetic.uwa_analog_scene(rng, models, normals,
                                                    diams=diams)
        if len(sp) != synthetic.N_TOTAL:
            raise RuntimeError(f"scene {s + 1} has {len(sp)} points")
        scenes.append((sp, sn, truths))
        occl_lines += [f"{s + 1} {n} {truths[n][1]:.1f}" for n in names]
    # One static voxel capacity for the sweep: the first scenes' largest
    # occupancy + 15%, in the CLI's voxelization mode.
    na = args.models == "real"
    occs = [int(pc.voxel_downsample_np(sp, sn, scene_leaf,
                                       normal_aware=na)[0].shape[0])
            for sp, sn, _ in scenes[:4]]
    capacity = ((int(max(occs) * 1.15) + 127) // 128) * 128
    print(f"[uwa-analog] scene occupancies {occs}, capacity {capacity}",
          file=sys.stderr, flush=True)
    (out / "occlusion.txt").write_text("\n".join(occl_lines) + "\n")

    bits = []
    for s, (sp, sn, truths) in enumerate(scenes):
        scene_path = out / f"rs{s + 1}.ply"
        log_path = run_dir / f"rs{s + 1}_0.log"
        if args.resume:
            row = scene_log_bits(log_path, len(names))
            if row is not None:
                bits.append(row)
                print(f"[uwa-analog] scene {s + 1}/{args.scenes}: "
                      f"{dict(zip(names, row))} (resumed from log)",
                      file=sys.stderr, flush=True)
                continue
        ply.write_ply(scene_path, sp, sn)
        tpaths = []
        for n in names:
            tp = out / f"rs{s + 1}_{n}_truth.txt"
            validation.write_truth_file(tp, truths[n][0])
            tpaths.append(str(tp))
        argv_s = cli_argv(args.models, scene_path, model_paths, tpaths,
                          scene_leaf, capacity, args.max_poses, args.rescore,
                          log_path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv_s, device=device)
        if rc != 0:
            raise RuntimeError(f"scene {s + 1}: the CLI exited with {rc}")
        row = [int(b) for b in buf.getvalue().split()]
        bits.append(row)
        print(f"[uwa-analog] scene {s + 1}/{args.scenes}: "
              f"{dict(zip(names, row))} ({time.time() - t0:.0f}s)",
              file=sys.stderr, flush=True)

    summary = summarize(out, run_dir, names, args.scenes, sfx, t0)
    summary.update({"bits": bits, "capacity": capacity,
                    "scene_occupancies": occs, "models_kind": args.models})
    (out / f"summary{sfx}.json").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None, device=None) -> int:
    print(json.dumps(sweep(parse_args(argv), device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
