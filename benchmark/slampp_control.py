"""Readings that the surface and recognition limits of `correct` are set
from in a `kinfu_recognize` cell, on the card.

    python benchmark/slampp_control.py --workload slampp-recognize-512 \
        [--frames 2,5,...] [--nudge 1e-6] [--out FILE]

The cell's set-up and warm-up, then one pass over the segment as the
window sends it. At each recognition frame listed (all by default): the
surface reference in float32 on the program's volume, held against the
program's surface (the lower readings) and against the same reference with
its products in TF32 (the upper readings); then frozen/reference's plain
PPF in float32 on the program's surface, held against the program's
matches (lower), the TF32 reference's own answers in the program's place
(upper) and the float32 reference's own answers with ICP's start moved by
`--nudge` of the diameter (the witness of how far float32 rounding alone
carries ICP). One JSON line per frame: each side's numbers as the judge
aggregates them, every object's parts, the request's latency and counters,
and the seconds each reference part took; then one line per side with the
worst of each number over the frames. The camera and volume readings are
`kinfu_control.py`'s (the frames and the tracking are `kinfu_track`'s).
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.frozen import reference as ref  # noqa: E402
from benchmark.frozen import surface_reference as sr  # noqa: E402
from benchmark.kinds import ppf_scan  # noqa: E402

NUMBERS = ("rows_gap", "normal_gap", "topk_gap", "survivors_gap",
           "winner_gap", "pose_gap")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def readings(cell, device, frames, nudge: float, emit):
    kind = importlib.import_module(f"benchmark.kinds.{cell.config['kind']}")
    params = cell.config["judge"]
    inputs = kind.Inputs(cell.config, cell.traffic, 0)
    t0 = time.perf_counter()
    dep = kind.Deployment(inputs, device)
    dep.warm_up()
    emit({"setup_and_warm_up_s": time.perf_counter() - t0,
          "peak_bytes": torch.cuda.max_memory_allocated()
          if torch.cuda.is_available() else 0})
    fp32, tf32 = ref.FP32, ref.Precision(tf32=True)
    m32 = kind._Matches(inputs, device, fp32)
    mtf = kind._Matches(inputs, device, tf32)
    reqs = inputs.requests()
    latencies, worst = [], {}
    for _ in range(inputs.segment):
        req = next(reqs)
        t = time.perf_counter()
        out = dep.serve(req)
        latencies.append(time.perf_counter() - t)
        out = dep.retain(out)
        if not req.recognize or (frames and req.scan not in frames):
            continue
        row = {"frame": req.scan, "latency_s": latencies[-1],
               "occupancy": out.occupancy, "capacity": out.capacity,
               "scene_points": out.scene_points, "seconds": {}}
        vol = dep.rec.volume
        geo = (vol.origin.cpu().numpy(), vol.voxel_size, inputs.dims,
               float(params["normal_deg"]))
        t = time.perf_counter()
        r32 = sr.extract(vol.tsdf, vol.weight, vol.origin, vol.voxel_size,
                         out.capacity)
        rtf = sr.extract(vol.tsdf, vol.weight, vol.origin, vol.voxel_size,
                         out.capacity, prec=tf32)
        _sync()
        row["seconds"]["surface_reference_x2"] = time.perf_counter() - t
        sides = {"program": kind.surface_gaps(out.surface, r32, *geo),
                 "control": kind.surface_gaps(
                     (rtf.points.cpu().numpy(), rtf.normals.cpu().numpy()),
                     r32, *geo)}
        sides["nudge"] = {"rows_gap": 0.0, "normal_gap": 0.0}
        del r32, rtf
        s = m32.add(out.surface)
        s_tf = mtf.add(out.surface)
        parts = {k: [] for k in sides}
        for i in range(len(inputs.models)):
            pick = kind._Pick(s, i)
            t = time.perf_counter()
            m32.candidates(s, i)
            _sync()
            row["seconds"][f"candidates_{i}"] = time.perf_counter() - t
            t = time.perf_counter()
            parts["program"].append(ppf_scan.judge(m32, pick, out.matches[i],
                                                   params))
            _sync()
            row["seconds"][f"judge_{i}"] = time.perf_counter() - t
            parts["control"].append(ppf_scan.judge(
                m32, pick, mtf.outcome(s_tf, i), params))
            parts["nudge"].append(ppf_scan.judge(
                m32, pick, m32.outcome(s, i, nudge), params))
        for side, rows in parts.items():
            agg = ppf_scan.aggregate(rows)
            sides[side].update({k: agg[k] for k in NUMBERS[2:]})
            for k in NUMBERS:
                worst.setdefault(side, {})[k] = max(
                    worst.get(side, {}).get(k, 0.0), sides[side][k])
        row["sides"] = sides
        row["parts"] = parts
        emit(row)
    emit({"latencies_s": latencies,
          "peak_bytes": torch.cuda.max_memory_allocated()
          if torch.cuda.is_available() else 0})
    for side, numbers in worst.items():
        emit({"side": side, "worst": numbers})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--frames", default="")
    ap.add_argument("--nudge", type=float, default=1e-6)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slampp_control.py reads the card; no CUDA device",
              file=sys.stderr)
        return 2
    manifest = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    frames = {int(f) for f in args.frames.split(",") if f}
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"workload": args.workload, **obj})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        readings(cell, "cuda:0", frames, args.nudge, emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
