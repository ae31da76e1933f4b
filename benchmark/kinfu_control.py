"""Readings that the limits of `correct` are set from in a `kinfu_track`
cell, on the card.

    python benchmark/kinfu_control.py --workload kinfu-track-512 \
        [--sides program,control,nudge] [--nudge 1e-6] [--out FILE]

The plain reference (float32) replays the segment from its own snapshot,
and beside it, frame by frame, one other side: `program`, the cell's
set-up and warm-up, then the segment's requests in order as the window
sends them (the lower readings); `control`, the same reference with every
matrix product's operands rounded to TF32 (the upper readings); `nudge`,
the reference itself with its first frame's start moved by `--nudge`
voxels (the witness of how far float32 rounding alone carries a replay).
After each frame both sides are compared as the judge compares them: the
pose gap of that frame, and the volume gaps of the two volumes after it.
One JSON line per side and frame, then one per side with the largest
reading of each number over the frames.
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
from benchmark.frozen import kinfu_reference as kr  # noqa: E402

SIDES = ("program", "control", "nudge")


def readings(cell, side: str, device, nudge: float = 1e-6, sink=None):
    """Per-frame readings of one side against the float32 reference, and
    the largest of each over the segment."""
    kind = importlib.import_module(f"benchmark.kinds.{cell.config['kind']}")
    inputs = kind.Inputs(cell.config, cell.traffic, 0)
    if side == "program":
        dep = kind.Deployment(inputs, device)
        dep.warm_up()
        reqs = inputs.requests()
    else:
        prec = kr.Precision(tf32=True) if side == "control" else kr.FP32
        moved = nudge if side == "nudge" else 0.0
        mine = kind.session(inputs, device, prec)
    rows = []

    def compare(f, stream):
        if side == "program":
            out = dep.serve(next(reqs))
            pose, vol, lost = out.pose, inputs.final.volume, out.lost
        else:
            lost, _ = kind.advance(mine, inputs, f, moved)
            pose, vol = mine.T_cw.cpu().numpy(), mine.vol
        row = {"frame": f, "lost": lost,
               "pose_gap": kr.corner_gap(pose, stream.T_cw, inputs.origin,
                                         inputs.extent),
               "rot_deg": kr.rotation_deg(pose, stream.T_cw),
               "truth_gap": kr.corner_gap(pose, inputs.frames[f].T_cw,
                                          inputs.origin, inputs.extent)}
        row.update(kind.volume_gaps(vol, stream.vol, inputs.truncation,
                                    f + 1))
        rows.append(row)
        line = json.dumps({"workload": cell.name, "side": side, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    kind.replay(inputs, device, each=compare)
    worst = {k: max(r[k] for r in rows) for k in rows[0]
             if k not in ("frame", "lost")}
    worst["lost_frames"] = sum(r["lost"] for r in rows)
    return worst, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sides", default=",".join(SIDES))
    ap.add_argument("--nudge", type=float, default=1e-6)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kinfu_control.py reads the card; no CUDA device",
              file=sys.stderr)
        return 2
    manifest = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for side in args.sides.split(","):
            t0 = time.perf_counter()
            worst, _ = readings(cell, side, "cuda:0", args.nudge, sink)
            line = json.dumps({"workload": args.workload, "side": side,
                               "worst": worst,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
