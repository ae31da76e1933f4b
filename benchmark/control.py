"""Readings that the limits of `correct` are set from, on the card.

    python benchmark/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--nudge-seeds 1,2] [--sample 8] [--out FILE]

For each of --seeds: the cell's set-up and warm-up, then one pass over the
pool through the program as the window sends it, and the judge on a
sample of those requests (the lower readings). For each of
--control-seeds: the plain reference with every matrix product in TF32
put in the program's place, judged by the float32 reference on the same
sample (the upper readings). For each of --nudge-seeds: the reference
itself with ICP's start moved by 1e-6 of the diameter. One JSON line per
seed and side: the numbers over the sample as the run aggregates them,
and every request's parts beside them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.frozen import reference as ref  # noqa: E402


def _sample(inputs, n, seed):
    reqs = [r for _, r in zip(range(len(inputs.scans) * len(inputs.models)),
                              inputs.requests())]
    rng = np.random.default_rng([seed, 7])
    pick = rng.choice(len(reqs), size=min(n, len(reqs)), replace=False)
    return [reqs[i] for i in sorted(pick.tolist())]


def readings(cell, seed, n, device, side: str):
    """(the numbers over the sample, every request's numbers) on one seed:
    the program's, the TF32 control's, or the reference's own with ICP's
    start nudged by 1e-6 of the diameter."""
    import importlib
    kind = importlib.import_module(f"benchmark.kinds.{cell.config['kind']}")
    inputs = kind.Inputs(cell.config, cell.traffic, seed)
    picks = _sample(inputs, n, seed)
    judge = kind.Reference(inputs, device)
    if side == "control":
        low = kind.Reference(inputs, device, ref.Precision(tf32=True))
        outs = [low.outcome(r.scan, r.model) for r in picks]
    elif side == "nudge":
        outs = [judge.outcome(r.scan, r.model, nudge=1e-6) for r in picks]
    else:
        dep = kind.Deployment(inputs, device)
        dep.warm_up()
        by_req = {}
        for r in _sample(inputs, 10 ** 6, seed):
            by_req[r] = dep.serve(r)
        outs = [by_req[r] for r in picks]
        del dep
        torch.cuda.empty_cache()
    rows = [kind.judge(judge, r, o, cell.config["judge"])
            for r, o in zip(picks, outs)]
    return kind.aggregate(rows), [dict(scan=r.scan, model=r.model, **row)
                                  for r, row in zip(picks, rows)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--nudge-seeds", default="")
    ap.add_argument("--sample", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py reads the card; no CUDA device", file=sys.stderr)
        return 2
    manifest = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    sink = open(args.out, "a") if args.out else None
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds),
                        ("nudge", args.nudge_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            numbers, rows = readings(cell, seed, args.sample, "cuda:0",
                                     side)
            line = json.dumps({"workload": args.workload, "side": side,
                               "seed": seed, "numbers": numbers,
                               "seconds": time.perf_counter() - t0,
                               "requests": rows})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
