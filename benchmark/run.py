"""The benchmark of objective_slam_tpu_torch on NVIDIA GPUs.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json (at the root of the checkout) in this
process: set-up, warm-up of the cell's shapes, the traffic's loop for
--seconds, then the judge against the plain reference. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), `device`, with --trace 1 `breakdown`, and last `checks`, each
number compared beside its limit (also the last lines of standard error).
Exits with 2, printing no result, without the CUDA devices the cell asks
for, and with 3 if JAX or the JAX package was loaded.
"""

import os
import time


def _process_start() -> float:
    """perf_counter() at the moment this process started."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (
            uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness

    manifest = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload)
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    line, checks = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0", T_PROCESS)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules that may not be loaded are loaded: {bad}",
              file=sys.stderr)
        return 3
    line["card"] = card_line()
    line["checks"] = checks
    print(f"card: {line['card']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
