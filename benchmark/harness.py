"""The benchmark's harness: it finds a cell's configuration, traffic mix,
deployment kind, loop and metric readers by the names in BENCHMARK.json,
sets the deployment up, runs the traffic's loop for the window, reads the
metrics and decides `correct`.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under this directory; adding a cell adds files and
manifest entries and edits none.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmark import tracing

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# What the process that prints the result may not hold (top-level names).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "objective_slam_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    end_to_end: list      # manifest entries that this cell reports
    per_layer: list
    root: Path            # the benchmark directory its files are in


def find_cell(manifest: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell `workload` of the manifest, with its configuration's file
    and its traffic's file read. Raises KeyError for an unknown name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it "
                       f"has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root.parent / configs[w["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")

    def here(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in manifest["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in moved and here(m)]
    return Cell(workload, config, traffic, e2e, per_layer, root)


def load_reader(name: str, root: Path = HERE):
    """The reader of metric `name`, metrics/<name>.py: `read(run)` takes a
    RunView and returns the value, or None where it finds nothing."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._reader_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Record(NamedTuple):
    n: int                # the request's number among those attempted
    req: object
    outcome: object
    latency_s: float


class RunView:
    """What the metric readers read: the window's records, its length,
    the set-up time, the device's peak memory, the trace (None in an
    untraced run) and the kernel work of a request (worked out by the
    reference)."""

    def __init__(self, records, window_s, setup_s, peak_bytes, trace,
                 work_fn):
        self.records = records
        self.window_s = window_s
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace
        self._work_fn = work_fn
        self._work = {}

    def work(self, req):
        key = (req.scan, req.model)
        if key not in self._work:
            self._work[key] = self._work_fn(*key)
        return self._work[key]


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float):
    """Set-up, warm-up, the window and the judge. Returns (result line as
    a dict, the checks)."""
    kind = importlib.import_module(f"benchmark.kinds.{cell.config['kind']}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    inputs = kind.Inputs(cell.config, cell.traffic, seed)
    deployment = kind.Deployment(inputs, dev)
    deployment.warm_up()
    requests = inputs.requests()
    setup_s = time.perf_counter() - t_process

    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    tracer = tracing.Tracer() if trace else contextlib.nullcontext()
    with tracer:
        records, attempted, failed, window_s = loop.run(
            deployment, requests, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del deployment
    if on_card:
        torch.cuda.empty_cache()

    t_read = time.perf_counter()
    reference = kind.Reference(inputs, dev)
    view = RunView(records, window_s, setup_s, peak,
                   tracer.summary if trace else None, reference.work)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_reader(m["name"], cell.root).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        print(f"trace: reduced in {tracer.reduce_s:.1f} s, metrics read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)

    t_ref = time.perf_counter()
    checks = check(kind, reference, records, failed, cell, seed)
    print(f"reference: {len(records)} requests, judged in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if on_card else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if on_card
                       else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        line["device"]["busy_s"] = tracer.summary.busy_s
        line["device"]["window_s"] = tracer.summary.window_s
        line["breakdown"] = tracer.summary.breakdown()
    return line, checks


def check(kind, reference, records, failed, cell, seed):
    """The judge over a sample of the window's requests drawn from the
    seed, the slowest one among them: each number over the sample (the
    kind's `aggregate`) beside its limit. A failed request, or none
    completed, fails."""
    params = cell.config["judge"]
    limits = cell.config["limits"]
    n = min(int(params["sample"]), len(records))
    rng = np.random.default_rng([seed, 7])
    picks = set(rng.choice(len(records), size=n, replace=False).tolist()) \
        if records else set()
    if records:
        picks.add(max(range(len(records)),
                      key=lambda i: records[i].latency_s))
    rows = [kind.judge(reference, records[i].req, records[i].outcome,
                       params) for i in sorted(picks)]
    numbers = kind.aggregate(rows) if rows else {}
    checks = {name: {"value": numbers.get(name, math.inf),
                     "limit": limits[name]} for name in limits}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["judged_requests_missing"] = {"value": 0 if picks else 1,
                                         "limit": 0}
    return checks
