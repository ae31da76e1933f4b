"""Loop `closed`: one client sends its next request as soon as the last
has its pose. No request starts after `seconds`.

Each request runs inside the profiler span `benchmark.request.<n>`, n its
number among the attempted ones, so that a traced run can tell which
device operations belong to which request (the span costs about a
microsecond when nothing traces).
"""

import sys
import time
import traceback

import torch

from benchmark.harness import Record


def run(deployment, requests, seconds: float):
    """Returns (records, attempted, failed, window seconds)."""
    records, attempted, failed = [], 0, 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        req = next(requests)
        n = attempted
        attempted += 1
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"benchmark.request.{n}"):
                out = deployment.serve(req)
        except Exception:           # a failed request is counted, not fatal
            traceback.print_exc(file=sys.stderr)
            failed += 1
            continue
        latency_s = time.perf_counter() - t0
        records.append(Record(n, req, deployment.retain(out), latency_s))
    return records, attempted, failed, time.perf_counter() - t_start
