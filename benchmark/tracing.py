"""The traced window: a torch.profiler trace of CPU operators and device
activity, reduced to what the per-layer metrics and the breakdown read.

The raw kineto records are read directly (no FunctionEvent tree).
"""

from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict

import torch


REQUEST_SPAN = "benchmark.request."


class TraceSummary:
    """Device intervals, kernel records by name, host operators (CPU
    operators and CUDA runtime calls) and the loop's request spans."""

    def __init__(self, events, window_s: float):
        self.window_s = window_s
        dev, host = [], []
        self._records = defaultdict(list)       # name -> [(start, end)]
        self.spans = {}                         # request number -> (a, b)
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            name = e.name()
            on_device = e.device_type() == torch.autograd.DeviceType.CUDA
            if e.is_user_annotation():
                # A record_function span, and on the device its mirror from
                # its first to its last operation: no device work itself.
                if name.startswith(REQUEST_SPAN) and not on_device:
                    self.spans[int(name[len(REQUEST_SPAN):])] = (start, end)
            elif on_device:
                dev.append((start, end))
                self._records[name].append((start, end))
            else:
                host.append((start, end, name, e.start_thread_id()))
        self._durations = {k: [(b - a) / 1e9 for a, b in v]
                           for k, v in self._records.items()}
        self.kernels = sum(len(v) for k, v in self._durations.items()
                           if not k.startswith(("Memcpy", "Memset")))
        self._intervals = _merge(dev)
        self.busy_s = sum(b - a for a, b in self._intervals) / 1e9
        self._host = host

    def kernel_durations(self, substring: str) -> list[float]:
        """Seconds of each traced device operation whose name holds
        `substring`."""
        return [d for name, ds in self._durations.items()
                if substring in name for d in ds]

    def by_request(self, substring: str) -> dict:
        """Seconds of each traced device operation whose name holds
        `substring`, by the request whose span holds the operation's start
        (each request ends by waiting for the device, so its operations
        run inside its span): {request number: [seconds, ...]}."""
        recs = sorted(r for name, rs in self._records.items()
                      if substring in name for r in rs)
        starts = [a for a, _ in recs]
        out = {}
        for n, (a, b) in self.spans.items():
            i, j = bisect.bisect_left(starts, a), bisect.bisect_right(
                starts, b)
            out[n] = [(e - s) / 1e9 for s, e in recs[i:j]]
        return out

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the idle time
        between device operations by the innermost host operator running
        at each gap's middle ("python" where none ran)."""
        ops = sorted(((name, sum(ds)) for name, ds in
                      self._durations.items()), key=lambda x: -x[1])[:top]
        gaps = [(self._intervals[i][1], self._intervals[i + 1][0])
                for i in range(len(self._intervals) - 1)]
        idle = defaultdict(float)
        for (a, b), name in zip(gaps, _innermost(self._host, gaps)):
            idle[name] += (b - a) / 1e9
        gaps_top = sorted(idle.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps_top]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(host, gaps):
    """For each gap (in order), the name of the innermost operator on the
    busiest host thread that spans the gap's middle."""
    if not host:
        return ["python"] * len(gaps)
    main = Counter(h[3] for h in host).most_common(1)[0][0]
    ops = sorted((h for h in host if h[3] == main),
                 key=lambda h: (h[0], -h[1]))
    names, stack, i = [], [], 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append(stack[-1][2] if stack else "python")
    return names


class Tracer:
    """Profiles the block it wraps; `summary` holds the reduction."""

    def __init__(self):
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        if exc[0] is None:
            self.summary = TraceSummary(
                self._prof.profiler.kineto_results.events(), window_s)
        self.reduce_s = time.perf_counter() - self._t0 - window_s
        self._prof = None
        return False
