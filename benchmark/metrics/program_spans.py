"""The program's own spans in a traced window, by request: the stages that
``objective_slam_tpu_torch.utils.profiling.span`` records while the
profiler runs (``profiling.spans()``: name, start and end in Unix-epoch
nanoseconds, the index of the enclosing span). The profiler stamps its
records on the same clock, so each outermost span goes to the request
whose ``benchmark.request.<n>`` interval (``run.trace.spans``) it
overlaps, and the spans inside it go with it. An outermost span that
overlaps a request has to lie wholly in it, within CLOCK_SLACK_NS, or the
log is taken to be on another clock than the trace and nothing is
assigned. A pose is a request completed in the traced window.

`table(run)` does that once per run and prints to standard error one row
per span name, each per pose: spans, wall ms, self ms (wall less the child
spans), CUDA launches in the span's self time (``cudaLaunchKernel*``
records of the trace's host operators), device busy and idle ms in its
self time (the trace's device intervals); then the share of the requests'
wall the ``drost.match`` spans cover, the share of the requests' device
idle time whose gap middle lies in no program span, and the idle time by
innermost span and host operator. It returns None where the program
records no spans, or where no span falls in a request (a log on another
clock).
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import NamedTuple

ROOT = "drost.match"
# How far an outermost span may reach past its request's interval: the
# profiler converts its own clock to the epoch, and that conversion and
# the stamps' placement inside a record_function differ by microseconds.
CLOCK_SLACK_NS = 1_000_000
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


class Stage(NamedTuple):
    name: str
    start: int          # ns, Unix epoch
    end: int
    parent: int         # index in Table.stages, or -1
    request: int        # the request's number


class Table(NamedTuple):
    requests: list              # numbers of the requests completed in the
                                # traced window: the poses
    stages: list                # Stage, in the log's order
    latency_s: float            # Σ the poses' latencies (host clock)

    @property
    def poses(self) -> int:
        return len(self.requests)


def _program_log():
    """The program's span log, or None where the program has none."""
    try:
        from objective_slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def assign(run, log) -> Table | None:
    """The spans of `log` that fall in a completed request's interval;
    None where none does, or where the log disagrees with the trace's
    clock."""
    if run.trace is None or not log:
        return None
    done = {r.n: r for r in run.records if r.n in run.trace.spans}
    reqs = sorted((run.trace.spans[n], n) for n in done)
    starts = [a for (a, _), _ in reqs]
    keep, index, request = [], {}, {}
    for i, s in enumerate(log):
        if s.end_ns < s.start_ns:               # still open
            continue
        if s.parent >= 0:
            n = request.get(s.parent)
        else:
            j = bisect.bisect_right(starts, s.end_ns) - 1
            n = None
            if j >= 0 and reqs[j][0][1] >= s.start_ns:
                (a, b), n = reqs[j]
                if s.start_ns < a - CLOCK_SLACK_NS \
                        or s.end_ns > b + CLOCK_SLACK_NS:
                    print(f"program spans: {s.name} "
                          f"[{s.start_ns}, {s.end_ns}] is not inside "
                          f"request {n} [{a}, {b}]: the span log is on "
                          "another clock than the trace", file=sys.stderr)
                    return None
        if n is None:
            continue
        request[i] = n
        index[i] = len(keep)
        keep.append((s, n))
    if not keep:
        return None
    stages = [Stage(s.name, s.start_ns, s.end_ns, index.get(s.parent, -1), n)
              for s, n in keep]
    return Table(sorted(done), stages,
                 sum(r.latency_s for r in done.values()))


def table(run) -> Table | None:
    """`assign` of the program's log, worked out and printed once a run."""
    if "_program_spans" not in run.__dict__:
        t = assign(run, _program_log())
        run.__dict__["_program_spans"] = t
        if t is not None:
            _print(run, t)
    return run.__dict__["_program_spans"]


def ms_per_pose(run, names) -> float | None:
    """Σ the walls of the spans named in `names`, in ms per pose; None
    where no such span fell in a request."""
    t = table(run)
    if t is None:
        return None
    walls = [s.end - s.start for s in t.stages if s.name in names]
    if not walls:
        return None
    return sum(walls) / 1e6 / t.poses


def _children(stages):
    kids = defaultdict(list)
    for i, s in enumerate(stages):
        if s.parent >= 0:
            kids[s.parent].append(i)
    return kids


def _busy_before(intervals):
    """B(t): device-busy ns before t, from merged sorted intervals."""
    starts = [a for a, _ in intervals]
    acc = [0]
    for a, b in intervals:
        acc.append(acc[-1] + b - a)

    def busy(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0
        a, b = intervals[k - 1]
        return acc[k - 1] + min(t, b) - a
    return busy


def _innermost(stages, points):
    """For each sorted point, the index of the innermost stage holding it,
    or -1 (the stages of one thread nest)."""
    order = sorted(range(len(stages)),
                   key=lambda i: (stages[i].start, -stages[i].end))
    out, stack, k = [], [], 0
    for p in points:
        while k < len(order) and stages[order[k]].start <= p:
            i = order[k]
            while stack and stages[stack[-1]].end <= stages[i].start:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and stages[stack[-1]].end < p:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


class Breakdown(NamedTuple):
    rows: dict          # span name -> [spans, wall, self, launches in self,
                        # device busy in self] (ns), over all poses
    cover: float        # Σ drost.match walls over Σ latencies, in %
    idle_ns: int        # device idle inside the requests
    unspanned_ns: int   # of which the gap's middle lies in no span
    idle_by: dict       # (innermost span or "(no span)", innermost host
                        # operator) -> idle ns


def breakdown(run, t: Table) -> Breakdown:
    """The per-span table, the cover and the idle attribution."""
    from benchmark import tracing

    st = t.stages
    kids = _children(st)
    wall = [s.end - s.start for s in st]
    self_ns = [w - sum(wall[c] for c in kids[i]) for i, w in enumerate(wall)]
    ivs = run.trace._intervals
    busy = _busy_before(ivs)
    busy_in = [busy(s.end) - busy(s.start) for s in st]
    self_busy = [b - sum(busy_in[c] for c in kids[i])
                 for i, b in enumerate(busy_in)]
    launches = sorted(h[0] for h in run.trace._host
                      if h[2].startswith(LAUNCH))
    self_launch = defaultdict(int)
    for i in _innermost(st, launches):
        if i >= 0:
            self_launch[i] += 1
    rows = defaultdict(lambda: [0, 0, 0, 0, 0])
    for i, s in enumerate(st):
        r = rows[s.name]
        r[0] += 1
        r[1] += wall[i]
        r[2] += self_ns[i]
        r[3] += self_launch[i]
        r[4] += self_busy[i]
    match_ns = sum(w for s, w in zip(st, wall) if s.name == ROOT)
    cover = 100 * match_ns / 1e9 / t.latency_s if t.latency_s > 0 else 0.0

    # Device idle inside the requests, by the innermost program span and
    # the innermost host operator at each gap's middle.
    gaps = []
    iv_starts = [a for a, _ in ivs]
    for n in t.requests:
        a, b = run.trace.spans[n]
        k = max(bisect.bisect_right(iv_starts, a) - 1, 0)
        cur = a
        while k < len(ivs) and ivs[k][0] < b:
            lo, hi = ivs[k]
            if lo > cur:
                gaps.append((cur, lo))
            cur = max(cur, hi)
            k += 1
        if cur < b:
            gaps.append((cur, b))
    gaps.sort()
    inner = _innermost(st, [(a + b) // 2 for a, b in gaps])
    ops = tracing._innermost(run.trace._host, gaps)
    idle_by = defaultdict(int)
    for (a, b), i, op in zip(gaps, inner, ops):
        idle_by[(st[i].name if i >= 0 else "(no span)", op)] += b - a
    return Breakdown(dict(rows), cover, sum(b - a for a, b in gaps),
                     sum(b - a for (a, b), i in zip(gaps, inner) if i < 0),
                     dict(idle_by))


def _print(run, t: Table):
    b = breakdown(run, t)
    p = t.poses
    out = [f"program spans: {len(t.stages)} spans in {p} poses; per pose: "
           "spans, wall ms, self ms, launches (self), device busy ms "
           "(self), device idle ms (self)"]
    for name, (n, w, sf, la, bu) in sorted(b.rows.items(),
                                           key=lambda kv: -kv[1][1]):
        out.append(f"  {name:28s} {n / p:9.3f} {w / 1e6 / p:10.4f} "
                   f"{sf / 1e6 / p:10.4f} {la / p:10.2f} {bu / 1e6 / p:10.4f}"
                   f" {(sf - bu) / 1e6 / p:10.4f}")
    out.append(f"  {ROOT} walls cover {b.cover:.2f}% of the poses' summed "
               f"latency ({t.latency_s:.4f} s)")
    if b.idle_ns:
        out.append(f"  device idle in requests {b.idle_ns / 1e9:.4f} s, "
                   f"{100 * b.unspanned_ns / b.idle_ns:.2f}% of it in no "
                   "program span; by span and host operator (s):")
        for (name, op), ns in sorted(b.idle_by.items(),
                                     key=lambda kv: -kv[1])[:12]:
            out.append(f"    {name:28s} {op[:48]:48s} {ns / 1e9:.4f}")
    print("\n".join(out), file=sys.stderr)
