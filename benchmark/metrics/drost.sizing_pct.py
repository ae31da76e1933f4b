"""drost.sizing_pct: the share, in %, of the matcher's time not spent in
the match it returned: Σ over the `drost.match` spans of (its wall less
the wall of its last `drost.core`) over Σ their walls. Count passes,
discarded rungs of the top-K ladder, retries and host syncs (entry and
sizing, models/drost; program_spans)."""

from benchmark.metrics import program_spans

UNIT = "%"


def read(run):
    t = program_spans.table(run)
    if t is None:
        return None
    last_core = {}
    for i, s in enumerate(t.stages):
        if s.name == "drost.core":
            root = s.parent
            while root >= 0 and t.stages[root].name != program_spans.ROOT:
                root = t.stages[root].parent
            last_core[root] = s.end - s.start
    total = outside = 0
    for i, s in enumerate(t.stages):
        if s.name == program_spans.ROOT:
            total += s.end - s.start
            outside += s.end - s.start - last_core.get(i, 0)
    if not total:
        return None
    return 100.0 * outside / total
