"""icp.kernel_pct: the share, in %, of the program's `icp.refine` spans
that hold an `icp.kernel` span: the refinements that ran as one kernel
launch rather than the plain loop (ICP, ops/icp; program_spans). None
where no `icp.refine` span fell in a request."""

from benchmark.metrics import program_spans

UNIT = "%"


def read(run):
    t = program_spans.table(run)
    if t is None:
        return None
    refine = {i for i, s in enumerate(t.stages) if s.name == "icp.refine"}
    if not refine:
        return None
    held = {s.parent for s in t.stages if s.name == "icp.kernel"} & refine
    return 100.0 * len(held) / len(refine)
