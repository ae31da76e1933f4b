"""kinfu.gn_kernel_pct: the share, in %, of the program's `tsdf.gauss_newton`
spans that hold a `tsdf.gn_kernel` span: the tracked frames whose
Gauss-Newton steps ran as one kernel launch rather than the plain loop
(KinFu tracking, models/tsdf track_frame; program_spans). None where no
`tsdf.gauss_newton` span fell in a request."""

from benchmark.metrics import program_spans

UNIT = "%"


def read(run):
    t = program_spans.table(run)
    if t is None:
        return None
    steps = {i for i, s in enumerate(t.stages)
             if s.name == "tsdf.gauss_newton"}
    if not steps:
        return None
    held = {s.parent for s in t.stages if s.name == "tsdf.gn_kernel"} & steps
    return 100.0 * len(held) / len(steps)
