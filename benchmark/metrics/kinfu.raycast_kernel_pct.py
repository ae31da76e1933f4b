"""kinfu.raycast_kernel_pct: the share, in %, of the program's
`tsdf.raycast` spans that hold a `tsdf.raycast_kernel` span: the tracked
frames whose model view was raycast by the launches of the raycast
kernel rather than the plain version (KinFu tracking, models/tsdf
track_frame; program_spans). None where no `tsdf.raycast` span fell in a
request."""

from benchmark.metrics import program_spans

UNIT = "%"


def read(run):
    t = program_spans.table(run)
    if t is None:
        return None
    casts = {i for i, s in enumerate(t.stages) if s.name == "tsdf.raycast"}
    if not casts:
        return None
    held = {s.parent for s in t.stages
            if s.name == "tsdf.raycast_kernel"} & casts
    return 100.0 * len(held) / len(casts)
