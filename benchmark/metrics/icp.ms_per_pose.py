"""icp.ms_per_pose: the walls of the program's spans `icp.refine` per
pose, in ms (ICP, ops/icp; program_spans)."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("icp.refine",))
