"""kinfu.integrate_ms_per_pose: the walls of the program's spans
`tsdf.integrate` per pose, in ms (KinFu integration, models/tsdf
integrate_depth; program_spans): the voxel update at the tracked pose and
the pose's host copy, which waits for it."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("tsdf.integrate",))
