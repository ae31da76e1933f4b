"""kinfu.track_ms_per_pose: the walls of the program's spans `tsdf.track`
per pose, in ms (KinFu tracking, models/tsdf track_frame; program_spans):
the model view's raycast, the Gauss-Newton steps and the host read of
their inliers and overlap, which waits for them."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("tsdf.track",))
