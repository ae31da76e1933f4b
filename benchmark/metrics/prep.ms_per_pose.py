"""prep.ms_per_pose: the walls of the program's spans
`pointcloud.voxel_downsample` (the device voxel grid, charged to its scan's
first request) and `drost.keys` (PPF keys and α of the scene) per pose, in
ms (voxel grid and PPF keys; program_spans)."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(
        run, ("pointcloud.voxel_downsample", "drost.keys"))
