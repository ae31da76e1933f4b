"""kinfu.extract_ms_per_pose: the walls of the program's spans
`tsdf.extract` per pose, in ms (recognition on the fused surface,
models/tsdf extract_surface; program_spans): the occupancy count and its
host read, the extraction with its normals and the surface's copy to the
host."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("tsdf.extract",))
