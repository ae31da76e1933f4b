"""kinfu.recognize_ms_per_pose: the walls of the program's spans
`tsdf.recognize` per pose, in ms (recognition on the fused surface,
models/tsdf StreamingRecognizer.recognize; program_spans): the surface's
extraction and every object's match, to the last refined pose on the
host."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("tsdf.recognize",))
