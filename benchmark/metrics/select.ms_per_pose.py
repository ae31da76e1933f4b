"""select.ms_per_pose: the walls of the program's spans `drost.topk`
(top-K, candidate poses, weights) and `drost.cluster` (clustering,
rescoring, the winner) per pose, in ms (program_spans)."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("drost.topk", "drost.cluster"))
