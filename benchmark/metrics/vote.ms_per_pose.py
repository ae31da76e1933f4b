"""vote.ms_per_pose: the walls of the program's spans `drost.vote` (the
vote pass: expansion and tally, K1 or K2 included, on every rung) per
pose, in ms (program_spans)."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("drost.vote",))
