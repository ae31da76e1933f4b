"""host.sync_ms_per_pose: the walls of the program's spans `drost.sync`,
each a host read of a device value in the matcher, per pose, in ms: the
time the host waits for the device (program_spans)."""

from benchmark.metrics import program_spans

UNIT = "ms"


def read(run):
    return program_spans.ms_per_pose(run, ("drost.sync",))
