"""host.launches_per_pose: kernels the device ran in the traced window
(profiler records, memory copies and sets left out) over the requests
completed in it (host dispatch)."""

UNIT = "launches/pose"


def read(run):
    if run.trace is None or not run.records or run.trace.kernels == 0:
        return None
    return run.trace.kernels / len(run.records)
