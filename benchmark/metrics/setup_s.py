"""setup_s: seconds from the process's start to the first timed request:
imports, kernel load, inputs, descriptions and the warm-up (host clock)."""

UNIT = "s"


def read(run):
    return run.setup_s
