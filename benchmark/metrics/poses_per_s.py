"""poses_per_s: requests completed in the window over the window's
length, in poses/s (host clock)."""

UNIT = "poses/s"


def read(run):
    return len(run.records) / run.window_s
