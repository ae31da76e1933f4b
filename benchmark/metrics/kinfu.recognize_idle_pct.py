"""kinfu.recognize_idle_pct: the device's idle share, in %, inside the
program's `tsdf.recognize` spans (surface_work.idle_pct): what the host's
part of a recognition (its round trips, the numpy downsampling, the
launches) costs the card."""

from benchmark.metrics import surface_work

UNIT = "%"


def read(run):
    return surface_work.idle_pct(run, "tsdf.recognize")
