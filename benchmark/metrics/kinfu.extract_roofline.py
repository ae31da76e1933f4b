"""kinfu.extract_roofline: the surface extractions against their roofline,
in % (surface_work): the least time of each extraction (the volume read
once, the rows written) over the device busy time inside the program's
`tsdf.extract` spans."""

from benchmark.metrics import surface_work

UNIT = "%"


def read(run):
    return surface_work.extract_roofline_pct(run)
