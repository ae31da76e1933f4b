"""kinfu.integrate_roofline: the frames' voxel updates against their
roofline, in % (kinfu_work): the least time of each fused frame's update
over the device busy time inside the program's `tsdf.integrate` spans."""

from benchmark.metrics import kinfu_work

UNIT = "%"


def read(run):
    return kinfu_work.integrate_roofline_pct(run)
