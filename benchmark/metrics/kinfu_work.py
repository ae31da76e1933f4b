"""The work of a KinectFusion frame's voxel update, counted from the frame
itself, and its least time on the card: the yardstick of
`kinfu.integrate_roofline`.

A frame's update must read and write the tsdf and the weight of each voxel
it updates (16 B: two float32 read, two written) and read the depth image
once. The plain reference counts the updated voxels of each frame of its
own replay (`kinds/kinfu_track.Reference.work`), so the yardstick is the
same whatever implements the update: a dense pass over the whole volume,
as the program makes, moves more than this and cannot beat it.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.metrics import kernel_work, program_spans

SPAN = "tsdf.integrate"


class Work(NamedTuple):
    updated_voxels: int    # voxels the frame updates (reference's count)
    depth_pixels: int      # pixels of the depth image


def update_bytes(w: Work) -> int:
    return 16 * w.updated_voxels + 4 * w.depth_pixels


def bound_s(w: Work) -> float:
    """Least seconds the update can take on the card."""
    return update_bytes(w) / kernel_work.PEAK_BYTES_PER_S


def integrate_roofline_pct(run):
    """Σ bound over Σ device busy time inside the program's `tsdf.integrate`
    spans, in %; None where no such span fell in a completed request. Each
    span ends at a host read that waits for its update, so its device work
    runs inside it."""
    t = program_spans.table(run)
    if t is None:
        return None
    busy = program_spans._busy_before(run.trace._intervals)
    req = {r.n: r.req for r in run.records}
    need = took = 0.0
    for s in t.stages:
        if s.name != SPAN or s.request not in req:
            continue
        need += bound_s(run.work(req[s.request]))
        took += (busy(s.end) - busy(s.start)) / 1e9
    if took <= 0:
        return None
    return 100.0 * need / took
