"""The work of a surface extraction from a TSDF volume, counted from the
volume and the extraction's capacity, and its least time on the card: the
yardstick of `kinfu.extract_roofline`.

An extraction must read the tsdf and the weight of every voxel once (8 B
a voxel: which voxels lie near the surface is not known before) and write
its rows: a point and a normal (float32 × 3 each) and a validity byte a
row, 25 B. The capacity is the program's own counter of the request
(`kinds/kinfu_recognize.Outcome.capacity`, from
``StreamingRecognizer.last_recognition``). The normals' neighbourhood sums,
the sort and the host copy are work of one implementation and are not
counted, so no extraction that reads the volume can beat the yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.metrics import kernel_work, program_spans

SPAN = "tsdf.extract"
ROW_BYTES = 25


class Work(NamedTuple):
    voxels: int       # voxels of the volume
    rows: int         # the extraction's capacity


def extract_bytes(w: Work) -> int:
    return 8 * w.voxels + ROW_BYTES * w.rows


def bound_s(w: Work) -> float:
    """Least seconds the extraction can take on the card."""
    return extract_bytes(w) / kernel_work.PEAK_BYTES_PER_S


def extract_roofline_pct(run):
    """Σ bound over Σ device busy time inside the program's `tsdf.extract`
    spans of completed requests that report their capacity, in %; None
    where there is none. Each span ends with the surface's copy to the
    host, which waits for the extraction, so its device work runs inside
    it."""
    t = program_spans.table(run)
    if t is None:
        return None
    busy = program_spans._busy_before(run.trace._intervals)
    out = {r.n: r.outcome for r in run.records}
    need = took = 0.0
    for s in t.stages:
        o = out.get(s.request)
        if s.name != SPAN or getattr(o, "capacity", None) is None:
            continue
        need += bound_s(Work(o.voxels, o.capacity))
        took += (busy(s.end) - busy(s.start)) / 1e9
    if took <= 0:
        return None
    return 100.0 * need / took


def idle_pct(run, name: str):
    """The device's idle share, in %, inside the program's spans `name`
    of completed requests; None where there is none, or where the trace
    holds no device work at all (no device traced)."""
    t = program_spans.table(run)
    if t is None or run.trace.busy_s <= 0:
        return None
    busy = program_spans._busy_before(run.trace._intervals)
    wall = held = 0
    for s in t.stages:
        if s.name == name:
            wall += s.end - s.start
            held += busy(s.end) - busy(s.start)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - held / wall)
