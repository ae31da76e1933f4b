"""The work of the vote pass's kernels, counted from the algorithm's own
quantities, and its least time on the card: the yardstick of the kernels'
roofline shares.

Both kernels write the dense accumulator once (R × n_model × 31 α bins of
int32), read the model's key table once (key, first pair and count of each
occupied key; reference point and α_m of each model pair), and make one
add per vote. K2 also does the expansion: it reads one word for each of
the R × n scene pairs and the α of each pair that votes. K1 tallies the
vote rows that `voting_block._expand` wrote, so what it reads of them is
left out: its count is the least any tally of these votes moves. Buffers
of one implementation (vote rows, pair tables, padding) are not counted,
so a change that fuses or drops a buffer does not move the yardstick, and
no kernel that does the counted work can beat it. The least time is the
larger of the bytes over the card's memory bandwidth and the adds over its
float32 rate.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

# One NVIDIA H100 SXM at its 700 W limit (data sheet, dense, no sparsity).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
ALPHA_BINS = 31


class Work(NamedTuple):
    ref_rows: int          # R: reference points of the scene
    scene_points: int      # n: voxelized scene points
    model_points: int
    occupied_keys: int
    model_pairs: int
    voting_pairs: int      # scene pairs whose key the model holds
    votes: int


def tally_bytes(w: Work) -> int:
    """The accumulator written once and the key table read once."""
    table = w.occupied_keys * 3 * 4 + w.model_pairs * 2 * 4
    accumulator = w.ref_rows * w.model_points * ALPHA_BINS * 4
    return table + accumulator


def expansion_bytes(w: Work) -> int:
    """One word for each scene pair, and the α of each pair that votes."""
    return w.ref_rows * w.scene_points * 4 + w.voting_pairs * 4


def bound_s(w: Work, expands: bool) -> float:
    """Least seconds the kernel can take on the card: a tally, and with
    `expands` the expansion fused into it."""
    nbytes = tally_bytes(w) + (expansion_bytes(w) if expands else 0)
    return max(nbytes / PEAK_BYTES_PER_S, w.votes / PEAK_OPS_PER_S)


def roofline_pct(run, kernel: str, launches_field: str, expands: bool):
    """Σ bound over Σ traced time of `kernel`, over the requests whose
    every launch the trace holds: the program counts a request's launches,
    and the trace's records of the kernel inside the request's span must
    number as many (the profiler may drop records in a long window, and a
    share over a subset of the records would weigh the requests
    unevenly). None where no such request launched the kernel."""
    trace = run.trace
    if trace is None:
        return None
    traced = trace.by_request(kernel)
    need = took = 0.0
    whole = partial = 0
    for r in run.records:
        launched = getattr(r.outcome, launches_field)
        if not launched:
            continue
        durations = traced.get(r.n, [])
        if len(durations) != launched:
            partial += 1
            continue
        whole += 1
        need += launched * bound_s(run.work(r.req), expands)
        took += sum(durations)
    print(f"{kernel}: {whole} requests with every launch traced, "
          f"{partial} without; bound {need:.6g} s over {took:.6g} s; "
          f"{len(trace.kernel_durations(kernel))} records in the trace of "
          f"{sum(getattr(r.outcome, launches_field) for r in run.records)}"
          f" launches counted", file=sys.stderr)
    if not whole or took <= 0:
        return None
    return 100.0 * need / took
