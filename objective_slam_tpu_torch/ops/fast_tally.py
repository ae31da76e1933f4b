"""Kernel K2 — the fallback engine's tally with its per-vote expansion
fused in — its wrapper and its plain torch version.

Replaces the TPU kernel ``objective_slam_tpu.ops.voting_fast._pallas_tally``
(Pallas body at voting_fast.py:450-464, pallas_call at :466) and the XLA
combine after it (:478-487), together with the per-vote expansion before
it (segment fills and the per-vote pair lookup, :296-355). The CUDA source
is ``csrc/fast_tally.cu``; its header note gives the design and what
bounds it on the card.

The plain version is the per-slot route: ``expand_slots`` writes the
per-vote arrays (m_r, a_bin, vote_ok) over the whole vote buffer, and
``fast_tally_plain`` tallies them by chunk. ``fast_tally`` launches the
kernel, which walks the scene pairs and writes no per-vote array, for CUDA
tensors and runs the plain version for others (``_build.uses_kernel``); it
never falls back from one to the other. The module integer ``launches``
counts kernel launches (only launches: the plain version does not count).
"""

from __future__ import annotations

import ctypes
import math

import torch

from objective_slam_tpu_torch._common import f32, scatter_add_drop
from objective_slam_tpu_torch.ops import _build
from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops.block_tally import ALPHA_BITS, M_BITS, \
    MAX_CLUSTER, chunk_row_map
from objective_slam_tpu_torch.ops.voting import ALPHA_PAD

# Widest model whose (n_model, 32) int32 histogram fits one block's shared
# memory beside the kernel's 12 KB of tile arrays (227 KB in all); wider
# models take the kernel's global-atomic path.
SMEM_MAX_MODEL = 1712
_ALPHA_SCALE = (1 << ALPHA_BITS) / (2.0 * math.pi)
_ALPHA_MAX = (1 << ALPHA_BITS) - 1
_VOTES_PER_BLOCK = 32768        # vote slots a cluster block aims to take
# The launcher's arguments before the stream (csrc/fast_tally.cu).
_ARGTYPES = (*[ctypes.c_void_p] * 8, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)

launches = 0


def fill_last(size, idx, vals):
    """out[v] = vals[s] of the last s with idx[s] <= v, for non-decreasing
    idx (0 before idx[0]; indices at or past size, a suffix, drop out).

    The differences vals[s] - vals[s-1] are scattered at idx[s] and
    scanned, so the sum telescopes to the last value; torch's cummax, the
    JAX package's tool here, is a slow scan on the card. Inside a vote
    segment this gives what the JAX package's scatter-max + cummax over
    the segment heads gives (the segment's own pair is the last one that
    starts at or before the slot); the two differ only on padding slots,
    where vote_ok is false."""
    diff = vals - torch.cat([vals.new_zeros(1), vals[:-1]])
    d = scatter_add_drop(size, idx, diff)
    return torch.cumsum(d, dim=0, dtype=torch.int32)


def expand_slots(cnt, off, alpha_fix, row_start_p, row_tot, total_p, tables,
                 n: int, vote_cap: int, n_angle: int):
    """The per-vote arrays of the fallback engine (voting_fast.py:296-355):
    segment fills over the vote buffer, then one pair-table lookup per slot.

    cnt, off, alpha_fix (R·n,) int32 per scene pair; row_start_p, row_tot
    (R,) int32; total_p () int32 padded vote count; tables the
    FastModelTables (pair_packed, or pair_mr and pair_alpha). Returns
    (m_r, a_bin, vote_ok, heads, r_of_s): (vote_cap,) int32, int32, bool;
    heads (S,) int32 first slot of each scene pair's segment
    (non-decreasing; an empty pair's is the next pair's); r_of_s (S,) int32
    reference row of each scene pair."""
    dev = cnt.device
    S = cnt.shape[0]
    row_cum = voting_ref._exclusive_cumsum(row_tot)
    voffs = voting_ref._exclusive_cumsum(cnt)
    r_of_s = torch.arange(S, dtype=torch.int32, device=dev) // n
    heads = voffs + (row_start_p - row_cum).repeat_interleave(n)
    del voffs

    nz = cnt > 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    cap = torch.full((), vote_cap, dtype=torch.int32, device=dev)
    head_idx = torch.where(nz, heads, cap)
    tail_idx = torch.where(nz, heads + cnt, cap)

    # Segment start of each slot (the JAX package's scatter-max + cummax;
    # see fill_last).
    start = fill_last(vote_cap, heads, heads)

    def seg_fill(vals, dtype):
        """Each segment's value on its votes, 0 elsewhere: + at the head,
        − at the tail, then a scan. Segments never overlap, so the value
        rides exactly."""
        d = scatter_add_drop(vote_cap, head_idx, vals, dtype)
        d += scatter_add_drop(vote_cap, tail_idx, -vals.to(dtype), dtype)
        return torch.cumsum(d, dim=0, dtype=dtype)

    # (offset, count) ride one int64 fill, 32 bits each.
    oc_v = seg_fill(torch.where(nz, (off.to(torch.int64) << 32)
                                | cnt.to(torch.int64), 0), torch.int64)
    off_v = (oc_v >> 32).to(torch.int32)
    cnt_v = (oc_v & 0xFFFFFFFF).to(torch.int32)
    del oc_v
    alpha_v = seg_fill(torch.where(nz, alpha_fix, zero), torch.int32)

    v_iota = torch.arange(vote_cap, dtype=torch.int32, device=dev)
    j = v_iota - start
    vote_ok = (j >= 0) & (j < cnt_v) & (v_iota < total_p)
    del start, cnt_v, v_iota

    # THE per-vote lookup; slots are clipped to the padded table, whose pad
    # entries are 0, as the JAX package's padded lookup reads them.
    packed = tables.pair_packed
    table_len = (packed if packed is not None else tables.pair_mr).shape[0]
    slot = torch.clamp(off_v + j, 0, table_len - 1).to(torch.int64)
    del off_v, j
    if packed is not None:
        pp = packed[slot]
        m_r = (pp >> ALPHA_BITS) & ((1 << M_BITS) - 1)
        am_fix = pp & _ALPHA_MAX
        del pp
    else:
        m_r = tables.pair_mr[slot]
        a_m = tables.pair_alpha[slot]
        am_fix = torch.clamp(torch.round((a_m + f32(math.pi))
                                         * f32(_ALPHA_SCALE))
                             .to(torch.int32), 0, _ALPHA_MAX)
        del a_m
    del slot

    # Integer α binning: wrap(α_s − α_m) to [0, 2π), then the bin.
    w = (alpha_v - am_fix + (1 << (ALPHA_BITS - 1))) & _ALPHA_MAX
    del alpha_v, am_fix
    a_bin = torch.clamp((w * n_angle) >> ALPHA_BITS, 0, ALPHA_PAD - 1)
    return m_r, a_bin, vote_ok, heads, r_of_s


def fast_tally_plain(m_r, a_bin, vote_ok, row_start_p, total_p,
                     n_model: int, chunk: int):
    """Plain torch tally of per-vote arrays, bit-equal to the JAX package's
    CPU twin ``_mxu_tally`` (voting_fast.py:390-430) on the arrays
    cast_votes_fast makes.

    Chunk c of `chunk` votes belongs to the last reference row r with
    row_start_p[r] // chunk <= c (``chunk_row_map``; an empty row shares
    its start with the next row, and a start at or past the buffer's end
    drops out). Votes are counted where vote_ok is set, the slot is below
    total_p (cast_votes_fast clears vote_ok there), 0 <= m_r < n_model and
    0 <= a_bin < 32."""
    vote_cap = m_r.shape[0]
    n_chunks = vote_cap // chunk
    R = row_start_p.shape[0]
    cells = R * n_model * ALPHA_PAD
    owner, start = chunk_row_map(row_start_p, R, chunk, n_chunks)
    v = torch.arange(vote_cap, device=m_r.device)
    c = v // chunk
    ok = (vote_ok & (v < total_p.reshape(()).to(torch.int64))
          & (c >= start[0]) & (m_r >= 0) & (m_r < n_model)
          & (a_bin >= 0) & (a_bin < ALPHA_PAD))
    idx = (owner[c] * n_model + m_r) * ALPHA_PAD + a_bin
    idx = torch.where(ok, idx, cells)
    acc = torch.bincount(idx, minlength=cells + 1)[:cells]
    return acc.to(torch.int32).reshape(R, n_model, ALPHA_PAD)


def fast_tally_plain_pairs(cnt, off, alpha_fix, row_start_p, row_tot, tables,
                           n: int, vote_cap: int, n_model: int,
                           n_angle: int):
    """The function K2 computes, in plain torch: ``expand_slots`` followed
    by ``fast_tally_plain``, on the arguments of ``fast_tally``.

    Every vote lies below the end of the last row's votes, which stands in
    for the padded count. Chunks of one slot make the row map exact for
    any row alignment; with chunk-aligned starts, as cast_votes_fast makes
    them, they give the same rows as the engine's chunks."""
    total_p = row_start_p[-1:] + row_tot[-1:]
    m_r, a_bin, vote_ok, _, _ = expand_slots(
        cnt, off, alpha_fix, row_start_p, row_tot, total_p, tables, n,
        vote_cap, n_angle)
    return fast_tally_plain(m_r, a_bin, vote_ok, row_start_p, total_p,
                            n_model, 1)


def cluster_size(vote_cap: int, R: int) -> int:
    """Blocks per reference row: about _VOTES_PER_BLOCK slots of the
    capacity each, 1 to MAX_CLUSTER. Host numbers only, so the host never
    waits for the device."""
    return max(1, min(MAX_CLUSTER, vote_cap // max(R, 1) // _VOTES_PER_BLOCK))


def _table_tensors(tables):
    """(pair_packed, pair_mr, pair_alpha) with the unused ones None."""
    if tables.pair_packed is not None:
        return tables.pair_packed, None, None
    return None, tables.pair_mr, tables.pair_alpha


def _check(cnt, off, alpha_fix, row_start_p, row_tot, tables, n, vote_cap,
           n_model, n_angle):
    packed, pair_mr, pair_alpha = _table_tensors(tables)
    args = [("cnt", cnt, torch.int32), ("off", off, torch.int32),
            ("alpha_fix", alpha_fix, torch.int32),
            ("row_start_p", row_start_p, torch.int32),
            ("row_tot", row_tot, torch.int32)]
    if packed is not None:
        args.append(("pair_packed", packed, torch.int32))
    else:
        if pair_mr is None or pair_alpha is None:
            raise ValueError("fast_tally: tables need pair_packed, or "
                             "pair_mr and pair_alpha")
        args += [("pair_mr", pair_mr, torch.int32),
                 ("pair_alpha", pair_alpha, torch.float32)]
    for name, t, dtype in args:
        if t.dtype != dtype:
            raise TypeError(f"fast_tally: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fast_tally: {name} must be contiguous")
        if t.dim() != 1:
            raise ValueError(f"fast_tally: {name} must be 1-D")
    R = row_start_p.shape[0]
    if R < 1 or tuple(row_tot.shape) != (R,):
        raise ValueError("fast_tally: row_start_p and row_tot must be (R,), "
                         "R >= 1")
    if n < 1 or tuple(cnt.shape) != (R * n,) or \
            tuple(off.shape) != (R * n,) or \
            tuple(alpha_fix.shape) != (R * n,):
        raise ValueError(f"fast_tally: cnt, off and alpha_fix must be shaped"
                         f" (R·n,) = ({R}·{n},)")
    table = packed if packed is not None else pair_mr
    if table.shape[0] < 1 or (packed is None and
                              pair_alpha.shape != pair_mr.shape):
        raise ValueError("fast_tally: pair tables must be non-empty and "
                         "alike")
    if not 0 <= vote_cap < 2 ** 31:
        raise ValueError(f"fast_tally: vote_cap {vote_cap} outside "
                         f"[0, 2^31)")
    if n_model < 1:
        raise ValueError("fast_tally: n_model must be positive")
    if n_angle < 1:
        raise ValueError("fast_tally: n_angle must be positive")
    if R * n_model * ALPHA_PAD >= 2 ** 31:
        raise ValueError("fast_tally: accumulator over 2^31 cells")


def fast_tally(cnt, off, alpha_fix, row_start_p, row_tot, tables, n: int,
               vote_cap: int, n_model: int, n_angle: int,
               cluster: int | None = None):
    """(R, n_model, 32) int32 tally of the fallback engine from its per-pair
    arrays.

    cnt, off, alpha_fix (R·n,) int32: votes, bucket offset and α_s fixed
    point of each scene pair (``voting_fast._pair_lookup``); row_start_p
    (R,) int32 chunk-aligned first slot of each reference row; row_tot (R,)
    int32 votes of each row; tables the FastModelTables (pair_packed, or
    pair_mr and pair_alpha); vote_cap the rounded capacity: a vote at slot
    vote_cap or later is dropped; every tensor on one device. CUDA tensors
    launch the kernel on the current stream with `cluster` blocks
    per reference row (default ``cluster_size(vote_cap, R)``): its
    shared-memory histogram up to SMEM_MAX_MODEL points, its global-atomic
    path above. Others take the plain version."""
    global launches
    packed, pair_mr, pair_alpha = _table_tensors(tables)
    for name, t in (("off", off), ("alpha_fix", alpha_fix),
                    ("row_start_p", row_start_p), ("row_tot", row_tot),
                    ("pair_packed", packed), ("pair_mr", pair_mr),
                    ("pair_alpha", pair_alpha)):
        if t is not None and t.device != cnt.device:
            raise ValueError(f"fast_tally: {name} is on {t.device}, "
                             f"cnt on {cnt.device}")
    if not _build.uses_kernel(cnt.device):
        return fast_tally_plain_pairs(cnt, off, alpha_fix, row_start_p,
                                      row_tot, tables, n, vote_cap, n_model,
                                      n_angle)
    _check(cnt, off, alpha_fix, row_start_p, row_tot, tables, n, vote_cap,
           n_model, n_angle)
    R = row_start_p.shape[0]
    if cluster is None:
        cluster = cluster_size(vote_cap, R)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"fast_tally: cluster {cluster} outside "
                         f"[1, {MAX_CLUSTER}]")
    shared = n_model <= SMEM_MAX_MODEL
    # The shared-memory path writes every row; the global path adds.
    alloc = torch.empty if shared else torch.zeros
    out = alloc((R, n_model, ALPHA_PAD), dtype=torch.int32, device=cnt.device)
    table = packed if packed is not None else pair_mr
    _build.launch(
        "fast_tally", _ARGTYPES, cnt.data_ptr(), off.data_ptr(),
        alpha_fix.data_ptr(), row_start_p.data_ptr(), row_tot.data_ptr(),
        None if packed is None else packed.data_ptr(),
        None if pair_mr is None else pair_mr.data_ptr(),
        None if pair_alpha is None else pair_alpha.data_ptr(),
        table.shape[0], R, n, vote_cap, n_model, n_angle,
        float(f32(math.pi)), float(f32(_ALPHA_SCALE)), int(shared), cluster,
        out.data_ptr(), device=cnt.device,
        no_fit=f"fast_tally: no cluster of {cluster} blocks with "
               f"{n_model * ALPHA_PAD * 4 if shared else 0} B of shared "
               "memory each fits the card")
    launches += 1
    return out
