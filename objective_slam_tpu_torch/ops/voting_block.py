"""Block-expansion exact voting — the main-path engine.

Port of ``objective_slam_tpu.ops.voting_block`` (voting_block.py:59-631).
The pipeline and its capacity contract are the JAX package's:

  scene keys ──dictionary match──> (vote count, bucket start row) per pair
  per-segment row allocation + two per-row cumsum-of-diffs fills
  pair rows ──ONE row gather──> pp (row_cap, 128) words m << 22 | α_m_fix
  tally (kernel K1, ops/block_tally.py) ──> (R, n_model, 32) int32

so that given the same `vote_cap`/`seg_cap` the port returns the same
accumulator, `num_votes` and `overflowed` as the JAX engine. The TPU-shaped
steps are replaced by their plain GPU forms where the outputs stay equal:
the one-hot dictionary matmul by a binary search over the sorted occupied
keys, the sort-based compaction by a scan + scatter.

The pair table is uint32 in the JAX package; torch carries the same bits
as int32, so every decode masks after shifting (``(w >> 22) & 0x3FF`` is
the logical shift of the uint32 word).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import block_tally as k1
from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops.block_tally import ALPHA_BITS, LANES, \
    M_BITS

CHUNK_ROWS = 64                 # row-alignment unit per reference row
_ALPHA_SCALE = (1 << ALPHA_BITS) / (2.0 * math.pi)
BLOCK_MAX_KOCC = 4096           # occupied-key budget of the block engine


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BlockTables:
    """Bucket-padded model tables (voting_block.py:100-128).

    occ_keys (K_pad,) int32    occupied packed keys ascending, pad = -2
    occ_vals (K_pad, 2) float32 [bucket vote count, bucket start row]
    pair2d   (n_rows + 1, 128) int32 bits of m << 22 | α_m fixed point;
             each bucket padded to whole rows with the sentinel
             0xFFFFFFFF (m decodes to 1023), plus one
             all-sentinel row n_rows that padding vote rows point at.
    """
    occ_keys: torch.Tensor
    occ_vals: torch.Tensor
    pair2d: torch.Tensor
    k_occ: int
    n_rows: int


def build_block_tables(table: voting_ref.KeyTable,
                       max_kocc: int = BLOCK_MAX_KOCC) -> BlockTables | None:
    """Host numpy build from the key table (voting_block.py:131-176), on
    the table's device; None when the model does not fit the packing
    budgets."""
    device = table.counts.device
    counts = table.counts.cpu().numpy()
    offsets = table.offsets.cpu().numpy()
    pair_mr = table.pair_mr.cpu().numpy()
    pair_alpha = table.pair_alpha.cpu().numpy()

    occ = np.nonzero(counts)[0]
    k_occ = len(occ)
    n_m = int(pair_mr.max(initial=0)) + 1
    # Strict bound reserves m = 2^M_BITS − 1 for the pad-slot sentinel.
    if k_occ == 0 or k_occ > max_kocc or n_m >= (1 << M_BITS):
        return None

    occ_cnt = counts[occ].astype(np.int64)
    occ_rows = (occ_cnt + LANES - 1) // LANES
    row_start = np.concatenate([[0], np.cumsum(occ_rows)[:-1]])
    n_rows = int(occ_rows.sum())

    a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + math.pi)
                             * _ALPHA_SCALE), 0,
                    (1 << ALPHA_BITS) - 1).astype(np.uint32)
    packed = (pair_mr.astype(np.uint32) << ALPHA_BITS) | a_fix

    pair2d = np.full((n_rows + 1, LANES), 0xFFFFFFFF, np.uint32)
    flat = pair2d.reshape(-1)
    for i, k in enumerate(occ):
        s = row_start[i] * LANES
        flat[s:s + occ_cnt[i]] = packed[offsets[k]:offsets[k] + occ_cnt[i]]

    K_pad = _ceil_to(max(k_occ, 1), LANES)
    occ_keys = np.full((K_pad,), -2, np.int32)
    occ_keys[:k_occ] = occ.astype(np.int32)
    occ_vals = np.zeros((K_pad, 2), np.float32)
    occ_vals[:k_occ, 0] = occ_cnt
    occ_vals[:k_occ, 1] = row_start

    return BlockTables(
        occ_keys=torch.from_numpy(occ_keys).to(device),
        occ_vals=torch.from_numpy(occ_vals).to(device),
        pair2d=torch.from_numpy(pair2d.view(np.int32)).to(device),
        k_occ=k_occ, n_rows=n_rows)


def _dict_match(flat_keys, tables: BlockTables):
    """(vote count, bucket start row) per scene pair, 0 where the key is
    not occupied (voting_block.py:200-246).

    A binary search over the ascending occupied keys replaces the TPU's
    one-hot dictionary matmul; INVALID_KEY and the -2 pad match nothing."""
    occ = tables.occ_keys[:tables.k_occ]
    pos = torch.searchsorted(occ, flat_keys).clamp_(max=tables.k_occ - 1)
    hit = occ[pos] == flat_keys
    vals = tables.occ_vals[pos].to(torch.int32)               # (S, 2)
    zero = torch.zeros((), dtype=torch.int32, device=flat_keys.device)
    return (torch.where(hit, vals[:, 0], zero),
            torch.where(hit, vals[:, 1], zero))


def rows_for_counts(cnt):
    """Vote rows a segment of cnt votes occupies (ceil(cnt / 128))."""
    return (cnt + LANES - 1) // LANES


def cast_votes_block(scene_keys, scene_alpha, tables: BlockTables,
                     n_model: int, d_angle: float, vote_cap: int,
                     chunk_rows: int = CHUNK_ROWS,
                     seg_cap: int | None = None) -> voting_ref.VoteResult:
    """Generate and tally votes (voting_block.py:254-287).

    vote_cap is in SLOTS (rows = vote_cap // 128) and must cover the
    row-padded votes plus up to one chunk of padding per reference row;
    seg_cap bounds the number of nonzero scene-pair segments (None: the
    row capacity). Exceeding either sets `overflowed`."""
    pp, alpha_row, row_start_p, total, overflow, total_rows_p = _expand(
        scene_keys, scene_alpha, tables, vote_cap, chunk_rows, seg_cap)
    n_angle = int(round(2.0 * math.pi / d_angle))
    acc = _tally(pp, alpha_row, row_start_p, total_rows_p, n_model, n_angle)
    return voting_ref.VoteResult(accumulator=acc, num_votes=total,
                                 overflowed=overflow)


def _tally(pp, alpha_row, row_start_p, total_rows_p, n_model, n_angle):
    """Kernel K1: the TPU's Pallas tally (voting_block.py:478-631) is
    ``block_tally.block_tally`` — a hand-written CUDA kernel for a CUDA
    tensor, its plain torch version for a CPU tensor."""
    return k1.block_tally(pp, alpha_row, row_start_p, total_rows_p, n_model,
                          n_angle)


# Spare slots behind a drop-mode scatter's output. Where most indices are
# dropped (the fallback engine's empty scene pairs), one spare slot would
# take all their atomics on one address, one after another on the card.
_SPARE = 4096


def _scatter_add_drop(size, idx, vals, dtype=torch.int32):
    """zeros(size).at[idx].add(vals, mode="drop"): indices outside
    [0, size) go to spare slots that are sliced off."""
    out = torch.zeros(size + _SPARE, dtype=dtype, device=idx.device)
    spare = size + torch.arange(idx.shape[0], device=idx.device) % _SPARE
    idx = torch.where((idx >= 0) & (idx < size), idx.to(torch.int64), spare)
    out.index_add_(0, idx, vals.to(dtype))
    return out[:size]


def _expand(scene_keys, scene_alpha, tables: BlockTables, vote_cap: int,
            chunk_rows: int, seg_cap: int | None = None):
    """Dictionary match + row allocation + per-row fills + the row gather
    (voting_block.py:290-424).

    Returns (pp, alpha_row, row_start_p, total, overflow, total_rows_p):
    pp (row_cap, 128) int32 words, alpha_row (row_cap,) int32 α_s fixed
    point per vote row, row_start_p (R,) int32 chunk-aligned first vote row
    of each reference row, total_rows_p () int32 live vote rows."""
    dev = scene_keys.device
    row_cap = _ceil_to(max(vote_cap // LANES, chunk_rows), chunk_rows)
    R, n = scene_keys.shape
    S = R * n
    if seg_cap is None:
        seg_cap = row_cap
    seg_cap = min(_ceil_to(max(seg_cap, LANES), LANES), S)
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    def shift1(x, first):
        return torch.cat([i32([first]), x[:-1]])

    cnt, brs = _dict_match(flat_keys, tables)
    crows = rows_for_counts(cnt)

    # Row-aligned padding so that every chunk maps to one reference row.
    row_tot = torch.sum(crows.reshape(R, n), dim=1, dtype=torch.int32)
    row_tot_p = row_tot + (-row_tot) % chunk_rows
    row_start_p = voting_ref._exclusive_cumsum(row_tot_p)
    row_cum = voting_ref._exclusive_cumsum(row_tot)
    heads = voting_ref._exclusive_cumsum(crows) + \
        (row_start_p - row_cum)[:, None].expand(R, n).reshape(-1)
    total_rows_p = row_start_p[-1] + row_tot_p[-1]
    overflow = total_rows_p > row_cap

    total = voting_ref.saturating_total(
        torch.sum(cnt.reshape(R, n), dim=1, dtype=torch.int32))

    alpha_fix = torch.round((flat_alpha + f32(math.pi))
                            * f32(_ALPHA_SCALE)).to(torch.int32)
    alpha_fix = torch.clamp(alpha_fix, 0, (1 << ALPHA_BITS) - 1)

    # Stream-compact the nonzero segments in scene-pair order: the first
    # seg_cap of them are kept (as the JAX sort-based compaction keeps).
    nz = crows > 0
    n_seg = torch.sum(nz, dtype=torch.int32)
    seg_overflow = n_seg > seg_cap
    pos = torch.cumsum(nz, dim=0, dtype=torch.int32) - 1
    dest = torch.where(nz & (pos < seg_cap), pos, i32(seg_cap))
    gidx = torch.zeros(seg_cap + 1, dtype=torch.int64, device=dev)
    gidx.scatter_(0, dest.to(torch.int64), torch.arange(S, device=dev))
    seg_ok = torch.arange(seg_cap, device=dev) < n_seg
    gidx = torch.where(seg_ok, gidx[:seg_cap], 0)
    payload = torch.stack([cnt, brs, alpha_fix, heads], dim=1)    # (S, 4)
    compact = torch.where(seg_ok[:, None], payload[gidx], 0)
    c_cnt, c_brs, c_alpha, c_heads = compact.unbind(1)
    c_tail = c_heads + rows_for_counts(c_cnt)
    c_row = (gidx // n).to(torch.int32)

    # Two per-row transports (pair-table source row via u, α_s), each a
    # cumsum of diffs with the tail of segment j−1 folded into the head
    # of segment j (voting_block.py:365-407). u ≥ 1 inside segments and
    # the fill is 0 on padding rows.
    offset = row_cap + 1
    u = c_brs - c_heads + offset
    contig = (shift1(c_tail, -1) == c_heads) & (shift1(c_row, -1) == c_row)
    head_idx = torch.where(seg_ok, c_heads, i32(row_cap))
    du = torch.where(contig, u - shift1(u, 0), u)
    da = torch.where(contig, c_alpha - shift1(c_alpha, 0), c_alpha)

    # Per-reference-row corrections: the fill returns to 0 where the row's
    # padding starts.
    segs_per_row = torch.sum(nz.reshape(R, n), dim=1, dtype=torch.int32)
    last_seg = torch.clamp(torch.cumsum(segs_per_row, 0, dtype=torch.int32)
                           - 1, 0, seg_cap - 1).to(torch.int64)
    has_seg = segs_per_row > 0
    u_last = torch.where(has_seg, u[last_seg], 0)
    a_last = torch.where(has_seg, c_alpha[last_seg], 0)
    row_end = torch.where(has_seg, row_start_p + row_tot, i32(row_cap))

    idx = torch.cat([head_idx, row_end])
    d_u = _scatter_add_drop(row_cap, idx,
                            torch.cat([torch.where(seg_ok, du, 0), -u_last]))
    d_a = _scatter_add_drop(row_cap, idx,
                            torch.cat([torch.where(seg_ok, da, 0), -a_last]))
    fill_u = torch.cumsum(d_u, 0, dtype=torch.int32)
    alpha_row = torch.cumsum(d_a, 0, dtype=torch.int32)

    t_iota = torch.arange(row_cap, dtype=torch.int32, device=dev)
    src_row = torch.where(
        fill_u > 0,
        torch.clamp(fill_u - offset + t_iota, 0, tables.n_rows),
        i32(tables.n_rows))

    # THE gather: one 128-word row per vote row.
    pp = tables.pair2d[src_row.to(torch.int64)]              # (row_cap, 128)
    return (pp, alpha_row, row_start_p, total, overflow | seg_overflow,
            total_rows_p)
