"""The exact ("fast") vote engine: model tables and the fallback engine.

Port of ``objective_slam_tpu.ops.voting_fast`` (voting_fast.py:53-387).
``build_fast_tables`` makes the block-expansion tables of the main path
(ops/voting_block.py) when the model fits their budgets, and always the
one-lookup tables of the fallback engine ``cast_votes_fast``, which serves
the models over those budgets (more than 4096 occupied keys, or 1024 model
points and more). Its tally is kernel K2 (ops/fast_tally.py).

Given the same ``vote_cap`` and ``chunk``, ``cast_votes_fast`` returns the
same accumulator, ``num_votes`` and ``overflowed`` as the JAX engine:

  scene keys ──one lookup──> (offset, count, α_s) per scene pair
  row-aligned padding: each reference row's votes padded to a chunk
  ──> per-vote expansion + tally (kernel K2) ──> (R, n_model, 32) int32

Kernel K2 walks the scene pairs and expands each one's votes itself. Its
plain version (``expand_fast``, the route of ``use_mxu_tally=False`` and
of the CPU) writes the per-vote arrays: segment fills (scatter ± at
segment heads and tails, then a scan) and one pair-table lookup per vote
give each slot (m, α bin) in integer fixed point.

Two TPU layouts are not ported. ``PackedTable``/``packed_lookup``
(voting_fast.py:108-156) copy each table 128 times, rotated, so that the
TPU's sublane gather serves any lane; a GPU gathers from a flat table
directly, so the tables here are flat 1-D tensors, padded like the JAX
package's to a multiple of 128 with the same fill. ``dict_digits_matmul``
(:73-105) is a bf16 matrix-unit form of a dictionary lookup that this
engine does not use.

The uint32 tables are carried as int32 bits; every decode masks after the
shift. The segment fills run in int64, so the JAX package's int32
wraparound argument (:307-313) is not needed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import fast_tally as k2
from objective_slam_tpu_torch.ops import ppf as ppf_ops
from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops import voting_block

LANES = 128
# Votes per tally chunk; each reference row's votes are padded to a chunk
# multiple, so buffer sizing adds TALLY_CHUNK per reference row.
TALLY_CHUNK = 8192

# uint32 packing layouts.
CNT_BITS = 12                      # bucket count field (counts < 4096)
OFF_BITS = 32 - CNT_BITS           # pair-array offset field
ALPHA_BITS = 22                    # fixed-point α_m field
M_BITS = 32 - ALPHA_BITS           # model point index field (n_m <= 1024)
_ALPHA_SCALE = (1 << ALPHA_BITS) / (2.0 * math.pi)
_ALPHA_MAX = (1 << ALPHA_BITS) - 1


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FastModelTables(NamedTuple):
    """Model-side tables of engine="fast", flat 1-D on the key table's
    device. The packed one-lookup variants are used when the model fits
    their bit budgets, else the unpacked two-lookup ones; unused fields
    are None.

    cnt_off     int32 bits of uint32 (offset << CNT_BITS | count), per key
    pair_packed int32 bits of uint32 (m << ALPHA_BITS | α_m fixed point)
    counts, offsets  int32 per key (unpacked)
    pair_mr int32, pair_alpha float32 per model pair (unpacked)
    block       the block-expansion tables, None over their budgets
    """
    cnt_off: torch.Tensor | None
    pair_packed: torch.Tensor | None
    counts: torch.Tensor | None
    offsets: torch.Tensor | None
    pair_mr: torch.Tensor | None
    pair_alpha: torch.Tensor | None
    block: voting_block.BlockTables | None = None


def _flat(x: np.ndarray, device, fill=0) -> torch.Tensor:
    """x padded to a multiple of 128 with `fill` — the unrotated layout of
    the JAX package's pack_table (voting_fast.py:123-134)."""
    n = x.shape[0]
    padded = np.concatenate([x, np.full((_ceil_to(n, LANES) - n,), fill,
                                        x.dtype)])
    if padded.dtype == np.uint32:
        padded = padded.view(np.int32)
    return torch.from_numpy(padded).to(device)


def build_fast_tables(table: voting_ref.KeyTable,
                      max_bytes_per_table: int = 512 * 1024 * 1024,
                      force_unpacked: bool = False) -> FastModelTables:
    """Host build from the key table, with the JAX package's packing
    decisions (voting_fast.py:175-232). force_unpacked takes the two-lookup
    tables and no block tables, so that the fallback paths stay testable.
    max_bytes_per_table bounded the TPU layout's rotated copies; a flat
    table has none, and the argument is kept for the same signature."""
    del max_bytes_per_table
    device = table.counts.device
    counts = table.counts.cpu().numpy()
    offsets = table.offsets.cpu().numpy()
    pair_mr = table.pair_mr.cpu().numpy()
    pair_alpha = table.pair_alpha.cpu().numpy()
    p = pair_mr.shape[0]

    can_pack_ko = (not force_unpacked and
                   counts.max(initial=0) < (1 << CNT_BITS) and
                   p < (1 << OFF_BITS))
    n_m = int(pair_mr.max(initial=0)) + 1
    can_pack_pair = (not force_unpacked) and n_m <= (1 << M_BITS)

    t = dict(cnt_off=None, pair_packed=None, counts=None, offsets=None,
             pair_mr=None, pair_alpha=None)
    if can_pack_ko:
        t["cnt_off"] = _flat((offsets.astype(np.uint32) << CNT_BITS)
                             | counts.astype(np.uint32), device)
    else:
        t["counts"] = _flat(counts, device)
        t["offsets"] = _flat(offsets, device)
    if can_pack_pair:
        # α_m to fixed point on the host in float64, as the JAX package.
        a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + math.pi)
                                 * _ALPHA_SCALE),
                        0, _ALPHA_MAX).astype(np.uint32)
        t["pair_packed"] = _flat((pair_mr.astype(np.uint32) << ALPHA_BITS)
                                 | a_fix, device)
    else:
        t["pair_mr"] = _flat(pair_mr, device)
        t["pair_alpha"] = _flat(pair_alpha, device, fill=0.0)
    block = None if force_unpacked else voting_block.build_block_tables(table)
    return FastModelTables(block=block, **t)


def _gather(flat, idx):
    return flat[idx.to(torch.int64)]


class PairLookup(NamedTuple):
    """Per-scene-pair part of the fallback engine, the fused tally's inputs.

    cnt, off, alpha_fix (S,) int32: votes, pair-array offset of the key's
    bucket, α_s as 22-bit fixed point; row_tot (R,) int32 votes per
    reference row; row_start_p (R,) int32 chunk-aligned first slot of each
    row; total_p () int32 padded vote count; total () int32 votes;
    overflow () bool."""
    cnt: torch.Tensor
    off: torch.Tensor
    alpha_fix: torch.Tensor
    row_tot: torch.Tensor
    row_start_p: torch.Tensor
    total_p: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor


def _pair_lookup(scene_keys, scene_alpha, tables: FastModelTables,
                 vote_cap: int, chunk: int = TALLY_CHUNK) -> PairLookup:
    """One table lookup per scene pair, the row-aligned padding and α_s in
    fixed point (voting_fast.py:255-294, 315-318): everything of
    cast_votes_fast that is sized by scene pairs, not by votes."""
    R, n = scene_keys.shape
    dev = scene_keys.device
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)
    valid = flat_keys != ppf_ops.INVALID_KEY
    safe_keys = torch.where(valid, flat_keys, 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    if tables.cnt_off is not None:
        co = _gather(tables.cnt_off, safe_keys)
        cnt_q = co & ((1 << CNT_BITS) - 1)
        off = (co >> CNT_BITS) & ((1 << OFF_BITS) - 1)
    else:
        cnt_q = _gather(tables.counts, safe_keys)
        off = _gather(tables.offsets, safe_keys)
    cnt = torch.where(valid, cnt_q, zero)

    # Row-aligned padding so that every tally chunk maps to one row.
    row_tot = torch.sum(cnt.reshape(R, n), dim=1, dtype=torch.int32)
    row_tot_p = row_tot + (-row_tot) % chunk
    row_start_p = voting_ref._exclusive_cumsum(row_tot_p)
    row_cum = voting_ref._exclusive_cumsum(row_tot)
    total_p = row_start_p[-1] + row_tot_p[-1]
    total = row_cum[-1] + row_tot[-1]

    # α_s as 22-bit fixed point (float32 arithmetic, as the JAX package).
    alpha_fix = torch.round((flat_alpha + f32(math.pi))
                            * f32(_ALPHA_SCALE)).to(torch.int32)
    alpha_fix = torch.clamp(alpha_fix, 0, _ALPHA_MAX)
    return PairLookup(cnt=cnt, off=off, alpha_fix=alpha_fix, row_tot=row_tot,
                      row_start_p=row_start_p, total_p=total_p, total=total,
                      overflow=total_p > vote_cap)


class FastVotes(NamedTuple):
    """Per-vote arrays of the fallback engine's plain route, the chunked
    tally's inputs.

    m_r, a_bin (vote_cap,) int32; vote_ok (vote_cap,) bool; row_start_p
    (R,) int32 chunk-aligned first slot of each reference row; total_p ()
    int32 padded vote count; total () int32 votes; overflow () bool;
    heads (S,) int32 first slot of each scene pair's segment
    (non-decreasing; an empty pair's is the next pair's); r_of_s (S,) int32
    reference row of each scene pair."""
    m_r: torch.Tensor
    a_bin: torch.Tensor
    vote_ok: torch.Tensor
    row_start_p: torch.Tensor
    total_p: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor
    heads: torch.Tensor
    r_of_s: torch.Tensor


def expand_fast(scene_keys, scene_alpha, tables: FastModelTables,
                d_angle: float, vote_cap: int,
                chunk: int = TALLY_CHUNK) -> FastVotes:
    """Lookup, row-aligned padding, segment fills and the per-vote pair
    lookup of cast_votes_fast (voting_fast.py:255-361): ``_pair_lookup``
    then ``fast_tally.expand_slots``. The plain route only; the kernel
    route never writes these arrays. vote_cap must already be rounded to a
    multiple of max(128, chunk)."""
    n = scene_keys.shape[1]
    pl = _pair_lookup(scene_keys, scene_alpha, tables, vote_cap, chunk)
    n_angle = int(round(2.0 * math.pi / d_angle))
    m_r, a_bin, vote_ok, heads, r_of_s = k2.expand_slots(
        pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p, pl.row_tot, pl.total_p,
        tables, n, vote_cap, n_angle)
    return FastVotes(m_r=m_r, a_bin=a_bin, vote_ok=vote_ok,
                     row_start_p=pl.row_start_p, total_p=pl.total_p,
                     total=pl.total, overflow=pl.overflow, heads=heads,
                     r_of_s=r_of_s)


def cast_votes_fast(scene_keys, scene_alpha, tables: FastModelTables,
                    n_model: int, d_angle: float, vote_cap: int,
                    chunk: int = TALLY_CHUNK, use_mxu_tally: bool = True
                    ) -> voting_ref.VoteResult:
    """Generate and tally votes (voting_fast.py:239-387).

    scene_keys (R, n) int32 packed PPF keys (INVALID_KEY masked),
    scene_alpha (R, n) float32. vote_cap is rounded up to a multiple of
    max(128, chunk); row padding takes up to `chunk` slots per reference
    row, so size it as votes + chunk·R (drost.match does). Votes past the
    capacity are dropped and set `overflowed`.

    use_mxu_tally (the name is the JAX package's) picks the chunked tally,
    kernel K2; False tallies with a scatter over a per-vote row fill."""
    vote_cap = _ceil_to(vote_cap, max(LANES, chunk))
    R, n = scene_keys.shape
    A = voting_ref.ALPHA_PAD
    if use_mxu_tally:
        # Kernel K2 on the per-pair arrays: no per-vote array is made.
        pl = _pair_lookup(scene_keys, scene_alpha, tables, vote_cap, chunk)
        acc = k2.fast_tally(pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p,
                            pl.row_tot, tables, n, vote_cap, n_model,
                            int(round(2.0 * math.pi / d_angle)))
        return voting_ref.VoteResult(accumulator=acc, num_votes=pl.total,
                                     overflowed=pl.overflow)
    fv = expand_fast(scene_keys, scene_alpha, tables, d_angle, vote_cap,
                     chunk)
    r_fill = k2.fill_last(vote_cap, fv.heads, fv.r_of_s)
    cells = R * n_model * A
    target = torch.where(
        fv.vote_ok,
        (r_fill.to(torch.int64) * n_model + fv.m_r) * A + fv.a_bin,
        cells)
    acc = torch.bincount(target, minlength=cells + 1)[:cells] \
        .to(torch.int32).reshape(R, n_model, A)
    return voting_ref.VoteResult(accumulator=acc, num_votes=fv.total,
                                 overflowed=fv.overflow)
