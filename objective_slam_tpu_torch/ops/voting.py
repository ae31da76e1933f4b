"""Hough voting: model key table, readable vote engine, top-K selection.

Port of ``objective_slam_tpu.ops.voting`` (voting.py:36-280). The readable
``cast_votes`` engine is the port's in-package reference and the
``engine="reference"`` path; the main path votes with
``voting_block.cast_votes_block``.

JAX drops out-of-range ``.at[...]`` scatter indices under ``mode="drop"``;
torch raises on them, so every such scatter here writes into one spare
slot past the end that is sliced off.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import ppf as ppf_ops

# α-bin axis padded to 32 (bins 0..30 possible; kernel.cu:341-342).
ALPHA_PAD = 32

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -2 ** 31


class KeyTable(NamedTuple):
    """Direct-addressed model description table (voting.py:39-53).

    counts     (K,) int32  model pairs per packed key
    offsets    (K,) int32  exclusive scan of counts
    pair_mr    (P,) int32  reference-point index of each pair, key-sorted
    pair_alpha (P,) float32 α_m of each pair, key-sorted
    max_count  ()   int32  largest bucket
    """
    counts: torch.Tensor
    offsets: torch.Tensor
    pair_mr: torch.Tensor
    pair_alpha: torch.Tensor
    max_count: torch.Tensor


def _exclusive_cumsum(x):
    out = torch.zeros_like(x, dtype=torch.int32)
    out[1:] = torch.cumsum(x[:-1], dim=0, dtype=torch.int32)
    return out


def build_key_table(keys, alpha, num_keys: int) -> KeyTable:
    """Sort pair indices by key, histogram and exclusive-scan
    (model.cu:69-81); INVALID_KEY pairs sort last and stay out."""
    n = keys.shape[1]
    flat_keys = keys.reshape(-1)
    capped = torch.where(flat_keys == ppf_ops.INVALID_KEY,
                         torch.full_like(flat_keys, num_keys),
                         flat_keys).to(torch.int32)
    order = torch.argsort(capped, stable=True)
    counts = torch.bincount(capped.to(torch.int64),
                            minlength=num_keys + 1)[:num_keys] \
        .to(torch.int32)
    return KeyTable(counts=counts, offsets=_exclusive_cumsum(counts),
                    pair_mr=(order // n).to(torch.int32),
                    pair_alpha=alpha.reshape(-1)[order],
                    max_count=counts.max())


def saturating_total(row_totals):
    """Grand total of per-row int32 counts as two int32 limbs, saturating
    to INT32_MAX when the float32 sum of the rows reaches 2³¹ − 2¹⁹
    (voting.py:91-109)."""
    row_totals = row_totals.to(torch.int32)
    lo = torch.sum(row_totals & 0xFFFF, dtype=torch.int32)
    hi = torch.sum(row_totals >> 16, dtype=torch.int32)
    tot_f = torch.sum(row_totals.to(torch.float32))
    sat = tot_f >= f32(2 ** 31 - 2 ** 19)
    return torch.where(sat, torch.full_like(lo, _INT32_MAX), (hi << 16) + lo)


class VoteResult(NamedTuple):
    """accumulator (n_ref, n_model, ALPHA_PAD) int32; num_votes () int32;
    overflowed () bool (votes past the static capacity were dropped)."""
    accumulator: torch.Tensor
    num_votes: torch.Tensor
    overflowed: torch.Tensor


def cast_votes(scene_keys, scene_alpha, table: KeyTable, n_model: int,
               d_angle: float, vote_cap: int) -> VoteResult:
    """Readable expansion engine (voting.py:125-191): exclusive scan of
    per-pair match counts, scatter-max + cummax decode of vote slot to
    scene pair, gathers of each vote's (ref row, model point, α bin)."""
    R, n = scene_keys.shape
    S = R * n
    dev = scene_keys.device
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)

    valid = flat_keys != ppf_ops.INVALID_KEY
    safe_keys = torch.where(valid, flat_keys, torch.zeros_like(flat_keys)) \
        .to(torch.int64)
    cnt = torch.where(valid, table.counts[safe_keys],
                      torch.zeros((), dtype=torch.int32, device=dev))
    voffs = _exclusive_cumsum(cnt)
    total = voffs[-1] + cnt[-1]
    overflow = total > vote_cap

    # Scatter each pair's index at its first vote slot (slots >= vote_cap
    # land in the spare slot), then a running max.
    scatter_idx = torch.where((cnt > 0) & (voffs < vote_cap), voffs,
                              torch.full_like(voffs, vote_cap))
    head = torch.zeros(vote_cap + 1, dtype=torch.int32, device=dev)
    head.scatter_reduce_(0, scatter_idx.to(torch.int64),
                         torch.arange(S, dtype=torch.int32, device=dev),
                         reduce="amax")
    sp = torch.cummax(head[:vote_cap], dim=0).values.to(torch.int64)

    v = torch.arange(vote_cap, dtype=torch.int32, device=dev)
    in_range = v < total
    j = v - voffs[sp]
    slot = table.offsets[safe_keys[sp]] + j
    slot = torch.clamp(slot, 0, table.pair_mr.shape[0] - 1).to(torch.int64)
    m_r = table.pair_mr[slot]
    a_m = table.pair_alpha[slot]
    a_s = flat_alpha[sp]

    # α = wrap(α_s − α_m) quantized as kernel.cu:341-342.
    two_pi = f32(2.0 * math.pi)
    alpha = a_s - a_m
    alpha = alpha - two_pi * torch.floor((alpha + f32(math.pi)) / two_pi)
    shifted = alpha + f32(math.pi)
    quant = shifted - torch.fmod(shifted, f32(d_angle))
    a_bin = torch.round(quant / f32(d_angle)).to(torch.int32)
    a_bin = torch.clamp(a_bin, 0, ALPHA_PAD - 1)

    r_idx = (sp // n).to(torch.int32)
    cells = R * n_model * ALPHA_PAD
    target = (r_idx * n_model + m_r) * ALPHA_PAD + a_bin
    target = torch.where(in_range, target, torch.full_like(target, cells))
    acc = torch.bincount(target.to(torch.int64), minlength=cells + 1)
    return VoteResult(
        accumulator=acc[:cells].to(torch.int32).reshape(R, n_model, ALPHA_PAD),
        num_votes=total, overflowed=overflow)


class TopVotes(NamedTuple):
    """Surviving votes after count thresholding (voting.py:194-211)."""
    counts: torch.Tensor
    ref_idx: torch.Tensor
    model_idx: torch.Tensor
    alpha_idx: torch.Tensor
    keep: torch.Tensor
    saturated: torch.Tensor


def _top_k(x, k):
    """lax.top_k order: descending, lower index first among equals."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def top_votes(accumulator, vote_count_threshold: float,
              max_poses: int) -> TopVotes:
    """Top-`max_poses` accumulator cells and the relative-threshold mask
    (voting.py:214-280), with the same two-level selection (block maxima,
    then cells inside the gathered blocks in gathered order) so that ties
    resolve element for element as in the JAX package."""
    R, n_model, A = accumulator.shape
    flat = accumulator.reshape(-1)
    n = flat.shape[0]
    block = 256
    blocks_above = None
    if n <= 64 * max_poses or n <= 2 * block:
        k = min(max_poses, n)
        counts, idx = _top_k(flat, k)
        if k < max_poses:
            counts = torch.nn.functional.pad(counts, (0, max_poses - k))
            idx = torch.nn.functional.pad(idx, (0, max_poses - k))
    else:
        n_pad = ((n + block - 1) // block) * block
        padded = torch.nn.functional.pad(flat, (0, n_pad - n),
                                         value=_INT32_MIN)
        blocks = padded.reshape(-1, block)
        bmax = blocks.max(dim=1).values
        n_blocks = min(max(max_poses, 64), bmax.shape[0])
        _, bidx = _top_k(bmax, n_blocks)
        cand = blocks[bidx].reshape(-1)
        counts, cidx = _top_k(cand, max_poses)
        idx = bidx[cidx // block] * block + cidx % block
        idx = torch.clamp(idx, max=n - 1)
        blocks_above = bmax
    max_count = counts[0]
    thresh = f32(vote_count_threshold) * max_count.to(torch.float32)
    keep = (counts.to(torch.float32) > thresh) & (counts > 0)
    above = (flat.to(torch.float32) > thresh) & (flat > 0)
    saturated = torch.sum(above, dtype=torch.int32) > max_poses
    if blocks_above is not None:
        b_above = (blocks_above.to(torch.float32) > thresh) & \
            (blocks_above > 0)
        saturated = saturated | \
            (torch.sum(b_above, dtype=torch.int32) > n_blocks)
    return TopVotes(counts=counts,
                    ref_idx=(idx // (A * n_model)).to(torch.int32),
                    model_idx=((idx // A) % n_model).to(torch.int32),
                    alpha_idx=(idx % A).to(torch.int32), keep=keep,
                    saturated=saturated)
