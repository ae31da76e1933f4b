"""Correlation voting engine: matmul-only Hough voting (approximate α).

Port of ``objective_slam_tpu.ops.voting_corr`` (voting_corr.py:53-418).
The accumulator is factored through the key space:

  acc[r, m, a] = Σ_k Σ_b  S3[r, k, b] · M3[k, (b − a + n/2) mod n, m]

S3 histograms the scene pairs per (reference row, occupied model key,
coarse α_s bin) and M3 the model pairs per (key, coarse α_m bin, model
point), built once per model. The contraction is n_angle dense float32
matrix products whose cost does not depend on the vote count. The vote's
α bin comes from the coarse bins of α_s and α_m, so a vote may land one α
bin off (PARITY.md §10); the per-(row, model point) totals and
``num_votes`` are exact.

What differs from the JAX package, with the same results:

  * key -> occupied rank is one gather through ``dense_rank``; the one-hot
    dictionary matmul (voting_corr.py:187-220) is a TPU form of it.
  * S3 is a masked ``index_add_`` of ones over int64 cell ids. The JAX
    package sorts the cell ids and coalesces runs (:236-292) because TPU
    scatters are slow. Its flags are part of the result and are computed
    here from the histogram: a run is a nonzero cell, plus one run for the
    invalid pairs; ``overflowed`` is ``n_runs > runs_cap`` and, on the
    chunked path, also any row chunk with more than ``B`` runs, with the
    same ``runs_cap`` clamp, ``Rc``, ``chunks`` and ``B``. So the same
    inputs and ``runs_cap`` give the same ``overflowed``, and the retry
    ladder in ``drost._match_sized_caps`` takes the same steps. Nothing is
    truncated here when the flag is set; where it is clear the accumulator
    is bit-equal to the JAX package's.

Counts ride in float32 and are rounded at the end; every partial sum is an
integer under 2²⁴, so the order of the float adds does not matter. The
matrix products need TF32 off (the package's ``__init__`` sets it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from objective_slam_tpu_torch.ops import ppf as ppf_ops
from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops import voting_fast as vf

ALPHA_BITS = vf.ALPHA_BITS
_ALPHA_SCALE = vf._ALPHA_SCALE

# Past this many cells the JAX package sorts (row, col) pairs instead of
# flat int32 ids and keeps every row chunk under it (voting_corr.py:50,
# 302-307). The flat ids here are int64, but the bound still decides Rc,
# chunks and B, and with them `overflowed`.
_FLAT_ID_MAX = 2 ** 31


@dataclasses.dataclass(frozen=True)
class CorrTables:
    """Correlation-engine model tables (voting_corr.py:57-81), with the
    JAX package's shapes and pads.

    occ_keys   (K_pad,) int32 sorted occupied keys, pad −2.
    m3_dup     (k_occ+1, 2·n_angle, n_m) float32: per-key α_m histogram
               over model points, repeated along the α axis so that every
               shift is a contiguous slice; row k_occ is all zero.
    dense_rank (key_space,) int32 key -> occupied rank (k_occ where
               unoccupied).
    """
    occ_keys: torch.Tensor
    m3_dup: torch.Tensor
    dense_rank: torch.Tensor
    k_occ: int
    n_angle: int


def build_corr_tables(table: voting_ref.KeyTable, n_model: int,
                      n_angle: int = 30) -> CorrTables:
    """Build from the key table (pairs sorted by key). The index math over
    the model pairs runs on the host; the m3 histogram is made on the key
    table's device (327 MB for a 250-point model with 5,455 keys)."""
    device = table.counts.device
    counts = table.counts.cpu().numpy()
    pair_mr = table.pair_mr.cpu().numpy()
    pair_alpha = table.pair_alpha.cpu().numpy()

    occ_keys = np.nonzero(counts)[0]
    k_occ = len(occ_keys)
    k_pad = max(((k_occ + 127) // 128) * 128, 128)
    occ_dict = np.full((k_pad,), -2, np.int32)
    occ_dict[:k_occ] = occ_keys.astype(np.int32)
    dense_rank = np.full((len(counts),), k_occ, np.int32)
    dense_rank[occ_keys] = np.arange(k_occ, dtype=np.int32)

    # Coarse α_m bins by the fallback engine's fixed-point rounding, in
    # float64 on the host as build_fast_tables does.
    a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + math.pi)
                             * _ALPHA_SCALE), 0,
                    (1 << ALPHA_BITS) - 1).astype(np.int64)
    b_m = (a_fix * n_angle) >> ALPHA_BITS

    pair_key_rank = np.repeat(np.arange(k_occ, dtype=np.int64),
                              counts[occ_keys])
    n_pairs = pair_key_rank.shape[0]
    cell = ((pair_key_rank * n_angle + b_m[:n_pairs]) * n_model
            + pair_mr[:n_pairs].astype(np.int64))
    k1 = k_occ + 1
    m3 = torch.bincount(torch.from_numpy(cell).to(device),
                        minlength=k1 * n_angle * n_model) \
        .to(torch.float32).reshape(k1, n_angle, n_model)
    return CorrTables(
        occ_keys=torch.from_numpy(occ_dict).to(device),
        m3_dup=torch.cat([m3, m3], dim=1),
        dense_rank=torch.from_numpy(dense_rank).to(device),
        k_occ=k_occ, n_angle=n_angle)


def cast_votes_corr(scene_keys, scene_alpha, tables: CorrTables,
                    n_model: int, runs_cap: int | None = None,
                    chunk_budget_bytes: int | None = None
                    ) -> voting_ref.VoteResult:
    """Scene histogram plus n_angle matrix products per row chunk.

    runs_cap bounds the number of occupied histogram cells the JAX package
    compacts (None: S // 6, at least 65,536; clamped to S). More cells set
    `overflowed`, and drost.match retries with a larger cap.

    The dense (R, K1·n_angle) float32 histogram is built in row chunks of
    Rc rows when it would exceed chunk_budget_bytes (None: 2 GiB); one
    chunk holds it whole."""
    R, n = scene_keys.shape
    dev = scene_keys.device
    n_angle = tables.n_angle
    K1 = tables.k_occ + 1
    S = R * n
    flat_keys = scene_keys.reshape(-1)
    valid = flat_keys != ppf_ops.INVALID_KEY
    key_space = tables.dense_rank.shape[0]
    in_table = valid & (flat_keys >= 0) & (flat_keys < key_space)
    occ = torch.where(in_table,
                      tables.dense_rank[torch.where(in_table, flat_keys, 0)
                                        .to(torch.int64)],
                      tables.k_occ).to(torch.int64)
    b_s = (vf.alpha_to_fix(scene_alpha.reshape(-1)) * n_angle) >> ALPHA_BITS
    col = occ * n_angle + b_s                     # (S,) cell within its row
    weight = valid.to(torch.float32)

    if runs_cap is None:
        runs_cap = max(S // 6, 65536)
    runs_cap = min(vf._ceil_to(runs_cap, vf.LANES), S)

    cells_per_row = K1 * n_angle
    n_cells = R * cells_per_row
    if chunk_budget_bytes is None:
        chunk_budget_bytes = 2 << 30
    Rc = max(8, min(R, chunk_budget_bytes // (cells_per_row * 4)))
    if n_cells >= _FLAT_ID_MAX:
        Rc = max(1, min(Rc, (_FLAT_ID_MAX - 1) // cells_per_row))
    single = Rc >= R and n_cells < _FLAT_ID_MAX
    if single:
        Rc = R
    chunks = -(-R // Rc)

    m3d = tables.m3_dup
    m_tot = m3d[:, :n_angle, :].sum(dim=(1, 2)).to(torch.int64)   # (K1,)
    half = n_angle // 2
    acc = torch.empty((n_angle, R, n_model), dtype=torch.float32, device=dev)
    row_votes = torch.empty(R, dtype=torch.int64, device=dev)
    chunk_runs = []
    for c in range(chunks):
        lo, hi = c * Rc, min((c + 1) * Rc, R)
        rows = hi - lo
        local = (torch.arange(rows * n, device=dev) // n) * cells_per_row \
            + col[lo * n:hi * n]
        s3 = torch.zeros(rows * cells_per_row, dtype=torch.float32,
                         device=dev)
        s3.index_add_(0, local, weight[lo * n:hi * n])
        chunk_runs.append(torch.count_nonzero(s3))
        s3 = s3.reshape(rows, cells_per_row)
        # num_votes: Σ_k scene hits[k] · bucket size[k], in integers.
        s_tot = s3.reshape(rows, K1, n_angle).sum(dim=2).to(torch.int64)
        row_votes[lo:hi] = (s_tot * m_tot[None, :]).sum(dim=1)
        # acc[r, m, a] = S3 @ m3_dup[:, o_a : o_a + n, :], o_a = (n/2 − a)
        # mod n (the coarse-bin identity a ≈ b_s − b_m + n/2).
        for a in range(n_angle):
            o_a = (half - a) % n_angle
            rhs = m3d[:, o_a:o_a + n_angle, :].reshape(cells_per_row, n_model)
            torch.matmul(s3, rhs, out=acc[a, lo:hi])
        del s3, local

    chunk_runs = torch.stack(chunk_runs)
    # The invalid pairs sort into one sentinel run of their own.
    n_runs = chunk_runs.sum() + torch.any(~valid).to(torch.int64)
    overflowed = n_runs > runs_cap
    if not single:
        B = min(runs_cap,
                vf._ceil_to(max(65536, 4 * runs_cap // chunks), vf.LANES))
        overflowed = overflowed | torch.any(chunk_runs > B)

    # int32 rows as in the JAX package; the grand total saturates.
    num_votes = voting_ref.saturating_total(row_votes.to(torch.int32))
    out = torch.zeros((R, n_model, voting_ref.ALPHA_PAD), dtype=torch.int32,
                      device=dev)
    out[:, :, :n_angle] = torch.round(acc).permute(1, 2, 0).to(torch.int32)
    return voting_ref.VoteResult(accumulator=out, num_votes=num_votes,
                                 overflowed=overflowed)
