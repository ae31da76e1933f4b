"""Kernel K1 — the block tally with the row gather fused in — its wrapper
and its plain torch version.

Replaces the TPU kernel ``objective_slam_tpu.ops.voting_block._tally``
(Pallas kernel at voting_block.py:538-579, pallas_call at :590) and the
row gather before it (:421). The CUDA source is ``csrc/block_tally.cu``;
its header note gives the design and what bounds it on the card.

``block_tally`` launches the kernel for CUDA tensors and runs the plain
version for others (``_build.uses_kernel``); it never falls back from one
to the other. The module integer ``launches`` counts kernel launches (only
launches: the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

from objective_slam_tpu_torch.ops import _build
from objective_slam_tpu_torch.ops.voting import ALPHA_PAD

# The pair-word format, shared with voting_block: 128 words per vote row,
# each m << ALPHA_BITS | α_m fixed point (m < 2^M_BITS − 1; the all-ones
# word is the sentinel).
LANES = 128
ALPHA_BITS = 22
M_BITS = 32 - ALPHA_BITS
_ALPHA_MASK = (1 << ALPHA_BITS) - 1
_HALF = 1 << (ALPHA_BITS - 1)
_M_MASK = (1 << M_BITS) - 1
MAX_CLUSTER = 8                 # blocks per reference row (portable limit)
_ROWS_PER_BLOCK = 192           # vote rows a cluster block aims to take

# The launcher's arguments before the stream (csrc/block_tally.cu).
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

launches = 0


def _unpack_bin(pp, a_s, n_angle: int):
    """(m, α bin) of int32 pair words (voting_block.py:443-452): m is the
    logical shift of the uint32 word, bin = ((α_s − α_m + 2²¹) mod 2²²) ·
    n_angle >> 22 in int32 arithmetic, clipped to [0, 31]."""
    m = (pp >> ALPHA_BITS) & _M_MASK
    w = (a_s - (pp & _ALPHA_MASK) + _HALF) & _ALPHA_MASK
    return m, torch.clamp((w * n_angle) >> ALPHA_BITS, 0, ALPHA_PAD - 1)


def chunk_row_map(r_of_chunk_start, R: int, chunk_rows: int, n_chunks: int):
    """chunk → owning reference row (voting_block.py:427-440): each row id
    is scattered (max) at its start chunk, then a running max. A start at
    or past n_chunks — an empty trailing row of an exactly full buffer —
    drops out. Returns (cmap (n_chunks,) int64, start_chunk (R,))."""
    start_chunk = torch.div(r_of_chunk_start.to(torch.int64), chunk_rows,
                            rounding_mode="floor")
    idx = torch.where((start_chunk >= 0) & (start_chunk < n_chunks),
                      start_chunk, n_chunks)
    cmap = torch.zeros(n_chunks + 1, dtype=torch.int64,
                       device=start_chunk.device)
    cmap.scatter_reduce_(0, idx, torch.arange(R, device=idx.device), "amax")
    return torch.cummax(cmap[:n_chunks], dim=0).values, start_chunk


def tally_rows_plain(pp, alpha_row, row_start_p, total_rows_p,
                     n_model: int, n_angle: int):
    """Plain torch tally of gathered pair words pp (row_cap, 128), bit-equal
    to the JAX package's XLA twin of ``_tally`` (voting_block.py:601-631).

    Vote row t belongs to the last reference row r with row_start_p[r] <= t
    (row starts are non-decreasing and chunk-aligned by construction, so
    rows and chunks map alike; an empty row shares its start with the next
    row and gets nothing). Rows at or past total_rows_p are skipped, as the
    TPU kernel skips chunks past `live`: ``_expand`` leaves only sentinels
    there. Sentinel words (m = 1023) and m >= n_model are skipped."""
    row_cap = pp.shape[0]
    R = row_start_p.shape[0]
    cells = R * n_model * ALPHA_PAD
    owner, start = chunk_row_map(row_start_p, R, 1, row_cap)
    t = torch.arange(row_cap, device=pp.device)
    owned = (t >= start[0]) & (t < total_rows_p.reshape(()))
    m, a_bin = _unpack_bin(pp, alpha_row[:, None], n_angle)
    idx = (owner[:, None] * n_model + m) * ALPHA_PAD + a_bin
    idx = torch.where((m < n_model) & owned[:, None], idx, cells)
    acc = torch.bincount(idx.reshape(-1), minlength=cells + 1)[:cells]
    return acc.to(torch.int32).reshape(R, n_model, ALPHA_PAD)


def block_tally_plain(pair2d, src_row, alpha_row, row_start_p, total_rows_p,
                      n_model: int, n_angle: int):
    """The function K1 computes, in plain torch: the row gather
    ``pair2d[src_row]`` followed by ``tally_rows_plain``."""
    return tally_rows_plain(pair2d[src_row.to(torch.int64)], alpha_row,
                            row_start_p, total_rows_p, n_model, n_angle)


def cluster_size(row_cap: int, R: int) -> int:
    """Blocks per reference row: about _ROWS_PER_BLOCK vote rows of the
    capacity each, 1 to MAX_CLUSTER. Host numbers only, so the host never
    waits for the device."""
    return max(1, min(MAX_CLUSTER, row_cap // max(R, 1) // _ROWS_PER_BLOCK))


def _named(pair2d, src_row, alpha_row, row_start_p, total_rows_p):
    return (("pair2d", pair2d), ("src_row", src_row),
            ("alpha_row", alpha_row), ("row_start_p", row_start_p),
            ("total_rows_p", total_rows_p))


def _check(pair2d, src_row, alpha_row, row_start_p, total_rows_p, n_model,
           n_angle):
    for name, t in _named(pair2d, src_row, alpha_row, row_start_p,
                          total_rows_p):
        if t.dtype != torch.int32:
            raise TypeError(f"block_tally: {name} must be int32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"block_tally: {name} must be contiguous")
    if pair2d.dim() != 2 or pair2d.shape[1] != LANES or pair2d.shape[0] < 1:
        raise ValueError(f"block_tally: pair2d must be (n_rows + 1, {LANES}),"
                         f" got {tuple(pair2d.shape)}")
    if src_row.dim() != 1:
        raise ValueError("block_tally: src_row must be (row_cap,)")
    if tuple(alpha_row.shape) != tuple(src_row.shape):
        raise ValueError("block_tally: alpha_row must be (row_cap,)")
    if row_start_p.dim() != 1 or row_start_p.shape[0] < 1:
        raise ValueError("block_tally: row_start_p must be (R,), R >= 1")
    if total_rows_p.numel() != 1:
        raise ValueError("block_tally: total_rows_p must hold one value")
    # m = _M_MASK is the sentinel; real model points are 0 .. n_model − 1.
    if not 0 < n_model <= _M_MASK:
        raise ValueError(f"block_tally: n_model {n_model} outside "
                         f"[1, {_M_MASK}]")
    if n_angle < 1:
        raise ValueError("block_tally: n_angle must be positive")
    if pair2d.data_ptr() % 16:
        raise ValueError("block_tally: pair2d must be 16-byte aligned")


def block_tally(pair2d, src_row, alpha_row, row_start_p, total_rows_p,
                n_model: int, n_angle: int, cluster: int | None = None):
    """(R, n_model, 32) int32 tally of the pair-table rows that the vote
    rows name.

    pair2d (n_rows + 1, 128) int32 pair table (row n_rows all sentinel),
    src_row (row_cap,) int32 table row of each vote row, alpha_row
    (row_cap,) int32, row_start_p (R,) int32, total_rows_p () int32 (the
    live vote rows; read on the device, so the host never waits for it),
    all on one device. CUDA tensors launch the kernel on the current
    stream with `cluster` blocks per reference row (default
    ``cluster_size(row_cap, R)``); others take the plain version."""
    global launches
    tensors = (pair2d, src_row, alpha_row, row_start_p, total_rows_p)
    for name, t in _named(*tensors):
        if t.device != pair2d.device:
            raise ValueError(f"block_tally: {name} is on {t.device}, "
                             f"pair2d on {pair2d.device}")
    if not _build.uses_kernel(pair2d.device):
        return block_tally_plain(*tensors, n_model, n_angle)
    _check(*tensors, n_model, n_angle)
    R = row_start_p.shape[0]
    row_cap = src_row.shape[0]
    if cluster is None:
        cluster = cluster_size(row_cap, R)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"block_tally: cluster {cluster} outside "
                         f"[1, {MAX_CLUSTER}]")
    out = torch.empty((R, n_model, ALPHA_PAD), dtype=torch.int32,
                      device=pair2d.device)
    _build.launch(
        "block_tally", _ARGTYPES, pair2d.data_ptr(), pair2d.shape[0],
        src_row.data_ptr(), alpha_row.data_ptr(), row_start_p.data_ptr(),
        total_rows_p.data_ptr(), R, row_cap, n_model, n_angle, cluster,
        out.data_ptr(), device=pair2d.device,
        no_fit=f"block_tally: no cluster of {cluster} blocks with "
               f"{n_model * ALPHA_PAD * 4} B of shared memory each fits "
               "the card")
    launches += 1
    return out
