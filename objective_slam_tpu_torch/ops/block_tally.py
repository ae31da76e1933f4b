"""Kernel K1 — the block tally — its wrapper and its plain torch version.

Replaces the TPU kernel ``objective_slam_tpu.ops.voting_block._tally``
(Pallas kernel at voting_block.py:538-579, pallas_call at :590). The CUDA
source is ``csrc/block_tally.cu``; its header note gives the design and
what bounds it on the card.

``block_tally`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); it never falls back from one to the
other. The module integer ``launches`` counts kernel launches (only
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

launches = 0


def _unpack_bin(pp, a_s, n_angle: int):
    """(m, α bin) of int32 pair words (voting_block.py:443-452): m is the
    logical shift of the uint32 word, bin = ((α_s − α_m + 2²¹) mod 2²²) ·
    n_angle >> 22 in int32 arithmetic, clipped to [0, 31]."""
    m = (pp >> ALPHA_BITS) & _M_MASK
    w = (a_s - (pp & _ALPHA_MASK) + _HALF) & _ALPHA_MASK
    return m, torch.clamp((w * n_angle) >> ALPHA_BITS, 0, ALPHA_PAD - 1)


def _chunk_row_map(r_of_chunk_start, R: int, chunk_rows: int, n_chunks: int):
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


def block_tally_plain(pp, alpha_row, row_start_p, total_rows_p,
                      n_model: int, n_angle: int):
    """Plain torch tally, bit-equal to the JAX package's XLA twin of
    ``_tally`` (voting_block.py:601-631) on the arrays ``_expand`` makes.

    Vote row t belongs to the last reference row r with row_start_p[r] <= t
    (row starts are non-decreasing and chunk-aligned by construction, so
    rows and chunks map alike; an empty row shares its start with the next
    row and gets nothing). Rows at or past total_rows_p are skipped, as the
    TPU kernel skips chunks past `live`: ``_expand`` leaves only sentinels
    there. Sentinel words (m = 1023) and m >= n_model are skipped."""
    row_cap = pp.shape[0]
    R = row_start_p.shape[0]
    cells = R * n_model * ALPHA_PAD
    owner, start = _chunk_row_map(row_start_p, R, 1, row_cap)
    t = torch.arange(row_cap, device=pp.device)
    owned = (t >= start[0]) & (t < total_rows_p.reshape(()))
    m, a_bin = _unpack_bin(pp, alpha_row[:, None], n_angle)
    idx = (owner[:, None] * n_model + m) * ALPHA_PAD + a_bin
    idx = torch.where((m < n_model) & owned[:, None], idx, cells)
    acc = torch.bincount(idx.reshape(-1), minlength=cells + 1)[:cells]
    return acc.to(torch.int32).reshape(R, n_model, ALPHA_PAD)


def _lib():
    lib = _build.load("block_tally")
    if not getattr(lib, "_osn_typed", False):
        lib.osn_block_tally.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.osn_block_tally.restype = ctypes.c_int
        lib.osn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.osn_cuda_error_string.restype = ctypes.c_char_p
        lib._osn_typed = True
    return lib


def _check(pp, alpha_row, row_start_p, total_rows_p, n_model, n_angle):
    dev = pp.device
    for name, t in (("pp", pp), ("alpha_row", alpha_row),
                    ("row_start_p", row_start_p),
                    ("total_rows_p", total_rows_p)):
        if t.device != dev:
            raise ValueError(f"block_tally: {name} is on {t.device}, "
                             f"pp on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"block_tally: {name} must be int32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"block_tally: {name} must be contiguous")
    if pp.dim() != 2 or pp.shape[1] != LANES:
        raise ValueError(f"block_tally: pp must be (row_cap, {LANES}), "
                         f"got {tuple(pp.shape)}")
    if tuple(alpha_row.shape) != (pp.shape[0],):
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
    if pp.data_ptr() % 16:
        raise ValueError("block_tally: pp must be 16-byte aligned")


def block_tally(pp, alpha_row, row_start_p, total_rows_p, n_model: int,
                n_angle: int):
    """(R, n_model, 32) int32 tally of the gathered pair words.

    pp (row_cap, 128) int32, alpha_row (row_cap,) int32, row_start_p (R,)
    int32, total_rows_p () int32 (the live vote rows; read on the device,
    so the host never waits for it). CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream."""
    global launches
    tensors = (pp, alpha_row, row_start_p, total_rows_p)
    if all(t.device.type == "cpu" for t in tensors):
        return block_tally_plain(pp, alpha_row, row_start_p, total_rows_p,
                                 n_model, n_angle)
    if pp.device.type != "cuda":
        raise ValueError(f"block_tally: unsupported device {pp.device}")
    _check(pp, alpha_row, row_start_p, total_rows_p, n_model, n_angle)
    R = row_start_p.shape[0]
    out = torch.empty((R, n_model, ALPHA_PAD), dtype=torch.int32,
                      device=pp.device)
    lib = _lib()
    with torch.cuda.device(pp.device):
        stream = torch.cuda.current_stream(pp.device).cuda_stream
        err = lib.osn_block_tally(
            pp.data_ptr(), alpha_row.data_ptr(), row_start_p.data_ptr(),
            total_rows_p.data_ptr(), R, pp.shape[0], n_model, n_angle,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("block_tally: launch failed: "
                           + lib.osn_cuda_error_string(err).decode())
    launches += 1
    return out
