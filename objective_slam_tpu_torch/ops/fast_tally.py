"""Kernel K2 — the chunked tally of the fallback vote engine — its wrapper
and its plain torch version.

Replaces the TPU kernel ``objective_slam_tpu.ops.voting_fast._pallas_tally``
(Pallas body at voting_fast.py:450-464, pallas_call at :466) together with
the XLA combine after it (:478-487). The CUDA source is
``csrc/fast_tally.cu``; its header note gives the design and what bounds
it on the card.

``fast_tally`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises); it never falls back from one to the
other. The module integer ``launches`` counts kernel launches (only
launches: the plain version does not count).
"""

from __future__ import annotations

import ctypes

import torch

from objective_slam_tpu_torch.ops import _build
from objective_slam_tpu_torch.ops.block_tally import _chunk_row_map
from objective_slam_tpu_torch.ops.voting import ALPHA_PAD

# Widest model whose (n_model, 32) int32 histogram fits one block's shared
# memory (227 KB); wider models take the kernel's global-atomic path.
SMEM_MAX_MODEL = 1792
_THREADS = 256

launches = 0


def fast_tally_plain(m_r, a_bin, vote_ok, row_start_p, total_p,
                     n_model: int, chunk: int):
    """Plain torch tally, bit-equal to the JAX package's CPU twin
    ``_mxu_tally`` (voting_fast.py:390-430) on the arrays cast_votes_fast
    makes.

    Chunk c of `chunk` votes belongs to the last reference row r with
    row_start_p[r] // chunk <= c (``_chunk_row_map``; an empty row shares
    its start with the next row, and a start at or past the buffer's end
    drops out). Votes are counted where vote_ok is set, the slot is below
    total_p (cast_votes_fast clears vote_ok there; the kernel skips whole
    chunks past it), 0 <= m_r < n_model and 0 <= a_bin < 32."""
    vote_cap = m_r.shape[0]
    n_chunks = vote_cap // chunk
    R = row_start_p.shape[0]
    cells = R * n_model * ALPHA_PAD
    owner, start = _chunk_row_map(row_start_p, R, chunk, n_chunks)
    v = torch.arange(vote_cap, device=m_r.device)
    c = v // chunk
    ok = (vote_ok & (v < total_p.reshape(()).to(torch.int64))
          & (c >= start[0]) & (m_r >= 0) & (m_r < n_model)
          & (a_bin >= 0) & (a_bin < ALPHA_PAD))
    idx = (owner[c] * n_model + m_r) * ALPHA_PAD + a_bin
    idx = torch.where(ok, idx, cells)
    acc = torch.bincount(idx, minlength=cells + 1)[:cells]
    return acc.to(torch.int32).reshape(R, n_model, ALPHA_PAD)


def _lib():
    lib = _build.load("fast_tally")
    if not getattr(lib, "_osn_typed", False):
        lib.osn_fast_tally.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.osn_fast_tally.restype = ctypes.c_int
        lib.osn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.osn_cuda_error_string.restype = ctypes.c_char_p
        lib._osn_typed = True
    return lib


def _check(m_r, a_bin, vote_ok, row_start_p, total_p, n_model, chunk):
    dev = m_r.device
    for name, t, dtype in (("m_r", m_r, torch.int32),
                           ("a_bin", a_bin, torch.int32),
                           ("vote_ok", vote_ok, torch.bool),
                           ("row_start_p", row_start_p, torch.int32),
                           ("total_p", total_p, torch.int32)):
        if t.device != dev:
            raise ValueError(f"fast_tally: {name} is on {t.device}, "
                             f"m_r on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fast_tally: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fast_tally: {name} must be contiguous")
    if m_r.dim() != 1:
        raise ValueError("fast_tally: m_r must be (vote_cap,)")
    if tuple(a_bin.shape) != tuple(m_r.shape) or \
            tuple(vote_ok.shape) != tuple(m_r.shape):
        raise ValueError("fast_tally: a_bin and vote_ok must be shaped like "
                         "m_r")
    if row_start_p.dim() != 1 or row_start_p.shape[0] < 1:
        raise ValueError("fast_tally: row_start_p must be (R,), R >= 1")
    if total_p.numel() != 1:
        raise ValueError("fast_tally: total_p must hold one value")
    if chunk < 1 or m_r.shape[0] % chunk:
        raise ValueError(f"fast_tally: chunk {chunk} must divide vote_cap "
                         f"{m_r.shape[0]}")
    if n_model < 1:
        raise ValueError("fast_tally: n_model must be positive")
    if row_start_p.shape[0] * n_model * ALPHA_PAD >= 2 ** 31:
        raise ValueError("fast_tally: accumulator over 2^31 cells")


def fast_tally(m_r, a_bin, vote_ok, row_start_p, total_p, n_model: int,
               chunk: int):
    """(R, n_model, 32) int32 tally of the per-vote (m_r, a_bin) where
    vote_ok, each chunk added into the reference row that owns it.

    m_r, a_bin (vote_cap,) int32, vote_ok (vote_cap,) bool, row_start_p
    (R,) int32 chunk-aligned row starts, total_p () int32 padded vote count
    (read on the device, so the host never waits for it). CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current
    stream: its shared-memory histogram up to SMEM_MAX_MODEL points, its
    global-atomic path above."""
    global launches
    tensors = (m_r, a_bin, vote_ok, row_start_p, total_p)
    if all(t.device.type == "cpu" for t in tensors):
        return fast_tally_plain(m_r, a_bin, vote_ok, row_start_p, total_p,
                                n_model, chunk)
    if m_r.device.type != "cuda":
        raise ValueError(f"fast_tally: unsupported device {m_r.device}")
    _check(m_r, a_bin, vote_ok, row_start_p, total_p, n_model, chunk)
    R = row_start_p.shape[0]
    out = torch.zeros((R, n_model, ALPHA_PAD), dtype=torch.int32,
                      device=m_r.device)
    lib = _lib()
    with torch.cuda.device(m_r.device):
        stream = torch.cuda.current_stream(m_r.device).cuda_stream
        err = lib.osn_fast_tally(
            m_r.data_ptr(), a_bin.data_ptr(), vote_ok.data_ptr(),
            row_start_p.data_ptr(), total_p.data_ptr(), R, m_r.shape[0],
            chunk, n_model, int(n_model <= SMEM_MAX_MODEL), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("fast_tally: launch failed: "
                           + lib.osn_cuda_error_string(err).decode())
    launches += 1
    return out
