"""FNV-1a 32-bit hashing and the FNV keying mode.

Port of ``objective_slam_tpu.ops.hashing`` (hashing.py:29-138). The
reference hashes the raw little-endian bytes of each quantized float4 PPF
with FNV-1a (offset basis 2166136261, prime 16777619; kernel.cu:23-30) and
uses the result as the model hash key. ``PPFConfig.use_fnv_keys`` matches
through these hashes, collisions included: two distinct quantized features
whose hashes collide share one bucket, and a feature hashing to 0 is taken
for "no feature" and skipped (kernel.cu:467-470).

torch has little uint32 arithmetic, so hashes are int64 tensors holding
values in [0, 2³²): ``(h ^ byte) * 16777619`` stays under 2⁵⁶ and is masked
back to 32 bits after every multiply. Float and int32 inputs are
reinterpreted with ``.view(torch.int32)`` and masked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import ppf as ppf_ops

FNV_OFFSET_BASIS = 2166136261
FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF


def _fnv1a_word(h, word):
    """Fold one little-endian 32-bit word (4 bytes) into the hash."""
    for shift in (0, 8, 16, 24):
        byte = (word >> shift) & 0xFF
        h = ((h ^ byte) * FNV_PRIME) & _MASK
    return h


def _bits(x) -> torch.Tensor:
    """The 32-bit patterns of a float32 or int32 tensor, as int64 in
    [0, 2³²)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _MASK


def fnv1a_words(words, h0: int = FNV_OFFSET_BASIS):
    """FNV-1a over the bytes of 32-bit words along the last axis.

    words: (..., k) int64 holding uint32 values. Returns (...) int64."""
    words = torch.as_tensor(words).to(torch.int64) & _MASK
    h = torch.full(words.shape[:-1], h0, dtype=torch.int64,
                   device=words.device)
    for i in range(words.shape[-1]):
        h = _fnv1a_word(h, words[..., i])
    return h


def fnv1a_float4(f):
    """Hash of a float4's raw bytes, hash(f, sizeof(float4))
    (kernel.cu:23-30, 460-477). f: (..., 4) float32 -> (...) int64."""
    return fnv1a_words(_bits(torch.as_tensor(f).to(torch.float32)))


def fnv1a_int3(v):
    """Hash of an int3's raw bytes (trans2idx_kernel, kernel.cu:680).
    v: (..., 3) int32 -> (...) int64."""
    return fnv1a_words(_bits(torch.as_tensor(v).to(torch.int32)))


def packed_key_fnv(keys, d_dist, d_angle):
    """FNV-1a hash of the quantized float4 feature a packed key encodes
    (hashing.py:66-92): bin·step in float32 is bit-equal to the
    reference's quant_downf output. INVALID_KEY hashes to 0.

    keys: (...) int32 packed. Returns (...) int64."""
    k = torch.as_tensor(keys).to(torch.int32)
    a3 = (k & 15).to(torch.float32)
    a2 = ((k >> 4) & 15).to(torch.float32)
    a1 = ((k >> 8) & 15).to(torch.float32)
    db = (k >> 12).to(torch.float32)
    f = torch.stack([db * f32(d_dist), a1 * f32(d_angle), a2 * f32(d_angle),
                     a3 * f32(d_angle)], dim=-1)
    return torch.where(k == ppf_ops.INVALID_KEY, 0, fnv1a_float4(f))


@dataclasses.dataclass(frozen=True)
class FnvRemap:
    """The model's occupied FNV hash dictionary (hashing.py:95-108).

    occ_hashes (K_pad,) int64: sorted unique nonzero model-feature hashes
    (the remapped key space is their rank order); pad rows repeat the last
    real hash. k_occ: the number of real entries."""
    occ_hashes: torch.Tensor
    k_occ: int


def build_fnv_remap(model_keys, d_dist, d_angle) -> FnvRemap:
    """Collect the model's occupied FNV buckets on the host. Distinct
    packed keys whose features hash equal share one rank; hash 0 is left
    out (it can never match, kernel.cu:467-470)."""
    model_keys = torch.as_tensor(model_keys)
    h = packed_key_fnv(model_keys, d_dist, d_angle).cpu().numpy()
    h = np.unique(h[h != 0])
    k_occ = len(h)
    k_pad = max(((k_occ + 127) // 128) * 128, 128)
    occ = np.full((k_pad,), h[-1] if k_occ else 0, np.int64)
    occ[:k_occ] = h
    return FnvRemap(occ_hashes=torch.from_numpy(occ).to(model_keys.device),
                    k_occ=k_occ)


def fnv_remap_keys(keys, remap: FnvRemap, d_dist, d_angle):
    """Packed keys -> FNV-bucket ranks, or INVALID_KEY for a hash that is
    0 or not in the model (the lower_bound miss and key-0 skip of
    ppf_vote_count_kernel, kernel.cu:480-501). Returns int32."""
    h = packed_key_fnv(keys, d_dist, d_angle)
    occ = remap.occ_hashes
    idx = torch.searchsorted(occ, h).clamp_(0, occ.shape[0] - 1)
    hit = (occ[idx] == h) & (h != 0) & (idx < remap.k_occ)
    return torch.where(hit, idx, ppf_ops.INVALID_KEY).to(torch.int32)


def fnv_rank_table(remap: FnvRemap, num_packed_keys: int, d_dist, d_angle):
    """fnv_remap_keys of every packed key, (num_packed_keys,) int32. The
    packed key space is small (ppf.num_keys(max_dist_bin), tens of
    thousands), so a matcher hashes it once and maps its millions of scene
    pairs with one gather; the ranks are those fnv_remap_keys gives pair by
    pair."""
    keys = torch.arange(num_packed_keys, dtype=torch.int32,
                        device=remap.occ_hashes.device)
    return fnv_remap_keys(keys, remap, d_dist, d_angle)
