"""Point-pair features, truncating quantization and packed integer keys.

Port of ``objective_slam_tpu.ops.ppf`` (ppf.py:101-196): the injective
packed key ((dist·16 + a1)·16 + a2)·16 + a3 replaces the reference's FNV-1a
of the quantized float bytes (kernel.cu:460-477).
"""

from __future__ import annotations

import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import transforms as tr

# Sentinel for pairs that produce no feature (self pairs, unmatchable
# distance bins); key 0 stays a valid feature (ppf.py:27-33).
INVALID_KEY = 2147483647

# Feature-angle bins 0..15 (acos ∈ [0, π], step 2π/30), padded to 16.
ANGLE_BINS = 16


def quant_downf(x, step):
    """Truncating quantizer x − fmod(x, step) (kernel.cu:90-92)."""
    return x - torch.fmod(x, f32(step))


def compute_ppf(p1, n1, p2, n2):
    """F = (‖d‖, ∠(n1,d), ∠(n2,d), ∠(n1,n2)) with d = p2 − p1
    (kernel.cu:109-122); dots clamped to [−1, 1] (ppf.py:49-76). Inputs
    broadcast; returns (..., 4) float32."""
    d = p2 - p1
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    pos = dist > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, dist, 1.0), 0.0)
    n1n = torch.sqrt(torch.sum(n1 * n1, dim=-1))
    n2n = torch.sqrt(torch.sum(n2 * n2, dim=-1))

    def acos(c):
        return torch.arccos(torch.clamp(c, -1.0, 1.0))

    f2 = acos(torch.sum(n1 * d, dim=-1) * inv / torch.where(n1n > 0, n1n, 1.0))
    f3 = acos(torch.sum(n2 * d, dim=-1) * inv / torch.where(n2n > 0, n2n, 1.0))
    nn = n1n * n2n
    f4 = acos(torch.sum(n1 * n2, dim=-1) / torch.where(nn > 0, nn, 1.0))
    return torch.stack(torch.broadcast_tensors(dist, f2, f3, f4), dim=-1)


def disc_feature(f, d_dist, d_angle):
    """Quantize a PPF: distance by d_dist, angles by d_angle
    (kernel.cu:94-100). Returns the quantized float4."""
    return torch.stack([quant_downf(f[..., 0], d_dist),
                        quant_downf(f[..., 1], d_angle),
                        quant_downf(f[..., 2], d_angle),
                        quant_downf(f[..., 3], d_angle)], dim=-1)


def feature_bins(f, d_dist, d_angle):
    """Integer bin indices of a PPF, round(quant_downf(x, s) / s), taken
    through the quantized float so that bin edges match the reference."""
    q = disc_feature(f, d_dist, d_angle)
    db = torch.round(q[..., 0] / f32(d_dist)).to(torch.int32)
    ab = torch.round(q[..., 1:] / f32(d_angle)).to(torch.int32)
    return db, ab


def pack_key(dist_bin, angle_bins, max_dist_bin):
    """Pack (dist_bin, a1, a2, a3) into one int32 key; out-of-range bins map
    to INVALID_KEY (ppf.py:101-115)."""
    a1 = angle_bins[..., 0]
    a2 = angle_bins[..., 1]
    a3 = angle_bins[..., 2]
    key = ((dist_bin * ANGLE_BINS + a1) * ANGLE_BINS + a2) * ANGLE_BINS + a3
    valid = ((dist_bin >= 0) & (dist_bin <= max_dist_bin)
             & (a1 < ANGLE_BINS) & (a2 < ANGLE_BINS) & (a3 < ANGLE_BINS))
    return torch.where(valid, key, torch.full_like(key, INVALID_KEY))


def num_keys(max_dist_bin: int) -> int:
    """Size of the direct-addressed key table."""
    return (int(max_dist_bin) + 1) * ANGLE_BINS * ANGLE_BINS * ANGLE_BINS


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _bin(x, step):
    """round(quant_downf(x, step) / step) as float (not yet cast)."""
    return torch.round(quant_downf(x, step) / f32(step))


def pairwise_ppf_keys(points, normals, d_dist, d_angle, max_dist_bin,
                      ref_indices=None):
    """All-pairs PPF keys and α angles (ppf.py:123-196).

    Args:
      points, normals: (n, 3) float32 tensors.
      ref_indices: optional (r,) int tensor of reference rows
        (ref_point_downsample_factor, kernel.cu:432-435).

    Returns:
      keys:  (r, n) int32, INVALID_KEY on self pairs (kernel.cu:438-441)
             and for distance bins outside [0, max_dist_bin].
      alpha: (r, n) float32 α of each pair in its reference point's
             canonical frame.
    """
    points = points.to(torch.float32)
    normals = normals.to(torch.float32)
    n = points.shape[0]
    if ref_indices is None:
        ref_indices = torch.arange(n, device=points.device)
    ref_indices = ref_indices.to(torch.int64)
    ref_pts = points[ref_indices]                         # (r, 3)
    ref_nrm = normals[ref_indices]                        # (r, 3)

    d = points[None, :, :] - ref_pts[:, None, :]          # (r, n, 3)
    dist = torch.sqrt(torch.sum(d * d, dim=-1))           # (r, n)
    safe = torch.where(dist > 0, dist, torch.ones_like(dist))
    d_hat = d / safe[..., None]

    def unit(v):
        nn = torch.sqrt(torch.sum(v * v, dim=-1))
        return v / torch.where(nn > 0, nn, torch.ones_like(nn))[:, None]

    ref_unit = unit(ref_nrm)
    all_unit = unit(normals)
    c2 = _dot3(ref_unit[:, None, :], d_hat)
    c3 = _dot3(all_unit[None, :, :], d_hat)
    c4 = ref_unit @ all_unit.T
    f2 = torch.arccos(torch.clamp(c2, -1.0, 1.0))
    f3 = torch.arccos(torch.clamp(c3, -1.0, 1.0))
    f4 = torch.arccos(torch.clamp(c4, -1.0, 1.0))

    dist_q = _bin(dist, d_dist)
    # Validity is decided on the float bin before the int cast: a pad
    # sentinel point (pointcloud._PAD_OFFSET) gives a huge quotient whose
    # float->int32 conversion is implementation-defined (ppf.py:176-181).
    valid = (dist > 0) & (dist_q >= 0) & (dist_q <= max_dist_bin)
    dist_bin = torch.where(valid, dist_q, torch.zeros_like(dist_q)) \
        .to(torch.int32)
    a1 = _bin(f2, d_angle).to(torch.int32)
    a2 = _bin(f3, d_angle).to(torch.int32)
    a3 = _bin(f4, d_angle).to(torch.int32)
    key = ((dist_bin * ANGLE_BINS + a1) * ANGLE_BINS + a2) * ANGLE_BINS + a3
    self_pair = ref_indices[:, None] == torch.arange(n, device=points.device)
    keys = torch.where(valid & ~self_pair, key,
                       torch.full_like(key, INVALID_KEY))

    # α as explicit row products (ppf.py:186-195).
    beta, gamma = tr.canonical_angles(ref_pts, ref_nrm)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    u_y = (sg * cb)[:, None] * dx + cg[:, None] * dy + (sg * sb)[:, None] * dz
    u_z = (-sb)[:, None] * dx + cb[:, None] * dz
    alpha = torch.atan2(u_z, u_y)                         # (r, n)
    return keys, alpha
