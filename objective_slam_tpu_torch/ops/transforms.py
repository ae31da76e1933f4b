"""Batched rigid-transform and quaternion math (float32 torch).

Port of ``objective_slam_tpu.ops.transforms``: every function broadcasts
over leading batch dimensions. Conventions are the JAX package's:
homogeneous transforms are (..., 4, 4) float32 tensors and quaternions are
(..., 4) ordered (w, x, y, z).
"""

from __future__ import annotations

import torch

from objective_slam_tpu_torch._common import f32


def _mv(A, v):
    """(..., i, j) x (..., j) -> (..., i)."""
    return torch.einsum("...ij,...j->...i", A, v)


def invht(T):
    """Closed-form inverse of a rigid homogeneous transform
    (kernel.cu:254-299): inv([R t; 0 1]) = [Rᵀ -Rᵀt; 0 1]."""
    T = T.to(torch.float32)
    R_T = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = R_T
    out[..., :3, 3] = -_mv(R_T, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def transform_points(T, p):
    """(..., 4, 4) x (..., 3) -> (..., 3) (kernel.cu:234-252)."""
    return _mv(T[..., :3, :3], p) + T[..., :3, 3]


def hrotmat2quat(T):
    """Rotation matrix -> unit quaternion (w, x, y, z) (kernel.cu:128-144,
    normalized to unit length as in the JAX package)."""
    def half_sqrt(x):
        return 0.5 * torch.sqrt(torch.clamp(x, min=0.0))

    t00, t11, t22 = T[..., 0, 0], T[..., 1, 1], T[..., 2, 2]
    w = half_sqrt(1.0 + (t00 + t11 + t22))
    x = torch.copysign(half_sqrt(1.0 + t00 - t11 - t22),
                       T[..., 2, 1] - T[..., 1, 2])
    y = torch.copysign(half_sqrt(1.0 - t00 + t11 - t22),
                       T[..., 0, 2] - T[..., 2, 0])
    z = torch.copysign(half_sqrt(1.0 - t00 - t11 + t22),
                       T[..., 1, 0] - T[..., 0, 1])
    q = torch.stack([w, x, y, z], dim=-1)
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat2hrotmat(q):
    """Quaternion (w, x, y, z) -> homogeneous rotation (kernel.cu:146-168)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n == 0, torch.zeros_like(n),
                    2.0 / torch.where(n == 0, torch.ones_like(n), n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    T = torch.zeros(q.shape[:-1] + (4, 4), dtype=torch.float32,
                    device=q.device)
    T[..., 0, 0] = 1 - (yy + zz)
    T[..., 0, 1] = xy - wz
    T[..., 0, 2] = xz + wy
    T[..., 1, 0] = xy + wz
    T[..., 1, 1] = 1 - (xx + zz)
    T[..., 1, 2] = yz - wx
    T[..., 2, 0] = xz - wy
    T[..., 2, 1] = yz + wx
    T[..., 2, 2] = 1 - (xx + yy)
    T[..., 3, 3] = 1.0
    return T


def canonical_angles(p, n):
    """Per-point canonical-frame angles (β about y, γ about z)
    (kernel.cu:302-327): β = atan2(n.z, n.x),
    γ = −atan2(n.y, cos β·n.x + sin β·n.z). `p` is unused, as in the JAX
    package (the angles depend on the normal only)."""
    del p
    beta = torch.atan2(n[..., 2], n[..., 0])
    xp = torch.cos(beta) * n[..., 0] + torch.sin(beta) * n[..., 2]
    gamma = -torch.atan2(n[..., 1], xp)
    return beta, gamma


def canonical_rotation(beta, gamma):
    """3x3 R = Rz(γ) @ Ry(β) with the reference's roty convention."""
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    zero = torch.zeros_like(cb)
    row0 = torch.stack([cg * cb, -sg, cg * sb], dim=-1)
    row1 = torch.stack([sg * cb, cg, sg * sb], dim=-1)
    row2 = torch.stack([-sb, zero, cb], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pose_from_vote(alpha_idx, m_point, m_beta, m_gamma, s_point, s_beta,
                   s_gamma, d_angle):
    """T = invht(T_s_g) · Rotx(α_idx·Δα − π) · T_m_g (kernel.cu:372-401,
    605-645), batched."""
    alpha = alpha_idx.to(torch.float32) * f32(d_angle) - f32(torch.pi)
    Rm = canonical_rotation(m_beta, m_gamma)
    Rs = canonical_rotation(s_beta, s_gamma)
    tm = -_mv(Rm, m_point)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    Rx = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, ca, -sa], dim=-1),
        torch.stack([zero, sa, ca], dim=-1),
    ], dim=-2)
    Rs_T = Rs.transpose(-1, -2)
    RsRx = Rs_T @ Rx
    T = torch.zeros(RsRx.shape[:-2] + (4, 4), dtype=torch.float32,
                    device=RsRx.device)
    T[..., :3, :3] = RsRx @ Rm
    T[..., :3, 3] = _mv(RsRx, tm) + s_point
    T[..., 3, 3] = 1.0
    return T


def ht_dist(a, b):
    """(‖t_a − t_b‖, |angle(R_aᵀ R_b)|) (src/cuda/linalg.cu:9-20), batched."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    dt = a[..., :3, 3] - b[..., :3, 3]
    t_diff = torch.sqrt(torch.sum(dt * dt, dim=-1))
    R = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    ang = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    return t_diff, torch.abs(ang)
