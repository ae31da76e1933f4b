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


def _embed_rot(theta, i: int, j: int):
    """Homogeneous rotation by theta in the plane (i, j); the other rows
    and columns are the identity."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    T = torch.zeros(theta.shape + (4, 4), dtype=torch.float32,
                    device=theta.device)
    for k in range(4):
        if k not in (i, j):
            T[..., k, k] = 1.0
    T[..., i, i] = c
    T[..., j, j] = c
    T[..., j, i] = s
    T[..., i, j] = -s
    return T


def rotx(theta):
    """Rotation about x (kernel.cu:181-189)."""
    return _embed_rot(theta, 1, 2)


def roty(theta):
    """Rotation about y (kernel.cu:191-199): T[0][2] = sin, T[2][0] = −sin."""
    return _embed_rot(theta, 2, 0)


def rotz(theta):
    """Rotation about z (kernel.cu:201-209)."""
    return _embed_rot(theta, 0, 1)


def trans_mat(v):
    """Homogeneous translation by v (..., 3) (kernel.cu:170-179)."""
    v = torch.as_tensor(v, dtype=torch.float32)
    T = torch.eye(4, dtype=torch.float32, device=v.device) \
        .expand(v.shape[:-1] + (4, 4)).clone()
    T[..., :3, 3] = v
    return T


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


def rotate_vectors(T, n):
    """Apply only the rotation part of T to vectors (for normals)."""
    return _mv(T[..., :3, :3], n)


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


def canonical_transform(p, n):
    """Full 4x4 T_g = Rotz(γ)·Roty(β)·Trans(−p) (kernel.cu:310-318)."""
    beta, gamma = canonical_angles(p, n)
    R = canonical_rotation(beta, gamma)
    T = torch.zeros(beta.shape + (4, 4), dtype=torch.float32,
                    device=beta.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = -_mv(R, p.to(torch.float32))
    T[..., 3, 3] = 1.0
    return T


def alpha_about_x(u, v):
    """Signed angle from u to v about +x after projecting both onto the yz
    plane: atan2(x̂·(û×v̂), û·v̂) (trans_model_scene.m:34-39,
    kernel.cu:330-340)."""
    cross_x = u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]
    dot_yz = u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]
    return torch.atan2(cross_x, dot_yz)


def alpha_angle(p_ref, n_ref, p_other):
    """α of a point pair: the angle about x of the second point once the
    pair is moved to the canonical frame of (p_ref, n_ref). The per-vote
    α of the reference (kernel.cu:330-340) is wrap(α_s − α_m) of two such
    angles."""
    beta, gamma = canonical_angles(p_ref, n_ref)
    u = _mv(canonical_rotation(beta, gamma), p_other - p_ref)
    return torch.atan2(u[..., 2], u[..., 1])


def wrap_angle(a):
    """Wrap to [−π, π)."""
    two_pi = f32(2.0 * torch.pi)
    return a - two_pi * torch.floor((a + torch.pi) / two_pi)


def trans_model_scene(m_r, n_r_m, m_i, s_r, n_r_s, s_i):
    """Transliteration of matlab/trans_model_scene.m:1-41 /
    kernel.cu:302-349: (T_m_g, T_s_g, α). For tests of the α
    decomposition; the matcher never calls it."""
    T_m_g = canonical_transform(m_r, n_r_m)
    T_s_g = canonical_transform(s_r, n_r_s)
    alpha = alpha_about_x(transform_points(T_m_g, m_i),
                          transform_points(T_s_g, s_i))
    return T_m_g, T_s_g, alpha


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
