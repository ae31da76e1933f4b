"""ICP pose refinement, point-to-point (Kabsch) and point-to-plane.

Port of ``objective_slam_tpu.ops.icp.refine_pose`` (icp.py:30-222): a fixed
number of iterations; nearest neighbours from the ‖a‖² + ‖b‖² − 2a·b
distance tile, chunked over scene points; distance rejection and the
optional normal gate; a weighted Kabsch solve, or the clamped linearized
6×6 point-to-plane solve after the first Kabsch iterations. All matrix
products run in full float32 (TF32 is off package-wide).

On the card a refinement is one launch of ``csrc/icp_refine.cu``, which
runs every iteration with the pose kept on chip. Elsewhere
``refine_pose_plain`` runs the loop of small torch ops: the CPU path, and
the twin the kernel is tested against. The module integer ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import _build
from objective_slam_tpu_torch.utils.profiling import span


class ICPResult(NamedTuple):
    pose: torch.Tensor      # (4, 4) refined model -> scene transform
    rms: torch.Tensor       # () float32 final inlier RMS distance
    inliers: torch.Tensor   # () int32 final inlier count


# One (n_m, chunk) distance tile: the whole scene when it fits the budget,
# else 16k-point chunks (icp.py:36-42).
_NN_TILE_BUDGET = 64 * 1024 * 1024
_NN_CHUNK = 16384

# Per-step rotation clamp of the plane solve (~1.1°, icp.py:159-165).
_OMEGA_MAX = 0.02

# Sweeps and tolerances of the 3 × 3 Jacobi SVD (csrc/icp_refine.cu).
_JACOBI_SWEEPS = 12
_JACOBI_TOL = 1e-7
_RANK_TOL = 1e-6

# The launcher's arguments before the stream (csrc/icp_refine.cu).
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p)

launches = 0


def _solve_point(mt, tgt, w, wsum):
    """Weighted Procrustes (Kabsch) increment; the det term fixes a
    reflection, so only the product R is compared, never U or V."""
    cm = torch.sum(w[:, None] * mt, dim=0) / wsum
    cs = torch.sum(w[:, None] * tgt, dim=0) / wsum
    H = (w[:, None] * (mt - cm)).T @ (tgt - cs)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = (Vt.T @ D) @ U.T
    return R, cs - R @ cm


def _solve_plane(mt, tgt, nrm, w):
    """Linearized point-to-plane increment: the 6×6 normal equations, the
    se(3) step clamped to _OMEGA_MAX, ω lifted by Rodrigues."""
    r = torch.sum((mt - tgt) * nrm, dim=1)
    J = torch.cat([torch.linalg.cross(mt, nrm, dim=1), nrm], dim=1)
    Jw = J * w[:, None]
    A = Jw.T @ J + 1e-6 * torch.eye(6, dtype=torch.float32, device=J.device)
    delta = torch.linalg.solve(A, -(Jw.T @ r))
    omega, t = delta[:3], delta[3:]
    th = torch.sqrt(torch.sum(omega * omega)) + 1e-12
    scale = torch.clamp(_OMEGA_MAX / th, max=1.0)
    omega, t, th = omega * scale, t * scale, th * scale
    k = omega / th
    zero = torch.zeros_like(k[0])
    K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                     torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    R = (torch.eye(3, dtype=torch.float32, device=K.device)
         + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K))
    return R, t


def kabsch_rotation(H):
    """The Kabsch rotation of a 3 × 3 correlation H in float32: with
    H = U S Vᵀ, R = V diag(1, 1, det(V Uᵀ)) Uᵀ, and the identity for H = 0,
    as ``_solve_point`` gets them from ``torch.linalg.svd``.

    The torch twin of the kernel's solver (csrc/icp_refine.cu,
    kabsch_rotation), step for step: a one-sided Jacobi SVD of H scaled to
    a largest entry of 1 makes the columns of A = H V orthogonal; S holds
    their norms and U their directions. U's second column is taken
    orthogonal to its first and its third is their cross product, so U is a
    rotation for a rank-deficient H too and det(V Uᵀ) is the sign of
    det(V), set on the smallest singular value."""
    H = H.to(torch.float32)
    eye = torch.eye(3, dtype=torch.float32, device=H.device)
    scale = torch.max(torch.abs(H))
    if not bool(scale > 0):
        return eye
    a = H / scale
    v = eye.clone()
    for _ in range(_JACOBI_SWEEPS):
        rotated = False
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha = torch.sum(a[:, p] * a[:, p])
            beta = torch.sum(a[:, q] * a[:, q])
            gamma = torch.sum(a[:, p] * a[:, q])
            if not bool(torch.abs(gamma)
                        > _JACOBI_TOL * torch.sqrt(alpha * beta)):
                continue
            rotated = True
            zeta = (beta - alpha) / (2.0 * gamma)
            t = torch.copysign(torch.ones_like(zeta), zeta) / (
                torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            sn = c * t
            for x in (a, v):
                xp, xq = x[:, p].clone(), x[:, q].clone()
                x[:, p] = c * xp - sn * xq
                x[:, q] = sn * xp + c * xq
        if not rotated:
            break
    sig = torch.sqrt(torch.sum(a * a, dim=0))
    o = [0, 1, 2]              # columns by singular value, largest first
    for i, j in ((0, 1), (1, 2), (0, 1)):
        if bool(sig[o[j]] > sig[o[i]]):
            o[i], o[j] = o[j], o[i]
    u0 = a[:, o[0]] / sig[o[0]]
    u1 = a[:, o[1]] - torch.sum(u0 * a[:, o[1]]) * u0
    n1 = torch.sqrt(torch.sum(u1 * u1))
    if not bool(n1 > _RANK_TOL * sig[o[0]]):
        # Rank 1: any direction orthogonal to u0.
        k = int(torch.argmin(torch.abs(u0)))
        u1 = eye[k] - u0[k] * u0
        n1 = torch.sqrt(torch.sum(u1 * u1))
    u1 = u1 / n1
    u2 = torch.linalg.cross(u0, u1)
    v0, v1, v2 = v[:, o[0]], v[:, o[1]], v[:, o[2]]
    d = -1.0 if bool(torch.sum(v0 * torch.linalg.cross(v1, v2)) < 0) else 1.0
    return (torch.outer(v0, u0) + torch.outer(v1, u1)
            + d * torch.outer(v2, u2))


def _wants_plane(point_to_plane, scene_normals) -> bool:
    """point_to_plane=None means point-to-plane iff scene_normals are
    given; point-to-plane without them raises."""
    if point_to_plane is None:
        point_to_plane = scene_normals is not None
    if point_to_plane and scene_normals is None:
        raise ValueError(
            "point-to-plane ICP requires scene_normals for the ICP cloud; "
            "pass them (icp_normals= at the match level) or use the "
            "point-to-point solver")
    return point_to_plane


def refine_pose(model_points, scene_points, init_pose, *,
                iterations: int = 12, max_dist: float,
                scene_valid=None, scene_normals=None, model_normals=None,
                point_to_plane: bool | None = None,
                normal_cos_thresh: float = 0.5) -> ICPResult:
    """Refine `init_pose` so that model_points @ Rᵀ + t aligns with
    scene_points (see the JAX package's docstring for each argument).
    point_to_plane=None means point-to-plane iff scene_normals are given.

    Where ``_build.uses_kernel`` holds (`scene_points` on a CUDA device)
    the call is one launch of the kernel, ``refine_pose_kernel``: the span
    ``icp.refine`` holding one span ``icp.kernel``. Otherwise it is
    ``refine_pose_plain``."""
    kw = dict(iterations=iterations, max_dist=max_dist,
              scene_valid=scene_valid, scene_normals=scene_normals,
              model_normals=model_normals,
              normal_cos_thresh=normal_cos_thresh)
    if not _build.uses_kernel(scene_points.device):
        return refine_pose_plain(model_points, scene_points, init_pose,
                                 point_to_plane=point_to_plane, **kw)
    with span("icp.refine"):
        plane = _wants_plane(point_to_plane, scene_normals)
        with span("icp.kernel"):
            return refine_pose_kernel(model_points, scene_points, init_pose,
                                      point_to_plane=plane, **kw)


def _rows(x, name: str, device, contiguous: bool = False):
    """x as float32 rows of 3 on `device`, with a unit column stride (a
    row-strided view such as raw[::8] is read in place)."""
    x = x.to(device=device, dtype=torch.float32)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"refine_pose_kernel: {name} must be (n, 3), got "
                         f"{tuple(x.shape)}")
    if contiguous or x.stride(1) != 1:
        x = x.contiguous()
    return x


def refine_pose_kernel(model_points, scene_points, init_pose, *,
                       iterations: int = 12, max_dist: float,
                       scene_valid=None, scene_normals=None,
                       model_normals=None, point_to_plane: bool = False,
                       normal_cos_thresh: float = 0.5,
                       kabsch_iterations: int | None = None) -> ICPResult:
    """refine_pose_plain's result from one launch of csrc/icp_refine.cu on
    the current stream (point_to_plane is a bool here). `scene_points`
    lies on a CUDA device and holds at least one point. Float32 inputs in
    place are taken as they are; others are converted first.

    With point_to_plane, the first `kabsch_iterations` iterations are
    Kabsch steps (None: min(4, iterations), as in the plain loop), so that
    one plane step can be run alone from a given pose."""
    global launches
    dev = scene_points.device
    if not _build.uses_kernel(dev):
        raise ValueError(f"refine_pose_kernel: unsupported device {dev}")
    m = _rows(model_points, "model_points", dev, contiguous=True)
    s = _rows(scene_points, "scene_points", dev)
    n_m, n_s = m.shape[0], s.shape[0]
    if n_s < 1 or iterations < 0:
        raise ValueError("refine_pose_kernel: needs a scene point and "
                         "iterations >= 0")
    if point_to_plane and scene_normals is None:
        raise ValueError("refine_pose_kernel: point-to-plane needs "
                         "scene_normals")
    gate = scene_normals is not None and model_normals is not None
    sn = (_rows(scene_normals, "scene_normals", dev)
          if gate or point_to_plane else None)
    mn = (_rows(model_normals, "model_normals", dev, contiguous=True)
          if gate else None)
    for name, t, n in (("scene_normals", sn, n_s),
                       ("model_normals", mn, n_m)):
        if t is not None and t.shape[0] != n:
            raise ValueError(f"refine_pose_kernel: {name} must have {n} "
                             "rows")
    valid = None
    if scene_valid is not None:
        valid = scene_valid.to(device=dev, dtype=torch.bool).contiguous()
        if tuple(valid.shape) != (n_s,):
            raise ValueError("refine_pose_kernel: scene_valid must be "
                             "(n_s,)")
    T = init_pose.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(T.shape) != (4, 4):
        raise ValueError("refine_pose_kernel: init_pose must be (4, 4)")
    if not point_to_plane:
        n_point_iters = iterations
    elif kabsch_iterations is None:
        n_point_iters = min(4, iterations)
    else:
        n_point_iters = kabsch_iterations
    keys = torch.empty(3 * n_m, dtype=torch.int64, device=dev)
    out = torch.empty(18, dtype=torch.float32, device=dev)
    _build.launch(
        "icp_refine", _ARGTYPES, m.data_ptr(),
        None if mn is None else mn.data_ptr(), s.data_ptr(), s.stride(0),
        None if sn is None else sn.data_ptr(),
        0 if sn is None else sn.stride(0),
        None if valid is None else valid.data_ptr(), T.data_ptr(), n_m, n_s,
        f32(max_dist) ** 2, normal_cos_thresh, iterations, n_point_iters,
        int(gate), keys.data_ptr(), out.data_ptr(), device=dev,
        no_fit="icp_refine: no block fits an SM")
    launches += 1
    return ICPResult(pose=out[:16].view(4, 4), rms=out[16],
                     inliers=out[17:].view(torch.int32)[0])


def refine_pose_plain(model_points, scene_points, init_pose, *,
                      iterations: int = 12, max_dist: float,
                      scene_valid=None, scene_normals=None,
                      model_normals=None, point_to_plane: bool | None = None,
                      normal_cos_thresh: float = 0.5) -> ICPResult:
    """refine_pose as a loop of small torch ops on any device: the CPU
    path and the kernel's twin. The call is the span ``icp.refine``, each
    iteration ``icp.iteration``."""
    with span("icp.refine"):
        point_to_plane = _wants_plane(point_to_plane, scene_normals)
        m = model_points.to(torch.float32)
        s = scene_points.to(torch.float32)
        dev = s.device
        T = init_pose.to(torch.float32)
        n_s, n_m = s.shape[0], m.shape[0]
        s_sq = torch.sum(s * s, dim=1)
        if scene_valid is not None:
            s_sq = torch.where(scene_valid, s_sq,
                               torch.full_like(s_sq, float("inf")))
        max_sq = f32(max_dist) ** 2

        ch = n_s if n_m * n_s <= _NN_TILE_BUDGET else min(_NN_CHUNK, n_s)
        n_chunks = -(-n_s // ch)
        pad = n_chunks * ch - n_s
        s_c = torch.cat([s, torch.zeros((pad, 3), device=dev)]) \
            .reshape(n_chunks, ch, 3)
        ssq_c = torch.cat([s_sq, torch.full((pad,), float("inf"),
                                            device=dev)]).reshape(n_chunks, ch)

        def nearest(mt):
            """(n_m,) global nearest index and squared distance; one
            (n_m, ch) tile at a time, first index on ties."""
            mt_sq = torch.sum(mt * mt, dim=1)[:, None]
            d2c, ic = [], []
            for sc, sqc in zip(s_c, ssq_c):
                d2 = mt_sq + sqc[None, :] - 2.0 * (mt @ sc.T)
                d2_min, i = torch.min(d2, dim=1)
                d2c.append(d2_min)
                ic.append(i)
            d2c = torch.stack(d2c)                            # (n_chunks, n_m)
            best = torch.argmin(d2c, dim=0)
            nn_d2 = torch.gather(d2c, 0, best[None, :])[0]
            nn = torch.gather(torch.stack(ic), 0, best[None, :])[0] + best * ch
            return torch.clamp(nn, 0, n_s - 1), nn_d2

        gate = scene_normals is not None and model_normals is not None
        if scene_normals is not None:
            sn = scene_normals.to(torch.float32)
            sn = sn / torch.clamp(torch.linalg.vector_norm(sn, dim=1,
                                                           keepdim=True),
                                  min=1e-12)
        if model_normals is not None:
            mn = model_normals.to(torch.float32)

        n_point_iters = min(4, iterations) if point_to_plane else iterations
        rms = torch.zeros((), device=dev)
        inliers = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(iterations):
            with span("icp.iteration"):
                mt = m @ T[:3, :3].T + T[:3, 3]
                nn, nn_d2 = nearest(mt)
                w = (nn_d2 < max_sq).to(torch.float32)
                if gate:
                    mnt = mn @ T[:3, :3].T
                    w = w * (torch.sum(mnt * sn[nn], dim=1)
                             > normal_cos_thresh).to(torch.float32)
                tgt = s[nn]
                wsum = torch.clamp(torch.sum(w), min=1.0)
                if i < n_point_iters:
                    R, t = _solve_point(mt, tgt, w, wsum)
                else:
                    R, t = _solve_plane(mt, tgt, sn[nn], w)
                dT = torch.eye(4, dtype=torch.float32, device=dev)
                dT[:3, :3] = R
                dT[:3, 3] = t
                T = dT @ T
                rms = torch.sqrt(torch.sum(w * nn_d2) / wsum)
                inliers = torch.sum(w).to(torch.int32)
        return ICPResult(pose=T, rms=rms, inliers=inliers)
