"""ICP pose refinement, point-to-point (Kabsch) and point-to-plane.

Port of ``objective_slam_tpu.ops.icp.refine_pose`` (icp.py:30-222): a fixed
number of iterations; nearest neighbours from the ‖a‖² + ‖b‖² − 2a·b
distance tile, chunked over scene points; distance rejection and the
optional normal gate; a weighted Kabsch solve, or the clamped linearized
6×6 point-to-plane solve after the first Kabsch iterations. All matrix
products run in full float32 (TF32 is off package-wide).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from objective_slam_tpu_torch._common import f32
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


def refine_pose(model_points, scene_points, init_pose, *,
                iterations: int = 12, max_dist: float,
                scene_valid=None, scene_normals=None, model_normals=None,
                point_to_plane: bool | None = None,
                normal_cos_thresh: float = 0.5) -> ICPResult:
    """Refine `init_pose` so that model_points @ Rᵀ + t aligns with
    scene_points (see the JAX package's docstring for each argument).
    point_to_plane=None means point-to-plane iff scene_normals are given.
    The call is the span ``icp.refine``, each iteration ``icp.iteration``."""
    with span("icp.refine"):
        if point_to_plane is None:
            point_to_plane = scene_normals is not None
        if point_to_plane and scene_normals is None:
            raise ValueError(
                "point-to-plane ICP requires scene_normals for the ICP cloud; "
                "pass them (icp_normals= at the match level) or use the "
                "point-to-point solver")
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
