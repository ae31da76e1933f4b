"""Geometric pose verification: inlier rescoring of candidate poses.

Port of ``objective_slam_tpu.ops.verify_pose`` (verify_pose.py:28-86).
Each candidate is scored by the fraction of model points whose transformed
position has a scene point within ``max_dist`` and, when normals are given,
whose rotated normal agrees with that scene point's. Enabled by
``PPFConfig.rescore_poses``.
"""

from __future__ import annotations

import torch

from objective_slam_tpu_torch._common import f32

# Bytes the (chunk, n_m, n_s) float32 distance tensors of one step may
# take; three of them are alive at once. At 250 model points and 4,992
# scene points this gives 143 candidates a step.
_CHUNK_BUDGET_BYTES = 2 << 30


def _unit_rows(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                           min=1e-9)


def inlier_scores(poses, valid, model_points, scene_points, max_dist,
                  model_normals=None, scene_normals=None,
                  cos_thresh: float = 0.7, chunk: int | None = None):
    """Fraction of model points explained by the scene, per candidate.

    poses (P, 4, 4) model -> scene; valid (P,) bool; model_points (n_m, 3);
    scene_points (n_s, 3), padding rows at far sentinels are harmless.
    Invalid candidates score -1. `chunk` candidates are scored per step; it
    only bounds memory (every chunk size gives the same scores) and
    defaults to what fits _CHUNK_BUDGET_BYTES."""
    m = model_points.to(torch.float32)
    s = scene_points.to(torch.float32)
    use_normals = model_normals is not None and scene_normals is not None
    if use_normals:
        mn = _unit_rows(model_normals.to(torch.float32))
        sn = _unit_rows(scene_normals.to(torch.float32))
    P = poses.shape[0]
    if chunk is None:
        chunk = _CHUNK_BUDGET_BYTES // (3 * 4 * m.shape[0] * s.shape[0])
    chunk = max(1, min(int(chunk), P))
    s_sq = torch.sum(s * s, dim=1)
    max_sq = f32(max_dist) ** 2

    scores = []
    for lo in range(0, P, chunk):
        T = poses[lo:lo + chunk]
        R = T[:, :3, :3]
        mt = torch.einsum("cij,nj->cni", R, m) + T[:, None, :3, 3]
        # ‖a‖² + ‖b‖² − 2a·b, as the JAX package expands it.
        d2 = (torch.sum(mt * mt, dim=-1)[..., None] + s_sq[None, None, :]
              - 2.0 * torch.einsum("cni,si->cns", mt, s))
        nn_d2, nn_idx = torch.min(d2, dim=-1)
        ok = nn_d2 < max_sq
        if use_normals:
            mnt = torch.einsum("cij,nj->cni", R, mn)
            ok = ok & (torch.sum(mnt * sn[nn_idx], dim=-1) > f32(cos_thresh))
        scores.append(ok.to(torch.float32).mean(dim=-1))
    scores = torch.cat(scores) if scores else poses.new_zeros(0)
    return torch.where(valid, scores, -1.0)
