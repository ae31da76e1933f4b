"""Dense pose clustering (port of ``objective_slam_tpu.ops.clustering``,
clustering.py:37-113).

Each candidate sums the weighted counts of candidates in the adjacent
translation grid cells (trunc-of-fmod cells, kernel.cu:675-678) whose
quaternion distance |8(1 − q·q′)| < rot_thresh² and, unless use_l1_norm,
whose translation distance is below d_dist (kernel.cu:702-763).

The P×P masks are built axis by axis, so no (P, P, 3) tensor is formed;
the result is the same as the JAX package's broadcast form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from objective_slam_tpu_torch._common import f32


class ClusterResult(NamedTuple):
    vote_counts: torch.Tensor   # (P,) float32 clustered weighted counts
    translations: torch.Tensor  # (P, 3) float32 (cluster-averaged or not)


def cluster_poses_dense(translations, quats, weighted_counts, valid,
                        d_dist, rot_thresh, *, include_center_cell: bool,
                        use_l1_norm: bool, use_averaged_clusters: bool
                        ) -> ClusterResult:
    """Dense equivalent of rot_clustering_kernel (kernel.cu:702-763).

    include_center_cell=False keeps the reference quirk: a pose's own grid
    cell (and so the pose itself) is excluded and its tally starts at 1
    (kernel.cu:684-689, 722); True counts all 27 cells, seed 0."""
    t = translations.to(torch.float32)
    q = quats.to(torch.float32)
    w = weighted_counts.to(torch.float32)
    d = f32(d_dist)

    cell = torch.trunc((t - torch.fmod(t, d)) / d).to(torch.int32)  # (P, 3)

    adjacent = None
    same_cell = None
    sq = None
    for k in range(3):
        dc = cell[:, None, k] - cell[None, :, k]
        adj_k = torch.abs(dc) <= 1
        same_k = dc == 0
        adjacent = adj_k if adjacent is None else adjacent & adj_k
        same_cell = same_k if same_cell is None else same_cell & same_k
        if not use_l1_norm:
            dt = t[:, None, k] - t[None, :, k]
            sq = dt * dt if sq is None else sq + dt * dt
    if not include_center_cell:
        adjacent = adjacent & ~same_cell

    qdot = q @ q.T
    mask = adjacent & (torch.abs(8.0 * (1.0 - qdot)) < f32(rot_thresh) ** 2)
    if not use_l1_norm:
        mask = mask & (torch.sqrt(sq) < d)
    mask = mask & valid[None, :] & valid[:, None]

    mf = mask.to(torch.float32)
    neighbor_sum = mf @ w
    seed = 0.0 if include_center_cell else 1.0
    counts_out = neighbor_sum + seed

    if use_averaged_clusters:
        # The reference's sequential weighted average (kernel.cu:747-752)
        # telescopes to (seed·t_i + Σ w_j t_j) / (seed + Σ w_j).
        t_sum = mf @ (w[:, None] * t) + seed * t
        denom = neighbor_sum + seed
        t_out = t_sum / torch.where(denom > 0, denom,
                                    torch.ones_like(denom))[:, None]
    else:
        t_out = t

    counts_out = torch.where(valid, counts_out, torch.zeros_like(counts_out))
    return ClusterResult(vote_counts=counts_out, translations=t_out)
