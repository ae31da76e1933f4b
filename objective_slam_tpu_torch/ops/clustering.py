"""Pose clustering (port of ``objective_slam_tpu.ops.clustering``,
clustering.py:37-186): the dense device clustering of the match path and
the host greedy clustering of the reference's CPU mode.

Each candidate sums the weighted counts of candidates in the adjacent
translation grid cells (trunc-of-fmod cells, kernel.cu:675-678) whose
quaternion distance |8(1 − q·q′)| < rot_thresh² and, unless use_l1_norm,
whose translation distance is below d_dist (kernel.cu:702-763).

The P×P masks are built axis by axis, so no (P, P, 3) tensor is formed;
the result is the same as the JAX package's broadcast form.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class GreedyCluster(NamedTuple):
    poses: np.ndarray   # (k, 4, 4) averaged cluster poses, votes descending
    votes: np.ndarray   # (k,) summed votes


def _quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z) (clustering.py:135)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    w = 0.5 * np.sqrt(max(1.0 + tr, 0.0))
    x = np.copysign(0.5 * np.sqrt(max(1 + R[0, 0] - R[1, 1] - R[2, 2], 0)),
                    R[2, 1] - R[1, 2])
    y = np.copysign(0.5 * np.sqrt(max(1 - R[0, 0] + R[1, 1] - R[2, 2], 0)),
                    R[0, 2] - R[2, 0])
    z = np.copysign(0.5 * np.sqrt(max(1 - R[0, 0] - R[1, 1] + R[2, 2], 0)),
                    R[1, 0] - R[0, 1])
    q = np.array([w, x, y, z])
    n = np.linalg.norm(q)
    return q / n if n > 0 else q


def cluster_poses_greedy(poses, votes, trans_thresh, rot_thresh,
                         max_clusters: int = 3) -> GreedyCluster:
    """Host greedy clustering, a numpy copy of the JAX package's
    (clustering.py:121-186; clusterPoses, transformation_clustering.cpp:
    62-123): poses by votes descending join the first cluster whose seed is
    within (trans_thresh, rot_thresh); the top clusters' translations and
    quaternions are averaged."""
    poses = np.asarray(poses, np.float32)
    votes = np.asarray(votes, np.float32)
    order = np.argsort(-votes, kind="stable")
    seeds: list[int] = []
    members: list[list[int]] = []
    cluster_votes: list[float] = []
    for i in order:
        placed = False
        for c, seed in enumerate(seeds):
            s = poses[seed]
            p = poses[i]
            tdist = np.linalg.norm(s[:3, 3] - p[:3, 3])
            Rrel = s[:3, :3].T @ p[:3, :3]
            ang = abs(np.arccos(np.clip((np.trace(Rrel) - 1) / 2, -1, 1)))
            if tdist < trans_thresh and ang < rot_thresh:
                members[c].append(i)
                cluster_votes[c] += float(votes[i])
                placed = True
                break
        if not placed:
            seeds.append(i)
            members.append([i])
            cluster_votes.append(float(votes[i]))

    order_c = np.argsort(-np.asarray(cluster_votes), kind="stable")
    k = min(max_clusters, len(order_c))
    out = np.zeros((k, 4, 4), np.float32)
    out_votes = np.zeros((k,), np.float32)
    for oi, c in enumerate(order_c[:k]):
        ts = poses[members[c], :3, 3].mean(axis=0)
        qs = np.stack([_quat(poses[m][:3, :3]) for m in members[c]])
        q_avg = qs.mean(axis=0)
        q_avg /= np.linalg.norm(q_avg)
        w, x, y, z = q_avg
        out[oi, :3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        out[oi, :3, 3] = ts
        out[oi, 3, 3] = 1.0
        out_votes[oi] = cluster_votes[c]
    return GreedyCluster(poses=out, votes=out_votes)
