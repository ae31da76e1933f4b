"""Voxel-grid downsampling, the model diameter and mesh normals.

Port of part of ``objective_slam_tpu.utils.pointcloud`` (pointcloud.py:
30-164, 471-483): the device voxel grid (``voxel_downsample``, the bench
and CLI front end), its numpy copy, ``bbox_diameter`` and
``mesh_vertex_normals``. Both voxel grids take ``normal_aware``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import f32


class VoxelizedCloud(NamedTuple):
    """Padded, static-shape voxel-grid output.

    points/normals (capacity, 3): rows >= num_voxels are padding at a far
    sentinel (no PPF key can match them) with zero normals.
    num_voxels () int32; dropped () bool — more occupied voxels than
    capacity (the excess merged into the last row; raise capacity)."""
    points: torch.Tensor
    normals: torch.Tensor
    num_voxels: torch.Tensor
    dropped: torch.Tensor


# Padding rows sit this far below the cloud: every pair distance bin to
# them overflows max_dist_bin and maps to INVALID_KEY.
_PAD_OFFSET = 1.0e7


def voxel_downsample(points, normals, leaf, capacity: int | None = None,
                     normal_aware: bool = False) -> VoxelizedCloud:
    """Per-voxel centroids of points and normals (pcl::VoxelGrid,
    alignment.cpp:79-87): cell keys -> stable sort -> segment means
    (pointcloud.py:50-109). Sorted segments are contiguous, so they are
    summed with a segment reduction rather than float atomics: the
    centroids are the same from run to run on the card.

    normal_aware extends the cell key with the normal's octant (three sign
    bits), so that geometry thinner than the leaf keeps one point per
    side."""
    p = points.to(torch.float32)
    nr = normals.to(torch.float32)
    n = p.shape[0]
    dev = p.device
    if capacity is None:
        capacity = n

    lo = torch.min(p, dim=0).values
    cell = torch.floor((p - lo) / f32(leaf)).to(torch.int32)      # (n, 3)
    dims = torch.max(cell, dim=0).values + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    if normal_aware:
        key = key * 8 + _octant(nr)

    order = torch.argsort(key, stable=True)
    skey = key[order]
    new_seg = torch.ones(n, dtype=torch.int32, device=dev)
    new_seg[1:] = (skey[1:] != skey[:-1]).to(torch.int32)
    seg = torch.cumsum(new_seg, 0, dtype=torch.int32) - 1
    num_voxels = seg[-1] + 1
    dropped = num_voxels > capacity
    seg = torch.clamp(seg, max=capacity - 1).to(torch.int64)

    lengths = torch.bincount(seg, minlength=capacity)
    psum = torch.segment_reduce(p[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)
    nsum = torch.segment_reduce(nr[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)
    denom = torch.clamp(lengths, min=1).to(torch.float32)[:, None]

    valid = (torch.arange(capacity, device=dev) < num_voxels)[:, None]
    out_p = torch.where(valid, psum / denom, lo - f32(_PAD_OFFSET))
    out_n = torch.where(valid, nsum / denom, torch.zeros_like(nsum))
    return VoxelizedCloud(points=out_p, normals=out_n,
                          num_voxels=num_voxels, dropped=dropped)


def _octant(nr):
    """Normal octant code 0..7 (sign bits of x, y, z)."""
    return ((nr[:, 0] > 0).to(torch.int32) + 2 * (nr[:, 1] > 0).to(torch.int32)
            + 4 * (nr[:, 2] > 0).to(torch.int32))


def voxel_downsample_np(points, normals, leaf, normal_aware: bool = False):
    """Host-side exact voxel grid (dynamic output size), a numpy copy of
    the JAX package's (pointcloud.py:112-137)."""
    p = np.asarray(points, np.float64)
    nr = np.asarray(normals, np.float64) if normals is not None else None
    lo = p.min(axis=0)
    cell = np.floor((p - lo) / leaf).astype(np.int64)
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    if normal_aware:
        if nr is None:
            raise ValueError("normal_aware downsampling requires normals")
        key = key * 8 + ((nr[:, 0] > 0).astype(np.int64)
                         + 2 * (nr[:, 1] > 0).astype(np.int64)
                         + 4 * (nr[:, 2] > 0).astype(np.int64))
    order = np.argsort(key, kind="stable")
    skey = key[order]
    _, start, cnt = np.unique(skey, return_index=True, return_counts=True)
    out_p = np.add.reduceat(p[order], start, axis=0) / cnt[:, None]
    out_n = None
    if nr is not None:
        out_n = np.add.reduceat(nr[order], start, axis=0) / cnt[:, None]
        out_n = out_n.astype(np.float32)
    return out_p.astype(np.float32), out_n


def bbox_diameter(points) -> float:
    """Max bbox edge — the CLI's model-diameter estimate
    (alignment.cpp:246-253)."""
    p = np.asarray(points)
    return float((p.max(axis=0) - p.min(axis=0)).max())


def mesh_vertex_normals(points, faces):
    """Area-weighted vertex normals of a triangle mesh (pointcloud.py:
    471-483; compute_normals.m), in numpy."""
    p = np.asarray(points, np.float64)
    f = np.asarray(faces, np.int64)
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(p)
    for c in range(3):
        np.add.at(out, f[:, c], fn)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    out = out / np.where(norms > 0, norms, 1.0)
    return out.astype(np.float32)
