"""Point-cloud preprocessing: voxel grids, normal estimation, the model
diameter, downsamplers, scene centering, mesh normals and sampling.

Port of ``objective_slam_tpu.utils.pointcloud``. The device functions
(``voxel_downsample``, ``estimate_normals_knn``, ``estimate_normals_grid``,
``smooth_normals_grid``) run on the device of their input tensor; a numpy
input goes to the current CUDA device unless ``device`` says otherwise.
The rest is numpy, copied from the JAX package.

Per-cell sums are taken over sorted, contiguous segments with
``torch.segment_reduce`` rather than float atomics, so the results are the
same from run to run on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import as_tensor, f32


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


def bbox_center_radius(points) -> float:
    """Max distance from the bbox center, the MATLAB diameter convention
    (model_description.m:5-13); d_dist = 0.1 · this."""
    p = np.asarray(points, np.float64)
    center = (p.min(axis=0) + p.max(axis=0)) / 2
    return float(np.linalg.norm(p - center, axis=1).max())


def random_downsample(points, normals, fraction, seed=0):
    """Keep ⌊fraction·n⌋ random points (alignment.cpp:57-64)."""
    n = np.asarray(points).shape[0]
    k = int(fraction * n)
    idx = np.random.default_rng(seed).permutation(n)[:k]
    nrm = None if normals is None else np.asarray(normals)[idx]
    return np.asarray(points)[idx], nrm


def sequential_downsample(points, normals, step: int):
    """Keep every step-th point (alignment.cpp:67-76)."""
    nrm = None if normals is None else np.asarray(normals)[::step]
    return np.asarray(points)[::step], nrm


def center_scene(points, offset=1.0):
    """Translate so that the centroid sits at (offset, offset, offset)
    (scene_generation.hpp:88-103). Returns (points, T_applied)."""
    p = np.asarray(points, np.float32)
    shift = -p.mean(axis=0) + offset
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = shift
    return p + shift, T


def _det3(m):
    """Determinant of (n, 3, 3) matrices, closed form."""
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def _smallest_eigvec_sym3(cov):
    """Unit eigenvector of the smallest eigenvalue of each symmetric 3×3,
    closed form (pointcloud.py:185-223): trigonometric eigenvalues, then
    the largest cross product of two rows of cov − λI. Isotropic or zero
    neighbourhoods fall back to +z.

    cov: (n, 3, 3) float32 symmetric. Returns (n, 3) unit vectors."""
    eye = torch.eye(3, dtype=torch.float32, device=cov.device)
    q = (cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2]) / 3.0
    B = cov - q[:, None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    half_det = _det3(B / p[:, None, None]) / 2.0
    phi = torch.arccos(torch.clamp(half_det, -1.0, 1.0)) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + f32(2.0 * np.pi / 3.0))

    M = cov - lam_min[:, None, None] * eye
    c0 = torch.linalg.cross(M[:, 0], M[:, 1])
    c1 = torch.linalg.cross(M[:, 0], M[:, 2])
    c2 = torch.linalg.cross(M[:, 1], M[:, 2])
    n0 = torch.sum(c0 * c0, dim=-1)
    n1 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    best = torch.where(((n1 >= n0) & (n1 >= n2))[:, None], c1,
                       torch.where((n2 >= n0)[:, None], c2, c0))
    nbest = torch.maximum(n0, torch.maximum(n1, n2))
    unit = best / torch.clamp(torch.linalg.norm(best, dim=-1, keepdim=True),
                              min=1e-30)
    fallback = torch.tensor([0.0, 0.0, 1.0], device=cov.device).expand_as(unit)
    ok = (nbest > 1e-20) & (p2 > 1e-24)
    return torch.where(ok[:, None], unit, fallback)


def _orient(normal, p, viewpoint, orient):
    """Flip normals toward the viewpoint, or away from the cloud centroid
    when orient == "outward"."""
    if orient == "outward":
        ref_dir = p - torch.mean(p, dim=0)
    else:
        ref_dir = torch.as_tensor(viewpoint, dtype=torch.float32,
                                  device=p.device) - p
    flip = torch.sum(normal * ref_dir, dim=-1) < 0
    return torch.where(flip[:, None], -normal, normal)


# Rows of the distance matrix re-read at once to break ties at the k-th
# neighbour: a float32 copy and a float32 key of this many bytes each.
_TIE_CHUNK_BYTES = 256 << 20


def _sq_dist(p, fused_norms: bool = False):
    """The (n, n) float32 matrix ‖a‖² + ‖b‖² − 2a·b of the JAX package
    (pointcloud.py:246-249), rounded as XLA:CPU rounds it, on any device:
    a·b as the fused multiply-add chain fma(z, z', fma(y, y', x·x')) that
    the CPU matrix products evaluate, and ‖a‖² as (x² + y²) + z² where the
    JAX function runs eagerly, or as fma(z, z, fma(y, y, x²)) where a
    compiled caller fuses the squares into their sum (fused_norms; the
    TSDF surface extraction). A cuBLAS product need not round a·b so, and
    on regular grids an ulp decides which neighbour is k-th."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    if fused_norms:
        sq = torch.addcmul(torch.addcmul(x * x, y, y), z, z)
    else:
        sq = (x * x + y * y) + z * z
    dot = torch.outer(x, x)
    dot.addcmul_(y[:, None], y[None, :])
    dot.addcmul_(z[:, None], z[None, :])
    d2 = sq[:, None] + sq[None, :]
    return d2.sub_(dot, alpha=2.0)


def knn_indices(p, k: int, fused_norms: bool = False):
    """The k nearest points of each point of p (n, 3), self included, as
    `lax.top_k(-d2, k)` gives them (pointcloud.py:250-252): the k smallest
    d2 = ‖a‖² + ‖b‖² − 2a·b of each row, in ascending d2 and, among equal
    d2, ascending column. `torch.topk` keeps an arbitrary subset of the
    values tied at the k-th place; a row where the (k+1)-th value equals
    the k-th has its tied places refilled with the lowest tied columns.
    fused_norms as in `_sq_dist`. Returns (n, k) int64."""
    n = p.shape[0]
    k = min(k, n)
    d2 = _sq_dist(p, fused_norms)
    kk = min(k + 1, n)
    neg, idx = torch.topk(-d2, kk, dim=1)          # -d2 descending
    val = -neg[:, :k]                               # d2 ascending
    idx = idx[:, :k].contiguous()
    if kk > k:
        t = val[:, k - 1]
        tied_rows = torch.nonzero(-neg[:, k] == t)[:, 0]
        # Places that hold the k-th value: the last (k − first) of the row.
        first = torch.sum(val < t[:, None], dim=1)
        step = max(1, _TIE_CHUNK_BYTES // (4 * n))
        col = torch.arange(n, device=p.device, dtype=torch.float32)
        for lo in range(0, tied_rows.numel(), step):
            r = tied_rows[lo:lo + step]
            # The lowest columns at d2 == t, ascending: top-k of −column.
            key = torch.where(d2[r] == t[r, None], -col, -math.inf)
            low = (-torch.topk(key, k, dim=1).values).to(torch.int64)
            f = first[r]
            place = torch.arange(k, device=p.device)
            from_low = torch.clamp(place[None, :] - f[:, None], min=0)
            idx[r] = torch.where(place[None, :] < f[:, None], idx[r],
                                 torch.gather(low, 1, from_low))
    # Equal d2 in ascending column: sort by column, then stably by d2.
    idx, _ = torch.sort(idx, dim=1)
    order = torch.sort(torch.gather(d2, 1, idx), dim=1, stable=True).indices
    del d2
    return torch.gather(idx, 1, order)


def estimate_normals_knn(points, k: int = 16, viewpoint=(0.0, 0.0, 0.0),
                         orient: str = "viewpoint", device=None,
                         fused_norms: bool = False):
    """k-NN PCA surface normals (pointcloud.py:226-266): the k nearest
    points of `knn_indices` (self included) and the smallest-eigenvalue
    eigenvector of each neighbourhood covariance, summed over the
    neighbours in that order.

    orient "viewpoint" flips toward `viewpoint` (range scans); "outward"
    flips away from the cloud centroid (closed objects). Model and scene
    need the same convention. The distance matrix takes 4·n² bytes, as in
    the JAX package (2.7 GB at 26,000 points), and twice that while it is
    built. fused_norms: the distances as the JAX function rounds them
    inside a compiled caller (`_sq_dist`)."""
    p = as_tensor(points, device)
    k = min(k, p.shape[0])
    nbrs = p[knn_indices(p, k, fused_norms)]                                   # (n, k, 3)
    centered = nbrs - torch.mean(nbrs, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    return _orient(_smallest_eigvec_sym3(cov), p, viewpoint, orient)


def _grid_dims(p, radius):
    """(dx, dy, dz) of the grid at leaf `radius` over the cloud's bbox,
    computed on the host (pointcloud.py:313-318)."""
    ext = (torch.max(p, dim=0).values - torch.min(p, dim=0).values) \
        .cpu().numpy()
    return tuple(int(d) + 1 for d in
                 np.floor(ext / float(radius)).astype(np.int64))


def _grid_keys(p, radius, dims):
    """Flat cell id of each point, clipped into the grid."""
    dx, dy, dz = dims
    lo = torch.min(p, dim=0).values
    cell = torch.floor((p - lo) / f32(radius)).to(torch.int64)
    cell = torch.minimum(torch.clamp(cell, min=0),
                         torch.tensor([dx - 1, dy - 1, dz - 1],
                                      device=p.device))
    return (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]


def _cell_sums(values, key, n_cells):
    """Per-cell sums of the rows of `values` (n, c) -> (n_cells, c), each
    cell's rows added in point order."""
    order = torch.argsort(key, stable=True)
    lengths = torch.bincount(key, minlength=n_cells)
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                unsafe=True, initial=0.0)


def _box3(x):
    """27-cell box sum over the leading three (grid) axes of x, as three
    separable width-3 passes (pointcloud.py:269-276)."""
    for ax in range(3):
        size = x.shape[ax]
        lo = torch.zeros_like(x)
        hi = torch.zeros_like(x)
        if size > 1:
            lo.narrow(ax, 1, size - 1).copy_(x.narrow(ax, 0, size - 1))
            hi.narrow(ax, 0, size - 1).copy_(x.narrow(ax, 1, size - 1))
        x = x + lo + hi
    return x


def _box_gather(mom, key, dims, box_filter=True):
    """Each point's neighbourhood sums of the per-point rows `mom`: the
    cell sums, box-filtered over the 27-cell neighbourhood, gathered back
    with one row gather."""
    dx, dy, dz = dims
    n_cells = dx * dy * dz
    c = mom.shape[1]
    grid = _cell_sums(mom, key, n_cells)
    if box_filter:
        grid = _box3(grid.reshape(dx, dy, dz, c)).reshape(n_cells, c)
    return grid[key]


def _sym3(diag, off):
    """(n, 3, 3) symmetric matrices from (xx, yy, zz) and (xy, xz, yz)."""
    return torch.stack([
        torch.stack([diag[:, 0], off[:, 0], off[:, 1]], dim=-1),
        torch.stack([off[:, 0], diag[:, 1], off[:, 2]], dim=-1),
        torch.stack([off[:, 1], off[:, 2], diag[:, 2]], dim=-1)], dim=-2)


_XY = ([0, 0, 1], [1, 2, 2])      # the (xy, xz, yz) index pairs


def estimate_normals_grid(points, radius, viewpoint=(0.0, 0.0, 0.0),
                          orient: str = "viewpoint", dims=None,
                          box_filter: bool = True, device=None):
    """Surface normals for large raw scans in O(n + grid)
    (pointcloud.py:279-360): bucket the points into a grid at leaf =
    radius, sum per-cell first and second moments, box-filter them over
    the 27-cell neighbourhood, read each point's sums back and solve the
    batched 3×3 eigenproblem. box_filter=False takes the point's own cell
    only (for surfaces that curve within a few radii).

    dims: optional (dx, dy, dz) grid shape; from the cloud's bbox when
    omitted. orient as in estimate_normals_knn."""
    p = as_tensor(points, device)
    if dims is None:
        dims = _grid_dims(p, radius)
    key = _grid_keys(p, radius, dims)
    # Per-cell moments: [1, x, y, z, xx, yy, zz, xy, xz, yz].
    mom = torch.cat([torch.ones_like(p[:, :1]), p, p * p,
                     p[:, _XY[0]] * p[:, _XY[1]]], dim=1)         # (n, 10)
    s = _box_gather(mom, key, dims, box_filter)
    cnt = torch.clamp(s[:, 0], min=1.0)[:, None]
    mu = s[:, 1:4] / cnt
    # cov = E[ppᵀ] − μμᵀ about the window mean.
    cov = _sym3(s[:, 4:7] / cnt - mu * mu,
                s[:, 7:10] / cnt - mu[:, _XY[0]] * mu[:, _XY[1]])
    return _orient(_smallest_eigvec_sym3(cov), p, viewpoint, orient)


def smooth_normals_grid(points, normals, radius, dims=None,
                        iterations: int = 1, order: int = 0,
                        ridge: float = 0.05, device=None):
    """Smooth a noisy normal field over the 27-cell grid neighbourhood at
    leaf = radius (pointcloud.py:363-468); each output keeps the hemisphere
    of its input.

    order 0 is the box average. order 1 fits the normal field linearly on
    position over the window, n(x) ≈ n̄ + Bᵀ(x − c), and evaluates it at the
    query point, which cancels the window's first-order curvature bias; it
    costs a 22-channel moment grid and a 3×3 solve per point, damped by
    `ridge` · mean(trace(Cxx))."""
    p = as_tensor(points, device)
    out = as_tensor(normals, p.device)
    if dims is None:
        dims = _grid_dims(p, radius)
    key = _grid_keys(p, radius, dims)
    # Coordinates about the cloud mean keep the second moments small.
    x = p - torch.mean(p, dim=0)

    for _ in range(iterations):
        if order == 0:
            s = _box_gather(out, key, dims)
        else:
            # Moments: [1, x(3), n(3), xxᵀ(6 sym), x⊗n(9)] = 22 channels.
            mom = torch.cat([
                torch.ones_like(x[:, :1]), x, out, x * x,
                x[:, _XY[0]] * x[:, _XY[1]],
                (x[:, :, None] * out[:, None, :]).reshape(-1, 9)], dim=1)
            s22 = _box_gather(mom, key, dims)
            cnt = torch.clamp(s22[:, 0], min=1.0)[:, None]
            c = s22[:, 1:4] / cnt                         # window centroid
            nbar = s22[:, 4:7] / cnt                      # window mean normal
            cxx = _sym3(s22[:, 7:10] / cnt - c * c,
                        s22[:, 10:13] / cnt - c[:, _XY[0]] * c[:, _XY[1]])
            exn = s22[:, 13:22].reshape(-1, 3, 3) / cnt[:, :, None]
            cxn = exn - c[:, :, None] * nbar[:, None, :]  # Cov(x, n)
            tr = (cxx[:, 0, 0] + cxx[:, 1, 1] + cxx[:, 2, 2]) / 3.0
            lam = (f32(ridge) * tr + 1e-12)[:, None, None]
            A = cxx + lam * torch.eye(3, dtype=torch.float32, device=p.device)
            # B = A⁻¹ Cxn; n(p) = n̄ + Bᵀ (p − c).
            B = torch.linalg.solve(A, cxn)
            s = nbar + torch.sum(B * (x - c)[:, :, None], dim=1)
            # Single-point or degenerate windows keep the mean.
            s = torch.where((cnt > 3.0) & (tr[:, None] > 1e-20), s, nbar)
        norm = torch.linalg.norm(s, dim=1, keepdim=True)
        sm = s / torch.where(norm > 1e-12, norm, 1.0)
        flip = torch.sum(sm * out, dim=-1, keepdim=True) < 0
        sm = torch.where(flip, -sm, sm)
        # A cancelled average falls back to the input normal.
        out = torch.where(norm > 1e-6, sm, out)
    return out


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


def sample_mesh_surface(points, faces, n, rng):
    """Uniform area-weighted point sampling of a triangle mesh surface
    (pointcloud.py:486-520), with barycentrically interpolated vertex
    normals. Decimated meshes crowd their vertices at high curvature;
    sampling by area gives the even coverage of a range scan.

    Returns (points (n, 3) float32, normals (n, 3) float32)."""
    p = np.asarray(points, np.float64)
    f = np.asarray(faces, np.int64)
    vn = mesh_vertex_normals(p, f).astype(np.float64)
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    tri = rng.choice(len(f), size=n, p=area / area.sum())
    # Uniform barycentric coordinates by the square-root trick.
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    b0, b1, b2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    fi = f[tri]
    pts = (b0[:, None] * p[fi[:, 0]] + b1[:, None] * p[fi[:, 1]]
           + b2[:, None] * p[fi[:, 2]])
    nrm = (b0[:, None] * vn[fi[:, 0]] + b1[:, None] * vn[fi[:, 1]]
           + b2[:, None] * vn[fi[:, 2]])
    norms = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.where(norms > 1e-12, norms, 1.0)
    return pts.astype(np.float32), nrm.astype(np.float32)


def write_trans_adj(path, T) -> None:
    """Write the translation-adjustment sidecar the MATLAB preprocessing
    puts next to each PLY (compute_trans_adj.m:1-16): the 4x4 transform
    that moved the cloud into its stored frame."""
    with open(path, "w") as f:
        for row in np.asarray(T, np.float32):
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def read_trans_adj(path):
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    return np.asarray(vals[:16], np.float32).reshape(4, 4)
