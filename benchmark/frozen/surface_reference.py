"""Plain reference of surface extraction from a TSDF volume, written from
the extraction's definition in plain PyTorch.

It imports nothing of the program and reads only the volume (its tsdf and
weight grids, origin and voxel size):

  * the near-surface set: observed voxels (weight > 0) with |tsdf| <
    iso_band · voxel_size, the product in float32;
  * the rows: the `capacity` near voxels with the smallest |tsdf|, ties in
    voxel order (a stable sort), at their centres (index + ½)·voxel_size +
    origin;
  * the normals: neighbourhood PCA over the rows, the smallest
    eigenvector of each covariance (`torch.linalg.eigh`, on the host). Up
    to 8,192 rows the k = 12 nearest rows by ‖a‖² + ‖b‖² − 2a·b (self
    included, ties in row order); above, the moment grid: leaf
    2·voxel_size from the rows' least corner, per-cell sums of [1, p, p²,
    the cross products], summed over the 27 cells around each row's cell,
    cov = E[ppᵀ] − μμᵀ. Every other row's centre lies on a cell's face,
    where the float32 roundings of the centre and of the quotient
    (p − corner) / leaf decide its cell; the reference takes the ones the
    extraction documents: the centre by one fused multiply-add (addcmul),
    the quotient as torch divides a tensor by a Python float;
  * orientation: each normal turned to the side of the volume's
    central-difference gradient (one-sided on the grid's faces) at its row.

Everything runs in float32 with TF32 off. ``reference.Precision(tf32=True)``
rounds both operands of every product of coordinates (the moments, the
kNN distances and covariances) to TF32: the control, the same reference
one precision step lower.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import reference as _ppf

KNN_ROWS = 8192          # up to this capacity the k-NN neighbourhood
KNN_K = 12


class Surface(NamedTuple):
    index: torch.Tensor      # (n,) int64 flat voxel index of each row
    points: torch.Tensor     # (n, 3) float32 voxel centres
    normals: torch.Tensor    # (n, 3) float32 oriented unit normals
    count: int               # near-surface voxels (may exceed capacity)


def tf32_off():
    """Products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mul(prec: _ppf.Precision, a, b):
    if prec.tf32:
        a, b = _ppf.tf32_round(a), _ppf.tf32_round(b)
    return a * b


def near_surface(tsdf, weight, voxel_size: float, iso_band: float = 0.5):
    """(D, H, W) bool: observed voxels within iso_band voxels of the
    surface."""
    thr = torch.tensor(iso_band, dtype=torch.float32) * torch.tensor(
        voxel_size, dtype=torch.float32)
    return (torch.abs(tsdf) < thr.to(tsdf.device)) & (weight > 0)


def rows(tsdf, weight, voxel_size: float, capacity: int,
         iso_band: float = 0.5):
    """(flat indices of the rows, near-surface count)."""
    near = torch.nonzero(near_surface(tsdf, weight, voxel_size, iso_band)
                         .reshape(-1)).reshape(-1)
    _, order = torch.sort(torch.abs(tsdf.reshape(-1)[near]), stable=True)
    return near[order[:capacity]], int(near.shape[0])


def centres(index, dims, origin, voxel_size: float):
    """(index + ½)·voxel_size + origin, with one rounding (addcmul)."""
    D, H, W = dims
    ijk = torch.stack([index // (H * W), (index // W) % H, index % W], -1)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=index.device)
    return torch.addcmul(origin.to(index.device), ijk.to(torch.float32) + 0.5,
                         vs)


def _smallest_eigvec(cov):
    """eigh's eigenvector of the smallest eigenvalue (eigh returns them
    ascending), solved on the host: LAPACK takes any batch."""
    return torch.linalg.eigh(cov.cpu())[1][..., 0].to(cov.device)


def knn_normals(points, k: int = KNN_K, prec: _ppf.Precision = _ppf.FP32):
    sq = torch.sum(_mul(prec, points, points), dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * prec.mm(points, points.T)
    _, order = torch.sort(d2, dim=1, stable=True)
    nb = points[order[:, :min(k, points.shape[0])]]
    c = nb - torch.mean(nb, dim=1, keepdim=True)
    cov = torch.sum(_mul(prec, c[:, :, :, None], c[:, :, None, :]), dim=1) \
        / nb.shape[1]
    return _smallest_eigvec(cov)


def grid_normals(points, leaf: float, prec: _ppf.Precision = _ppf.FP32):
    p = points
    lo = torch.min(p, dim=0).values
    cell = torch.floor((p - lo) / float(torch.tensor(leaf))).to(
        torch.int64) + 1
    dx, dy, dz = (int(v) + 2 for v in torch.max(cell, dim=0).values)
    key = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    mom = torch.stack([torch.ones_like(p[:, 0]), p[:, 0], p[:, 1], p[:, 2]]
                      + [_mul(prec, p[:, a], p[:, b]) for a, b in pairs], 1)
    grid = torch.zeros((dx * dy * dz, 10), dtype=torch.float32,
                       device=p.device)
    grid.index_add_(0, key, mom)
    grid = grid.reshape(dx, dy, dz, 10)
    box = torch.zeros_like(grid)
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                box[1:-1, 1:-1, 1:-1] += grid[1 + a:dx - 1 + a,
                                              1 + b:dy - 1 + b,
                                              1 + c:dz - 1 + c]
    s = box.reshape(-1, 10)[key]
    n = torch.clamp(s[:, 0], min=1.0)
    mu = s[:, 1:4] / n[:, None]
    cov = torch.empty((p.shape[0], 3, 3), dtype=torch.float32,
                      device=p.device)
    for col, (a, b) in enumerate(pairs):
        v = s[:, 4 + col] / n - _mul(prec, mu[:, a], mu[:, b])
        cov[:, a, b] = v
        cov[:, b, a] = v
    return _smallest_eigvec(cov)


def gradient_at(tsdf, index):
    """The central-difference gradient (one-sided on the faces) at the flat
    voxel indices."""
    g = torch.gradient(tsdf)
    return torch.stack([x.reshape(-1)[index] for x in g], -1)


def extract(tsdf, weight, origin, voxel_size: float, capacity: int,
            iso_band: float = 0.5,
            prec: _ppf.Precision = _ppf.FP32) -> Surface:
    """The rows, their centres and their oriented normals."""
    tf32_off()
    index, count = rows(tsdf, weight, voxel_size, capacity, iso_band)
    pts = centres(index, tuple(tsdf.shape), origin, voxel_size)
    if capacity <= KNN_ROWS:
        nrm = knn_normals(pts, prec=prec)
    else:
        nrm = grid_normals(pts, 2.0 * voxel_size, prec)
    flip = torch.sum(nrm * gradient_at(tsdf, index), dim=-1) < 0
    return Surface(index, pts, torch.where(flip[:, None], -nrm, nrm), count)
