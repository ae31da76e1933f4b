"""TSDF volume fusion, KinFu tracking and streaming object recognition —
the port of ``objective_slam_tpu.models.tsdf`` (tsdf.py:1-952).

  * `TSDFVolume` — a dense truncated-signed-distance voxel grid;
  * `integrate_depth` — the KinFu sensor-model update (voxel-projective
    TSDF, Newcombe et al. 2011) with free-space carving, and
    `integrate_depth_banded`, the same per-voxel math on the 8³ blocks
    that can hold the truncation band;
  * `integrate` — the point splat for clouds without a camera model;
  * `raycast_depth` — the volume's depth view by a conservative coarse
    march and trilinear refinement windows;
  * `track_frame` — frame-to-model projective point-to-plane ICP;
  * `extract_surface` — zero-crossing voxels as a point cloud with
    gradient-oriented PCA normals (static capacity and validity mask);
  * `StreamingRecognizer` — fuse frames as they arrive, track the camera,
    and match registered models against the fused surface with
    ``drost.match`` (kernel K1 or K2).

Everything runs eagerly on the device of the volume; numpy inputs are
moved there. Where the JAX package's float32 arithmetic is reproduced to
the bit, the expressions follow XLA:CPU's evaluation of the same code: a
product added to a value is one fused multiply-add (``_fma``), a 3×3
product by a point is the chain fma(r₂, z, fma(r₁, y, r₀·x)), and a
division by the constant voxel size is a product with its float32
reciprocal (``_inv``). The static-shape forms that exist for the TPU's
cost model (sort-based compaction of the banded blocks, their
block-major transposes) are a mask, ``nonzero`` and an index gather here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from objective_slam_tpu_torch._common import as_tensor, default_device, \
    f32, to_numpy
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.utils import pointcloud as pc

# Float→int casts first clamp the float to this range: XLA saturates an
# out-of-range cast and torch need not, and every such index is masked
# afterwards, so any value past the volume or image serves.
_INDEX_LIMIT = float(1 << 30)


@dataclasses.dataclass(frozen=True)
class TSDFVolume:
    """Dense TSDF grid (tsdf.py:44-54); `dataclasses.replace` swaps the
    tensor fields."""
    tsdf: torch.Tensor      # (D, H, W) float32 truncated signed distance
    weight: torch.Tensor    # (D, H, W) float32 integration weights
    origin: torch.Tensor    # (3,) float32 world position of voxel (0,0,0)
    dims: tuple             # (D, H, W)
    voxel_size: float
    truncation: float

    @property
    def device(self) -> torch.device:
        return self.tsdf.device


def make_volume(origin, dims, voxel_size, truncation=None,
                device=None) -> TSDFVolume:
    """An empty volume (tsdf 1, weight 0; tsdf.py:57-66) on `device`: by
    default the device of `origin` when it is a tensor, else the current
    CUDA device (no card: raises; pass device="cpu")."""
    if device is None:
        device = origin.device if isinstance(origin, torch.Tensor) \
            else default_device()
    if truncation is None:
        truncation = 3.0 * voxel_size
    D, H, W = (int(d) for d in dims)
    return TSDFVolume(
        tsdf=torch.ones((D, H, W), dtype=torch.float32, device=device),
        weight=torch.zeros((D, H, W), dtype=torch.float32, device=device),
        origin=as_tensor(origin, device),
        dims=(D, H, W), voxel_size=float(voxel_size),
        truncation=float(truncation))


def volume_from_arrays(tsdf, weight, origin, voxel_size, truncation,
                       device=None) -> TSDFVolume:
    """A volume holding given tsdf/weight arrays (a state carried over from
    another run or package), on `device` as `make_volume` picks it. numpy
    arrays are copied."""
    def own(x):
        return x if isinstance(x, torch.Tensor) else np.array(x, np.float32)

    t = as_tensor(own(tsdf), device)
    return TSDFVolume(tsdf=t, weight=as_tensor(own(weight), t.device),
                      origin=as_tensor(own(origin), t.device),
                      dims=tuple(int(d) for d in t.shape),
                      voxel_size=float(voxel_size),
                      truncation=float(truncation))


def _fma(a, b, c):
    """a·b + c with one rounding, as XLA:CPU contracts a product added to
    a value (torch's addcmul is a fused multiply-add)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=a.device)
    return torch.addcmul(c, a, b)


def _inv(x: float) -> float:
    """The float32 reciprocal of float32(x): XLA rewrites a division by a
    constant into a product with it."""
    return f32(np.float32(1.0) / np.float32(x))


def _rotate(R, x, y, z, t=None):
    """R (3, 3) applied to points given by their coordinate tensors (any
    broadcastable shapes), as XLA:CPU evaluates the float32 einsum: row i
    is fma(R[i,2], z, fma(R[i,1], y, R[i,0]·x)), then + t[i]."""
    out = []
    for i in range(3):
        r = _fma(y, R[i, 1], R[i, 0] * x)
        r = _fma(z, R[i, 2], r)
        out.append(r if t is None else r + t[i])
    return out


def _norm3(x, y, z):
    """‖(x, y, z)‖ as XLA:CPU reduces the squares: fma(z, z, fma(y, y, x²))."""
    return torch.sqrt(torch.addcmul(torch.addcmul(x * x, y, y), z, z))


def _linspace(start, stop, num: int, device, fused: bool):
    """float32 `jnp.linspace(start, stop, num)` as XLA:CPU evaluates it:
    step i·c with c = float32(1/(num−1)), start·(1 − i·c) + i·(stop·c),
    the last sample `stop`. Inside a compiled function with traced ends
    the sum is one fused multiply-add (fused=True); with constant ends it
    is folded at compile time without one (fused=False)."""
    def scalar(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.tensor(f32(v), dtype=torch.float32, device=device)

    a, b = scalar(start), scalar(stop)
    c = f32(1.0 / (num - 1))
    it = torch.arange(num - 1, dtype=torch.float32, device=device)
    head = a * (1.0 - it * c)
    bc = b * c
    head = torch.addcmul(head, it, bc) if fused else head + it * bc
    return torch.cat([head, b.reshape(1)])


def _round_index(x):
    """round-half-even(x) as an int64 index, x clamped first."""
    return torch.round(torch.clamp(x, -_INDEX_LIMIT, _INDEX_LIMIT)) \
        .to(torch.int64)


def _floor_index(x):
    return torch.floor(torch.clamp(x, -_INDEX_LIMIT, _INDEX_LIMIT)) \
        .to(torch.int64)


def _cam_scalars(intrinsics):
    return tuple(f32(v) for v in intrinsics)


def integrate(volume: TSDFVolume, points, normals, n_band: int = 7
              ) -> TSDFVolume:
    """Fuse a cloud by point splat (tsdf.py:69-108): each point writes
    signed distances t ∈ [−τ, τ] at n_band samples along its normal,
    with the running-average update w·v ← w·v + 1·t. Per-voxel sums run
    over the samples sorted by voxel, in sample order, as a segment
    reduction: the sums repeat from run to run on the card."""
    dev = volume.device
    p = as_tensor(points, dev)
    nr = as_tensor(normals, dev)
    nr = nr / torch.clamp(_norm3(nr[:, 0], nr[:, 1], nr[:, 2]),
                          min=f32(1e-9))[:, None]
    D, H, W = volume.dims
    n_vox = D * H * W
    tau = f32(volume.truncation)
    ts = _linspace(-1.0, 1.0, n_band, dev, fused=False) * tau      # (B,)

    # Sample positions (n, B, 3); the sdf value at a sample is +t.
    samples = _fma(nr[:, None, :], ts[None, :, None], p[:, None, :])
    ijk = _floor_index((samples - volume.origin) * _inv(volume.voxel_size))
    inside = ((ijk[..., 0] >= 0) & (ijk[..., 0] < D)
              & (ijk[..., 1] >= 0) & (ijk[..., 1] < H)
              & (ijk[..., 2] >= 0) & (ijk[..., 2] < W))
    flat = (ijk[..., 0] * H + ijk[..., 1]) * W + ijk[..., 2]
    vals = ts[None, :].expand(flat.shape)
    flat, vals = flat[inside], vals[inside]

    order = torch.argsort(flat, stable=True)
    lengths = torch.bincount(flat, minlength=n_vox)
    sdf_sum = torch.segment_reduce(vals[order], "sum", lengths=lengths,
                                   unsafe=True, initial=0.0)
    sdf_sum = sdf_sum.reshape(D, H, W)
    w_sum = lengths.to(torch.float32).reshape(D, H, W)

    new_w = volume.weight + w_sum
    old_contrib = torch.where(volume.weight > 0,
                              volume.tsdf * volume.weight, 0.0)
    new_tsdf = torch.where(new_w > 0, (old_contrib + sdf_sum)
                           / torch.clamp(new_w, min=f32(1e-9)), volume.tsdf)
    new_tsdf = torch.clamp(new_tsdf, -tau, tau)
    return dataclasses.replace(volume, tsdf=new_tsdf, weight=new_w)


def _center_coords(volume: TSDFVolume, i, j, k):
    """World coordinates of the centres of voxels (i, j, k) (int tensors,
    broadcastable): (idx + 0.5)·voxel_size + origin, per axis."""
    vs = f32(volume.voxel_size)
    o = volume.origin
    return tuple(_fma(idx.to(torch.float32) + 0.5, vs, o[a])
                 for a, idx in enumerate((i, j, k)))


def _voxel_grid_coords(volume: TSDFVolume):
    """Voxel-centre coordinates of the whole grid as three broadcastable
    tensors (D,1,1), (1,H,1), (1,1,W) (tsdf.py:111-118)."""
    D, H, W = volume.dims
    dev = volume.device
    return _center_coords(volume,
                          torch.arange(D, device=dev).reshape(D, 1, 1),
                          torch.arange(H, device=dev).reshape(1, H, 1),
                          torch.arange(W, device=dev).reshape(1, 1, W))


def _project(px, py, pz, intrinsics, T):
    """Camera depth z and rounded pixel (u, v) of world points (px, py,
    pz) under world→camera T (tsdf.py:147-152)."""
    fx, fy, cx, cy = _cam_scalars(intrinsics)
    x, y, z = _rotate(T[:3, :3], px, py, pz, T[:3, 3])
    zc = torch.clamp(z, min=f32(1e-9))
    return _round_index(fx * x / zc + cx), _round_index(fy * y / zc + cy), z


def _projective_update(tsdf, weight, px, py, pz, depth, intrinsics, T, tau,
                       w_max):
    """The KinFu voxel update (tsdf.py:141-170) of voxels with world centres
    (px, py, pz) and state (tsdf, weight), all broadcastable; returns
    (tsdf, weight) after the frame."""
    h, w = depth.shape
    u, v, z = _project(px, py, pz, intrinsics, T)
    in_img = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d_meas = depth.reshape(-1)[torch.clamp(v, 0, h - 1) * w
                               + torch.clamp(u, 0, w - 1)]
    has_meas = in_img & torch.isfinite(d_meas) & (d_meas > 0)

    sdf = d_meas - z
    update = has_meas & (sdf > -tau)
    tsdf_obs = torch.clamp(sdf, -tau, tau)
    w_new = torch.where(update, torch.clamp(weight + 1.0, max=w_max), weight)
    # Running average; weight 0 gives t_new = tsdf_obs (the +1 prior of an
    # unobserved voxel carries no weight).
    t_new = torch.where(update, _fma(tsdf, weight, tsdf_obs) / (weight + 1.0),
                        tsdf)
    return torch.clamp(t_new, -tau, tau), w_new


def integrate_depth(volume: TSDFVolume, depth, intrinsics, T_cw,
                    w_max: float = 64.0) -> TSDFVolume:
    """KinFu voxel-projective TSDF update (tsdf.py:121-170): every voxel
    centre projects into the depth image; sdf = D(u,v) − z_cam; updated
    where the projection has a measurement and sdf > −τ, so voxels between
    the camera and the surface take positive (free-space) updates.

    depth: (h, w) metric depth, 0 / non-finite = no measurement;
    intrinsics (fx, fy, cx, cy); T_cw (4, 4) world→camera; w_max clamps
    the running-average weight."""
    dev = volume.device
    depth = as_tensor(depth, dev)
    T = as_tensor(T_cw, dev)
    px, py, pz = _voxel_grid_coords(volume)
    t_new, w_new = _projective_update(
        volume.tsdf, volume.weight, px, py, pz, depth, intrinsics, T,
        f32(volume.truncation), f32(w_max))
    return dataclasses.replace(volume, tsdf=t_new, weight=w_new)


_BAND_BLOCK = 8        # banded-update block edge (block = 8³ voxels)
_BAND_TILE = 16        # depth-image pooling tile (px)
_BAND_WIN = 4          # pooling window half-width, in tiles


def _window_pool(x, r: int, ax: int, fill: float, op):
    """op over the window [i − r, i + r] along axis `ax`, padded by fill."""
    n = x.shape[ax]
    pad_shape = list(x.shape)
    pad_shape[ax] = r
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    p = torch.cat([pad, x, pad], dim=ax)
    return functools.reduce(op, [p.narrow(ax, o, n)
                                 for o in range(2 * r + 1)])


def _ceil_to_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _band_block_mask(volume: TSDFVolume, depth, intrinsics, T_cw):
    """Conservative per-block candidate mask of the banded update
    (tsdf.py:178-254): a block is a candidate iff its bounding sphere can
    overlap [min − τ, max + τ] of the measured depth over the tiles its
    projection can touch (tile min/max maps window-pooled ±_BAND_WIN
    tiles; invalid pixels ±inf), or it is so near the camera that its
    on-screen radius exceeds the window's reach. Returns (bd·bh·bw,) bool."""
    dev = volume.device
    depth = as_tensor(depth, dev)
    h, w = depth.shape
    fx, fy, cx, cy = _cam_scalars(intrinsics)
    T = as_tensor(T_cw, dev)
    tau = f32(volume.truncation)
    B, tile = _BAND_BLOCK, _BAND_TILE
    D, H, W = volume.dims
    bd, bh, bw = D // B, H // B, W // B

    ok = torch.isfinite(depth) & (depth > 0)
    hp, wp = _ceil_to_mult(h, tile), _ceil_to_mult(w, tile)
    dmin = torch.full((hp, wp), torch.inf, device=dev)
    dmax = torch.full((hp, wp), -torch.inf, device=dev)
    dmin[:h, :w] = torch.where(ok, depth, torch.inf)
    dmax[:h, :w] = torch.where(ok, depth, -torch.inf)
    tmin = dmin.reshape(hp // tile, tile, wp // tile, tile).amin(dim=(1, 3))
    tmax = dmax.reshape(hp // tile, tile, wp // tile, tile).amax(dim=(1, 3))
    for ax in (0, 1):
        tmin = _window_pool(tmin, _BAND_WIN, ax, torch.inf, torch.minimum)
        tmax = _window_pool(tmax, _BAND_WIN, ax, -torch.inf, torch.maximum)

    # Block centres -> camera frame.
    vs = f32(volume.voxel_size)
    o = volume.origin

    def centres(n, shape):
        c = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * B
        return c.reshape(shape)

    gx = _fma(centres(bd, (bd, 1, 1)), vs, o[0])
    gy = _fma(centres(bh, (1, bh, 1)), vs, o[1])
    gz = _fma(centres(bw, (1, 1, bw)), vs, o[2])
    x, y, z = _rotate(T[:3, :3], gx, gy, gz, T[:3, 3])
    r_w = f32(np.float32(np.sqrt(3.0) / 2.0 * B) * np.float32(vs))
    # The on-screen radius takes the NEAREST depth of the bounding sphere
    # (z − r_w); the centre pixel projects with the true z (tsdf.py:235-238).
    z_eff = torch.clamp(z - r_w, min=f32(1e-3))
    r_px = f32(np.float32(max(fx, fy)) * np.float32(r_w)) / z_eff
    z3 = torch.clamp(z, min=f32(1e-3))
    u_c = fx * x / z3 + cx
    v_c = fy * y / z3 + cy
    reach = f32((_BAND_WIN - 1) * tile)          # window px reach margin

    front = z + r_w > 0
    near = front & (r_px > reach)                # pooled test unsafe
    onscreen = (front & (u_c >= -r_px) & (u_c < w + r_px)
                & (v_c >= -r_px) & (v_c < h + r_px))
    n_ti, n_tj = tmin.shape
    ti = torch.clamp(torch.clamp(v_c / tile, -1.0, float(n_ti))
                     .to(torch.int64), 0, n_ti - 1)
    tj = torch.clamp(torch.clamp(u_c / tile, -1.0, float(n_tj))
                     .to(torch.int64), 0, n_tj - 1)
    wmin = tmin.reshape(-1)[ti * n_tj + tj]
    wmax = tmax.reshape(-1)[ti * n_tj + tj]
    band = (z - r_w <= wmax + tau) & (z + r_w >= wmin - tau)
    return (near | (onscreen & band)).reshape(-1)


def band_block_occupancy(volume: TSDFVolume, depth, intrinsics, T_cw):
    """Candidate-block count of `integrate_depth_banded` — the exact count
    pass that sizes its block_cap (tsdf.py:261-267). () int32."""
    return torch.sum(_band_block_mask(volume, depth, intrinsics, T_cw),
                     dtype=torch.int32)


def integrate_depth_banded(volume: TSDFVolume, depth, intrinsics, T_cw,
                           block_cap: int, w_max: float = 64.0):
    """Band-limited KinFu update (tsdf.py:270-370): `integrate_depth`'s
    per-voxel math, run only on the 8³ blocks of `_band_block_mask`. On
    every voxel within the truncation band of the frame the result equals
    `integrate_depth`'s bit for bit; voxels of other blocks keep their
    state, so free-space carving reaches only ±(τ + block diagonal) of the
    measured surface.

    Returns (volume, overflowed): overflowed () bool says that more than
    block_cap blocks were candidates (size it with `band_block_occupancy`);
    the update then covered the first block_cap candidate blocks in index
    order."""
    dev = volume.device
    depth = as_tensor(depth, dev)
    T = as_tensor(T_cw, dev)
    B = _BAND_BLOCK
    D, H, W = volume.dims
    if D % B or H % B or W % B:
        raise ValueError("banded update needs dims divisible by 8")
    bh, bw = H // B, W // B

    mask = _band_block_mask(volume, depth, intrinsics, T)
    cand = torch.nonzero(mask)[:, 0]             # ascending block index
    overflowed = torch.tensor(cand.numel() > block_cap, device=dev)
    sel = cand[:block_cap]
    o = torch.arange(B, device=dev)
    gi = ((sel // (bh * bw)) * B)[:, None, None, None] + o[:, None, None]
    gj = (((sel // bw) % bh) * B)[:, None, None, None] + o[:, None]
    gk = ((sel % bw) * B)[:, None, None, None] + o
    flat = ((gi * H + gj) * W + gk).reshape(-1)   # block-major voxel order
    px, py, pz = _center_coords(volume, gi, gj, gk)
    shape = (sel.numel(), B, B, B)
    t_rows = volume.tsdf.reshape(-1)[flat].reshape(shape)
    w_rows = volume.weight.reshape(-1)[flat].reshape(shape)
    t_new, w_new = _projective_update(
        t_rows, w_rows, px, py, pz, depth, intrinsics, T,
        f32(volume.truncation), f32(w_max))
    tsdf = volume.tsdf.clone()
    weight = volume.weight.clone()
    tsdf.view(-1)[flat] = t_new.reshape(-1)
    weight.view(-1)[flat] = w_new.reshape(-1)
    return dataclasses.replace(volume, tsdf=tsdf, weight=weight), overflowed


def _pixel_rays(intrinsics, shape, device):
    """Camera-frame ray directions ((u − cx)/fx, (v − cy)/fy, 1) of every
    pixel, as three (h, w) tensors."""
    h, w = shape
    fx, fy, cx, cy = _cam_scalars(intrinsics)
    gu = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w)
    gv = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w)
    return (gu - cx) / fx, (gv - cy) / fy, torch.ones((h, w), device=device)


def _flat_index(volume: TSDFVolume, i, j, k):
    D, H, W = volume.dims
    inside = ((i >= 0) & (i < D) & (j >= 0) & (j < H) & (k >= 0) & (k < W))
    flat = ((torch.clamp(i, 0, D - 1) * H + torch.clamp(j, 0, H - 1)) * W
            + torch.clamp(k, 0, W - 1))
    return flat, inside


def raycast_depth(volume: TSDFVolume, intrinsics, T_wc, shape,
                  t_near: float = 0.1, t_far: float = 6.0,
                  n_steps: int = 192, fine_steps: int = 32,
                  n_brackets: int = 3):
    """The volume's depth view from camera T_wc (camera→world) (tsdf.py:
    373-553): per pixel the first positive→negative TSDF zero crossing,
    linearly interpolated; 0 where there is none. Returns (h, w) float32.

    A coarse march of n_steps nearest reads of the 3³-min-pooled observed
    field brackets every point where the trilinear field could cross (the
    pooled field is at or below every voxel a trilinear neighbourhood
    reads); each of the first n_brackets brackets gets fine_steps
    trilinear samples over [bracket − dt, bracket + 9·dt], and the first
    crossing across the windows, in bracket order, is the depth. A window
    without a crossing is a graze of a nearer feature; the next bracket
    resumes behind it. The step dt = (t_far − t_near)/n_steps must stay
    below the truncation band. The (n_steps, h, w) stack of the coarse
    march is kept whole."""
    dev = volume.device
    h, w = shape
    T = as_tensor(T_wc, dev)
    D, H, W = volume.dims
    vs_inv = _inv(volume.voxel_size)
    trunc = f32(volume.truncation)
    o = volume.origin

    dcx, dcy, dcz = _pixel_rays(intrinsics, shape, dev)
    dirs_w = _rotate(T[:3, :3], dcx, dcy, dcz)
    org_w = T[:3, 3]
    ts = _linspace(t_near, t_far, n_steps, dev, fused=True)
    dt = ts[1] - ts[0]

    # Observed field with the weight test folded in; the 3³ min-pool as
    # three width-3 passes makes it a lower envelope of every trilinear
    # neighbourhood.
    c_field = torch.where(volume.weight > 0.0, volume.tsdf, trunc)
    for ax in range(3):
        c_field = torch.minimum(c_field, _window_pool(
            c_field, 1, ax, trunc, torch.minimum))
    c_flat = c_field.reshape(-1)
    # Unobserved voxels as NaN: one gather per trilinear corner.
    obs_flat = torch.where(volume.weight > 0.0, volume.tsdf,
                           torch.nan).reshape(-1)

    def pos_of(t):
        """Grid coordinates of the ray points at parameters t (..., h, w)."""
        return [(_fma(dirs_w[a], t, org_w[a]) - o[a]) * vs_inv - 0.5
                for a in range(3)]

    def coarse_sample(t):
        i, j, k = (_round_index(c) for c in pos_of(t))
        flat, inside = _flat_index(volume, i, j, k)
        return torch.where(inside, c_flat[flat], trunc)

    def sample(t):
        """Trilinear sample; unobserved corners are left out of the
        weights, and outside / unobserved reads as +τ."""
        pos = pos_of(t)
        base = [_floor_index(c) for c in pos]
        frac = [c - b.to(torch.float32) for c, b in zip(pos, base)]
        val = torch.zeros_like(frac[0])
        wsum = torch.zeros_like(frac[0])
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    flat, inside = _flat_index(volume, base[0] + di,
                                               base[1] + dj, base[2] + dk)
                    tv = obs_flat[flat]
                    wt = ((frac[0] if di else 1 - frac[0])
                          * (frac[1] if dj else 1 - frac[1])
                          * (frac[2] if dk else 1 - frac[2]))
                    ok = inside & ~torch.isnan(tv)
                    val = val + torch.where(ok, wt * tv, 0.0)
                    wsum = wsum + torch.where(ok, wt, 0.0)
        return torch.where(wsum > 0.5, val / torch.clamp(wsum, min=f32(1e-9)),
                           trunc)

    # Coarse march over the whole (n_steps, h, w) stack; every +→− segment
    # of the pooled field is a bracket, ranked per pixel by a cumulative
    # count. A bracket records its segment start ts[s].
    vc = coarse_sample(ts[:, None, None].expand(n_steps, h, w))
    crossed = (vc[:-1] > 0) & (vc[1:] <= 0)
    rank = torch.cumsum(crossed.to(torch.int32), dim=0)
    ts_seg = ts[:-1][:, None, None]

    offs = _linspace(-dt, 9.0 * dt, fine_steps, dev, fused=True)
    depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for k in range(n_brackets):
        mask_k = crossed & (rank == k + 1)             # ≤ 1 per pixel
        found_k = torch.any(mask_k, dim=0)
        t_k = torch.sum(torch.where(mask_k, ts_seg, 0.0), dim=0)
        t0 = torch.where(found_k, t_k, f32(t_near))
        tw = t0[None] + offs[:, None, None]            # (F, h, w)
        vw = sample(tw)
        cr = (vw[:-1] > 0) & (vw[1:] <= 0)
        first = cr & (torch.cumsum(cr.to(torch.int32), dim=0) == 1)
        prev_v, now_v = vw[:-1], vw[1:]
        frac = prev_v / torch.clamp(prev_v - now_v, min=f32(1e-9))
        d_all = _fma(frac, tw[1:] - tw[:-1], tw[:-1])
        d_k = torch.sum(torch.where(first, d_all, 0.0), dim=0)
        ok_k = found_k & torch.any(first, dim=0) & (depth == 0.0)
        depth = torch.where(ok_k, d_k, depth)
    return depth


def _invert_rigid(T):
    R = T[:3, :3]
    Ti = torch.zeros((4, 4), dtype=torch.float32, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -(R.T @ T[:3, 3])
    Ti[3, 3] = 1.0
    return Ti


def _volume_normals_at(volume: TSDFVolume, pos_w):
    """TSDF central-difference normals at world positions (..., 3) from
    nearest-voxel reads (tsdf.py:565-591); zero, and not ok, where a tap
    is unobserved or outside. Returns (normals (..., 3), ok (...))."""
    vs_inv = _inv(volume.voxel_size)
    base = [_round_index((pos_w[..., a] - volume.origin[a]) * vs_inv - 0.5)
            for a in range(3)]
    weight = volume.weight.reshape(-1)
    tsdf = volume.tsdf.reshape(-1)

    def tap(di, dj, dk):
        flat, inside = _flat_index(volume, base[0] + di, base[1] + dj,
                                   base[2] + dk)
        ok = inside & (weight[flat] > 0)
        return torch.where(ok, tsdf[flat], torch.nan)

    g = [tap(1, 0, 0) - tap(-1, 0, 0), tap(0, 1, 0) - tap(0, -1, 0),
         tap(0, 0, 1) - tap(0, 0, -1)]
    ok = torch.isfinite(g[0]) & torch.isfinite(g[1]) & torch.isfinite(g[2])
    g = [torch.where(ok, c, 0.0) for c in g]
    n = torch.clamp(_norm3(*g), min=f32(1e-9))
    return torch.where(ok[..., None], torch.stack([c / n for c in g], -1),
                       0.0), ok


class TrackResult(NamedTuple):
    """One tracked frame (tsdf.py:594-603)."""
    T_cw: torch.Tensor     # (4, 4) world→camera estimate for this frame
    inliers: torch.Tensor  # () int32 final-iteration correspondence count
    rms: torch.Tensor      # () float32 final point-to-plane RMS residual (m)
    overlap: torch.Tensor  # () int32 final-iteration candidate associations
    #                        (frame pixel projects onto a valid model pixel,
    #                        before the distance/normal gates): the
    #                        denominator of the lost-tracking gate


_OMEGA_MAX = 0.08        # rad per Gauss-Newton step (trust region)


def track_frame(volume: TSDFVolume, depth, intrinsics, T_cw_init,
                iters: int = 10, dist_thresh: float | None = None,
                normal_cos: float = 0.7) -> TrackResult:
    """KinFu frame-to-model camera tracking (tsdf.py:606-740): projective
    point-to-plane ICP of a raw depth frame against the volume's raycast
    view from T_cw_init (the previous pose).

    The model view is raycast once: vertex map from `raycast_depth`,
    normal map from the TSDF gradient. Each of the `iters` Gauss-Newton
    steps moves the frame's points by the current estimate, projects them
    into that view (no k-NN), solves the damped 6×6 point-to-plane normal
    equations, clamps the rotation step to _OMEGA_MAX and lifts it by
    Rodrigues. The first iters // 2 steps gate associations at 4× the
    final radius (16·d²), the rest at dist_thresh (None: 6·voxel_size).
    The solve is `solve_ex`: no host check per step."""
    dev = volume.device
    depth = as_tensor(depth, dev)
    h, w = depth.shape
    fx, fy, cx, cy = _cam_scalars(intrinsics)
    if dist_thresh is None:
        dist_thresh = 6.0 * volume.voxel_size
    d2_max = f32(np.float32(dist_thresh) ** 2)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    damp = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)

    T_cw_prev = as_tensor(T_cw_init, dev)
    T_wc_prev = _invert_rigid(T_cw_prev)

    # Model view from the previous pose: raycast depth -> world vertex map
    # and TSDF-gradient normal map.
    d_model = raycast_depth(volume, intrinsics, T_wc_prev, (h, w))
    dirs_c = _pixel_rays(intrinsics, (h, w), dev)
    dirs_w = _rotate(T_wc_prev[:3, :3], *dirs_c)
    v_model = torch.stack([_fma(dirs_w[a], d_model, T_wc_prev[a, 3])
                           for a in range(3)], dim=-1)            # world
    n_model, n_ok = _volume_normals_at(volume, v_model)
    model_ok = ((d_model > 0) & n_ok).reshape(-1)
    v_model = v_model.reshape(-1, 3)
    n_model = n_model.reshape(-1, 3)

    # New frame: camera-space vertex map and image-space normals, turned
    # toward the camera.
    frame_ok = torch.isfinite(depth) & (depth > 0)
    dz = torch.where(frame_ok, depth, 0.0)
    v_cam = torch.stack([c * dz for c in dirs_c], dim=-1)        # (h, w, 3)
    dx = torch.gradient(v_cam, dim=1)[0]
    dy = torch.gradient(v_cam, dim=0)[0]
    n_cam = torch.linalg.cross(dx, dy, dim=-1)
    n_cam = n_cam / torch.clamp(torch.linalg.norm(n_cam, dim=-1,
                                                  keepdim=True), min=1e-9)
    n_cam = torch.where((torch.sum(n_cam * v_cam, dim=-1) > 0)[..., None],
                        -n_cam, n_cam)
    frame_ok = frame_ok.reshape(-1)

    T_wc = _invert_rigid(T_cw_prev)
    rms = torch.zeros((), dtype=torch.float32, device=dev)
    inl = ovl = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(iters):
        # Annealed association gate: capture range first, then precision.
        d2_i = 16.0 * d2_max if i < iters // 2 else d2_max
        pw = torch.stack(_rotate(T_wc[:3, :3], v_cam[..., 0], v_cam[..., 1],
                                 v_cam[..., 2], T_wc[:3, 3]), -1)
        nw = torch.stack(_rotate(T_wc[:3, :3], n_cam[..., 0], n_cam[..., 1],
                                 n_cam[..., 2]), -1)
        # Projective association into the PREVIOUS camera.
        x, y, z = _rotate(T_cw_prev[:3, :3], pw[..., 0], pw[..., 1],
                          pw[..., 2], T_cw_prev[:3, 3])
        zc = torch.clamp(z, min=f32(1e-9))
        up = _round_index(fx * x / zc + cx)
        vp = _round_index(fy * y / zc + cy)
        in_img = (z > 0) & (up >= 0) & (up < w) & (vp >= 0) & (vp < h)
        flat = (torch.clamp(vp, 0, h - 1) * w
                + torch.clamp(up, 0, w - 1)).reshape(-1)
        pw = pw.reshape(-1, 3)
        nw = nw.reshape(-1, 3)
        vm = v_model[flat]
        nm = n_model[flat]
        diff = pw - vm
        cand = frame_ok & in_img.reshape(-1) & model_ok[flat]
        ok = (cand & (torch.sum(diff * diff, dim=-1) < d2_i)
              & (torch.sum(nw * nm, dim=-1) > normal_cos))
        wf = ok.to(torch.float32)
        rf = torch.sum(diff * nm, dim=-1)
        Jf = torch.cat([torch.linalg.cross(pw, nm, dim=-1), nm], dim=-1)
        Jw = Jf * wf[:, None]
        A = Jw.T @ Jf + damp
        b = -(Jw.T @ rf)
        delta = torch.linalg.solve_ex(A, b).result
        omega, t = delta[:3], delta[3:]
        th = torch.linalg.norm(omega) + 1e-12
        scale = torch.clamp(_OMEGA_MAX / th, max=1.0)
        omega, t, th = omega * scale, t * scale, th * scale
        k = omega / th
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                         torch.stack([k[2], zero, -k[0]]),
                         torch.stack([-k[1], k[0], zero])])
        R = eye3 + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
        dT = torch.eye(4, dtype=torch.float32, device=dev)
        dT[:3, :3] = R
        dT[:3, 3] = t
        wsum = torch.clamp(torch.sum(wf), min=1.0)
        rms = torch.sqrt(torch.sum(wf * rf * rf) / wsum)
        inl = torch.sum(wf).to(torch.int32)
        ovl = torch.sum(cand, dtype=torch.int32)
        T_wc = dT @ T_wc
    return TrackResult(T_cw=_invert_rigid(T_wc), inliers=inl, rms=rms,
                       overlap=ovl)


class Surface(NamedTuple):
    """Extracted surface (tsdf.py:743-750)."""
    points: torch.Tensor      # (capacity, 3) voxel centres near the surface
    normals: torch.Tensor     # (capacity, 3) oriented PCA normals
    valid: torch.Tensor       # (capacity,) bool
    count: torch.Tensor       # () int32 true number of surface voxels (may
    #                           exceed capacity: see overflowed)
    overflowed: torch.Tensor  # () bool: surface voxels were dropped; raise
    #                           capacity (size it with surface_occupancy)


def _near_surface(volume: TSDFVolume, iso_band: float):
    thr = f32(np.float32(iso_band) * np.float32(volume.voxel_size))
    return (torch.abs(volume.tsdf) < thr) & (volume.weight > 0)


def surface_occupancy(volume: TSDFVolume, iso_band: float = 0.5):
    """Number of near-surface voxels — the exact count pass that sizes
    extract_surface's capacity (tsdf.py:753-760). () int32."""
    return torch.sum(_near_surface(volume, iso_band), dtype=torch.int32)


def extract_surface(volume: TSDFVolume, capacity: int = 4096,
                    iso_band: float = 0.5, normal_k: int = 12) -> Surface:
    """Surface voxels = observed cells with |tsdf| < iso_band·voxel_size
    (tsdf.py:763-822), the `capacity` with the smallest |tsdf|, ties in
    voxel order (as `lax.top_k` breaks them: a stable descending sort of
    the score). Normals: neighbourhood PCA over the extracted points —
    exact k-NN up to 8,192 rows, the moment-grid estimator above (leaf
    2·voxel_size, pad rows parked in a corner no real point reaches) —
    oriented by the sign of the central-difference TSDF gradient. Pad rows
    sit at origin − 1e7 with zero normals and can never vote."""
    D, H, W = volume.dims
    t = volume.tsdf
    near = _near_surface(volume, iso_band)
    score = torch.where(near, -torch.abs(t), -torch.inf).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:capacity], idx[:capacity]
    valid = torch.isfinite(vals)
    n_near = torch.sum(near, dtype=torch.int32)
    i, j, k = idx // (H * W), (idx // W) % H, idx % W
    centers = torch.stack(_center_coords(volume, i, j, k), dim=-1)
    far = volume.origin - 1.0e7
    pts = torch.where(valid[:, None], centers, far)

    # Central-difference TSDF gradient at the selected voxels.
    g = [torch.gradient(t, dim=a)[0].reshape(-1)[idx] for a in range(3)]
    gn = torch.clamp(_norm3(*g), min=f32(1e-9))
    grad_n = torch.where(valid[:, None], torch.stack([c / gn for c in g], -1),
                         0.0)

    if capacity <= 8192:
        # Distances rounded as inside the JAX package's compiled
        # extraction.
        knn_n = pc.estimate_normals_knn(pts, k=normal_k, fused_norms=True)
    else:
        # Pads sit 10 leaves past the volume's far corner and `dims_n`
        # adds headroom cells, so their moments never box-filter into a
        # real point's window.
        leaf = 2.0 * volume.voxel_size
        extent = torch.tensor(volume.dims, dtype=torch.float32,
                              device=t.device) * f32(volume.voxel_size)
        pad_loc = volume.origin + extent + f32(10.0 * leaf)
        pts_n = torch.where(valid[:, None], pts, pad_loc)
        dims_n = tuple(int(d) // 2 + 14 for d in volume.dims)
        knn_n = pc.estimate_normals_grid(pts_n, leaf, dims=dims_n,
                                         box_filter=True)
    flip = torch.sum(knn_n * grad_n, dim=-1) < 0
    nrm = torch.where(valid[:, None],
                      torch.where(flip[:, None], -knn_n, knn_n), 0.0)
    return Surface(points=pts, normals=nrm, valid=valid, count=n_near,
                   overflowed=n_near > capacity)


class StreamingRecognizer:
    """Continuous recognition over a stream of frames (tsdf.py:825-952):
    integrate each frame into the TSDF (or track it first), then match the
    registered model descriptions against the fused surface on demand."""

    def __init__(self, volume: TSDFVolume, config: PPFConfig = PPFConfig(),
                 surface_capacity: int | None = None):
        """surface_capacity: static extraction capacity; None sizes it from
        the volume's surface occupancy at each surface() call, rounded up
        to a capacity bucket (never overflows)."""
        self.volume = volume
        self.config = config
        self.surface_capacity = surface_capacity
        self.models: dict[str, drost.ModelDescription] = {}
        self.frames = 0
        self.T_cw = None            # last tracked/integrated camera pose
        self.last_track: TrackResult | None = None
        self.tracking_lost = False  # the last track_depth_frame failed the
        #                             lost-tracking gate (not fused)

    def register_model(self, name: str, desc: drost.ModelDescription):
        self.models[name] = desc

    def integrate_frame(self, points, normals) -> None:
        self.volume = integrate(self.volume, points, normals)
        self.frames += 1

    def integrate_depth_frame(self, depth, intrinsics, T_cw) -> None:
        """Sensor-model fusion of one depth image (free-space carving);
        T_cw is the frame's world→camera transform."""
        self.volume = integrate_depth(self.volume, depth, intrinsics, T_cw)
        self.T_cw = to_numpy(T_cw).astype(np.float32)
        self.frames += 1

    def track_depth_frame(self, depth, intrinsics, T_cw_hint=None,
                          min_inlier_frac: float = 0.15
                          ) -> TrackResult | None:
        """Consume a raw depth frame without a pose (tsdf.py:861-918):
        track the camera against the fused volume (`track_frame`), then
        integrate at the tracked pose. The first frame anchors the world
        frame and needs T_cw_hint (or an earlier integrate_depth_frame);
        later frames start from the previous tracked pose unless a hint
        is given. Returns the TrackResult (None for the anchoring frame).

        Lost-tracking gate: the frame is not fused when inliers <
        min_inlier_frac · overlap, or when overlap is under 5% of the
        frame's valid pixels; the pose then holds and `tracking_lost` is
        set. Frame-to-model projective ICP assumes small motion: far
        outside its basin, over self-similar geometry, it can converge to
        a wrong attractor that no geometric gate tells from a healthy
        track (tsdf.py:891-898)."""
        if self.T_cw is None and T_cw_hint is None:
            raise ValueError(
                "first frame anchors the world frame: pass T_cw_hint (or "
                "integrate one posed frame first)")
        if self.frames == 0:
            self.integrate_depth_frame(depth, intrinsics, T_cw_hint)
            return None
        init = self.T_cw if T_cw_hint is None else T_cw_hint
        res = track_frame(self.volume, depth, intrinsics, init)
        self.last_track = res
        inl, ovl = torch.stack([res.inliers, res.overlap]).tolist()
        d = to_numpy(depth)
        valid = int(np.count_nonzero(np.isfinite(d) & (d > 0)))
        self.tracking_lost = (inl < min_inlier_frac * max(ovl, 1)
                              or ovl < 0.05 * valid)
        if not self.tracking_lost:
            self.integrate_depth_frame(depth, intrinsics, res.T_cw)
        return res

    def surface(self) -> Surface:
        cap = self.surface_capacity
        if cap is None:
            # Capacity from the exact count pass, rounded to a bucket.
            occ = int(surface_occupancy(self.volume))
            cap = drost._next_cap(max(occ, 1024))
        return extract_surface(self.volume, cap)

    def recognize(self, names=None) -> dict[str, drost.MatchResult]:
        """drost.match of each registered model (all by default) against
        the fused surface, re-downsampled to the model's d_dist (the
        matcher's scene sampling); ICP refines against the full surface."""
        surf = self.surface()
        # Drop the far pad rows before voxelizing: a bbox spanning them
        # overflows the int32 cell keys.
        ok = to_numpy(surf.valid)
        pts = to_numpy(surf.points)[ok]
        nrm = to_numpy(surf.normals)[ok]
        out = {}
        for name in (names or self.models):
            desc = self.models[name]
            if float(desc.d_dist) > 1.5 * self.volume.voxel_size:
                vp, vn = pc.voxel_downsample_np(pts, nrm,
                                                float(desc.d_dist))
            else:
                vp, vn = pts, nrm
            out[name] = drost.match(desc, vp, vn, self.config,
                                    icp_points=pts, icp_normals=nrm)
        return out
