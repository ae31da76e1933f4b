"""Plain reference of the recognition path: Drost et al. 2010 point-pair
features, Hough voting, pose clustering and point-to-point ICP, written
from the method's definition in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
voxelizes the raw model and the raw scan itself, builds its own key table,
casts every vote into a dense (rows, model points, 31 α bins) accumulator,
and works out the candidate poses, their clusters and the refined winner.
Where the method fixes a convention the reference keeps it: the truncating
quantizer x − fmod(x, step) (kernel.cu:90-100), α = wrap(α_s − α_m)
binned on α + π (kernel.cu:341-342), the quaternion of kernel.cu:128-144
and the clustering rule of kernel.cu:702-763 (adjacent translation cells,
own cell left out, |8(1 − q·q′)| < rot², ‖Δt‖ < d_dist, seed count 1).

Everything runs in float32 with TF32 off. ``Precision(tf32=True)`` rounds
both operands of every matrix product to TF32 (10 mantissa bits, round to
nearest even) and keeps the float32 accumulation, as a TF32 tensor core
does: that is the control, the same reference one precision step lower.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

N_ANGLE = 30
D_ANGLE = 2.0 * math.pi / N_ANGLE
ALPHA_BINS = N_ANGLE + 1          # α + π in [0, 2π] gives bins 0..30
ALPHA_SLOTS = 32                  # the accumulator's α axis, bin 31 empty
ANGLE_BINS = 16                   # feature angles in [0, π]: bins 0..15
VOTE_THRESHOLD = 0.4              # survivors: count > 0.4 · the top count
ROT_THRESH = 2.0 * D_ANGLE        # clustering's quaternion threshold
NORMAL_COS = 0.5                  # ICP's normal gate
POSES_CEILING = 8192              # most candidates the matcher ever keeps
TOPK_BLOCK = 256                  # cells a block in the two-level top-K


def f32(x) -> float:
    return float(np.float32(x))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x0FFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """float32 matrix products, or (tf32=True) the TF32 control."""
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)


FP32 = Precision()


def quant_bin(x, step):
    """round((x − fmod(x, step)) / step): the truncating quantizer's bin."""
    s = f32(step)
    return torch.round((x - torch.fmod(x, s)) / s)


def voxel_grid(points, normals, leaf):
    """Per-cell centroids of points and normals (pcl::VoxelGrid), cells
    floor((p − min p) / leaf) in float32, means in float64, ordered by cell
    (x, then y, then z)."""
    p = points.to(torch.float32)
    lo = torch.min(p, dim=0).values
    cell = torch.floor((p - lo) / f32(leaf)).to(torch.int64)
    dims = torch.max(cell, dim=0).values + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    _, inv, cnt = torch.unique(key, sorted=True, return_inverse=True,
                               return_counts=True)
    n_vox = cnt.shape[0]
    out = []
    for x in (p, normals.to(torch.float32)):
        acc = torch.zeros((n_vox, 3), dtype=torch.float64, device=p.device)
        acc.index_add_(0, inv, x.to(torch.float64))
        out.append((acc / cnt[:, None].to(torch.float64)).to(torch.float32))
    return out[0], out[1]


def _unit(v):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.where(n > 0, n, torch.ones_like(n))


def canonical_rotation(normals):
    """R = Rz(γ)·Ry(β) taking a normal onto +x: β = atan2(n_z, n_x),
    γ = −atan2(n_y, cos β·n_x + sin β·n_z) (kernel.cu:302-327)."""
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    beta = torch.atan2(nz, nx)
    cb, sb = torch.cos(beta), torch.sin(beta)
    gamma = -torch.atan2(ny, cb * nx + sb * nz)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    zero = torch.zeros_like(cb)
    return torch.stack([
        torch.stack([cg * cb, -sg, cg * sb], dim=-1),
        torch.stack([sg * cb, cg, sg * sb], dim=-1),
        torch.stack([-sb, zero, cb], dim=-1)], dim=-2)


def pair_features(ref_p, ref_n, pts, nrm, d_dist, max_dist_bin, ref_ids,
                  prec: Precision = FP32):
    """Keys and α of the pairs (reference row r, point j).

    key = ((dist bin·16 + a1)·16 + a2)·16 + a3 of F = (‖d‖, ∠(n_r, d),
    ∠(n_j, d), ∠(n_r, n_j)), d = p_j − p_r; −1 for self pairs and distance
    bins past max_dist_bin. α = atan2(u_z, u_y), u = R_r·d. Returns
    (keys (r, n) int64, alpha (r, n) float32)."""
    d = pts[None, :, :] - ref_p[:, None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    d_hat = d / torch.where(dist > 0, dist, torch.ones_like(dist))[..., None]
    nr, nj = _unit(ref_n), _unit(nrm)
    c2 = torch.sum(nr[:, None, :] * d_hat, dim=-1)
    c3 = torch.sum(nj[None, :, :] * d_hat, dim=-1)
    c4 = prec.mm(nr, nj.T)
    a = [quant_bin(torch.arccos(torch.clamp(c, -1.0, 1.0)), D_ANGLE)
         .to(torch.int64) for c in (c2, c3, c4)]
    db = quant_bin(dist, d_dist)
    valid = (dist > 0) & (db <= max_dist_bin)
    valid &= ref_ids[:, None] != torch.arange(pts.shape[0],
                                              device=pts.device)[None, :]
    key = ((torch.where(valid, db, 0).to(torch.int64) * ANGLE_BINS + a[0])
           * ANGLE_BINS + a[1]) * ANGLE_BINS + a[2]
    key = torch.where(valid, key, -1)
    u = prec.mm(d, canonical_rotation(ref_n).transpose(1, 2))
    alpha = torch.atan2(u[..., 2], u[..., 1])
    return key, alpha


class Model(NamedTuple):
    """The reference's model description."""
    points: torch.Tensor      # (n, 3) voxelized
    normals: torch.Tensor
    d_dist: float
    max_dist_bin: int
    diameter: float           # largest bbox edge of the raw model
    keys: torch.Tensor        # (K,) occupied keys, ascending
    counts: torch.Tensor      # (K,) pairs per key
    offsets: torch.Tensor     # (K,) first pair of each key
    pair_mr: torch.Tensor     # (P,) reference point of each pair, key order
    pair_alpha: torch.Tensor  # (P,) α_m of each pair, key order


def build_model(raw_points, raw_normals, tau_d, voxelize, device,
                prec: Precision = FP32) -> Model:
    """Model description from the raw model: d_dist = tau_d · its largest
    bbox edge, the cloud voxelized at d_dist by `voxelize` (the CLI's
    float64 grid), every ordered pair (i ≠ j) keyed."""
    diameter = float((raw_points.max(0) - raw_points.min(0)).max())
    d_dist = f32(tau_d * diameter)
    mp, mn = voxelize(raw_points, raw_normals, tau_d * diameter)
    bbox = mp.max(axis=0) - mp.min(axis=0)
    max_dist_bin = int(np.linalg.norm(bbox) / d_dist) + 1
    pts = torch.as_tensor(mp, device=device)
    nrm = torch.as_tensor(mn, device=device)
    ids = torch.arange(pts.shape[0], device=device)
    key, alpha = pair_features(pts, nrm, pts, nrm, d_dist, max_dist_bin, ids,
                               prec)
    flat = key.reshape(-1)
    ok = flat >= 0
    order = torch.argsort(torch.where(ok, flat, flat.max() + 1), stable=True)
    order = order[:int(ok.sum())]
    uk, cnt = torch.unique_consecutive(flat[order], return_counts=True)
    off = torch.cumsum(cnt, 0) - cnt
    return Model(points=pts, normals=nrm, d_dist=d_dist,
                 max_dist_bin=max_dist_bin, diameter=diameter, keys=uk,
                 counts=cnt, offsets=off,
                 pair_mr=order // pts.shape[0],
                 pair_alpha=alpha.reshape(-1)[order])


def _lookup(model: Model, key):
    """(pairs of the key, index of the key in model.keys) per scene pair."""
    idx = torch.clamp(torch.searchsorted(model.keys, key), max=model.keys
                      .shape[0] - 1)
    hit = (key >= 0) & (model.keys[idx] == key)
    return torch.where(hit, model.counts[idx], 0), idx


def _chunks(n_rows, n_cols, budget=1 << 21):
    step = max(1, budget // max(n_cols, 1))
    return [(a, min(a + step, n_rows)) for a in range(0, n_rows, step)]


def vote_total(model: Model, pts, nrm, ref_point_df,
               prec: Precision = FP32) -> tuple[int, int]:
    """(total Hough votes, scene pairs that vote): Σ over scene pairs of
    the model pairs that share the pair's key (the count pass alone)."""
    ref = torch.arange(0, pts.shape[0], ref_point_df, device=pts.device)
    total = pairs = 0
    for a, b in _chunks(ref.shape[0], pts.shape[0]):
        key, _ = pair_features(pts[ref[a:b]], nrm[ref[a:b]], pts, nrm,
                               model.d_dist, model.max_dist_bin, ref[a:b],
                               prec)
        cnt = _lookup(model, key)[0]
        total += int(torch.sum(cnt))
        pairs += int(torch.count_nonzero(cnt))
    return total, pairs


def accumulate(model: Model, pts, nrm, ref_point_df,
               prec: Precision = FP32):
    """Every vote cast into the dense accumulator. Returns (accumulator
    (R, n_model, 32) int64, bin 31 empty, and the total votes)."""
    ref = torch.arange(0, pts.shape[0], ref_point_df, device=pts.device)
    n_m = model.points.shape[0]
    acc = torch.zeros(ref.shape[0] * n_m * ALPHA_SLOTS, dtype=torch.int64,
                      device=pts.device)
    total = 0
    two_pi = f32(2.0 * math.pi)
    for a, b in _chunks(ref.shape[0], pts.shape[0]):
        key, alpha_s = pair_features(pts[ref[a:b]], nrm[ref[a:b]], pts, nrm,
                                     model.d_dist, model.max_dist_bin,
                                     ref[a:b], prec)
        cnt, idx = _lookup(model, key.reshape(-1))
        n_votes = int(torch.sum(cnt))
        total += n_votes
        if n_votes == 0:
            continue
        pair = torch.repeat_interleave(
            torch.arange(cnt.shape[0], device=pts.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        slot = model.offsets[idx[pair]] + (
            torch.arange(n_votes, device=pts.device) - first[pair])
        alpha = alpha_s.reshape(-1)[pair] - model.pair_alpha[slot]
        alpha = alpha - two_pi * torch.floor((alpha + f32(math.pi)) / two_pi)
        a_bin = torch.clamp(quant_bin(alpha + f32(math.pi), D_ANGLE)
                            .to(torch.int64), 0, ALPHA_BINS - 1)
        row = pair // pts.shape[0] + a
        cell = (row * n_m + model.pair_mr[slot]) * ALPHA_SLOTS + a_bin
        acc += torch.bincount(cell, minlength=acc.shape[0])
    return acc.reshape(ref.shape[0], n_m, ALPHA_SLOTS), total


def quaternion(R):
    """Rotation → unit quaternion (w, x, y, z), w ≥ 0 (kernel.cu:128-144)."""
    def half_sqrt(x):
        return 0.5 * torch.sqrt(torch.clamp(x, min=0.0))
    r00, r11, r22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    q = torch.stack([
        half_sqrt(1.0 + r00 + r11 + r22),
        torch.copysign(half_sqrt(1.0 + r00 - r11 - r22),
                       R[:, 2, 1] - R[:, 1, 2]),
        torch.copysign(half_sqrt(1.0 - r00 + r11 - r22),
                       R[:, 0, 2] - R[:, 2, 0]),
        torch.copysign(half_sqrt(1.0 - r00 - r11 + r22),
                       R[:, 1, 0] - R[:, 0, 1]),
    ], dim=-1)
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


class Candidates(NamedTuple):
    poses: torch.Tensor       # (P, 4, 4) every surviving accumulator cell
    votes: torch.Tensor       # (P,) its count
    clustered: torch.Tensor   # (P,) clustered weighted count
    num_votes: int


def _stable_top(x, k):
    """The k largest, descending, the lower position first among equals."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def top_cells(flat, max_poses):
    """The matcher's top-K over the accumulator (voting.py:214-280): at
    most 64·max_poses cells, one stable sort; above that, the
    max(max_poses, 64) blocks of TOPK_BLOCK cells with the largest maxima
    (lower block first among equals), then the top cells of those blocks
    in that order. Returns (counts, cell indices, saturated): saturated
    when more cells, or more blocks, pass the threshold than were kept."""
    n = flat.shape[0]
    if n <= 64 * max_poses or n <= 2 * TOPK_BLOCK:
        counts, idx = _stable_top(flat, min(max_poses, n))
        blocks_over = torch.zeros((), dtype=torch.bool, device=flat.device)
    else:
        n_pad = -(-n // TOPK_BLOCK) * TOPK_BLOCK
        blocks = torch.cat([flat, torch.full((n_pad - n,), -2 ** 31,
                                             dtype=flat.dtype,
                                             device=flat.device)]) \
            .reshape(-1, TOPK_BLOCK)
        bmax = blocks.max(dim=1).values
        n_blocks = min(max(max_poses, 64), bmax.shape[0])
        _, bidx = _stable_top(bmax, n_blocks)
        counts, cidx = _stable_top(blocks[bidx].reshape(-1), max_poses)
        idx = bidx[cidx // TOPK_BLOCK] * TOPK_BLOCK + cidx % TOPK_BLOCK
        blocks_over = None
    thresh = torch.tensor(f32(VOTE_THRESHOLD), device=flat.device) \
        * counts[0].to(torch.float32)
    above = (flat.to(torch.float32) > thresh) & (flat > 0)
    saturated = torch.sum(above) > max_poses
    if blocks_over is None:
        b_above = (bmax.to(torch.float32) > thresh) & (bmax > 0)
        saturated |= torch.sum(b_above) > n_blocks
    keep = (counts.to(torch.float32) > thresh) & (counts > 0)
    return counts[keep], idx[keep], bool(saturated)


def candidates(model: Model, pts, nrm, ref_point_df, max_poses,
               prec: Precision = FP32) -> Candidates:
    """The cells that pass the relative threshold among the top-K, K
    doubled from max_poses while more pass than it holds, up to
    POSES_CEILING (the matcher's ladder); their poses
    T = R_sᵀ·Rx(α·Δ − π)·[R_m | −R_m·p_m] + p_s, and their clustered
    counts."""
    acc, total = accumulate(model, pts, nrm, ref_point_df, prec)
    flat = acc.reshape(-1)
    k = max_poses
    while True:
        votes, cell, saturated = top_cells(flat, k)
        grown = min(2 * k, POSES_CEILING, flat.shape[0])
        if not saturated or grown <= k:
            break
        k = grown
    n_m = model.points.shape[0]
    r = cell // (n_m * ALPHA_SLOTS)
    m = (cell // ALPHA_SLOTS) % n_m
    a = cell % ALPHA_SLOTS
    ref = torch.arange(0, pts.shape[0], ref_point_df, device=pts.device)[r]
    Rm = canonical_rotation(model.normals[m])
    Rs = canonical_rotation(nrm[ref])
    ang = a.to(torch.float32) * f32(D_ANGLE) - f32(math.pi)
    ca, sa = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, ca, -sa], -1),
                      torch.stack([zero, sa, ca], -1)], -2)
    RsRx = prec.mm(Rs.transpose(1, 2), Rx)
    T = torch.zeros((cell.shape[0], 4, 4), device=pts.device)
    T[:, :3, :3] = prec.mm(RsRx, Rm)
    tm = -prec.mm(Rm, model.points[m][:, :, None])
    T[:, :3, 3] = prec.mm(RsRx, tm)[:, :, 0] + pts[ref]
    T[:, 3, 3] = 1.0
    clustered = cluster(T, votes.to(torch.float32), model.d_dist, prec)
    return Candidates(poses=T, votes=votes, clustered=clustered,
                      num_votes=total)


def cluster(poses, weights, d_dist, prec: Precision = FP32):
    """Clustered count of each candidate: 1 + the weights of the candidates
    in the 26 neighbouring translation cells (own cell left out) whose
    quaternion and translation lie within ROT_THRESH and d_dist."""
    t = poses[:, :3, 3]
    d = f32(d_dist)
    cell = torch.trunc((t - torch.fmod(t, d)) / d).to(torch.int64)
    q = quaternion(poses[:, :3, :3])
    dc = cell[:, None, :] - cell[None, :, :]
    near = torch.all(torch.abs(dc) <= 1, dim=-1) & ~torch.all(dc == 0, dim=-1)
    near &= torch.abs(8.0 * (1.0 - prec.mm(q, q.T))) < f32(ROT_THRESH) ** 2
    dt = t[:, None, :] - t[None, :, :]
    near &= torch.sqrt(torch.sum(dt * dt, dim=-1)) < d
    return 1.0 + torch.sum(near.to(torch.float32) * weights[None, :], dim=1)


def icp(model: Model, scene_points, scene_normals, init, iterations,
        max_dist, prec: Precision = FP32):
    """Point-to-point ICP from each of the (C, 4, 4) starts: nearest scene
    point by ‖a‖² + ‖b‖² − 2a·b, rejected past max_dist or where the
    posed model normal and the unit scene normal have a cosine ≤ 0.5,
    then the weighted Kabsch step (det fixed), composed on the left."""
    m, mn = model.points, model.normals
    s = scene_points.to(torch.float32)
    sn = _unit(scene_normals.to(torch.float32))
    s_sq = torch.sum(s * s, dim=1)
    T = init.clone()
    max_sq = f32(max_dist) ** 2
    for _ in range(iterations):
        Rt = T[:, :3, :3].transpose(1, 2)
        mt = prec.mm(m, Rt) + T[:, None, :3, 3]
        d2 = (torch.sum(mt * mt, dim=-1)[:, :, None] + s_sq[None, None, :]
              - 2.0 * prec.mm(mt, s.T))
        nn_d2, nn = torch.min(d2, dim=-1)
        w = (nn_d2 < max_sq) & (
            torch.sum(prec.mm(mn, Rt) * sn[nn], dim=-1) > NORMAL_COS)
        w = w.to(torch.float32)
        tgt = s[nn]
        wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
        cm = torch.sum(w[..., None] * mt, dim=1) / wsum
        cs = torch.sum(w[..., None] * tgt, dim=1) / wsum
        H = prec.mm((w[..., None] * (mt - cm[:, None])).transpose(1, 2),
                    tgt - cs[:, None])
        U, _, Vt = torch.linalg.svd(H)
        V = Vt.transpose(1, 2)
        det = torch.linalg.det(prec.mm(V, U.transpose(1, 2)))
        D = torch.diag_embed(torch.stack(
            [torch.ones_like(det), torch.ones_like(det), det], dim=-1))
        R = prec.mm(prec.mm(V, D), U.transpose(1, 2))
        dT = torch.eye(4, device=s.device).repeat(T.shape[0], 1, 1)
        dT[:, :3, :3] = R
        dT[:, :3, 3] = cs - prec.mm(R, cm[:, :, None])[:, :, 0]
        T = prec.mm(dT, T)
    return T


def pose_gap(model: Model, a, b):
    """Largest displacement of a model point between poses a and b (..., 4,
    4), over the model's diameter."""
    pa = model.points @ a[..., :3, :3].transpose(-1, -2) + a[..., None, :3, 3]
    pb = model.points @ b[..., :3, :3].transpose(-1, -2) + b[..., None, :3, 3]
    return torch.amax(torch.sqrt(torch.sum((pa - pb) ** 2, dim=-1)),
                      dim=-1) / model.diameter
