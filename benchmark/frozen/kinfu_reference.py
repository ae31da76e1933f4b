"""Plain reference of the KinectFusion path (Newcombe et al.,
"KinectFusion: Real-time dense surface mapping and tracking", ISMAR 2011,
§3-4), written from the published description in plain PyTorch, as the
program under test states each equation:

  * the voxel-projective TSDF update (§3.3): every voxel centre projects
    into the depth image by rounding; sdf = D(u, v) − z; a voxel with a
    measurement and sdf > −τ takes tsdf ← (tsdf·w + clamp(sdf, ±τ)) /
    (w + 1) and w ← min(w + 1, w_max) (free-space carving: voxels in front
    of the surface take positive updates);
  * the zero-crossing raycast (§3.4) by the program's march: a coarse
    march of n_steps nearest reads of the observed field min-pooled over
    3³ voxels (unobserved and outside read +τ) brackets each +→− segment;
    each of the first n_brackets brackets gets fine_steps trilinear samples
    over [t − dt, t + 9·dt] (unobserved corners left out of the weights;
    less than half the weight observed reads +τ), and the first crossing,
    linearly interpolated, in bracket order is the depth;
  * projective association and the point-to-plane error (§3.5): the
    frame's vertices, moved by the estimate, project by rounding into the
    model view raycast from the previous pose; a pair counts when both
    are valid, its squared distance is under the gate (16·d² for the first
    half of the steps, then d²) and its normals' dot product over
    normal_cos;
  * the damped 6×6 normal equations (J = [p × n, n]; A = Jᵀ J + 1e-6·I,
    b = −Jᵀ r), the trust-region clamp of the rotation step to 0.08 rad
    (scaling the translation with it) and the lift by Rodrigues' formula,
    dT ∘ T_wc;
  * the lost-tracking gate: a frame is not fused, and the pose holds, when
    inliers < 0.15 · overlap or overlap < 5% of the frame's valid pixels.

Departures from the paper, as in the program: one pyramid level and a
fixed number of Gauss-Newton steps (the paper: three levels, 10/5/4
iterations), no bilateral filter on the raw depth, frame normals by
central differences of the vertex map (the paper: forward differences),
model normals by central differences of the TSDF at the nearest voxel,
the running average divided by w + 1 also at the clamp, and the model
view's vertices taken from the raycast depth along each pixel's ray.

Everything runs in float32 with TF32 off. Every matrix product, the rigid
transforms of points among them, goes through ``reference.Precision``, so
that ``Precision(tf32=True)`` gives the control: the same reference one
precision step lower. Work on the volume and on the image runs in slabs and
row blocks, so that a 512³ volume and a 640×480 image fit the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import reference as _ppf

Precision = _ppf.Precision
FP32 = _ppf.FP32
f32 = _ppf.f32

OMEGA_MAX = 0.08          # rad per Gauss-Newton step (trust region)
DAMP = 1e-6               # Levenberg damping of the 6×6 system
SLAB_VOXELS = 1 << 23     # voxels an integration slab holds
BLOCK_SAMPLES = 1 << 23   # ray samples a raycast row block holds


def tf32_off():
    """Matrix products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Volume(NamedTuple):
    tsdf: torch.Tensor        # (D, H, W) float32
    weight: torch.Tensor      # (D, H, W) float32
    origin: torch.Tensor      # (3,) float32: corner of voxel (0, 0, 0)
    voxel_size: float
    truncation: float

    def clone(self) -> "Volume":
        return self._replace(tsdf=self.tsdf.clone(),
                             weight=self.weight.clone())


def make_volume(origin, dims, voxel_size, truncation, device) -> Volume:
    D, H, W = (int(d) for d in dims)
    return Volume(torch.ones((D, H, W), dtype=torch.float32, device=device),
                  torch.zeros((D, H, W), dtype=torch.float32, device=device),
                  torch.as_tensor(origin, dtype=torch.float32,
                                  device=device).reshape(3),
                  float(voxel_size), float(truncation))


def transform(prec: Precision, T, pts):
    """T (4, 4) applied to points (..., 3)."""
    shape = pts.shape
    out = prec.mm(pts.reshape(-1, 3), T[:3, :3].T) + T[:3, 3]
    return out.reshape(shape)


def invert(prec: Precision, T):
    R = T[:3, :3]
    Ti = torch.eye(4, dtype=torch.float32, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -prec.mm(R.T, T[:3, 3:4])[:, 0]
    return Ti


def project(K, pts):
    """Rounded pixel (u, v) and depth z of camera-frame points (..., 3)."""
    fx, fy, cx, cy = (f32(k) for k in K)
    z = pts[..., 2]
    zc = torch.clamp(z, min=f32(1e-9))
    u = torch.round(torch.clamp(fx * pts[..., 0] / zc + cx, -1e9, 1e9))
    v = torch.round(torch.clamp(fy * pts[..., 1] / zc + cy, -1e9, 1e9))
    return u.to(torch.int64), v.to(torch.int64), z


def integrate(vol: Volume, depth, K, T_cw, w_max: float,
              prec: Precision = FP32):
    """The frame's voxel-projective update, in place, slab by slab over the
    first axis. Returns the number of voxels it updated."""
    D, H, W = vol.tsdf.shape
    h, w = depth.shape
    dev = vol.tsdf.device
    tau = f32(vol.truncation)
    flat_depth = depth.reshape(-1)
    jj, kk = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    step = max(1, SLAB_VOXELS // (H * W))
    updated = 0
    for i0 in range(0, D, step):
        ii = torch.arange(i0, min(D, i0 + step), device=dev)
        idx = torch.stack(torch.broadcast_tensors(
            ii[:, None, None], jj[None], kk[None]), -1)
        centres = (idx.to(torch.float32) + 0.5) * f32(vol.voxel_size) \
            + vol.origin
        u, v, z = project(K, transform(prec, T_cw, centres))
        in_img = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        meas = flat_depth[torch.clamp(v, 0, h - 1) * w
                          + torch.clamp(u, 0, w - 1)]
        sdf = meas - z
        upd = in_img & torch.isfinite(meas) & (meas > 0) & (sdf > -tau)
        t = vol.tsdf[i0:i0 + step]
        wt = vol.weight[i0:i0 + step]
        obs = torch.clamp(sdf, -tau, tau)
        t_new = torch.clamp((t * wt + obs) / (wt + 1.0), -tau, tau)
        t.copy_(torch.where(upd, t_new, t))
        wt.copy_(torch.where(upd, torch.clamp(wt + 1.0, max=f32(w_max)), wt))
        updated += int(torch.count_nonzero(upd))
    return updated


def pixel_rays(K, rows, w, device):
    """Camera-frame directions ((u − cx)/fx, (v − cy)/fy, 1) of the pixels
    of image rows `rows`, (len(rows), w, 3)."""
    fx, fy, cx, cy = (f32(k) for k in K)
    u = torch.arange(w, dtype=torch.float32, device=device)
    v = rows.to(torch.float32)
    du = ((u - cx) / fx)[None, :].expand(len(rows), w)
    dv = ((v - cy) / fy)[:, None].expand(len(rows), w)
    return torch.stack([du, dv, torch.ones_like(du)], -1)


def _min_pool3(field, fill):
    """min over each voxel's 3³ neighbourhood, outside reading `fill`."""
    pad = torch.nn.functional.pad(field[None, None], (1, 1, 1, 1, 1, 1),
                                  value=fill)
    return -torch.nn.functional.max_pool3d(-pad, 3, stride=1)[0, 0]


class _Reader:
    """Nearest and trilinear reads of the observed field of a volume."""

    def __init__(self, vol: Volume):
        self.vol = vol
        self.dims = vol.tsdf.shape
        tau = f32(vol.truncation)
        seen = vol.weight > 0
        self.coarse = _min_pool3(torch.where(seen, vol.tsdf, tau),
                                 tau).reshape(-1)
        self.obs = torch.where(seen, vol.tsdf, torch.nan).reshape(-1)

    def grid(self, pts):
        """Continuous voxel coordinates (..., 3) of world points."""
        return (pts - self.vol.origin) / f32(self.vol.voxel_size) - 0.5

    def index(self, ijk):
        D, H, W = self.dims
        inside = ((ijk >= 0) & (ijk < torch.tensor(
            [D, H, W], device=ijk.device))).all(-1)
        c = torch.maximum(ijk, torch.zeros_like(ijk))
        c = torch.minimum(c, torch.tensor([D - 1, H - 1, W - 1],
                                          device=ijk.device))
        return (c[..., 0] * H + c[..., 1]) * W + c[..., 2], inside

    def nearest(self, pts):
        flat, inside = self.index(torch.round(self.grid(pts)).to(
            torch.int64))
        return torch.where(inside, self.coarse[flat],
                           f32(self.vol.truncation))

    def trilinear(self, pts):
        g = self.grid(pts)
        base = torch.floor(g)
        frac = g - base
        base = base.to(torch.int64)
        val = torch.zeros_like(frac[..., 0])
        wsum = torch.zeros_like(val)
        for corner in range(8):
            off = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1,
                                corner & 1], device=g.device)
            flat, inside = self.index(base + off)
            tv = self.obs[flat]
            wt = torch.prod(torch.where(off.bool(), frac, 1.0 - frac), -1)
            ok = inside & ~torch.isnan(tv)
            val = val + torch.where(ok, wt * tv, 0.0)
            wsum = wsum + torch.where(ok, wt, 0.0)
        return torch.where(wsum > 0.5, val / torch.clamp(wsum, min=1e-9),
                           f32(self.vol.truncation))


def raycast(vol: Volume, K, T_wc, shape, t_near: float, t_far: float,
            n_steps: int, fine_steps: int = 32, n_brackets: int = 3,
            prec: Precision = FP32):
    """Depth (h, w) of the first zero crossing seen from camera T_wc
    (camera→world); 0 where there is none."""
    h, w = shape
    dev = vol.tsdf.device
    reader = _Reader(vol)
    ts = torch.linspace(t_near, t_far, n_steps, dtype=torch.float32,
                        device=dev)
    dt = ts[1] - ts[0]
    offs = torch.linspace(-1.0, 9.0, fine_steps, dtype=torch.float32,
                          device=dev) * dt
    rows_per = max(1, BLOCK_SAMPLES // (n_steps * w))
    out = torch.zeros((h, w), dtype=torch.float32, device=dev)
    org = T_wc[:3, 3]
    for r0 in range(0, h, rows_per):
        rows = torch.arange(r0, min(h, r0 + rows_per), device=dev)
        dirs = prec.mm(pixel_rays(K, rows, w, dev).reshape(-1, 3),
                       T_wc[:3, :3].T)                       # (n, 3)
        # Coarse march: brackets are +→− segments of the pooled field.
        pts = org + ts[:, None, None] * dirs[None]           # (S, n, 3)
        vc = reader.nearest(pts)
        crossed = (vc[:-1] > 0) & (vc[1:] <= 0)
        rank = torch.cumsum(crossed.to(torch.int32), 0)
        depth = torch.zeros(dirs.shape[0], dtype=torch.float32, device=dev)
        for k in range(1, n_brackets + 1):
            mark = crossed & (rank == k)
            found = mark.any(0)
            seg = torch.argmax(mark.to(torch.int8), 0)
            t0 = torch.where(found, ts[seg], f32(t_near))
            tw = t0[None] + offs[:, None]                    # (F, n)
            vw = reader.trilinear(org + tw[..., None] * dirs[None])
            cr = (vw[:-1] > 0) & (vw[1:] <= 0)
            hit = cr.any(0)
            j = torch.argmax(cr.to(torch.int8), 0)
            a = vw.gather(0, j[None])[0]
            b = vw.gather(0, (j + 1)[None])[0]
            ta = tw.gather(0, j[None])[0]
            tb = tw.gather(0, (j + 1)[None])[0]
            d = ta + a / torch.clamp(a - b, min=1e-9) * (tb - ta)
            take = found & hit & (depth == 0)
            depth = torch.where(take, d, depth)
        out[rows] = depth.reshape(len(rows), w)
    return out


def volume_normals(vol: Volume, pts):
    """Unit central differences of the TSDF at the nearest voxel of each
    world point (..., 3), and whether all six taps are observed."""
    reader = _Reader(vol)
    base = torch.round(reader.grid(pts)).to(torch.int64)
    tsdf, weight = vol.tsdf.reshape(-1), vol.weight.reshape(-1)
    g = []
    for a in range(3):
        off = torch.zeros(3, dtype=torch.int64, device=pts.device)
        off[a] = 1
        taps = []
        for sign in (1, -1):
            flat, inside = reader.index(base + sign * off)
            ok = inside & (weight[flat] > 0)
            taps.append(torch.where(ok, tsdf[flat], torch.nan))
        g.append(taps[0] - taps[1])
    g = torch.stack(g, -1)
    ok = torch.isfinite(g).all(-1)
    g = torch.where(ok[..., None], g, 0.0)
    n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                        min=1e-9)
    return torch.where(ok[..., None], n, 0.0), ok


def frame_maps(depth, K):
    """The frame's camera-frame vertices (h, w, 3), normals by central
    differences turned toward the camera, and its valid pixels."""
    h, w = depth.shape
    valid = torch.isfinite(depth) & (depth > 0)
    rays = pixel_rays(K, torch.arange(h, device=depth.device), w,
                      depth.device)
    v = rays * torch.where(valid, depth, 0.0)[..., None]
    dx = torch.gradient(v, dim=1)[0]
    dy = torch.gradient(v, dim=0)[0]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    n = torch.where(((n * v).sum(-1) > 0)[..., None], -n, n)
    return v, n, valid


class Track(NamedTuple):
    T_cw: torch.Tensor
    inliers: int
    overlap: int
    rms: float


def rodrigues(omega, device, prec: Precision = FP32):
    """The rotation exp([omega]×), omega (3,)."""
    th = torch.linalg.norm(omega) + 1e-12
    k = omega / th
    zero = torch.zeros((), dtype=torch.float32, device=device)
    Kx = torch.stack([torch.stack([zero, -k[2], k[1]]),
                      torch.stack([k[2], zero, -k[0]]),
                      torch.stack([-k[1], k[0], zero])])
    return (torch.eye(3, dtype=torch.float32, device=device)
            + torch.sin(th) * Kx + (1.0 - torch.cos(th)) * prec.mm(Kx, Kx))


def track(vol: Volume, depth, K, T_cw_init, iters: int,
          march: tuple, dist_thresh: float | None = None,
          normal_cos: float = 0.7, prec: Precision = FP32) -> Track:
    """Frame-to-model point-to-plane Gauss-Newton from T_cw_init (the
    previous pose): the model view raycast once from it; `march` is
    (t_near, t_far, n_steps)."""
    dev = vol.tsdf.device
    h, w = depth.shape
    if dist_thresh is None:
        dist_thresh = 6.0 * vol.voxel_size
    d2 = f32(f32(dist_thresh) ** 2)
    T_prev = T_cw_init.to(device=dev, dtype=torch.float32)
    T_wc_prev = invert(prec, T_prev)
    d_model = raycast(vol, K, T_wc_prev, (h, w), *march, prec=prec)
    rays = pixel_rays(K, torch.arange(h, device=dev), w, dev)
    v_model = (T_wc_prev[:3, 3] + d_model[..., None] * prec.mm(
        rays.reshape(-1, 3), T_wc_prev[:3, :3].T).reshape(h, w, 3))
    n_model, n_ok = volume_normals(vol, v_model)
    model_ok = ((d_model > 0) & n_ok).reshape(-1)
    v_model, n_model = v_model.reshape(-1, 3), n_model.reshape(-1, 3)

    v_cam, n_cam, valid = frame_maps(depth, K)
    v_cam, n_cam, valid = (v_cam.reshape(-1, 3), n_cam.reshape(-1, 3),
                           valid.reshape(-1))
    T_wc = T_wc_prev.clone()
    eye6 = DAMP * torch.eye(6, dtype=torch.float32, device=dev)
    for i in range(iters):
        gate = 16.0 * d2 if i < iters // 2 else d2
        pw = transform(prec, T_wc, v_cam)
        nw = prec.mm(n_cam, T_wc[:3, :3].T)
        u, v, z = project(K, transform(prec, T_prev, pw))
        in_img = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
        vm, nm = v_model[pix], n_model[pix]
        diff = pw - vm
        cand = valid & in_img & model_ok[pix]
        ok = (cand & ((diff * diff).sum(-1) < gate)
              & ((nw * nm).sum(-1) > normal_cos))
        wf = ok.to(torch.float32)
        r = (diff * nm).sum(-1)
        J = torch.cat([torch.linalg.cross(pw, nm, dim=-1), nm], -1)
        Jw = J * wf[:, None]
        A = prec.mm(Jw.T, J) + eye6
        b = -prec.mm(Jw.T, r[:, None])[:, 0]
        delta = torch.linalg.solve(A, b)
        omega, t = delta[:3], delta[3:]
        scale = torch.clamp(OMEGA_MAX / (torch.linalg.norm(omega) + 1e-12),
                            max=1.0)
        dT = torch.eye(4, dtype=torch.float32, device=dev)
        dT[:3, :3] = rodrigues(omega * scale, dev, prec)
        dT[:3, 3] = t * scale
        T_wc = prec.mm(dT, T_wc)
        n_in = wf.sum()
        rms = torch.sqrt((wf * r * r).sum() / torch.clamp(n_in, min=1.0))
        inliers, overlap = int(n_in), int(cand.sum())
    return Track(invert(prec, T_wc), inliers, overlap, float(rms))


class Stream:
    """A KinectFusion session: posed frames fused as given, later frames
    tracked from the previous pose (or a hint) and fused at the tracked
    pose unless the lost-tracking gate holds them back."""

    def __init__(self, vol: Volume, K, w_max: float, march: tuple,
                 iters: int, min_inlier_frac: float = 0.15,
                 prec: Precision = FP32):
        tf32_off()
        self.vol, self.K, self.w_max = vol, K, float(w_max)
        self.march, self.iters = march, int(iters)
        self.min_inlier_frac = float(min_inlier_frac)
        self.prec = prec
        self.T_cw = None

    def fuse(self, depth, T_cw) -> int:
        """Posed fusion; returns the number of voxels updated."""
        T = torch.as_tensor(T_cw, dtype=torch.float32,
                            device=self.vol.tsdf.device)
        n = integrate(self.vol, depth, self.K, T, self.w_max, self.prec)
        self.T_cw = T
        return n

    def step(self, depth, hint=None):
        """Track and fuse one frame: (Track, lost, voxels updated)."""
        init = self.T_cw if hint is None else torch.as_tensor(
            hint, dtype=torch.float32, device=self.vol.tsdf.device)
        res = track(self.vol, depth, self.K, init, self.iters, self.march,
                    prec=self.prec)
        valid = int((torch.isfinite(depth) & (depth > 0)).sum())
        lost = (res.inliers < self.min_inlier_frac * max(res.overlap, 1)
                or res.overlap < 0.05 * valid)
        if lost:                      # the previous pose holds
            return res, True, 0
        return res, False, self.fuse(depth, res.T_cw)


def corner_gap(T_a, T_b, origin, extent: float) -> float:
    """Largest displacement of the volume's 8 corners under world→camera
    T_a against T_b, over the volume's edge."""
    T_a, T_b = (torch.as_tensor(T, dtype=torch.float64).cpu()
                for T in (T_a, T_b))
    o = torch.as_tensor(origin, dtype=torch.float64).cpu().reshape(3)
    c = torch.tensor([[(i >> 2) & 1, (i >> 1) & 1, i & 1]
                      for i in range(8)], dtype=torch.float64) * extent + o
    d = (c @ (T_a[:3, :3] - T_b[:3, :3]).T + (T_a[:3, 3] - T_b[:3, 3]))
    return float(torch.linalg.norm(d, dim=1).max()) / extent


def rotation_deg(T_a, T_b) -> float:
    R = torch.as_tensor(T_a, dtype=torch.float64).cpu()[:3, :3].T \
        @ torch.as_tensor(T_b, dtype=torch.float64).cpu()[:3, :3]
    c = (float(torch.trace(R)) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))
