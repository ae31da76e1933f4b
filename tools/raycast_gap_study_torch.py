"""raycast_depth's documented gaps against a dense march, on the PyTorch
port: the port's counterpart of tools/raycast_gap_study.py (same scene,
flags and JSON keys; `--device`, with `--cpu` kept as its shorthand).

`models/tsdf.raycast_depth` (coarse-to-fine: nearest reads of a
3³-min-pooled field bracket the crossing, then a trilinear fine window)
documents two classes of pixels that read 0 where a dense all-trilinear
march finds a surface: rays beyond the grazing-incidence bound (a
sub-pixel silhouette ring), and rays that graze within one voxel of a
closer surface and hit a farther one more than 9·dt later. The study fuses
the tsdf_smoke tabletop scene into a 256³ volume, renders one tracking
view with both raycasts, and reports the pixels where the dense march
hits and coarse-to-fine reads 0 (and the converse), how many of those lie
within 1 px of the dense hit mask's silhouette, and the depth agreement
where both hit. The dense march uses raycast_depth's own trilinear
sample (weight-masked, unobserved reads +τ) at n_dense steps over
[t_near, t_far], with no coarse bracket.

Writes one JSON line; --out also stores it. On the card:
    python3 tools/raycast_gap_study_torch.py [--dims 256] [--img 240]
A caller that wants the CPU passes --device cpu (or --cpu).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from objective_slam_tpu_torch._common import as_tensor, default_device, \
    f32  # noqa: E402
from objective_slam_tpu_torch.models import tsdf  # noqa: E402
from objective_slam_tpu_torch.utils import pointcloud as pc, \
    synthetic  # noqa: E402

CHUNK = 32          # march steps sampled per pass


def dense_trilinear_depth(volume, intrinsics, T_wc, shape, t_near, t_far,
                          n_dense):
    """First positive→negative crossing of the trilinear field along each
    ray, over n_dense evenly spaced samples (raycast_gap_study.py:46-113),
    linearly interpolated; 0 where none. The sample is raycast_depth's."""
    dev = volume.device
    h, w = shape
    T = as_tensor(T_wc, dev)
    D, H, W = volume.dims
    vs_inv = tsdf._inv(volume.voxel_size)
    trunc = f32(volume.truncation)
    o = volume.origin
    dirs = tsdf._rotate(T[:3, :3], *tsdf._pixel_rays(intrinsics, shape, dev))
    org = T[:3, 3]
    obs_flat = torch.where(volume.weight > 0.0, volume.tsdf,
                           torch.nan).reshape(-1)

    def sample(t):
        pos = [(tsdf._fma(dirs[a], t, org[a]) - o[a]) * vs_inv - 0.5
               for a in range(3)]
        base = [tsdf._floor_index(c) for c in pos]
        frac = [c - b.to(torch.float32) for c, b in zip(pos, base)]
        val = torch.zeros_like(frac[0])
        wsum = torch.zeros_like(frac[0])
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    flat, inside = tsdf._flat_index(
                        volume, base[0] + di, base[1] + dj, base[2] + dk)
                    tv = obs_flat[flat]
                    wt = ((frac[0] if di else 1 - frac[0])
                          * (frac[1] if dj else 1 - frac[1])
                          * (frac[2] if dk else 1 - frac[2]))
                    ok = inside & ~torch.isnan(tv)
                    val = val + torch.where(ok, wt * tv, 0.0)
                    wsum = wsum + torch.where(ok, wt, 0.0)
        return torch.where(wsum > 0.5, val / torch.clamp(wsum, min=f32(1e-9)),
                           trunc)

    ts = tsdf._linspace(t_near, t_far, n_dense, dev, fused=False)
    hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
    prev_t, prev_v = ts[:1], sample(ts[0].expand(h, w))[None]
    for c0 in range(1, n_dense, CHUNK):
        t_now = ts[c0:c0 + CHUNK]
        v_now = sample(t_now[:, None, None].expand(len(t_now), h, w))
        t_prev = torch.cat([prev_t, t_now[:-1]])[:, None, None]
        v_prev = torch.cat([prev_v, v_now[:-1]])
        crossed = (v_prev > 0) & (v_now <= 0)
        first = crossed & (torch.cumsum(crossed.to(torch.int32), 0) == 1)
        frac = v_prev / torch.clamp(v_prev - v_now, min=f32(1e-9))
        d_hit = t_prev + frac * (t_now[:, None, None] - t_prev)
        d_c = torch.sum(torch.where(first, d_hit, 0.0), dim=0)
        hit = torch.where((hit == 0.0) & torch.any(first, dim=0), d_c, hit)
        prev_t, prev_v = t_now[-1:], v_now[-1:]
    return hit


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=256)
    ap.add_argument("--img", type=int, default=240)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--n_dense", type=int, default=768)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--dump", type=str, default=None,
                    help="also save the two depth maps (npz)")
    return ap.parse_args(argv)


def run(args, dev, log=sys.stderr):
    """The study on `dev`. Returns (the JSON line's dict, coarse-to-fine
    depth, dense depth) as numpy."""
    t0 = time.time()
    # The tsdf_smoke tabletop scene verbatim (object on a plane, 8-view
    # orbit), so the numbers land on the volume the smoke times.
    rng = np.random.default_rng(0)
    verts, faces = synthetic.bumpy_mesh(subdiv=4, bumps=0.35)
    mp, _mn = pc.sample_mesh_surface(verts, faces, 40_000, rng)
    obj = mp + np.float32([0, 0, 1.0])
    u = rng.uniform(-2.2, 2.2, size=(40_000, 2)).astype(np.float32)
    plane = np.concatenate([u, np.full((len(u), 1), -1.05, np.float32)],
                           axis=1)
    world = np.concatenate([obj, plane]).astype(np.float32)

    D = args.dims
    vs = 5.0 / D
    vol = tsdf.make_volume(origin=(-2.5, -2.5, -1.5), dims=(D, D, D),
                           voxel_size=vs, device=dev)
    h = w = args.img
    intr = (0.9 * w, 0.9 * w, w / 2 - 0.5, h / 2 - 0.5)
    for f in range(args.frames):
        ang = 2 * math.pi * f / args.frames
        eye = np.float32([3.2 * math.cos(ang), 3.2 * math.sin(ang), 1.6])
        T_cw = synthetic.look_at(eye, (0, 0, 0.5))
        depth = synthetic.render_depth(world, T_cw, intr, (h, w))
        vol = tsdf.integrate_depth(vol, depth, intr, T_cw)
    print(f"[gap] fused {args.frames} frames ({time.time()-t0:.0f}s)",
          file=log, flush=True)

    T_wc = np.linalg.inv(synthetic.look_at(
        np.float32([3.2, 0, 1.6]), (0, 0, 0.5)))
    t_near, t_far = 0.1, 6.0
    cf = tsdf.raycast_depth(vol, intr, T_wc, (h, w), t_near=t_near,
                            t_far=t_far).cpu().numpy()
    dense = dense_trilinear_depth(vol, intr, T_wc, (h, w), t_near, t_far,
                                  args.n_dense).cpu().numpy()
    print(f"[gap] both raycasts done ({time.time()-t0:.0f}s)",
          file=log, flush=True)

    hit_cf = cf > 0
    hit_dn = dense > 0
    miss_cf = hit_dn & ~hit_cf          # the documented gap classes
    extra_cf = hit_cf & ~hit_dn
    both = hit_cf & hit_dn

    # Silhouette edge of the dense hit mask: a hit pixel with a 4-neighbour
    # miss (or the image border); gap pixels within 1 px of it are the ring.
    pad = np.pad(hit_dn, 1, constant_values=False)
    nb_miss = (~pad[:-2, 1:-1] | ~pad[2:, 1:-1]
               | ~pad[1:-1, :-2] | ~pad[1:-1, 2:])
    edge = hit_dn & nb_miss
    epad = np.pad(edge, 1, constant_values=False)
    near_edge = np.zeros_like(edge)
    for di in (0, 1, 2):
        for dj in (0, 1, 2):
            near_edge |= epad[di:di + h, dj:dj + w]

    n_miss = int(miss_cf.sum())
    n_ring = int((miss_cf & near_edge).sum())
    dd = np.abs(cf - dense)[both]
    res = {
        "dims": D, "img": args.img, "n_dense": args.n_dense,
        "voxel_size": vs,
        "pixels": int(h * w),
        "dense_hits": int(hit_dn.sum()),
        "cf_hits": int(hit_cf.sum()),
        "missed_by_cf": n_miss,
        "missed_by_cf_pct_of_hits": 100.0 * n_miss / max(hit_dn.sum(), 1),
        "missed_within_1px_of_silhouette": n_ring,
        "missed_interior": n_miss - n_ring,
        "extra_cf_hits": int(extra_cf.sum()),
        "both_hit_abs_depth_diff_median": float(np.median(dd)) if dd.size
        else 0.0,
        "both_hit_abs_depth_diff_p99": float(np.percentile(dd, 99))
        if dd.size else 0.0,
        "both_hit_diff_over_1_voxel": int((dd > vs).sum()),
        "wall_s": time.time() - t0,
        "device": str(dev),
    }
    return res, cf, dense


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    dev = torch.device(args.device) if args.device else default_device()
    res, cf, dense = run(args, dev)
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    if args.dump:
        np.savez(args.dump, cf=cf, dense=dense)
    return 0


if __name__ == "__main__":
    sys.exit(main())
