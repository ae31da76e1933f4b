"""256³ TSDF streaming-recognition smoke on the PyTorch/CUDA port, with
timings: the port's counterpart of tools/tsdf_smoke.py (same scene,
trajectory, flags and JSON keys).

Fuses synthetic depth frames of a tabletop scene (one bumpy-mesh object on
a plane) into a 256³ volume of 2 cm voxels with the sensor-model update
(free-space carving), fuses the same frames with the banded update into a
second volume, raycasts a view, extracts the surface with
capacity-from-occupancy and recognizes the object on the fused geometry
(drost.match: kernel K1, or K2 for a model over the block budgets). Then a
tracked orbit: only the first frame is posed, every later pose comes from
frame-to-model projective ICP started at the previous one, each frame is
fused at its tracked pose, and recognition runs again on that volume. The
model description is built through the same sensing pipeline (fused into
its own volume, extracted, d_dist-filtered), so model and scene share
sampling density and normal convention.

Times are host-clock milliseconds of calls that end in
torch.cuda.synchronize() on the card. `*_cold` is the first call and the
plain key the second: with no compiler in the way, cold on the card is the
first call's kernel loading, cuBLAS/cuSOLVER handle creation and the
caching allocator's growth (and the tally kernel's nvcc build when no
earlier call in the process built it). Beyond the JAX script's keys the
line has `device`, `peak_mem_gib` per phase (the card's
max_memory_allocated over the phase; null on the CPU), `overflowed` flags
(the run raises if one is set), the recognition calls' tally kernel and
each tracked frame's `lost` flag.

Prints one JSON line. On the card:
    python3 tools/tsdf_smoke_torch.py [--dims 256] [--frames 8] [--img 240]
A caller that wants the CPU passes --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import objective_slam_tpu_torch as pt  # noqa: E402
from objective_slam_tpu_torch._common import default_device  # noqa: E402
from objective_slam_tpu_torch.models import drost, tsdf  # noqa: E402
from objective_slam_tpu_torch.ops import transforms as tr  # noqa: E402
from objective_slam_tpu_torch.utils import pointcloud as pc, \
    synthetic  # noqa: E402

ORIGIN = (-2.5, -2.5, -1.5)      # a 5 m cube
EXTENT = 5.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--img", type=int, default=240)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def build_world(rng):
    """Mesh samples of the object (points, normals) and the posed-pass
    world: the object at z = 1 on a 4.4 m plane (tsdf_smoke.py:48-58)."""
    verts, faces = synthetic.bumpy_mesh(subdiv=4, bumps=0.35)
    # Dense area-uniform samples: a sensor returns a dense grid, the raw
    # vertices leave pinholes in 240² depth images.
    mp, mn = pc.sample_mesh_surface(verts, faces, 40_000, rng)
    obj = mp + np.float32([0, 0, 1.0])
    u = rng.uniform(-2.2, 2.2, size=(40_000, 2)).astype(np.float32)
    plane = np.concatenate([u, np.full((len(u), 1), -1.05, np.float32)],
                           axis=1)
    return mp, mn, np.concatenate([obj, plane]).astype(np.float32)


def clutter_world(world):
    """The tracked pass's world: three boxy objects around the target that
    constrain yaw from every viewpoint (tsdf_smoke.py:186-199)."""
    rngc = np.random.default_rng(7)
    clutter = []
    for i in range(3):
        bv, bf = synthetic.superellipsoid_mesh(subdiv=3, p=4.0,
                                               bumps=0.05 * (i + 1))
        cp_i, _ = pc.sample_mesh_surface(bv, bf, 8_000, rngc)
        cp_i = cp_i * np.float32([0.45, 0.3 + 0.12 * i, 0.55])
        q = synthetic.random_rotation_quat(rngc)
        cp_i = cp_i @ synthetic.quat_to_matrix(q).T
        ang_i = 2 * math.pi * i / 3 + 0.5
        cp_i += np.float32([1.7 * math.cos(ang_i),
                            1.7 * math.sin(ang_i), -0.55])
        clutter.append(cp_i)
    return np.concatenate([world] + clutter).astype(np.float32)


def orbit_pose(f, n):
    ang = 2 * math.pi * f / n
    eye = np.float32([3.2 * math.cos(ang), 3.2 * math.sin(ang), 1.6])
    return synthetic.look_at(eye, (0, 0, 0.5))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def peak_memory(dev, out: dict, name: str):
    """out[name] = the card's peak allocated GiB over the block; None on
    the CPU, where no device memory is measured."""
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    yield
    out[name] = None
    if dev.type == "cuda":
        sync(dev)
        out[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30


def pose_err(T, T_ref):
    td, rd = tr.ht_dist(torch.as_tensor(np.asarray(T, np.float32)),
                        torch.as_tensor(np.asarray(T_ref, np.float32)))
    return float(td), float(rd)


def model_description(mp, mn, vs, cfg, dev):
    """The model through the sensing pipeline: splat into its own volume
    at the scene's voxel size, extract, d_dist-filter (the CLI's model
    path), describe (tsdf_smoke.py:68-85)."""
    lo, hi = mp.min(axis=0) - 0.2, mp.max(axis=0) + 0.2
    md = int(np.ceil(float((hi - lo).max()) / vs / 8.0)) * 8
    mvol = tsdf.make_volume(origin=lo, dims=(md, md, md), voxel_size=vs,
                            device=dev)
    mvol = tsdf.integrate(mvol, mp, mn)
    msurf = tsdf.extract_surface(
        mvol, drost._next_cap(max(int(tsdf.surface_occupancy(mvol)), 1024)))
    mok = msurf.valid.cpu().numpy()
    fp = msurf.points.cpu().numpy()[mok]
    fn = msurf.normals.cpu().numpy()[mok]
    d_dist = cfg.tau_d * float(pc.bbox_diameter(fp))
    fp, fn = pc.voxel_downsample_np(fp, fn, d_dist)
    return pt.build_model_description(fp, fn, cfg, device=dev)


def run(args, dev):
    """The smoke on `dev`. Returns (the JSON line's dict, a context with the
    tracked recognizer, the intrinsics and the last tracked frame's depth
    and start pose, for a caller that traces a tracked frame)."""
    rng = np.random.default_rng(0)
    mp, mn, world = build_world(rng)
    D = args.dims
    vs = EXTENT / D                                 # 2 cm at 256³
    mem = {}

    def volume():
        return tsdf.make_volume(origin=ORIGIN, dims=(D, D, D), voxel_size=vs,
                                device=dev)

    cfg = pt.PPFConfig(max_poses=512, ref_point_df=2, refine_icp=True,
                       icp_iterations=8)
    rec = tsdf.StreamingRecognizer(volume(), cfg)
    with peak_memory(dev, mem, "model"):
        desc = model_description(mp, mn, vs, cfg, dev)
    rec.register_model("blob", desc)

    h = w = args.img
    intr = (0.9 * w, 0.9 * w, w / 2 - 0.5, h / 2 - 0.5)
    frames = [(synthetic.render_depth(world, T, intr, (h, w)), T)
              for T in (orbit_pose(f, args.frames)
                        for f in range(args.frames))]
    t_int = []
    with peak_memory(dev, mem, "integrate"):
        for depth, T_cw in frames:
            t0 = time.perf_counter()
            rec.integrate_depth_frame(depth, intr, T_cw)
            sync(dev)
            t_int.append(time.perf_counter() - t0)

    # Band-limited integration of the same trajectory into a fresh volume:
    # block_cap from the largest candidate count (+15%, rounded to 128).
    vol_b = volume()
    occ_blocks = max(int(tsdf.band_block_occupancy(vol_b, d, intr, T))
                     for d, T in frames)
    block_cap = ((int(occ_blocks * 1.15) + 127) // 128) * 128
    t_band = []
    band_overflowed = False
    with peak_memory(dev, mem, "integrate_banded"):
        for d, T in frames:
            t0 = time.perf_counter()
            vol_b, ovf_b = tsdf.integrate_depth_banded(vol_b, d, intr, T,
                                                       block_cap=block_cap)
            sync(dev)
            t_band.append(time.perf_counter() - t0)
            band_overflowed |= bool(ovf_b)
    if band_overflowed:
        raise RuntimeError("tsdf smoke: banded block_cap overflowed")
    del vol_b

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = fn()
        return warm, 1e3 * t_cold, 1e3 * (time.perf_counter() - t0)

    occ = int(tsdf.surface_occupancy(rec.volume))

    def do_surface():
        s = rec.surface()
        sync(dev)
        return s

    with peak_memory(dev, mem, "extract"):
        surf, t_surf_cold, t_surf = timed(do_surface)
    if bool(surf.overflowed):
        raise RuntimeError("tsdf smoke: capacity-from-occupancy overflowed")

    T_wc = np.linalg.inv(orbit_pose(0, 1))

    def do_ray():
        view = tsdf.raycast_depth(rec.volume, intr, T_wc, (h, w))
        sync(dev)
        return view

    with peak_memory(dev, mem, "raycast"):
        _, t_ray_cold, t_ray = timed(do_ray)

    def do_match():
        out = rec.recognize()["blob"]
        sync(dev)
        return out

    with peak_memory(dev, mem, "recognize"):
        out, t_match_cold, t_match = timed(do_match)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0, 0, 1.0]
    td, rd = pose_err(out.pose.cpu(), T_true)

    # The tracked orbit (tsdf_smoke.py:163-223): 7.5° per frame at the
    # default 48 frames, inside projective ICP's convergence basin.
    world_t = clutter_world(world)
    rec2 = tsdf.StreamingRecognizer(volume(), cfg)
    rec2.register_model("blob", desc)
    n_track = max(6 * args.frames, 48)
    drift = []
    t_trk = []
    lost_frames = 0
    last = None
    with peak_memory(dev, mem, "tracking"):
        for f in range(n_track):
            T_gt = orbit_pose(f, n_track)
            depth = synthetic.render_depth(world_t, T_gt, intr, (h, w))
            init = rec2.T_cw
            t0 = time.perf_counter()
            res_t = rec2.track_depth_frame(
                depth, intr, T_cw_hint=T_gt if f == 0 else None)
            sync(dev)
            t_trk.append(time.perf_counter() - t0)
            if f > 0:
                lost_frames += int(rec2.tracking_lost)
                tdt, rdt = pose_err(rec2.T_cw, T_gt)
                inl, ovl, rms = torch.stack([
                    res_t.inliers.to(torch.float32),
                    res_t.overlap.to(torch.float32), res_t.rms]).tolist()
                drift.append({"frame": f, "trans": tdt,
                              "rot_deg": math.degrees(rdt),
                              "inliers": int(inl), "overlap": int(ovl),
                              "rms": rms, "lost": rec2.tracking_lost})
                last = (depth, init)
    with peak_memory(dev, mem, "recognize_tracked"):
        out2 = rec2.recognize()["blob"]
        sync(dev)
    td2, rd2 = pose_err(out2.pose.cpu(), T_true)
    surf2 = rec2.surface()

    def criteria(t, r):
        return bool(t < 0.1 * desc.diameter and r < math.radians(12))

    line = {
        "dims": D, "voxel_size": vs, "frames": args.frames,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else str(dev),
        "integrate_ms_per_frame": 1e3 * float(np.mean(t_int[1:])),
        "integrate_banded_ms_per_frame": 1e3 * float(np.mean(t_band[1:])),
        "band_blocks_max": occ_blocks,
        "band_block_cap": block_cap,
        "band_blocks_total": (D // 8) ** 3,
        "surface_occupancy": occ,
        "surface_capacity_used": int(surf.points.shape[0]),
        "extract_ms": t_surf, "extract_ms_cold": t_surf_cold,
        "raycast_ms": t_ray, "raycast_ms_cold": t_ray_cold,
        "recognize_ms": t_match, "recognize_ms_cold": t_match_cold,
        "trans_err": td, "rot_err_deg": math.degrees(rd),
        "match": criteria(td, rd),
        "model_points": desc.n_points,
        "tally_kernel": "fast_tally (K2)" if desc.fast_tables.block is None
        else "block_tally (K1)",
        "overflowed": {"band": band_overflowed,
                       "surface": bool(surf.overflowed),
                       "surface_tracked": bool(surf2.overflowed),
                       "votes": bool(out.overflowed),
                       "votes_tracked": bool(out2.overflowed)},
        "peak_mem_gib": mem,
        "tracking": {
            "frames_tracked": n_track - 1,
            "deg_per_frame": 360.0 / n_track,
            "lost_frames": lost_frames,
            "track_ms_per_frame": 1e3 * float(np.mean(t_trk[1:])),
            "max_drift_trans": max(d["trans"] for d in drift),
            "max_drift_rot_deg": max(d["rot_deg"] for d in drift),
            "per_frame": drift,
            "recognize_trans_err": td2,
            "recognize_rot_err_deg": math.degrees(rd2),
            "recognize_match": criteria(td2, rd2),
        },
    }
    ctx = {"rec2": rec2, "intr": intr, "last_frame": last}
    return line, ctx


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()
    line, _ = run(args, dev)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
