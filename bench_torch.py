"""Benchmark of the PyTorch/CUDA port (objective_slam_tpu_torch) on one
NVIDIA GPU: PPF voting throughput and end-to-end pose latency.

    python3 bench_torch.py          # BENCH_SEEDS=3, BENCH_REPS=24

Prints ONE JSON line with bench.py's keys (its `extra` block, bench.py:
527-569) under the same names, beside each timed figure its spread
(`<name>_spread`: [min, max]) and its device time (`<name>_device_ms`).

The protocol is bench.py's (bench.py:212-571), which stays the JAX
package's benchmark:
  * the model is blob_cloud(20000) from default_rng(0), voxelized at
    0.1·diameter; the scenes are BENCH_SEEDS 100k-point bin-picking scans
    (utils/synthetic.bin_picking_scene), one per seed s from
    default_rng(s), each moved to the card once;
  * the voxel capacity is the largest occupancy + 2%, rounded up to 128;
    the vote caps come from the exact count pass over all seeds;
  * timed: the block engine at fixed caps (_match_core; 20 ICP iterations
    against raw[::8]), the sized drost.match runner (count pass + host
    sync inside the time), the correlation engine's pipeline, the exact
    and the correlation vote passes alone (voxel grid and keys included,
    as bench.py's vrun), and the estimated-normals run on a partial view;
  * untimed: the tally gate (tally_bitequal_check on seed 0) and the
    multi-instance recall at fixed caps.
Each repetition adds a fresh (r+1)·1e-6 to the scan, as bench.py does, so
that each repetition's vote total equals the JAX bench's.

Every timed figure is the median over all repetitions of all seeds, each
repetition ended by torch.cuda.synchronize (utils/profiling.phase); the
device time is the median of CUDA events recorded around the same calls.
`run(device="cpu", ...)` runs the same wiring on the CPU at toy size for
the tests; it records no device time (null) and names the device "cpu".
main() runs on the card only.

Environment: BENCH_SEEDS (3), BENCH_REPS (24, at least 10), BENCH_VERBOSE=1
(progress on stderr), BENCH_TRACE_DIR (a torch.profiler chrome trace of
one fixed-caps repetition of seed 0, with its kernel time in the line).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import objective_slam_tpu_torch as pt
from objective_slam_tpu_torch._common import default_device, f32
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.ops import ppf as ppf_ops
from objective_slam_tpu_torch.ops import voting as voting_ref
from objective_slam_tpu_torch.ops import voting_block, voting_corr, \
    voting_fast
from objective_slam_tpu_torch.utils import pointcloud as pc, profiling, \
    synthetic, validation

N_INSTANCES = 4
N_TOTAL = 100_000
N_MODEL_RAW = 20_000
N_INST_PTS = 15_000          # per instance, at N_TOTAL points
MIN_REPS = 10
_T0 = time.time()


def _log(msg):
    if os.environ.get("BENCH_VERBOSE", "0") == "1":
        print(f"[bench_torch {time.time() - _T0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)


def tally_bitequal_check(keys, alpha, desc, d_angle, cap, seg_cap,
                         cap_fast, cap_ref_gate):
    """The tally gate (bench.py:141-183) on the port, on one scan's keys.

    bitequal       — block engine (kernel K1) against the fallback engine
                     (kernel K2): the same vote set and the same 22-bit
                     fixed-point α binning through disjoint tally code, so
                     the accumulators and totals must be equal.
    ref_flip_votes — |block − readable float32 engine| summed / 2: the
                     readable engine subtracts α in float32 before binning,
                     so a few votes per million land one α bin over. The
                     caller bounds the rate (< 1e-4 per vote).

    Module-level, as in bench.py, so that a CPU test runs the wiring the
    card runs. Returns (bitequal, ref_votes_equal, ref_flip_votes,
    any_overflow) as Python values."""
    blk = voting_block.cast_votes_block(
        keys, alpha, desc.fast_tables.block, desc.n_points, d_angle, cap,
        seg_cap=seg_cap)
    fst = voting_fast.cast_votes_fast(
        keys, alpha, desc.fast_tables, desc.n_points, d_angle, cap_fast)
    bitequal = (torch.equal(blk.accumulator, fst.accumulator)
                and int(blk.num_votes) == int(fst.num_votes))
    overflow = bool(blk.overflowed) or bool(fst.overflowed)
    del fst
    ref = voting_ref.cast_votes(keys, alpha, desc.table, desc.n_points,
                                d_angle, cap_ref_gate)
    # Each bin flip moves one vote between adjacent cells: +1 and -1.
    ref_flip_votes = int((blk.accumulator.to(torch.int64)
                          - ref.accumulator).abs().sum()) // 2
    return (bitequal, int(blk.num_votes) == int(ref.num_votes),
            ref_flip_votes, overflow or bool(ref.overflowed))


def make_sized_runner(desc, cfg, vox_fn):
    """The production configuration: drost.match, with its exact count
    pass and host sync in every call, after the voxel grid `vox_fn`
    (bench.py:186-198). Module-level for the same reason as
    tally_bitequal_check."""
    def run_sized(raw_p, raw_n):
        vox = vox_fn(raw_p, raw_n)
        return drost.match(desc, vox.points, vox.normals, cfg,
                           icp_points=raw_p[::8], icp_normals=raw_n[::8])
    return run_sized


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _Timer:
    """Host and device times of repeated calls, by name."""

    def __init__(self, dev):
        self.dev = dev
        self.host = profiling.Timings()
        self.device = {}

    def run(self, name, fn, args_list, warm):
        """fn(*warm) once untimed, then fn(*a) for each a: the host time
        of each call ended by a synchronize, and on the card its CUDA-event
        time. Returns the last output."""
        fn(*warm)
        _sync(self.dev)
        on_card = self.dev.type == "cuda"
        out = None
        for a in args_list:
            if on_card:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            with profiling.phase(name, self.host) as hold:
                out = fn(*a)
                if on_card:
                    ev1.record()
                hold.append(out)
            if on_card:
                self.device.setdefault(name, []).append(
                    ev0.elapsed_time(ev1))
        return out

    def figure(self, name):
        """(median, [min, max], device median or None) over all calls."""
        xs = self.host.samples[name]
        dev = self.device.get(name)
        return (statistics.median(xs), [min(xs), max(xs)],
                statistics.median(dev) if dev else None)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _put(figures, key, timer, name):
    med, spread, dev_ms = timer.figure(name)
    figures[key] = med
    figures[f"{key}_spread"] = spread
    figures[f"{key}_device_ms"] = dev_ms


def _kernel_ms(prof):
    """Device time of the kernels in a torch.profiler trace (operator rows
    repeat their kernels' time and are left out)."""
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and not e.key.startswith("aten::"):
            total += us / 1e3
    return total


def run(device, n_seeds=3, reps=24, n_total=N_TOTAL,
        n_model_raw=N_MODEL_RAW, trace_dir=None):
    """The whole protocol on `device`. Returns (line, context): the JSON
    line's dict, and what a caller needs to check the kernels on the same
    inputs (the descriptions, configurations, caps and device scans).
    Smaller n_total and n_model_raw give a toy run; the instances keep
    N_INST_PTS / N_TOTAL of the scan. Raises when the tally gate fails."""
    dev = torch.device(device)
    timer = _Timer(dev)

    def to_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng0 = np.random.default_rng(0)
    mp_raw, mn_raw = synthetic.blob_cloud(rng0, n_model_raw)
    n_inst_pts = N_INST_PTS * n_total // N_TOTAL
    scenes = [synthetic.bin_picking_scene(
        np.random.default_rng(s), mp_raw, mn_raw, n_total=n_total,
        n_instances=N_INSTANCES, n_inst_pts=n_inst_pts)
        for s in range(n_seeds)]
    scenes_dev = [(to_dev(sp), to_dev(sn), truths)
                  for sp, sn, truths in scenes]

    def validate_best(pose, truths, diameter, cfg_v):
        """The winner must localize some planted instance."""
        vs = [validation.validate_pose(pose, T, diameter, cfg_v)
              for T in truths]
        return min(vs, key=lambda v: v.rot_err + (0.0 if v.match else 1e3))

    # bench.py:239-252: a fixed top-K budget of 512 cells, 20 ICP
    # iterations against an 8× stride of the raw scan.
    cfg = pt.PPFConfig(max_poses=512, ref_point_df=5, engine="fast",
                       refine_icp=True, icp_iterations=20)
    cfg_corr = pt.PPFConfig(max_poses=512, ref_point_df=5,
                            engine="correlation", refine_icp=True,
                            icp_iterations=20)
    d_dist = cfg.tau_d * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    # engine="correlation" builds the block and the correlation tables.
    desc = pt.build_model_description(mp, mn, cfg_corr, d_dist=d_dist,
                                      device=dev)
    if desc.fast_tables.block is None:
        raise RuntimeError("bench model is over the block engine's budgets")

    scene_leaf = d_dist
    occ = [int(pc.voxel_downsample(sp, sn, scene_leaf,
                                   capacity=n_total).num_voxels)
           for sp, sn, _ in scenes_dev]
    vox_capacity = ((int(max(occ) * 1.02) + 127) // 128) * 128
    ref_idx = torch.arange(0, vox_capacity, cfg.ref_point_df, device=dev)
    n_ref = ref_idx.shape[0]
    _log(f"occupancies {occ}; capacity {vox_capacity}")

    def vox_of(raw_p, raw_n):
        return pc.voxel_downsample(raw_p, raw_n, scene_leaf,
                                   capacity=vox_capacity)

    # Exact count pass per seed -> caps over all seeds (bench.py:271-282).
    counts = [drost._count_votes(desc, v.points, v.normals,
                                 cfg.ref_point_df, cfg.d_angle)
              for v in (vox_of(sp, sn) for sp, sn, _ in scenes_dev)]
    totals = [c[0] for c in counts]
    cap = drost._next_cap((max(c[1] for c in counts)
                           + voting_block.CHUNK_ROWS * n_ref) * 128)
    seg_cap = drost._next_cap(max(max(c[2] for c in counts), 1024))
    _log(f"votes {totals}; cap {cap}; seg_cap {seg_cap}")

    def pipeline(cfg_run):
        def run_one(raw_p, raw_n):
            vox = vox_of(raw_p, raw_n)
            return drost._match_core(
                desc, vox.points, vox.normals,
                ref_point_df=cfg_run.ref_point_df,
                vote_cap=cap if cfg_run.engine == "fast" else 0,
                config=cfg_run, icp_points=raw_p[::8],
                icp_normals=raw_n[::8], seg_cap=seg_cap)
        return run_one

    def stage_keys(raw_p, raw_n):
        vox = vox_of(raw_p, raw_n)
        return ppf_ops.pairwise_ppf_keys(
            vox.points, vox.normals, desc.d_dist, cfg.d_angle,
            desc.max_dist_bin, ref_indices=ref_idx)

    def vrun(p, n):
        return voting_block.cast_votes_block(
            *stage_keys(p, n), desc.fast_tables.block, desc.n_points,
            cfg.d_angle, cap, seg_cap=seg_cap)

    def vrun_corr(p, n):
        return voting_corr.cast_votes_corr(*stage_keys(p, n),
                                           desc.corr_tables, desc.n_points)

    run_fast = pipeline(cfg)
    run_corr = pipeline(cfg_corr)

    # ---- The tally gate (untimed, seed 0; bench.py:322-356) ----
    cap_ref_gate = drost._next_cap(max(totals))
    cap_fast_gate = drost._next_cap(max(totals)
                                    + voting_fast.TALLY_CHUNK * n_ref)
    gate_keys = stage_keys(scenes_dev[0][0], scenes_dev[0][1])
    eq_bf, eq_votes, ref_flips, gate_ovf = tally_bitequal_check(
        *gate_keys, desc, cfg.d_angle, cap, seg_cap, cap_fast_gate,
        cap_ref_gate)
    if gate_ovf:
        raise RuntimeError("tally gate: an engine overflowed its cap")
    if not eq_bf:
        raise RuntimeError("tally gate: the block engine's accumulator is "
                           "not bit-equal to the fallback engine's")
    if not eq_votes:
        raise RuntimeError("tally gate: vote totals differ from the "
                           "readable engine's")
    ref_flip_rate = ref_flips / max(totals[0], 1)
    if ref_flip_rate >= 1e-4:
        raise RuntimeError(f"tally gate: {ref_flips} α-bin flips against "
                           f"the readable engine ({ref_flip_rate:.2e} per "
                           "vote) exceed 1e-4")
    del gate_keys
    _log(f"tally gate: bit-equal, readable flips {ref_flips}/{totals[0]}")

    run_sized = make_sized_runner(desc, cfg, vox_of)

    matches = []
    n_votes = None
    for si, (sp_dev, sn_dev, truths) in enumerate(scenes_dev):
        # Fresh jitter per repetition, far below the leaf.
        args = [(sp_dev + f32((r + 1) * 1e-6), sn_dev) for r in range(reps)]
        warm = (sp_dev, sn_dev)
        res = timer.run("e2e", run_fast, args, warm)
        res_s = timer.run("sized", run_sized, args, warm)
        res_c = timer.run("e2e_corr", run_corr, args, warm)
        vres = timer.run("vote", vrun, args, warm)
        cres = timer.run("vote_corr", vrun_corr, args, warm)
        nv = int(vres.num_votes)
        if int(cres.num_votes) != nv:
            raise RuntimeError(f"seed {si}: the correlation engine counts "
                               f"{int(cres.num_votes)} votes, the block "
                               f"engine {nv}")
        n_votes = nv if n_votes is None else n_votes
        v = validate_best(res.pose, truths, desc.diameter, cfg)
        v_c = validate_best(res_c.pose, truths, desc.diameter, cfg)
        v_s = validate_best(res_s.pose, truths, desc.diameter, cfg)
        matches.append({
            "seed": si, "num_votes": nv,
            "match": bool(v.match), "trans_err": v.trans_err,
            "rot_err_deg": math.degrees(v.rot_err),
            "match_corr": bool(v_c.match),
            "rot_err_corr_deg": math.degrees(v_c.rot_err),
            "match_sized": bool(v_s.match),
            "overflowed": bool(res.overflowed),
            "e2e_ms": statistics.median(
                timer.host.samples["e2e"][-reps:]),
        })
        _log(f"seed {si}: e2e {matches[-1]['e2e_ms']:.1f} ms, votes {nv}, "
             f"match {v.match}, rot {matches[-1]['rot_err_deg']:.2f}")
        del args, res, res_s, res_c, vres, cres

    trace_info = None
    if trace_dir is not None:
        sp_dev, sn_dev, _ = scenes_dev[0]
        with profiling.trace(trace_dir) as prof:
            run_fast(sp_dev, sn_dev)
            _sync(dev)
        trace_info = {"path": os.path.join(trace_dir, "trace.json"),
                      "kernel_ms": _kernel_ms(prof)}

    # ---- Multi-instance recall (untimed; bench.py:419-440) ----
    cfg_mi = pt.PPFConfig(max_poses=1024, ref_point_df=5, engine="fast",
                          cluster_center_cell=True)
    run_mi = pipeline(cfg_mi)
    inst_found = []
    for sp_dev, sn_dev, truths in scenes_dev:
        poses_mi, _ = drost.extract_instances(
            run_mi(sp_dev, sn_dev), desc.diameter,
            max_instances=2 * N_INSTANCES)
        inst_found.append(sum(
            any(validation.validate_pose(p, T, desc.diameter, cfg_mi).match
                for p in poses_mi) for T in truths))
    _log(f"instances {inst_found}")

    # ---- Estimated-normals run (timed; bench.py:442-518) ----
    sp0, sn0, truths0 = scenes[0]
    viewpoint = np.array([0.0, -14.0, 7.0], np.float32)
    vis_p = np.asarray(sp0[synthetic.partial_view(sp0, sn0, viewpoint)],
                       np.float32)
    nrm_radius = 0.6 * float(scene_leaf)

    def dims_of(p):
        return tuple(int(d) + 1 for d in np.floor(
            (p.max(axis=0) - p.min(axis=0)) / nrm_radius).astype(np.int64))

    mn_est = pc.estimate_normals_grid(mp_raw, nrm_radius, orient="outward",
                                      dims=dims_of(mp_raw), device=dev)
    mp_e, mn_e = pc.voxel_downsample_np(mp_raw, mn_est.cpu().numpy(), d_dist)
    desc_est = pt.build_model_description(mp_e, mn_e, cfg, d_dist=d_dist,
                                          device=dev)
    dims = dims_of(vis_p)

    def est_normals(p):
        return pc.estimate_normals_grid(p, nrm_radius, viewpoint=viewpoint,
                                        orient="viewpoint", dims=dims)

    vis_dev = to_dev(vis_p)
    vis_occ = int(pc.voxel_downsample(vis_dev, torch.zeros_like(vis_dev),
                                      scene_leaf,
                                      capacity=len(vis_p)).num_voxels)
    # 15% headroom; the dropped flag is checked on the most-jittered input.
    vis_cap = ((int(vis_occ * 1.15) + 127) // 128) * 128
    vox_chk = pc.voxel_downsample(vis_dev + f32(reps * 1e-6),
                                  torch.zeros_like(vis_dev), scene_leaf,
                                  capacity=vis_cap)
    if bool(vox_chk.dropped):
        raise RuntimeError(f"est-normals voxel capacity {vis_cap} overflowed")
    vox_e = pc.voxel_downsample(vis_dev, est_normals(vis_dev), scene_leaf,
                                capacity=vis_cap)
    tE, rE, gE = drost._count_votes(desc_est, vox_e.points, vox_e.normals,
                                    cfg.ref_point_df, cfg.d_angle)
    cap_e = drost._next_cap((rE + voting_block.CHUNK_ROWS * (
        (vis_cap + cfg.ref_point_df - 1) // cfg.ref_point_df)) * 128)
    seg_e = drost._next_cap(max(gE, 1024))

    def run_est(raw_p):
        vox = pc.voxel_downsample(raw_p, est_normals(raw_p), scene_leaf,
                                  capacity=vis_cap)
        return drost._match_core(desc_est, vox.points, vox.normals,
                                 ref_point_df=cfg.ref_point_df,
                                 vote_cap=cap_e, config=cfg,
                                 icp_points=raw_p[::2], seg_cap=seg_e)

    def nrm_only(p):
        return torch.sum(est_normals(p) * p)

    est_args = [(vis_dev + f32((r + 1) * 1e-6),) for r in range(reps)]
    timer.run("normals", nrm_only, est_args, (vis_dev,))
    res_est = timer.run("e2e_est", run_est, est_args, (vis_dev,))
    v_est = validate_best(res_est.pose, truths0, desc_est.diameter, cfg)
    del est_args

    n_mean = float(np.mean([m["num_votes"] for m in matches]))
    vote_ms = timer.figure("vote")[0]
    corr_ms = timer.figure("vote_corr")[0]
    exact_vps = n_mean / (vote_ms / 1e3)
    corr_vps = n_mean / (corr_ms / 1e3)
    votes_per_s = max(exact_vps, corr_vps)
    extra = {}
    _put(extra, "e2e_pose_ms_100k_scene", timer, "e2e")
    _put(extra, "e2e_with_sizing_ms", timer, "sized")
    extra.update({
        "tally_bitequal_on_device": eq_bf,
        "readable_engine_flip_votes": ref_flips,
        "readable_engine_flip_rate": ref_flip_rate,
    })
    _put(extra, "e2e_corr_pose_ms", timer, "e2e_corr")
    extra.update({
        "engine_headline": "exact-block" if exact_vps >= corr_vps
        else "correlation",
        "exact_engine_votes_per_s": exact_vps,
    })
    _put(extra, "exact_engine_voting_ms", timer, "vote")
    extra["correlation_votes_per_s"] = corr_vps
    _put(extra, "correlation_voting_ms", timer, "vote_corr")
    est = {"visible_points": int(len(vis_p))}
    _put(est, "normals_ms", timer, "normals")
    _put(est, "e2e_ms", timer, "e2e_est")
    est.update({"match": bool(v_est.match),
                "rot_err_deg": math.degrees(v_est.rot_err),
                "num_votes": tE})
    extra.update({
        "icp_in_e2e": True,
        "seeds": n_seeds, "reps": reps,
        "num_votes": n_votes,
        "vote_cap": cap,
        "model_points": int(desc.n_points),
        "scene_voxels": occ,
        "scene_voxel_capacity": vox_capacity,
        "pose_match": all(m["match"] for m in matches),
        "pose_match_corr": all(m["match_corr"] for m in matches),
        "pose_match_sized": all(m["match_sized"] for m in matches),
        "trans_err": float(np.mean([m["trans_err"] for m in matches])),
        "rot_err_deg": float(np.mean([m["rot_err_deg"] for m in matches])),
        "per_seed": matches,
        "overflowed": any(m["overflowed"] for m in matches),
        "instances_found": inst_found,
        "instances_planted": N_INSTANCES,
        "instance_recall": float(np.mean(inst_found)) / N_INSTANCES,
        "est_normals": est,
        "trace": trace_info,
        "device": card_line() if dev.type == "cuda" else "cpu",
    })
    line = {
        "metric": "ppf_votes_per_sec_per_chip",
        "value": votes_per_s,
        "unit": "votes/s",
        "vs_baseline": votes_per_s / 1e9,
        "extra": extra,
    }
    context = dict(desc=desc, cfg=cfg, cap=cap, seg_cap=seg_cap,
                   cap_fast_gate=cap_fast_gate, vox_of=vox_of,
                   scenes=scenes_dev, totals=totals, desc_est=desc_est,
                   vis_dev=vis_dev, est_normals=est_normals, vis_cap=vis_cap,
                   cap_e=cap_e, seg_e=seg_e, scene_leaf=scene_leaf)
    return line, context


def main() -> int:
    dev = default_device()              # raises without a card
    reps = int(os.environ.get("BENCH_REPS", "24"))
    if reps < MIN_REPS:
        raise SystemExit(f"BENCH_REPS={reps}: at least {MIN_REPS} "
                         "repetitions per figure")
    line, _ = run(dev, n_seeds=int(os.environ.get("BENCH_SEEDS", "3")),
                  reps=reps, trace_dir=os.environ.get("BENCH_TRACE_DIR"))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
