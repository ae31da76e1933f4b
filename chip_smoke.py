#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (objective_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the repo's
checkout; imports nothing of JAX. Phases, each printing its own line:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    every kernel of the port built from csrc/ with nvcc
  3. k1-small kernel K1 (row gather + block tally) bit-equal to its plain
              version on small cases: sentinel words, padding rows naming
              the all-sentinel row, empty middle and trailing rows, a full
              buffer, a live count past the buffer, the largest model the
              block engine takes, one reference row holding most vote rows,
              and every cluster size the wrapper can pick
  4. k2-small kernel K2 (per-vote expansion + fast tally) bit-equal to its
              plain version on per-pair arrays: empty rows, a full buffer, a
              vote_cap that cuts a segment (at every cluster size), unpacked
              tables, a bucket over 4,096 pairs, n_model 1023/1024, and a
              2048-point model that takes the global-atomic path
  5. main     the bench protocol (bench.py:248-305, 419-440) on the port:
              a 280-point model, the seed-0 100k-point bin-picking scan,
              match() and match_with_state() twice, the 4-instance run at
              fixed caps, and the readable-engine flip-rate gate; K1 must
              have been launched on this path
  6. k1-bench K1 bit-equal to its plain version on the main path's
              pair table and vote rows
  7. k2-bench round 5's tally gate on the port: on the bench scan, the
              fallback engine (K2) and the block engine (K1) give the same
              accumulator and 46,218,777 votes each
  8. uwa-cli  the `alignment` CLI (objective_slam_tpu_torch.cli) on the
              UWA-analog scene 1 (tools/run_uwa_analog.py, seed 7) with the
              harness's argv: chef and chicken go through K1, trex and para
              (over the block budgets) through the fallback engine and K2;
              then K2 against its plain version on para's own per-pair
              arrays, with its packed and its unpacked tables
  9. corr-bench  the correlation engine on the bench scan (bench.py:250-256,
              316-320, 394-412): the count pass's vote total, per (row, model
              point) the block engine's total, no vote more than one α bin
              off, the runs_cap flag and retry ladder, the chunked path, and
              the pose through match()
 10. est-normals the bench's estimated-normals run (bench.py:442-518): a
              partial view, normals of model and scene by
              estimate_normals_grid on the card, matched at sized caps
 11. fnv      use_fnv_keys through K1 (bench scan) and K2 (UWA trex): the
              packed-key accumulator where the model has no hash collision
 12. uwa-cli-modes  four more CLI calls on UWA-analog scene 1: the
              harness's real-mesh argv (correlation engine, rescoring,
              point-to-plane ICP, normal-aware voxel grid), --use_fnv_keys,
              and --estimate_normals_k/--smooth_normals/--visualize on
              model points sampled by area and on the meshes' own vertices
 13. bench    bench_torch.run, the port's benchmark, at 3 seeds and 10
              repetitions; its JSON line, gate, vote total, pose flags,
              4/4 instances per seed and the est-normals match
 14. uwa-sweep  the dataset harness (tools/run_uwa_analog_torch.py) and
              analyze_uwa: UWA-analog scenes 1-3 with the synthetic models
              and scenes 1-2 with the real bone meshes, bits held against
              the JAX harness's on the CPU
 15. tsdf     the KinFu TSDF smoke (tools/tsdf_smoke_torch.py) at its
              defaults: 256³ volume of 2 cm voxels, 8 posed 240² frames
              fused dense and banded, raycast, extraction, recognition,
              then a 48-frame tracked orbit and recognition on the tracked
              volume; holds 47 frames tracked, none of the first 23 lost
              and their drift bounded, both recognitions and no cap
              overflow, and prints the whole orbit beside the JAX
              package's TPU and CPU figures; the recognitions' tally
              kernel held on their own keys; each stage's peak memory and
              one traced tracked frame's busy share
 16. times    medians over repetitions, each ended by a synchronize, each
              kernel's device time from torch.profiler, both kernels at
              every cluster size (blocks per reference row), and the new
              paths' stages
Every path that launches K1 or K2 also holds that kernel against its plain
version on the path's own keys and caps (the `holds` line).
Then a JSON line of kernels, the card line again, and the result line.
Any failed check raises, and the script exits non-zero.
"""

import contextlib
import gc
import io
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_SEEDS_FOR_CAPACITY = 3      # bench.py sizes the voxel capacity over 3
N_INSTANCES = 4
UWA_SEED = 7                  # run_uwa_analog.py's --seed default
BENCH_VOTES = 46_218_777      # round 5's tally gate, seed 0 (BENCH_r05.json)
# The bits the JAX package's CLI prints on the CPU for the same files and
# argv (XLA:CPU, tools/run_uwa_analog.py's scene 1 of seed 7; chef, trex,
# para, chicken).
JAX_CPU_BITS = {"base": [1, 1, 0, 1], "corr": [1, 1, 1, 1],
                "fnv": [1, 1, 0, 1], "normals": [1, 1, 1, 1],
                "normals_mesh": [1, 1, 0, 0]}
# Calls whose bits are printed beside the JAX package's and not held to
# them. On the meshes' own vertices the k-NN neighbour lists on the card
# equal the CPU's, and the CPU's equal lax.top_k's (the `knn_vs_cpu`
# numbers). The normals still differ by up to 0.04 degrees (float32 sums
# in another order), a few keys with them, and trex's weak peak (129
# votes on the CPU) goes to an alias on the card.
BITS_NOT_HELD = ("normals_mesh",)
# The bits the JAX package's harness (tools/run_uwa_analog.py, seed 7, on
# the CPU) prints per scene for the sweeps of the `uwa-sweep` phase: scenes
# 1-3 with the synthetic models (chef, trex, para, chicken) and scene 1
# with the real meshes (skull, pelvis, humerus, scapula; one real-mesh
# scene takes the JAX package about 90 minutes on the CPU).
SWEEP_SCENES = {"synthetic": 3, "real": 1}
JAX_CPU_SWEEP_BITS = {
    "synthetic": [[1, 1, 0, 1], [1, 1, 1, 1], [1, 0, 0, 1]],
    "real": [[1, 1, 0, 1]],
}
# The tracked orbit of the `tsdf` phase against the JAX package's
# tools/tsdf_smoke.py at the same defaults: its TPU figures
# (docs/eval/tsdf_smoke_256.json) and its figures on the CPU (XLA:CPU; over
# the first 23 tracked frames the largest drift, then the whole orbit's).
# Past frame 23 the orbit sits at the edge of projective ICP's basin: the
# JAX package on the CPU drifts past its TPU run's largest drift at frame
# 24 and loses 3 frames later, and whether a run keeps the orbit turns on
# float32 rounding (PERF.md §6). The first TSDF_HELD_FRAMES tracked
# frames are held to no lost frame and a drift of at most twice the TPU
# run's whole-orbit figures; the whole orbit is printed beside the
# references, and recognition on the tracked volume is held.
TSDF_JAX_REF = {
    "tpu": {"held_frames_max_rot_deg": 1.6193083987809103,
            "held_frames_max_trans": 0.04129612818360329,
            "lost_frames": 0, "max_drift_rot_deg": 3.119226584973879,
            "max_drift_trans": 0.06719598919153214,
            "recognize_rot_err_deg": 6.367966363215893},
    "cpu": {"held_frames_max_rot_deg": 1.7877219739715016,
            "held_frames_max_trans": 0.0363161601126194,
            "lost_frames": 3, "max_drift_rot_deg": 100.1967919163902,
            "max_drift_trans": 0.5836743712425232,
            "recognize_rot_err_deg": 3.1916912635297177},
}
TSDF_HELD_FRAMES = 23
TSDF_DRIFT_BOUND = {"rot_deg": 6.24, "trans": 0.134}
# Card normals against the same function on the CPU: at most this share of
# the points may differ by more than this angle (segment sums in another
# order move near-degenerate cells).
NORMALS_TOL_DEG = 1.0
NORMALS_OUTSIDE = 0.01
ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# One entry per comparison of a kernel with its plain version on a driven
# path's own inputs (hold_kernel).
HOLDS = []


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


class Phase:
    """Prints '[name] ... (t s)' when the block ends without raising."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"[{self.name}] ok ({time.perf_counter() - self.t0:.1f} s)",
                  flush=True)
        return False


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def tally_cases(dev):
    """Small K1 cases: (label, (pair2d, src_row, alpha_row, row_start_p,
    total_rows_p), n_model, cluster). The table's last row is all
    sentinels and padding vote rows name it; src_row past the live rows is
    left random, so both versions must skip those rows. cluster None lets
    the wrapper pick; the balance case also runs at every cluster size."""
    rng = np.random.default_rng(1)
    cases = []
    for label, n_model, chunk_rows, row_sizes, slack, live in [
            ("empty middle row", 24, 4, [2, 0, 3, 1, 2], 1, None),
            ("full buffer, empty tail", 100, 4, [3, 3, 0, 0], 0, None),
            ("n_model 1023", 1023, 8, [1, 2, 1], 1, None),
            ("live past row_cap", 280, 64, [0, 0, 4, 1, 1, 0], 2, 1 << 20),
            ("one heavy row", 280, 64, [1, 40, 1, 0, 2], 1, None)]:
        row_cap = (sum(row_sizes) + slack) * chunk_rows
        n_rows = 3 * row_cap // 4 + 1
        m = rng.integers(0, n_model, size=(n_rows + 1, 128)).astype(np.uint32)
        a_m = rng.integers(0, 1 << 22, size=(n_rows + 1, 128)) \
            .astype(np.uint32)
        pair2d = (m << 22) | a_m
        pair2d[rng.random((n_rows + 1, 128)) < 0.2] = 0xFFFFFFFF
        pair2d[n_rows] = 0xFFFFFFFF
        src_row = rng.integers(0, n_rows + 1, row_cap).astype(np.int32)
        src_row[rng.random(row_cap) < 0.1] = n_rows       # padding rows
        starts = np.concatenate([[0], np.cumsum(row_sizes)[:-1]]) * chunk_rows
        live = sum(row_sizes) * chunk_rows if live is None else live
        args = (torch_from(pair2d.view(np.int32), dev),
                torch_from(src_row, dev),
                torch_from(rng.integers(0, 1 << 22, row_cap).astype(np.int32),
                           dev),
                torch_from(starts.astype(np.int32), dev),
                torch.tensor(live, dtype=torch.int32, device=dev))
        clusters = [None]
        if label == "one heavy row":
            clusters += list(range(1, 9))
        if label == "n_model 1023":
            clusters.append(8)          # 8 × 130,944 B on one SM group
        cases += [(label, args, n_model, c) for c in clusters]
    return cases


def k2_tables(rng, n_model, table_len, packed, m_hi):
    """A FastModelTables with random pair tables: packed words, or
    pair_mr/pair_alpha (α_m drawn partly at the rounding half-way points,
    so the kernel's float32 rounding is held to round-half-even)."""
    from objective_slam_tpu_torch.ops import voting_fast

    m = rng.integers(0, m_hi, table_len)
    if packed:
        a_m = rng.integers(0, 1 << 22, table_len)
        words = ((m.astype(np.uint32) << 22) | a_m.astype(np.uint32))
        return voting_fast.FastModelTables(
            cnt_off=None, pair_packed=torch.from_numpy(words.view(np.int32)),
            counts=None, offsets=None, pair_mr=None, pair_alpha=None)
    scale = np.float32((1 << 22) / (2.0 * math.pi))
    alpha = rng.uniform(-math.pi, math.pi, table_len).astype(np.float32)
    half = rng.random(table_len) < 0.3
    k = rng.integers(0, 1 << 22, table_len)
    alpha[half] = ((k[half] + 0.5) / scale - np.float32(math.pi)) \
        .astype(np.float32)
    alpha[:2] = [-math.pi, math.pi]
    return voting_fast.FastModelTables(
        cnt_off=None, pair_packed=None, counts=None, offsets=None,
        pair_mr=torch.from_numpy((m - 1).astype(np.int32)),
        pair_alpha=torch.from_numpy(alpha))


def k2_cases(dev):
    """Small K2 cases on per-pair arrays: (label, (cnt, off, alpha_fix,
    row_start_p, row_tot, tables, n, vote_cap), n_model, cluster). Bucket
    offsets near the table's end run past it (the lookup clamps); some m
    fall outside [0, n_model). The cut case's vote_cap falls inside one
    scene pair's votes and runs at every cluster size."""
    from objective_slam_tpu_torch.ops import voting_fast

    rng = np.random.default_rng(2)
    cases = []
    for label, n_model, R, n, chunk, packed, empty, big, cap in [
            ("empty rows, full buffer", 24, 6, 300, 256, True, (1, 5), 0,
             "full"),
            ("vote_cap cuts a segment", 250, 5, 400, 512, True, (), 0, "cut"),
            ("force_unpacked tables", 250, 4, 300, 256, False, (2,), 0,
             "room"),
            ("bucket over 4096 pairs", 150, 3, 200, 1024, False, (), 5000,
             "room"),
            ("n_model 1023", 1023, 3, 200, 1024, True, (), 0, "room"),
            ("n_model 1024", 1024, 3, 200, 1024, True, (0,), 0, "room"),
            ("n_model 2048, global path", 2048, 3, 200, 2048, False, (), 0,
             "room")]:
        table_len = 8192
        cnt = np.where(rng.random(R * n) < 0.5, 0,
                       rng.integers(1, 12, R * n)).astype(np.int32)
        off = rng.integers(0, table_len - 8, R * n).astype(np.int32)
        if big:
            cnt[n + 7], off[n + 7] = big, 100
        for r in empty:
            cnt[r * n:(r + 1) * n] = 0
        alpha_fix = rng.integers(0, 1 << 22, R * n).astype(np.int32)
        row_tot = cnt.reshape(R, n).sum(1).astype(np.int64)
        row_tot_p = row_tot + (-row_tot) % chunk
        starts = np.concatenate([[0], np.cumsum(row_tot_p)[:-1]])
        total_p = int(row_tot_p.sum())
        heads = (np.concatenate([[0], np.cumsum(cnt)[:-1]])
                 - np.repeat(np.concatenate([[0], np.cumsum(row_tot)[:-1]])
                             - starts, n))
        if cap == "full":
            vote_cap = total_p
        elif cap == "room":
            vote_cap = total_p + 2 * chunk
        else:
            cuts = [c for c in range(chunk, total_p, chunk)
                    if np.any((heads < c) & (c < heads + cnt))]
            check(cuts, f"k2 case {label}: a vote_cap cuts a segment")
            vote_cap = cuts[len(cuts) // 2]
        m_hi = min(n_model + 3, 1024) if packed else n_model + 2
        t = k2_tables(rng, n_model, table_len, packed, m_hi)
        tables = voting_fast.FastModelTables(*[
            None if x is None else x.to(dev) for x in t])
        args = (torch_from(cnt, dev), torch_from(off, dev),
                torch_from(alpha_fix, dev),
                torch_from(starts.astype(np.int32), dev),
                torch_from(row_tot.astype(np.int32), dev), tables, n,
                vote_cap)
        clusters = [None] + (list(range(1, 9)) if cap == "cut" else [])
        cases += [(label, args, n_model, c) for c in clusters]
    return cases


def event_ms(fn, reps):
    """Per-call device times (ms) from CUDA events around each call."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def host_ms(fn, reps):
    """Per-call wall times (ms) of fn() ended by torch.cuda.synchronize()."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def build_bench_inputs(dev, n_model_raw=20_000, n_total=100_000,
                       n_inst_pts=15_000):
    """The bench model, its three seeded scans and the voxel capacity
    sized over them (bench.py:224-266). Smaller sizes serve a rehearsal of
    the main path on the CPU."""
    from objective_slam_tpu_torch.utils import pointcloud as pc, synthetic

    rng0 = np.random.default_rng(0)
    mp_raw, mn_raw = synthetic.blob_cloud(rng0, n_model_raw)
    d_dist = 0.1 * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    scenes = []
    for s in range(N_SEEDS_FOR_CAPACITY):
        sp, sn, truths = synthetic.bin_picking_scene(
            np.random.default_rng(s), mp_raw, mn_raw, n_total=n_total,
            n_instances=N_INSTANCES, n_inst_pts=n_inst_pts)
        scenes.append((torch_from(sp, dev), torch_from(sn, dev), truths))
    occ = [int(pc.voxel_downsample(sp, sn, d_dist,
                                   capacity=n_total).num_voxels)
           for sp, sn, _ in scenes]
    vox_capacity = ((int(max(occ) * 1.02) + 127) // 128) * 128
    return dict(mp_raw=mp_raw, mp=mp, mn=mn, d_dist=d_dist, scenes=scenes,
                occ=occ, vox_capacity=vox_capacity)


def top_kernels(fn, n=12):
    """Device time by kernel over one call of fn, from torch.profiler:
    [(name, calls, device ms)], largest first, and the call's device
    total. Rows of aten:: operators repeat the time of their kernels, so
    the total counts kernels only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((e.key[:60], e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    return rows[:n], sum(r[2] for r in rows if not r[0].startswith("aten::"))


def kernel_ms(fn, kernel, reps, attempts=3):
    """Device time (ms) of one launch of the CUDA kernel whose name holds
    `kernel`, from torch.profiler over `reps` calls of fn (divided by the
    launches the trace holds): the kernel alone, without the wrapper's
    host time between launches. A long process's trace can lose every
    record of a kernel; the calls are then traced again, up to
    `attempts` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if kernel in e.key and us > 0 and e.count > 0:
                return us / 1e3 / e.count
    raise RuntimeError(f"chip_smoke: no device time traced for {kernel}")


def torch_from(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def main_path(dev, inputs):
    """Phase 4: the port's main path on the bench scene. Returns the
    numbers it measured, the K1 launch count of the path, and the arrays
    that the later phases and the timings reuse."""
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally, ppf, \
        voting, voting_block
    from objective_slam_tpu_torch.utils import pointcloud as pc, validation

    cfg = pt.PPFConfig(max_poses=512, ref_point_df=5, engine="fast",
                       refine_icp=True, icp_iterations=20)
    cfg_mi = pt.PPFConfig(max_poses=1024, ref_point_df=5, engine="fast",
                          cluster_center_cell=True)
    d_dist, cap_vox = inputs["d_dist"], inputs["vox_capacity"]
    desc = pt.build_model_description(inputs["mp"], inputs["mn"], cfg,
                                      d_dist=d_dist, device=dev)
    check(desc.fast_tables is not None, "block tables built")
    # Fixed caps from the exact count pass over all seeds (bench.py:271-282).
    n_ref = len(range(0, cap_vox, cfg.ref_point_df))
    counts = []
    for sp, sn, _ in inputs["scenes"]:
        vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap_vox)
        check(not bool(vox.dropped), "voxel capacity holds the scene")
        counts.append(drost._count_votes(desc, vox.points, vox.normals,
                                         cfg.ref_point_df, cfg.d_angle))
    cap = drost._next_cap((max(c[1] for c in counts)
                           + voting_block.CHUNK_ROWS * n_ref) * 128)
    seg_cap = drost._next_cap(max(max(c[2] for c in counts), 1024))
    sp, sn, truths = inputs["scenes"][SEED]
    vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap_vox)
    total = counts[SEED][0]

    def best(pose):
        vs = [validation.validate_pose(pose, T, desc.diameter, cfg)
              for T in truths]
        return min(vs, key=lambda v: v.rot_err + (0.0 if v.match else 1e3))

    block_tally.launches = fast_tally.launches = 0
    res = pt.match(desc, vox.points, vox.normals, cfg,
                   icp_points=sp[::8], icp_normals=sn[::8])
    res1, caps = pt.match_with_state(desc, vox.points, vox.normals, cfg,
                                     icp_points=sp[::8], icp_normals=sn[::8])
    res2, caps2 = pt.match_with_state(desc, vox.points, vox.normals, cfg,
                                      state=caps, icp_points=sp[::8],
                                      icp_normals=sn[::8])
    res_mi = drost._match_core(desc, vox.points, vox.normals,
                               ref_point_df=cfg_mi.ref_point_df,
                               vote_cap=cap, config=cfg_mi, seg_cap=seg_cap)
    sync(dev)
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}

    check(launches["block_tally"] > 0, "kernel K1 launched on the main path")
    for r in (res, res1, res2, res_mi):
        check(not bool(r.overflowed), "no vote overflow")
        check(bool(torch.isfinite(r.pose).all()), "finite pose")
        check(tuple(r.pose.shape) == (4, 4), "pose shape")
    check(int(res.num_votes) == total, "match() casts every counted vote")
    check(caps2 == caps, "match_with_state reuses its caps")
    check(torch.equal(res2.accumulator, res1.accumulator),
          "match_with_state: same accumulator on the reused caps")
    v = best(res.pose.cpu())
    check(v.match, f"winner localizes an instance ({v})")
    v2 = best(res2.pose.cpu())
    check(v2.match, f"match_with_state winner localizes an instance ({v2})")

    poses_mi, _ = drost.extract_instances(res_mi, desc.diameter,
                                          max_instances=2 * N_INSTANCES)
    found = sum(any(validation.validate_pose(p, T, desc.diameter, cfg_mi)
                    .match for p in poses_mi) for T in truths)
    check(found == N_INSTANCES, f"instances found {found}/{N_INSTANCES}")

    # Readable-engine gate (bench.py:141-183, 330-356): the same vote set,
    # float32 binning, so only boundary votes may move one bin.
    ref_idx = torch.arange(0, cap_vox, cfg.ref_point_df, device=dev)
    keys, alpha = ppf.pairwise_ppf_keys(vox.points, vox.normals, desc.d_dist,
                                        cfg.d_angle, desc.max_dist_bin,
                                        ref_indices=ref_idx)
    readable = voting.cast_votes(keys, alpha, desc.table, desc.n_points,
                                 cfg.d_angle, drost._next_cap(total))
    check(int(readable.num_votes) == total, "readable engine vote total")
    flips = int((res_mi.accumulator - readable.accumulator).abs().sum()) // 2
    flip_rate = flips / max(total, 1)
    check(flip_rate < 1e-4, f"flip rate {flip_rate:.3e} per vote")
    del readable

    numbers = {
        "num_votes": total, "votes_per_seed": [c[0] for c in counts],
        "vote_cap": cap, "seg_cap": seg_cap,
        "model_points": desc.n_points, "scene_voxels": inputs["occ"],
        "scene_voxel_capacity": cap_vox, "reference_rows": n_ref,
        "match_caps": list(caps), "overflowed": bool(res.overflowed),
        "topk_saturated": bool(res.topk_saturated),
        "trans_err": v.trans_err, "rot_err_deg": math.degrees(v.rot_err),
        "instances_found": found, "instances_planted": N_INSTANCES,
        "readable_flip_votes": flips, "readable_flip_rate": flip_rate,
    }
    state = dict(desc=desc, cfg=cfg, cap=cap, seg_cap=seg_cap, sp=sp, sn=sn,
                 keys=keys, alpha=alpha, n_ref=n_ref)
    return numbers, launches, state


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the work, the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_kernel(desc, keys, alpha, n_angle, vote_cap, seg_cap, label,
                fallback=False):
    """The tally kernel that `desc` takes (K1 with block tables, else K2;
    K2 whenever `fallback`, as the fallback engine runs it) against its
    plain version on one path's own scene keys and caps. The wrapper's
    arguments are built as the engine builds them (voting_block._expand,
    voting_fast._pair_lookup); the two accumulators must be equal and hold
    every vote. Returns (kernel name, the wrapper's arguments, largest
    absolute difference)."""
    from objective_slam_tpu_torch.ops import block_tally, fast_tally, \
        voting_block, voting_fast

    n_model = desc.n_points
    if desc.fast_tables.block is not None and not fallback:
        name, k = "block_tally", block_tally
        src_row, alpha_row, row_start_p, total, _, live = \
            voting_block._expand(keys, alpha, desc.fast_tables.block,
                                 vote_cap, voting_block.CHUNK_ROWS, seg_cap)
        args = (desc.fast_tables.block.pair2d, src_row, alpha_row,
                row_start_p, live)
        got = k.block_tally(*args, n_model, n_angle)
        want = k.block_tally_plain(*args, n_model, n_angle)
    else:
        name, k = "fast_tally", fast_tally
        vote_cap = voting_fast._ceil_to(vote_cap, voting_fast.TALLY_CHUNK)
        pl = voting_fast._pair_lookup(keys, alpha, desc.fast_tables,
                                      vote_cap)
        total = pl.total
        args = (pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p, pl.row_tot,
                desc.fast_tables, keys.shape[1], vote_cap)
        got = k.fast_tally(*args, n_model, n_angle)
        want = k.fast_tally_plain_pairs(*args, n_model, n_angle)
    err = int((got - want).abs().max())
    check(err == 0, f"{name} bit-equal to its plain version on {label}")
    check(int(got.sum(dtype=torch.int64)) == int(total),
          f"{name} tallies every vote of {label}")
    HOLDS.append({"path": label, "kernel": name, "max_abs_err": err,
                  "votes": int(total), "n_model": n_model,
                  "reference_rows": int(keys.shape[0])})
    return name, args, err


def hold_scene(desc, sp, sn, cfg, label, caps=None):
    """hold_kernel on a voxelized scene as a sized match sees it: the keys
    of drost._scene_keys (FNV ranks where the description has a remap) and
    the caps of drost._match_sized_caps, unless `caps` gives them. Also
    returns the keys, α_s and caps."""
    import dataclasses

    from objective_slam_tpu_torch.models import drost

    cfg = dataclasses.replace(cfg, refine_icp=False, rescore_poses=False)
    if caps is None:
        caps = drost._match_sized_caps(desc, sp, sn, cfg)[1]
    pts, nrm, ref_idx = drost._scene_inputs(desc, sp, sn, cfg.ref_point_df)
    keys, alpha = drost._scene_keys(desc, pts, nrm, ref_idx, cfg.d_angle)
    name, args, err = hold_kernel(desc, keys, alpha, cfg.n_angle,
                                  caps.vote_cap, caps.seg_cap, label)
    return name, args, err, keys, alpha, caps


def uwa_files(workdir):
    """The UWA-analog models and scene 1 of tools/run_uwa_analog.py (seed
    7), written as the harness writes them (:244-251, 260-296). Returns
    (argv, names, truths, model diameters as the CLI takes them, n_voxels,
    capacity, argv of the `uwa-cli-modes` calls)."""
    from objective_slam_tpu_torch.utils import ply, pointcloud as pc, \
        synthetic, validation

    workdir.mkdir(parents=True, exist_ok=True)
    models = synthetic.uwa_analog_models()
    normals = {n: pc.mesh_vertex_normals(v, f) for n, (v, f) in models.items()}
    names = list(models)
    model_paths, xyz_paths, vert_paths = [], [], []
    for n, (v, f) in models.items():
        model_paths.append(str(workdir / f"{n}_model.ply"))
        ply.write_ply(model_paths[-1], v, normals[n], faces=f)
        # The same surface as points with neither normals nor faces, for
        # --estimate_normals_k: 3,000 samples by area, as a scan would be,
        # and the mesh's own vertices (see BITS_NOT_HELD).
        xyz_paths.append(str(workdir / f"{n}_xyz.ply"))
        ply.write_ply(xyz_paths[-1], pc.sample_mesh_surface(
            v, f, 3000, np.random.default_rng(UWA_SEED))[0])
        vert_paths.append(str(workdir / f"{n}_verts.ply"))
        ply.write_ply(vert_paths[-1], v)
    scale = max(synthetic.MODEL_DIAMS.values())
    leaf = synthetic.SCENE_LEAF_FACTOR * scale
    sp, sn, truths = synthetic.uwa_analog_scene(
        np.random.default_rng(UWA_SEED), models, normals)
    check(len(sp) == synthetic.N_TOTAL, "UWA-analog scene size")

    def capacity_of(normal_aware):
        n_vox = pc.voxel_downsample_np(sp, sn, leaf,
                                       normal_aware=normal_aware)[0].shape[0]
        return n_vox, ((int(n_vox * 1.15) + 127) // 128) * 128

    n_vox, capacity = capacity_of(False)
    cap_na = capacity_of(True)[1]
    scene_path = workdir / "rs1.ply"
    ply.write_ply(scene_path, sp, sn)
    truth_paths = []
    for n in names:
        truth_paths.append(str(workdir / f"rs1_{n}_truth.txt"))
        validation.write_truth_file(truth_paths[-1], truths[n][0])
    argv = ["--scene_files", str(scene_path),
            "--model_files", ",".join(model_paths),
            "--tau_d", ",".join(["0.1"] * len(names)),
            "--scene_leaf_size", str(leaf),
            "--scene_capacity", str(capacity),
            "--ref_point_df", "1", "--icp_iterations", "12",
            "--icp_max_dist_factor", "1.0", "--icp_point_to_plane", "false",
            "--normal_aware_downsample", "false", "--max_poses", "1024",
            "--validation_files", ",".join(truth_paths),
            "--loglevel", "info", "--logfile", str(workdir / "rs1_0.log")]
    modes = {
        # The harness's real-mesh argv (run_uwa_analog.py:301-337, with
        # --rescore), on the synthetic meshes.
        "corr": with_flags(argv, {
            "--scene_capacity": str(cap_na), "--icp_point_to_plane": "true",
            "--normal_aware_downsample": "true", "--engine": "correlation",
            "--runs_cap": str(cap_na * cap_na // 4),
            "--rescore_poses": "true",
            "--logfile": str(workdir / "rs1_corr.log")}),
        "fnv": with_flags(argv, {
            "--use_fnv_keys": "true",
            "--logfile": str(workdir / "rs1_fnv.log")}),
        "normals": with_flags(argv, {
            "--model_files": ",".join(xyz_paths),
            "--estimate_normals_k": "16", "--smooth_normals": "1",
            "--visualize": "true",
            "--visualize_out": str(workdir / "rs1_vis"),
            "--logfile": str(workdir / "rs1_normals.log")}),
    }
    modes["normals_mesh"] = with_flags(modes["normals"], {
        "--model_files": ",".join(vert_paths),
        "--visualize_out": str(workdir / "rs1_vis_mesh"),
        "--logfile": str(workdir / "rs1_normals_mesh.log")})
    diams = {n: pc.bbox_diameter(v) for n, (v, _) in models.items()}
    return argv, names, truths, diams, n_vox, capacity, modes


def with_flags(argv, flags):
    """A copy of the CLI argv (flag, value, flag, value, ...) with `flags`
    replaced or appended."""
    out = list(argv)
    for flag, value in flags.items():
        if flag in out:
            out[out.index(flag) + 1] = value
        else:
            out += [flag, value]
    return out


def run_cli(argv, dev):
    """One in-process CLI call with stdout captured, as the harness runs it
    (run_uwa_analog.py:297-339). Returns (rc, printed bits)."""
    from objective_slam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=dev)
    return rc, [int(b) for b in buf.getvalue().split()]


def traced_cli(argv, dev):
    """One CLI call with drost.match wrapped, so that each model's match
    is timed and its kernel launches counted (pipeline.py -> drost.match).
    The launch counts are set to 0 just before the call and read just
    after. Returns (rc, bits, per-match records, launches, (GiB allocated at
    the call's start by what earlier phases keep, peak GiB during the call,
    the former included), ms)."""
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally

    records = []
    plain_match = drost.match

    def timed_match(model, scene_points, scene_normals, config, *a, **k):
        sync(dev)
        k1, k2, t0 = block_tally.launches, fast_tally.launches, \
            time.perf_counter()
        res = plain_match(model, scene_points, scene_normals, config, *a,
                          **k)
        sync(dev)
        records.append(dict(
            desc=model, sp=scene_points, sn=scene_normals, cfg=config,
            res=res, ms=(time.perf_counter() - t0) * 1e3,
            k1=block_tally.launches - k1, k2=fast_tally.launches - k2))
        return res

    drost.match = timed_match
    block_tally.launches = fast_tally.launches = 0
    gc.collect()
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    try:
        rc, bits = run_cli(argv, dev)
    finally:
        drost.match = plain_match
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    return rc, bits, records, launches, (resident_gib, peak_gib), ms


def cli_models(names, bits, records, truths, diams):
    """Per-model numbers of one traced CLI call, with the checks every call
    must pass: the vote total is the count pass's, nothing overflowed, the
    pose is finite and the printed bit is what validate_pose says."""
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.utils import validation

    check(len(bits) == len(names) == len(records),
          f"one match bit per model ({bits})")
    per_model = {}
    for name, bit, r in zip(names, bits, records):
        desc, cfg, res = r["desc"], r["cfg"], r["res"]
        if cfg.engine == "correlation":
            engine = "correlation"
        else:
            engine = "fallback (K2)" if desc.fast_tables.block is None \
                else "block (K1)"
        total = drost._count_votes(desc, r["sp"], r["sn"], cfg.ref_point_df,
                                   cfg.d_angle)[0]
        check(int(res.num_votes) == total,
              f"{name}: votes {int(res.num_votes)} = count pass {total}")
        check(not bool(res.overflowed), f"{name}: no overflow")
        check(bool(torch.isfinite(res.pose).all()), f"{name}: finite pose")
        v = validation.validate_pose(res.pose.cpu(), truths[name][0],
                                     diams[name], cfg)
        check(bool(v.match) == bool(bit), f"{name}: printed bit")
        per_model[name] = {
            "engine": engine, "model_points": desc.n_points,
            "occupied_keys": int((desc.table.counts > 0).sum()),
            "votes": total, "bit": bit, "trans_err": v.trans_err,
            "rot_err_deg": math.degrees(v.rot_err),
            "occlusion_pct": truths[name][1], "match_ms": r["ms"],
            "k1_launches": r["k1"], "k2_launches": r["k2"],
            "topk_saturated": bool(res.topk_saturated)}
    return per_model


def uwa_cli(dev, workdir):
    """Phase 8: the CLI on UWA-analog scene 1. Returns the numbers (the
    CLI's peak device memory among them), the kernel launches of the call,
    what uwa_files returns, the per-model match records, and para's keys,
    caps and K2 arguments. Each model's kernel is held against its plain
    version on the model's own scene keys."""
    files = uwa_files(workdir)
    argv, names, truths, diams, n_vox, capacity, _ = files
    rc, bits, records, launches, (resident_gib, peak_gib), _ = traced_cli(
        argv, dev)
    check(rc == 0, f"CLI exit code {rc}")
    check(len(names) == 4, "four models")
    per_model = cli_models(names, bits, records, truths, diams)
    for name in ("trex", "para"):
        check(per_model[name]["engine"] == "fallback (K2)",
              f"{name} has no block tables")
        check(per_model[name]["k2_launches"] >= 1, f"{name} launched K2")
    for name in ("chef", "chicken"):
        check(per_model[name]["engine"] == "block (K1)",
              f"{name} has block tables")
        check(per_model[name]["k1_launches"] >= 1, f"{name} launched K1")
    check(launches["fast_tally"] >= 2, "K2 launched at least twice")
    check(bits == JAX_CPU_BITS["base"],
          f"bits {bits} as the JAX package prints them")

    # K1 on chef's and chicken's own keys, K2 on trex's and para's.
    for name, r in zip(names, records):
        kernel, k_args, err, keys, alpha, caps = hold_scene(
            r["desc"], r["sp"], r["sn"], r["cfg"], f"uwa-cli {name}")
        check(kernel == ("fast_tally" if name in ("trex", "para")
                         else "block_tally"), f"{name}: held {kernel}")
        if name == "para":
            cnt, vote_cap = k_args[0], k_args[7]
            para = dict(desc=r["desc"], cfg=r["cfg"], keys=keys, alpha=alpha,
                        k2_args=k_args, k2_err=err, vote_cap=vote_cap,
                        sp=r["sp"], sn=r["sn"], res=r["res"])
        del k_args
    numbers = {"bits": dict(zip(names, bits)), "scene_voxels": n_vox,
               "scene_capacity": capacity,
               "reference_rows": int(para["keys"].shape[0]),
               "para_vote_cap": vote_cap,
               "para_scene_pairs": int(cnt.numel()),
               "para_pairs_with_votes": int((cnt > 0).sum()),
               "resident_gib": resident_gib, "peak_mem_gib": peak_gib,
               "models": per_model}
    return numbers, launches, files, dict(zip(names, records)), para


def marginals_and_transport(corr_acc, exact_acc, n_angle):
    """The two checks that tie the correlation accumulator to an exact
    one: per (row, model point) the same total, and no vote more than one
    α bin off: corr[a] <= exact[a-1] + exact[a] + exact[a+1], cyclically
    over the n_angle bins (and the other way round)."""
    c = corr_acc[:, :, :n_angle].to(torch.int64)
    e = exact_acc[:, :, :n_angle].to(torch.int64)
    check(int(exact_acc[:, :, n_angle:].sum()) == 0
          and int(corr_acc[:, :, n_angle:].sum()) == 0,
          "no vote past the last α bin")
    check(torch.equal(c.sum(dim=2), e.sum(dim=2)),
          "correlation engine: α marginals equal the exact engine's")
    blur_e = torch.roll(e, 1, 2) + e + torch.roll(e, -1, 2)
    blur_c = torch.roll(c, 1, 2) + c + torch.roll(c, -1, 2)
    check(bool((c <= blur_e).all()) and bool((e <= blur_c).all()),
          "correlation engine: no vote moved more than one α bin")
    return int((c - e).abs().sum()) // 2


def corr_bench(dev, inputs, st):
    """Phase 9: the correlation engine on the bench scan. Returns its
    numbers, the launches of its match() call and what `times` reuses."""
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally, \
        voting_block, voting_corr
    from objective_slam_tpu_torch.utils import pointcloud as pc, validation

    cfg_corr = pt.PPFConfig(max_poses=512, ref_point_df=5,
                            engine="correlation", refine_icp=True,
                            icp_iterations=20)
    # engine="correlation" builds the block tables and the correlation
    # tables (bench.py:255-257).
    desc = pt.build_model_description(inputs["mp"], inputs["mn"], cfg_corr,
                                      d_dist=inputs["d_dist"], device=dev)
    check(desc.fast_tables.block is not None and desc.corr_tables is not None,
          "correlation description carries block and correlation tables")
    keys, alpha, n_model = st["keys"], st["alpha"], desc.n_points
    tables = desc.corr_tables
    corr = voting_corr.cast_votes_corr(keys, alpha, tables, n_model)
    exact = voting_block.cast_votes_block(
        keys, alpha, desc.fast_tables.block, n_model, cfg_corr.d_angle,
        st["cap"], seg_cap=st["seg_cap"])
    check(int(corr.num_votes) == int(exact.num_votes) == BENCH_VOTES,
          f"correlation engine counts {BENCH_VOTES} votes, got "
          f"{int(corr.num_votes)}")
    check(not bool(corr.overflowed), "no overflow at the default runs_cap")
    check(int(corr.accumulator.sum(dtype=torch.int64)) == BENCH_VOTES,
          "correlation accumulator holds every vote")
    moved = marginals_and_transport(corr.accumulator, exact.accumulator,
                                    cfg_corr.n_angle)
    del exact

    R = keys.shape[0]
    cells_per_row = (tables.k_occ + 1) * cfg_corr.n_angle
    small = voting_corr.cast_votes_corr(keys, alpha, tables, n_model,
                                        runs_cap=1024)
    check(bool(small.overflowed), "runs_cap 1024 sets overflowed")
    del small
    # A chunk budget of about a sixth of the dense histogram: the chunked
    # path, same accumulator and flags.
    budget = cells_per_row * 4 * (-(-R // 6))
    chunked = voting_corr.cast_votes_corr(keys, alpha, tables, n_model,
                                          chunk_budget_bytes=budget)
    check(not bool(chunked.overflowed)
          and int(chunked.num_votes) == BENCH_VOTES
          and torch.equal(chunked.accumulator, corr.accumulator),
          "chunked path equals the single-chunk path")
    del chunked

    sp, sn, truths = inputs["scenes"][SEED]
    vox = pc.voxel_downsample(sp, sn, inputs["d_dist"],
                              capacity=inputs["vox_capacity"])
    # The retry ladder from a cap too small, without ICP: same accumulator,
    # and a runs_cap that holds the scene.
    cfg_ladder = pt.PPFConfig(max_poses=512, ref_point_df=5,
                              engine="correlation")
    res_l, caps_l = drost._match_sized_caps(desc, vox.points, vox.normals,
                                            cfg_ladder, runs_cap=1024)
    check(not bool(res_l.overflowed) and caps_l.runs_cap > 1024
          and caps_l.vote_cap == 0, f"retry ladder ends clear ({caps_l})")
    check(torch.equal(res_l.accumulator, corr.accumulator),
          "retry ladder ends with the same accumulator")
    held = voting_corr.cast_votes_corr(keys, alpha, tables, n_model,
                                       runs_cap=caps_l.runs_cap)
    below = voting_corr.cast_votes_corr(keys, alpha, tables, n_model,
                                        runs_cap=caps_l.runs_cap // 2)
    check(not bool(held.overflowed), "the ladder's runs_cap holds the scene")
    check(bool(below.overflowed),
          "the ladder stopped at the first rung that holds: half its "
          "runs_cap, the rung before, overflows")
    del res_l, held, below

    block_tally.launches = fast_tally.launches = 0
    res = pt.match(desc, vox.points, vox.normals, cfg_corr,
                   icp_points=sp[::8], icp_normals=sn[::8])
    sync(dev)
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    check(not bool(res.overflowed) and int(res.num_votes) == BENCH_VOTES,
          "match() with the correlation engine casts every vote")
    vs = [validation.validate_pose(res.pose.cpu(), T, desc.diameter,
                                   cfg_corr) for T in truths]
    v = min(vs, key=lambda v: v.rot_err + (0.0 if v.match else 1e3))
    check(v.match, f"correlation winner localizes an instance ({v})")
    out = {
        "num_votes": int(corr.num_votes), "k_occ": tables.k_occ,
        "histogram_bytes": R * cells_per_row * 4,
        "m3_dup_bytes": tables.m3_dup.numel() * 4,
        "votes_one_bin_off": moved,
        "share_one_bin_off": moved / BENCH_VOTES,
        "ladder_runs_cap": caps_l.runs_cap,
        "chunk_budget_bytes": budget,
        "pose_match_corr": bool(v.match), "trans_err": v.trans_err,
        "rot_err_corr_deg": math.degrees(v.rot_err),
        "topk_saturated": bool(res.topk_saturated)}
    return out, launches, dict(desc=desc, cfg=cfg_corr, vox=vox)


def est_normals(dev, inputs, cfg):
    """Phase 10: the bench's estimated-normals run (bench.py:442-518).
    Model normals by estimate_normals_grid(orient="outward"), scene normals
    of a partial view by orient="viewpoint", both on the card; voxel grid,
    then _match_core at sized caps with ICP against every second raw
    point."""
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally, \
        voting_block
    from objective_slam_tpu_torch.utils import pointcloud as pc, synthetic, \
        validation

    mp_raw, d_dist = inputs["mp_raw"], inputs["d_dist"]
    sp0, sn0, truths = inputs["scenes"][SEED]
    sp0_h, sn0_h = sp0.cpu().numpy(), sn0.cpu().numpy()
    viewpoint = np.array([0.0, -14.0, 7.0], np.float32)
    vis_p = np.asarray(sp0_h[synthetic.partial_view(sp0_h, sn0_h, viewpoint)],
                       np.float32)
    radius = 0.6 * float(d_dist)

    def dims_of(p):
        return tuple(int(d) + 1 for d in np.floor(
            (p.max(axis=0) - p.min(axis=0)) / radius).astype(np.int64))

    mn_est = pc.estimate_normals_grid(mp_raw, radius, orient="outward",
                                      dims=dims_of(mp_raw), device=dev)
    mp_e, mn_e = pc.voxel_downsample_np(mp_raw, mn_est.cpu().numpy(), d_dist)
    desc = pt.build_model_description(mp_e, mn_e, cfg, d_dist=d_dist,
                                      device=dev)
    dims = dims_of(vis_p)
    vis_dev = torch_from(vis_p, dev)

    def normals(p, device=None):
        return pc.estimate_normals_grid(p, radius, viewpoint=viewpoint,
                                        orient="viewpoint", dims=dims,
                                        device=device)

    vis_occ = int(pc.voxel_downsample(vis_dev, torch.zeros_like(vis_dev),
                                      d_dist, capacity=len(vis_p)).num_voxels)
    vis_cap = ((int(vis_occ * 1.15) + 127) // 128) * 128
    nrm = normals(vis_dev)
    vox = pc.voxel_downsample(vis_dev, nrm, d_dist, capacity=vis_cap)
    check(not bool(vox.dropped), "est-normals voxel capacity holds the view")
    total, rows, segs = drost._count_votes(desc, vox.points, vox.normals,
                                           cfg.ref_point_df, cfg.d_angle)
    n_ref = (vis_cap + cfg.ref_point_df - 1) // cfg.ref_point_df
    cap = drost._next_cap((rows + voting_block.CHUNK_ROWS * n_ref) * 128)
    seg_cap = drost._next_cap(max(segs, 1024))

    def run(raw_p):
        vox = pc.voxel_downsample(raw_p, normals(raw_p), d_dist,
                                  capacity=vis_cap)
        return drost._match_core(desc, vox.points, vox.normals,
                                 ref_point_df=cfg.ref_point_df, vote_cap=cap,
                                 config=cfg, icp_points=raw_p[::2],
                                 seg_cap=seg_cap)

    block_tally.launches = fast_tally.launches = 0
    res = run(vis_dev)
    sync(dev)
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    check(launches["block_tally"] >= 1, "est-normals path launched K1")
    check(not bool(res.overflowed) and int(res.num_votes) == total,
          "est-normals run casts every counted vote")
    vs = [validation.validate_pose(res.pose.cpu(), T, desc.diameter, cfg)
          for T in truths]
    v = min(vs, key=lambda v: v.rot_err + (0.0 if v.match else 1e3))
    check(v.match, f"est-normals winner localizes an instance ({v})")
    # K1 on this path's own keys and caps (the voxel grid of `run`).
    kernel = hold_scene(desc, vox.points, vox.normals, cfg, "est-normals",
                        caps=drost.MatchCaps(cap, seg_cap, None,
                                             cfg.max_poses))[0]
    check(kernel == "block_tally", "est-normals held K1")

    # The card's normals against the same function on the CPU.
    nrm_cpu = normals(torch.from_numpy(vis_p), device="cpu")
    cos = (nrm.cpu().double() * nrm_cpu.double()).sum(dim=1).clamp(-1, 1)
    ang = torch.rad2deg(torch.arccos(cos))
    outside = float((ang > NORMALS_TOL_DEG).double().mean())
    check(outside <= NORMALS_OUTSIDE,
          f"card normals within {NORMALS_TOL_DEG} deg of the CPU's for all "
          f"but {NORMALS_OUTSIDE} of the points, got {outside}")
    out = {"visible_points": len(vis_p), "model_points": desc.n_points,
           "grid_dims": list(dims), "radius": radius,
           "voxels": int(vox.num_voxels), "voxel_capacity": vis_cap,
           "num_votes": total, "vote_cap": cap, "seg_cap": seg_cap,
           "match": bool(v.match), "trans_err": v.trans_err,
           "rot_err_deg": math.degrees(v.rot_err),
           "normals_vs_cpu_median_deg": float(ang.median()),
           "normals_vs_cpu_p99_deg": float(torch.quantile(ang, 0.99)),
           "normals_vs_cpu_max_deg": float(ang.max()),
           "normals_vs_cpu_share_over_tol": outside}
    return out, launches, dict(run=run, normals=normals, vis_dev=vis_dev)


def fnv_against_packed(desc, sp, sn, cfg, dev, label):
    """One model through use_fnv_keys and through packed keys, both at
    sized caps: bit-equal accumulators where the model's occupied keys hash
    without collision, else the conflated buckets are printed and the vote
    total is held against the FNV-mode count pass. The kernel of the
    FNV-mode run is held against its plain version on that run's keys.
    Returns the numbers and the launches of the FNV-mode run."""
    import dataclasses

    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally

    cfg = dataclasses.replace(cfg, refine_icp=False, use_fnv_keys=False)
    cfg_f = dataclasses.replace(cfg, use_fnv_keys=True)
    desc_f = pt.build_model_description(desc.points, desc.normals, cfg_f,
                                        d_dist=desc.d_dist, device=dev)
    occupied = int((desc.table.counts > 0).sum())
    k_occ = desc_f.fnv_remap.k_occ
    res_p = drost._match_sized_caps(desc, sp, sn, cfg)[0]
    block_tally.launches = fast_tally.launches = 0
    res_f, caps_f = drost._match_sized_caps(desc_f, sp, sn, cfg_f)
    sync(dev)
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    total_f = drost._count_votes(desc_f, sp, sn, cfg.ref_point_df,
                                 cfg.d_angle)[0]
    check(int(res_f.num_votes) == total_f and not bool(res_f.overflowed),
          "FNV mode casts every vote its count pass counts")
    # The kernel on the FNV-rank keys and the caps of that run.
    hold_scene(desc_f, sp, sn, cfg_f, label, caps=caps_f)
    if k_occ == occupied:
        check(torch.equal(res_f.accumulator, res_p.accumulator),
              "FNV-mode accumulator equals the packed-key one")
        check(int(res_f.num_votes) == int(res_p.num_votes),
              "FNV-mode vote total equals the packed-key one")
    else:
        print(f"  FNV collisions: {occupied} occupied packed keys share "
              f"{k_occ} hash buckets; votes {total_f} against "
              f"{int(res_p.num_votes)} with packed keys")
    return {"occupied_packed_keys": occupied, "fnv_k_occ": k_occ,
            "collision_free": k_occ == occupied,
            "votes": total_f, "votes_packed": int(res_p.num_votes),
            "match_caps": list(caps_f),
            "engine": "fallback (K2)" if desc_f.fast_tables.block is None
            else "block (K1)"}, launches


def uwa_cli_modes(dev, files, base):
    """Phase 12: the other CLI calls on the files of `uwa-cli`. After each
    call, every model that went through K1 or K2 has that kernel held
    against its plain version on its own scene keys."""
    from objective_slam_tpu_torch.utils import ply

    argv, names, truths, diams, n_vox, _, modes = files
    out, launches_by_mode = {}, {}
    records = per_model = r = None
    for mode in ("corr", "fnv", "normals", "normals_mesh"):
        # The last call's results are freed before this call's memory is
        # read.
        del records, per_model, r
        rc, bits, records, launches, (resident_gib, peak_gib), ms = \
            traced_cli(modes[mode], dev)
        check(rc == 0, f"{mode}: CLI exit code {rc}")
        per_model = cli_models(names, bits, records, truths, diams)
        if mode not in BITS_NOT_HELD:
            check(bits == JAX_CPU_BITS[mode], f"{mode}: bits {bits}, the "
                  f"JAX package prints {JAX_CPU_BITS[mode]}")
        out[mode] = {"bits": dict(zip(names, bits)),
                     "jax_cpu_bits": dict(zip(names, JAX_CPU_BITS[mode])),
                     "first_call_ms": ms, "resident_gib": resident_gib,
                     "peak_mem_gib": peak_gib, "launches": launches,
                     "models": per_model}
        launches_by_mode[mode] = launches
        for name, r in zip(names, records):
            if r["k1"] + r["k2"] > 0:
                kernel = hold_scene(r["desc"], r["sp"], r["sn"], r["cfg"],
                                    f"uwa-cli-{mode} {name}")[0]
                check((r["k1"] > 0) == (kernel == "block_tally"),
                      f"{mode} {name}: held the kernel it launched")
        if mode == "corr":
            for name, r in zip(names, records):
                check(per_model[name]["engine"] == "correlation"
                      and r["cfg"].rescore_poses
                      and r["cfg"].icp_point_to_plane,
                      f"{name}: correlation engine with rescoring")
            check(launches == {"block_tally": 0, "fast_tally": 0},
                  "the correlation engine launches neither tally kernel")
            out[mode]["scene_capacity"] = int(records[0]["sp"].shape[0])
        if mode == "fnv":
            check(bits == [base["models"][n]["bit"] for n in names],
                  "--use_fnv_keys prints uwa-cli's bits")
            for name, r in zip(names, records):
                occupied = base["models"][name]["occupied_keys"]
                k_occ = r["desc"].fnv_remap.k_occ
                per_model[name]["fnv_k_occ"] = k_occ
                if k_occ == occupied:
                    check(per_model[name]["votes"]
                          == base["models"][name]["votes"],
                          f"{name}: FNV-mode votes equal packed-key votes")
            check(launches["block_tally"] >= 2 and launches["fast_tally"] >= 2,
                  f"--use_fnv_keys went through K1 and K2 ({launches})")
        if mode in ("normals", "normals_mesh"):
            vis = pathlib.Path(modes[mode][modes[mode].index(
                "--visualize_out") + 1])
            cloud = ply.read_ply(str(vis) + ".ply")
            n_models = sum(r["desc"].n_points for r in records)
            check(len(cloud.points) == n_vox + n_models,
                  f"visualization PLY holds {n_vox} scene voxels and "
                  f"{n_models} model points, no pad row "
                  f"({len(cloud.points)})")
            check(bool(np.all(np.abs(cloud.points) < 1e4)),
                  "no far-sentinel row in the visualization")
            html = pathlib.Path(str(vis) + ".html")
            check(html.exists() and "model3@scene0" in html.read_text(),
                  "HTML viewer written with every posed model")
            out[mode]["visualization_points"] = len(cloud.points)
            out[mode]["png_written"] = pathlib.Path(str(vis)
                                                    + ".png").exists()
        if mode == "normals_mesh":
            out[mode]["knn_vs_cpu"] = knn_vs_cpu(
                modes[mode][modes[mode].index("--model_files") + 1]
                .split(","), names, dev)
    return out, launches_by_mode


def knn_vs_cpu(paths, names, dev):
    """k-NN neighbours (k = 16) and normals of each vertex-only model PLY
    on the card against the same functions on the CPU: the share of
    distance-matrix entries that differ, of points whose neighbour list
    differs, and of normals more than 1 degree apart."""
    from objective_slam_tpu_torch.utils import ply, pointcloud as pc

    out = {}
    for name, path in zip(names, paths):
        pts = torch.from_numpy(ply.read_ply(path).points)
        d2_card = pc._sq_dist(pts.to(dev)).cpu()
        d2_cpu = pc._sq_dist(pts)
        idx_card = pc.knn_indices(pts.to(dev), 16).cpu()
        idx_cpu = pc.knn_indices(pts, 16)
        n_card = pc.estimate_normals_knn(pts.to(dev), k=16,
                                         orient="outward").cpu().double()
        n_cpu = pc.estimate_normals_knn(pts, k=16, orient="outward").double()
        ang = torch.rad2deg(torch.arccos(
            (n_card * n_cpu).sum(dim=1).clamp(-1, 1)))
        out[name] = {
            "points": len(pts),
            "d2_entries_differ": float((d2_card != d2_cpu).double().mean()),
            "neighbour_lists_differ": float(
                (idx_card != idx_cpu).any(dim=1).double().mean()),
            "normals_over_1deg": float((ang > 1.0).double().mean()),
            "normals_max_deg": float(ang.max())}
    return out


def bench_phase(dev):
    """Phase 13: bench_torch.run on the card, 3 seeds and 10 repetitions.
    Holds its gate (raised inside run), the seed-0 vote total, the pose
    flags, 4/4 instances per seed and the est-normals match; then K1 on
    every seed's keys at the fixed caps and on the est-normals view, and K2
    on the gate's keys at its caps. Returns the JSON line and the launches
    of the run."""
    import bench_torch
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally
    from objective_slam_tpu_torch.utils import pointcloud as pc

    block_tally.launches = fast_tally.launches = 0
    line, ctx = bench_torch.run(dev, n_seeds=3, reps=10)
    sync(dev)
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    extra = line["extra"]
    check(extra["tally_bitequal_on_device"], "bench: K1 and K2 bit-equal")
    check(extra["num_votes"] == BENCH_VOTES
          and extra["per_seed"][0]["num_votes"] == BENCH_VOTES,
          f"bench: seed 0 casts {BENCH_VOTES} votes, got "
          f"{extra['num_votes']}")
    check(extra["readable_engine_flip_rate"] < 1e-4, "bench: flip rate")
    check(extra["pose_match"] and extra["pose_match_corr"],
          "bench: pose_match and pose_match_corr")
    check(extra["instances_found"] == [N_INSTANCES] * 3,
          f"bench: instances {extra['instances_found']}")
    check(extra["est_normals"]["match"], "bench: est-normals run matches")
    check(not extra["overflowed"], "bench: no overflow")
    check(launches["block_tally"] > 0 and launches["fast_tally"] > 0,
          f"bench launched K1 and K2 ({launches})")

    desc, cfg = ctx["desc"], ctx["cfg"]
    caps = drost.MatchCaps(ctx["cap"], ctx["seg_cap"], None, cfg.max_poses)
    for s, (sp, sn, _) in enumerate(ctx["scenes"]):
        vox = ctx["vox_of"](sp, sn)
        _, _, _, keys, alpha, _ = hold_scene(desc, vox.points, vox.normals,
                                             cfg, f"bench seed{s}",
                                             caps=caps)
        if s == 0:
            hold_kernel(desc, keys, alpha, cfg.n_angle, ctx["cap_fast_gate"],
                        None, "bench gate (fallback engine)", fallback=True)
            check(HOLDS[-1]["kernel"] == "fast_tally"
                  and HOLDS[-1]["votes"] == BENCH_VOTES,
                  "bench gate held K2 on every vote")
        del keys, alpha
    vis = ctx["vis_dev"]
    vox = pc.voxel_downsample(vis, ctx["est_normals"](vis),
                              ctx["scene_leaf"], capacity=ctx["vis_cap"])
    hold_scene(ctx["desc_est"], vox.points, vox.normals, cfg,
               "bench est-normals",
               caps=drost.MatchCaps(ctx["cap_e"], ctx["seg_e"], None,
                                    cfg.max_poses))
    return line, launches


def uwa_sweep(dev, workdir):
    """Phase 14: the dataset harness (tools/run_uwa_analog_torch.py) on the
    card, with analyze_uwa on its logs: scenes 1-3 with the synthetic
    models (the packed argv) and scenes 1-2 with the real meshes (the
    real-mesh argv), bits held against the JAX harness's on the CPU. Each
    model's match is recorded as in traced_cli; every model that launched
    K1 or K2 has that kernel held on its own keys. Returns the numbers and
    the launches of each sweep."""
    sys.path.insert(0, str(ROOT / "tools"))
    import run_uwa_analog_torch as harness
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally

    out, launches_by_kind = {}, {}
    for kind, n_scenes in SWEEP_SCENES.items():
        records = []
        plain_match = drost.match

        def counted_match(model, sp, sn, config, *a, **k):
            k1, k2 = block_tally.launches, fast_tally.launches
            t0 = time.perf_counter()
            res = plain_match(model, sp, sn, config, *a, **k)
            sync(dev)
            records.append(dict(desc=model, sp=sp, sn=sn, cfg=config,
                                ms=(time.perf_counter() - t0) * 1e3,
                                k1=block_tally.launches - k1,
                                k2=fast_tally.launches - k2))
            return res

        args = harness.parse_args([
            "--scenes", str(n_scenes), "--models", kind,
            "--outdir", str(workdir / kind)])
        drost.match = counted_match
        block_tally.launches = fast_tally.launches = 0
        t0 = time.perf_counter()
        try:
            summary = harness.sweep(args, dev)
        finally:
            drost.match = plain_match
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {"block_tally": block_tally.launches,
                    "fast_tally": fast_tally.launches}
        names = summary["models"]
        check(len(records) == n_scenes * len(names),
              f"{kind} sweep: one match per scene and model")
        want = JAX_CPU_SWEEP_BITS[kind]
        check(want is None or summary["bits"] == want,
              f"{kind} sweep: bits {summary['bits']}, the JAX harness "
              f"prints {want}")
        check(len(summary["trials"]) == n_scenes * len(names),
              f"{kind} sweep: analyze_uwa read every trial")
        check(summary["match_rate"] == float(np.mean(summary["bits"])),
              f"{kind} sweep: analyze_uwa's match rate is the CLI's bits'")
        if kind == "real":
            check(launches == {"block_tally": 0, "fast_tally": 0}
                  and all(r["cfg"].engine == "correlation" for r in records),
                  "real-mesh sweep: correlation engine, no tally kernel")
        else:
            check(launches["block_tally"] > 0 and launches["fast_tally"] > 0,
                  f"synthetic sweep launched K1 and K2 ({launches})")
        for i, r in enumerate(records):
            if r["k1"] + r["k2"] > 0:
                kernel = hold_scene(
                    r["desc"], r["sp"], r["sn"], r["cfg"],
                    f"uwa-sweep-{kind} scene{i // len(names) + 1} "
                    f"{names[i % len(names)]}")[0]
                check((r["k1"] > 0) == (kernel == "block_tally"),
                      f"{kind} sweep: held the kernel it launched")
        out[kind] = {
            "bits": summary["bits"], "jax_cpu_bits": want,
            "match_rate": summary["match_rate"],
            "per_model": summary["per_model"],
            "occlusion_curve": summary["occlusion_curve"],
            "capacity": summary["capacity"], "sweep_ms": ms,
            "match_ms": [r["ms"] for r in records], "launches": launches}
        launches_by_kind[kind] = launches
        del records
    return out, launches_by_kind


def tsdf_phase(dev, workdir):
    """Phase 15: tools/tsdf_smoke_torch.run at its defaults on the card,
    with drost.match wrapped so that each recognition's kernel launches
    are counted and its inputs kept. Holds the orbit and recognition
    criteria, then the tally kernel of each distinct recognition input on
    its own keys and caps, and traces one tracked frame. Writes the smoke's
    whole line to workdir. Returns the numbers and the launches of the
    run."""
    sys.path.insert(0, str(ROOT / "tools"))
    import tsdf_smoke_torch as smoke
    from objective_slam_tpu_torch.models import drost, tsdf
    from objective_slam_tpu_torch.ops import block_tally, fast_tally

    records = []
    plain_match = drost.match

    def counted_match(model, sp, sn, config, *a, **k):
        k1, k2 = block_tally.launches, fast_tally.launches
        res = plain_match(model, sp, sn, config, *a, **k)
        records.append(dict(desc=model, sp=sp, sn=sn, cfg=config,
                            k1=block_tally.launches - k1,
                            k2=fast_tally.launches - k2))
        return res

    drost.match = counted_match
    block_tally.launches = fast_tally.launches = 0
    t0 = time.perf_counter()
    try:
        line, ctx = smoke.run(smoke.parse_args([]), dev)
    finally:
        drost.match = plain_match
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "tsdf_smoke.json").write_text(json.dumps(line) + "\n")

    trk = line["tracking"]
    check(line["dims"] == 256 and line["band_blocks_total"] == 32768,
          "tsdf: a 256³ volume")
    check(trk["frames_tracked"] == 47 and len(trk["per_frame"]) == 47,
          f"tsdf: 47 frames tracked ({trk['frames_tracked']})")
    held = trk["per_frame"][:TSDF_HELD_FRAMES]
    held_drift = {"lost_frames": sum(f["lost"] for f in held),
                  "max_rot_deg": max(f["rot_deg"] for f in held),
                  "max_trans": max(f["trans"] for f in held)}
    check(held_drift["lost_frames"] == 0,
          f"tsdf: none of the first {TSDF_HELD_FRAMES} tracked frames lost "
          f"({held_drift})")
    check(held_drift["max_rot_deg"] <= TSDF_DRIFT_BOUND["rot_deg"]
          and held_drift["max_trans"] <= TSDF_DRIFT_BOUND["trans"],
          f"tsdf: drift over the first {TSDF_HELD_FRAMES} tracked frames "
          f"{held_drift} within {TSDF_DRIFT_BOUND}")
    check(line["match"] and trk["recognize_match"],
          f"tsdf: both recognitions match ({line['trans_err']:.4f} / "
          f"{line['rot_err_deg']:.2f}°, {trk['recognize_trans_err']:.4f} / "
          f"{trk['recognize_rot_err_deg']:.2f}°)")
    check(not any(line["overflowed"].values()),
          f"tsdf: no cap overflowed ({line['overflowed']})")
    check(all(math.isfinite(trk[k]) for k in ("max_drift_trans",
                                             "max_drift_rot_deg")),
          "tsdf: finite drift")
    check(len(records) == 3, f"tsdf: three recognitions ({len(records)})")
    kernel = "fast_tally" if records[0]["desc"].fast_tables.block is None \
        else "block_tally"
    check(launches[kernel] >= 3 and all(
        r["k1" if kernel == "block_tally" else "k2"] >= 1 for r in records),
        f"tsdf: every recognition launched {kernel} ({launches})")
    # Recognitions 1 and 2 (cold, warm) see the same surface; 3 the tracked.
    for label, r in (("tsdf posed volume", records[0]),
                     ("tsdf tracked volume", records[2])):
        held = hold_scene(r["desc"], r["sp"], r["sn"], r["cfg"], label)[0]
        check(held == kernel, f"{label}: held {held}")

    # One tracked frame (the orbit's last, from its start pose) traced.
    depth, init = ctx["last_frame"]
    rec2, intr = ctx["rec2"], ctx["intr"]

    def tracked_frame():
        return tsdf.track_frame(rec2.volume, depth, intr, init).T_cw

    tracked_frame()
    sync(dev)
    frame_ms = statistics.median(host_ms(tracked_frame, 5))
    rows, device_ms = top_kernels(tracked_frame, n=10)
    numbers = {k: v for k, v in line.items() if k != "tracking"}
    numbers["tracking"] = {k: v for k, v in trk.items() if k != "per_frame"}
    numbers["tracking"]["rot_deg_by_frame"] = [
        round(f["rot_deg"], 3) for f in trk["per_frame"]]
    numbers["tracking"]["held_frames"] = dict(held_drift,
                                              frames=TSDF_HELD_FRAMES)
    numbers.update({
        "jax_reference": TSDF_JAX_REF, "drift_bound": TSDF_DRIFT_BOUND,
        "smoke_ms": ms, "launches": launches,
        "tracked_frame": {"host_ms": frame_ms, "device_ms": device_ms,
                          "busy_share": device_ms / frame_ms,
                          "top_kernels": rows}})
    return numbers, launches


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import _build, block_tally, \
        fast_tally, voting_block, voting_fast
    from objective_slam_tpu_torch.utils import pointcloud as pc

    dev = torch.device("cuda", 0)
    with Phase("device"):
        card = card_line()
        print(f"device: {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    with Phase("build"):
        for name, log in _build.build().items():
            for line in log.splitlines():
                if "registers" in line or "smem" in line or "error" in line:
                    print(f"  {name}: {line.strip()}")

    with Phase("k1-small"):
        picked = set()
        for label, args, n_model, cluster in tally_cases(dev):
            got = block_tally.block_tally(*args, n_model, 30, cluster=cluster)
            want = block_tally.block_tally_plain(*args, n_model, 30)
            torch.cuda.synchronize()
            c = cluster or block_tally.cluster_size(args[1].shape[0],
                                                    args[3].shape[0])
            picked.add(c)
            check(torch.equal(got, want),
                  f"K1 bit-equal: {label}, cluster {c}")
        check(picked == set(range(1, block_tally.MAX_CLUSTER + 1)),
              f"K1 ran at every cluster size, got {sorted(picked)}")

    with Phase("k2-small"):
        n_global, picked = 0, set()
        for label, args, n_model, cluster in k2_cases(dev):
            got = fast_tally.fast_tally(*args, n_model, 30, cluster=cluster)
            want = fast_tally.fast_tally_plain_pairs(*args, n_model, 30)
            torch.cuda.synchronize()
            c = cluster or fast_tally.cluster_size(args[7], args[3].shape[0])
            picked.add(c)
            check(torch.equal(got, want),
                  f"K2 bit-equal: {label}, cluster {c}, vote_cap {args[7]}")
            n_global += n_model > fast_tally.SMEM_MAX_MODEL
        check(n_global > 0, "a K2 case takes the global-atomic path")
        check(picked == set(range(1, block_tally.MAX_CLUSTER + 1)),
              f"K2 ran at every cluster size, got {sorted(picked)}")

    with Phase("main"):
        torch.cuda.reset_peak_memory_stats()
        inputs = build_bench_inputs(dev)
        numbers, launches_main, st = main_path(dev, inputs)
        peak_main = torch.cuda.max_memory_allocated() / 2 ** 30
        print("main path: " + json.dumps(numbers))

    with Phase("k1-bench"):
        n_model, n_angle = st["desc"].n_points, st["cfg"].n_angle
        _, k1_args, _ = hold_kernel(st["desc"], st["keys"], st["alpha"],
                                    n_angle, st["cap"], st["seg_cap"],
                                    "main (bench-seed0)")
        pair2d, src_row, alpha_row, row_start_p, live = k1_args
        check(HOLDS[-1]["votes"] == numbers["num_votes"],
              "K1 tallies every vote of the main path")
        k1_cluster = block_tally.cluster_size(src_row.shape[0],
                                              row_start_p.shape[0])
        print(f"k1 bench shape: pair2d {tuple(pair2d.shape)}, src_row "
              f"{tuple(src_row.shape)}, live rows {int(live)}, R "
              f"{row_start_p.shape[0]}, n_model {n_model}, cluster "
              f"{k1_cluster}, votes {numbers['num_votes']}")

    with Phase("k2-bench"):
        desc, cfg = st["desc"], st["cfg"]
        fast_cap = drost._next_cap(numbers["num_votes"]
                                   + voting_fast.TALLY_CHUNK * st["n_ref"])
        fast = voting_fast.cast_votes_fast(
            st["keys"], st["alpha"], desc.fast_tables, desc.n_points,
            cfg.d_angle, fast_cap)
        block = voting_block.cast_votes_block(
            st["keys"], st["alpha"], desc.fast_tables.block, desc.n_points,
            cfg.d_angle, st["cap"], seg_cap=st["seg_cap"])
        votes = (int(fast.num_votes), int(block.num_votes))
        check(votes == (BENCH_VOTES, BENCH_VOTES),
              f"{BENCH_VOTES} votes in both engines, got {votes}")
        check(not bool(fast.overflowed) and not bool(block.overflowed),
              "no overflow in either engine")
        check(torch.equal(fast.accumulator, block.accumulator),
              "fallback engine (K2) and block engine (K1) bit-equal")
        print(f"k2 bench: votes {votes[0]} in both engines, fallback "
              f"vote_cap {fast_cap}, cluster "
              f"{fast_tally.cluster_size(fast_cap, st['n_ref'])}, "
              f"accumulators equal")
        del fast, block

    with Phase("uwa-cli"):
        uwa, launches_uwa, uwa_fileset, uwa_records, para = uwa_cli(
            dev, ROOT / "build" / "uwa_cli")
        uwa_argv = uwa_fileset[0]
        p_desc, p_cfg = para["desc"], para["cfg"]
        p_n, p_tables = p_desc.n_points, p_desc.fast_tables
        k2_args = para["k2_args"]
        p_votes = uwa["models"]["para"]["votes"]
        # The unpacked tables' float32 α_m rounding, at para's scale.
        unpacked = voting_fast.build_fast_tables(p_desc.table,
                                                 force_unpacked=True)
        check(unpacked.pair_packed is None, "para's unpacked tables")
        args_u = (*k2_args[:5], unpacked, *k2_args[6:], p_n, p_cfg.n_angle)
        check(torch.equal(fast_tally.fast_tally(*args_u),
                          fast_tally.fast_tally_plain_pairs(*args_u)),
              "K2 bit-equal on para's unpacked tables")
        uwa["para_cluster"] = fast_tally.cluster_size(para["vote_cap"],
                                                      k2_args[3].numel())
        del unpacked
        print("uwa-cli: " + json.dumps(uwa))

    with Phase("corr-bench"):
        corr_numbers, launches_corr, corr_st = corr_bench(dev, inputs, st)
        print("corr-bench: " + json.dumps(corr_numbers))

    with Phase("est-normals"):
        est_numbers, launches_est, est_st = est_normals(dev, inputs,
                                                        st["cfg"])
        print("est-normals: " + json.dumps(est_numbers))

    with Phase("fnv"):
        vox = corr_st["vox"]
        fnv_bench, launches_fnv_bench = fnv_against_packed(
            st["desc"], vox.points, vox.normals, st["cfg"], dev,
            "fnv bench-seed0")
        check(launches_fnv_bench["block_tally"] >= 1,
              "FNV mode on the bench scan launched K1")
        r = uwa_records["trex"]
        fnv_trex, launches_fnv_trex = fnv_against_packed(
            r["desc"], r["sp"], r["sn"], r["cfg"], dev, "fnv trex")
        check(launches_fnv_trex["fast_tally"] >= 1,
              "FNV mode on trex launched K2")
        print("fnv: " + json.dumps({
            "bench": fnv_bench, "bench_launches": launches_fnv_bench,
            "trex": fnv_trex, "trex_launches": launches_fnv_trex}))

    with Phase("uwa-cli-modes"):
        modes_numbers, launches_modes = uwa_cli_modes(dev, uwa_fileset, uwa)
        print("uwa-cli-modes: " + json.dumps(modes_numbers))

    with Phase("bench"):
        bench_line, launches_bench = bench_phase(dev)
        print("bench: " + json.dumps(bench_line))

    with Phase("uwa-sweep"):
        sweep_numbers, launches_sweep = uwa_sweep(dev,
                                                  ROOT / "build" / "uwa_sweep")
        print("uwa-sweep: " + json.dumps(sweep_numbers))

    with Phase("tsdf"):
        tsdf_numbers, launches_tsdf = tsdf_phase(dev, ROOT / "build" / "tsdf")
        print(f"tsdf on {card}: " + json.dumps(tsdf_numbers))

    with Phase("times"):
        cap, seg_cap = st["cap"], st["seg_cap"]
        cap_vox, d_dist = inputs["vox_capacity"], inputs["d_dist"]
        sp, sn = st["sp"], st["sn"]

        def k1():
            block_tally.block_tally(*k1_args, n_model, n_angle)

        def k1_plain():
            block_tally.block_tally_plain(*k1_args, n_model, n_angle)

        def k1_gather():
            pair2d[src_row.to(torch.int64)]

        def k2():
            fast_tally.fast_tally(*k2_args, p_n, p_cfg.n_angle)

        def k2_plain():
            fast_tally.fast_tally_plain_pairs(*k2_args, p_n, p_cfg.n_angle)

        def e2e_fixed():
            vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap_vox)
            return drost._match_core(
                desc, vox.points, vox.normals, ref_point_df=cfg.ref_point_df,
                vote_cap=cap, config=cfg, icp_points=sp[::8],
                icp_normals=sn[::8], seg_cap=seg_cap).pose

        def voting_only():
            return voting_block.cast_votes_block(
                st["keys"], st["alpha"], desc.fast_tables.block,
                desc.n_points, cfg.d_angle, cap, seg_cap=seg_cap).accumulator

        def sized():
            vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap_vox)
            return pt.match(desc, vox.points, vox.normals, cfg,
                            icp_points=sp[::8], icp_normals=sn[::8]).pose

        def para_votes():
            return voting_fast.cast_votes_fast(
                para["keys"], para["alpha"], p_tables, p_n, p_cfg.d_angle,
                para["vote_cap"]).accumulator

        def para_expand():
            return voting_fast.expand_fast(
                para["keys"], para["alpha"], p_tables, p_cfg.d_angle,
                para["vote_cap"]).m_r

        def cli_call():
            check(run_cli(uwa_argv, dev)[0] == 0, "CLI exit code")

        # The new paths' stages.
        from objective_slam_tpu_torch.ops import verify_pose, voting_corr
        from objective_slam_tpu_torch.utils import ply
        c_desc, c_cfg = corr_st["desc"], corr_st["cfg"]
        para_corr = voting_corr.build_corr_tables(p_desc.table, p_n,
                                                  p_cfg.n_angle)
        cand = para["res"].poses
        cand_ok = torch.ones(len(cand), dtype=torch.bool, device=dev)
        raw_uwa = torch_from(ply.read_ply(
            uwa_argv[uwa_argv.index("--scene_files") + 1]).points, dev)
        uwa_modes = uwa_fileset[6]

        def corr_bench_votes():
            return voting_corr.cast_votes_corr(
                st["keys"], st["alpha"], c_desc.corr_tables,
                c_desc.n_points).accumulator

        def corr_para_votes():
            return voting_corr.cast_votes_corr(
                para["keys"], para["alpha"], para_corr, p_n).accumulator

        def rescoring_para():
            return verify_pose.inlier_scores(
                cand, cand_ok, p_desc.points, para["sp"], p_desc.d_dist,
                model_normals=p_desc.normals, scene_normals=para["sn"])

        def normals_grid():
            return est_st["normals"](est_st["vis_dev"])

        def normals_knn():
            return pc.estimate_normals_knn(raw_uwa, k=16, orient="outward")

        def e2e_corr():
            vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap_vox)
            return drost._match_core(
                c_desc, vox.points, vox.normals,
                ref_point_df=c_cfg.ref_point_df, vote_cap=0, config=c_cfg,
                icp_points=sp[::8], icp_normals=sn[::8]).pose

        def e2e_est():
            return est_st["run"](est_st["vis_dev"]).pose

        for fn in (k1, k1_plain, k1_gather, k2, k2_plain, e2e_fixed,
                   voting_only, sized, para_votes, para_expand,
                   corr_bench_votes, corr_para_votes, rescoring_para,
                   normals_grid, normals_knn, e2e_corr, e2e_est):
            fn()                                    # warm-up
        torch.cuda.synchronize()
        # Kernel and plain version in turns: plain, kernel, kernel, plain.
        t_plain = event_ms(k1_plain, 5)
        t_k1 = event_ms(k1, 20) + event_ms(k1, 20)
        t_plain += event_ms(k1_plain, 5)
        t2_plain = event_ms(k2_plain, 3)
        t_k2 = event_ms(k2, 20) + event_ms(k2, 20)
        t2_plain += event_ms(k2_plain, 3)
        times = {
            "k1_ms": statistics.median(t_k1),
            "k1_kernel_ms": kernel_ms(k1, "block_tally_kernel", 20),
            "k1_plain_ms": statistics.median(t_plain),
            "k1_gather_ms": statistics.median(event_ms(k1_gather, 10)),
            "k2_ms": statistics.median(t_k2),
            "k2_kernel_ms": kernel_ms(k2, "fast_tally_kernel", 20),
            "k2_plain_ms": statistics.median(t2_plain),
            "e2e_pose_fixed_caps_ms": statistics.median(
                host_ms(e2e_fixed, 10)),
            "voting_fixed_caps_ms": statistics.median(
                event_ms(voting_only, 10)),
            "cast_votes_fast_para_ms": statistics.median(
                event_ms(para_votes, 5)),
            "expand_fast_para_ms": statistics.median(
                event_ms(para_expand, 5)),
            "match_with_sizing_ms": statistics.median(
                host_ms(sized, 3)),
            "uwa_cli_ms": statistics.median(host_ms(cli_call, 3)),
            "peak_mem_gib": peak_main,
            "uwa_cli_peak_mem_gib": uwa["peak_mem_gib"],
            "cast_votes_corr_bench_ms": statistics.median(
                event_ms(corr_bench_votes, 5)),
            "cast_votes_corr_para_ms": statistics.median(
                event_ms(corr_para_votes, 3)),
            "inlier_scores_para_ms": statistics.median(
                event_ms(rescoring_para, 3)),
            "inlier_scores_para_poses": len(cand),
            "estimate_normals_grid_ms": statistics.median(
                event_ms(normals_grid, 10)),
            "estimate_normals_knn_26k_ms": statistics.median(
                event_ms(normals_knn, 3)),
            "e2e_corr_pose_ms": statistics.median(host_ms(e2e_corr, 5)),
            "e2e_est_normals_ms": statistics.median(host_ms(e2e_est, 5)),
        }
        for mode, argv_m in uwa_modes.items():
            times[f"uwa_cli_{mode}_ms"] = statistics.median(host_ms(
                lambda: check(run_cli(argv_m, dev)[0] == 0, "CLI exit code"),
                2))
            times[f"uwa_cli_{mode}_peak_mem_gib"] = \
                modes_numbers[mode]["peak_mem_gib"]
        print(f"times on {card}: " + json.dumps(times))
        # Device time of the correlation vote pass and the share of it that
        # the matrix products take.
        for label, fn in (("bench", corr_bench_votes),
                          ("para", corr_para_votes)):
            rows, total = top_kernels(fn, n=1000)
            gemm = sum(ms for name, _, ms in rows
                       if not name.startswith("aten::")
                       and any(k in name.lower() for k in
                               ("gemm", "cutlass", "cublas", "xmma")))
            print(f"profile, cast_votes_corr at {label}: device "
                  f"{total:.3f} ms, matrix products {gemm:.3f} ms "
                  f"({gemm / max(total, 1e-9):.3f}); "
                  + json.dumps(rows[:8]))
        # Per-block balance: each kernel's device time at every cluster size
        # (blocks per reference row), at bench-seed0 and at para.
        bench_cap = voting_fast._ceil_to(fast_cap, voting_fast.TALLY_CHUNK)
        plb = voting_fast._pair_lookup(st["keys"], st["alpha"],
                                       desc.fast_tables, bench_cap)
        k2b_args = (plb.cnt, plb.off, plb.alpha_fix, plb.row_start_p,
                    plb.row_tot, desc.fast_tables, st["keys"].shape[1],
                    bench_cap)
        sweep = {"k1_bench": {}, "k2_para": {}, "k2_bench": {}}
        for c in range(1, block_tally.MAX_CLUSTER + 1):
            sweep["k1_bench"][c] = kernel_ms(
                lambda: block_tally.block_tally(*k1_args, n_model, n_angle,
                                                cluster=c),
                "block_tally_kernel", 10)
            sweep["k2_para"][c] = kernel_ms(
                lambda: fast_tally.fast_tally(*k2_args, p_n, p_cfg.n_angle,
                                              cluster=c),
                "fast_tally_kernel", 10)
            sweep["k2_bench"][c] = kernel_ms(
                lambda: fast_tally.fast_tally(*k2b_args, n_model, n_angle,
                                              cluster=c),
                "fast_tally_kernel", 10)
        picked = {"k1_bench": k1_cluster,
                  "k2_para": uwa["para_cluster"],
                  "k2_bench": fast_tally.cluster_size(bench_cap,
                                                      st["n_ref"])}
        print(f"cluster sweep on {card} (kernel ms by blocks per row; the "
              f"wrapper picks {picked}): " + json.dumps(sweep))
        del plb, k2b_args
        def cli_corr_call():
            check(run_cli(uwa_modes["corr"], dev)[0] == 0, "CLI exit code")

        for label, fn in (("para cast_votes_fast", para_votes),
                          ("uwa-cli call", cli_call),
                          ("uwa-cli-modes corr call", cli_corr_call)):
            rows, total = top_kernels(fn)
            print(f"profile, {label}: device {total:.3f} ms; "
                  + json.dumps(rows))

    # Bounds: each input byte read once and each output byte written once
    # over the memory rate, or one histogram add per vote over the float32
    # rate, whichever is longer. Where the kernel reads only what the data
    # asks for (the live vote rows, the pairs that have votes), only that
    # is counted.
    R1 = row_start_p.shape[0]
    k1_bytes = (int(live) * 8 + pair2d.numel() * 4 + R1 * 4
                + R1 * n_model * 32 * 4)
    k1_bound = bound(k1_bytes, numbers["num_votes"])
    R2 = k2_args[3].shape[0]
    table2 = p_tables.pair_packed
    k2_bytes = (k2_args[0].numel() * 4 + uwa["para_pairs_with_votes"] * 8
                + table2.numel() * 4 + R2 * 8 + R2 * p_n * 32 * 4)
    k2_bound = bound(k2_bytes, p_votes)
    def by_path(kernel):
        """The kernel's launches on each driven path, the counts set to 0
        just before the path and read just after."""
        paths = {"main": launches_main, "uwa-cli": launches_uwa,
                 "corr-bench": launches_corr, "est-normals": launches_est,
                 "fnv-bench": launches_fnv_bench,
                 "fnv-trex": launches_fnv_trex}
        paths.update({f"uwa-cli-{m}": l for m, l in launches_modes.items()})
        paths["bench"] = launches_bench
        paths.update({f"uwa-sweep-{k}": l for k, l in launches_sweep.items()})
        paths["tsdf"] = launches_tsdf
        return {name: l[kernel] for name, l in paths.items()}

    # Every comparison of a kernel with its plain version on a driven
    # path's own inputs; each raised on a difference.
    print("holds: " + json.dumps(HOLDS))
    k1_err, k2_err = (max(h["max_abs_err"] for h in HOLDS
                          if h["kernel"] == k)
                      for k in ("block_tally", "fast_tally"))
    print("bounds: " + json.dumps({
        "k1_bytes": k1_bytes, "k1_l2_pair_row_bytes": int(live) * 512,
        "k2_bytes": k2_bytes, "k2_l2_pair_word_bytes": p_votes * 4}))
    print(json.dumps({"kernels": [{
        "name": "block_tally", "route": "cuda",
        "source": "objective_slam_tpu_torch/csrc/block_tally.cu",
        "replaces": "objective_slam_tpu/ops/voting_block.py:590",
        "launches": launches_main["block_tally"],
        "launches_by_path": by_path("block_tally"),
        "max_abs_err": k1_err, "bitequal": True,
        "ms": times["k1_kernel_ms"], "event_ms": times["k1_ms"],
        "plain_ms": times["k1_plain_ms"],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "fast_tally", "route": "cuda",
        "source": "objective_slam_tpu_torch/csrc/fast_tally.cu",
        "replaces": "objective_slam_tpu/ops/voting_fast.py:466",
        "launches": launches_uwa["fast_tally"],
        "launches_by_path": by_path("fast_tally"),
        "max_abs_err": k2_err, "bitequal": True,
        "ms": times["k2_kernel_ms"], "event_ms": times["k2_ms"],
        "plain_ms": times["k2_plain_ms"],
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
        "library_ms": None,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
