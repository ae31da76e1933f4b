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
  9. times    medians over repetitions, each ended by a synchronize, each
              kernel's device time from torch.profiler, and both kernels
              at every cluster size (blocks per reference row)
Then a JSON line of kernels, the card line again, and the result line.
Any failed check raises, and the script exits non-zero.
"""

import contextlib
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
ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


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
    return dict(mp=mp, mn=mn, d_dist=d_dist, scenes=scenes, occ=occ,
                vox_capacity=vox_capacity)


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


def kernel_ms(fn, kernel, reps):
    """Device time (ms) of one launch of the CUDA kernel whose name holds
    `kernel`, from torch.profiler over `reps` calls of fn (divided by the
    launches the trace holds): the kernel alone, without the wrapper's
    host time between launches."""
    from torch.profiler import ProfilerActivity, profile

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
    that phase 5 and the timings reuse."""
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
    expanded = voting_block._expand(keys, alpha, desc.fast_tables.block,
                                    cap, voting_block.CHUNK_ROWS, seg_cap)
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
                 expanded=expanded, keys=keys, alpha=alpha, n_ref=n_ref)
    return numbers, launches, state


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the work, the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def uwa_files(workdir):
    """The UWA-analog models and scene 1 of tools/run_uwa_analog.py (seed
    7), written as the harness writes them (:244-251, 260-296). Returns
    (argv, names, truths, model diameters as the CLI takes them, n_voxels,
    capacity)."""
    from objective_slam_tpu_torch.utils import ply, pointcloud as pc, \
        synthetic, validation

    workdir.mkdir(parents=True, exist_ok=True)
    models = synthetic.uwa_analog_models()
    normals = {n: pc.mesh_vertex_normals(v, f) for n, (v, f) in models.items()}
    names = list(models)
    model_paths = []
    for n, (v, f) in models.items():
        model_paths.append(str(workdir / f"{n}_model.ply"))
        ply.write_ply(model_paths[-1], v, normals[n], faces=f)
    scale = max(synthetic.MODEL_DIAMS.values())
    leaf = synthetic.SCENE_LEAF_FACTOR * scale
    sp, sn, truths = synthetic.uwa_analog_scene(
        np.random.default_rng(UWA_SEED), models, normals)
    check(len(sp) == synthetic.N_TOTAL, "UWA-analog scene size")
    n_vox = pc.voxel_downsample_np(sp, sn, leaf)[0].shape[0]
    capacity = ((int(n_vox * 1.15) + 127) // 128) * 128
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
    diams = {n: pc.bbox_diameter(v) for n, (v, _) in models.items()}
    return argv, names, truths, diams, n_vox, capacity


def run_cli(argv, dev):
    """One in-process CLI call with stdout captured, as the harness runs it
    (run_uwa_analog.py:297-339). Returns (rc, printed bits)."""
    from objective_slam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device=dev)
    return rc, [int(b) for b in buf.getvalue().split()]


def uwa_cli(dev, workdir):
    """Phase 8: the CLI on UWA-analog scene 1. Returns the numbers (the
    CLI's peak device memory among them), the kernel launches of the call,
    the argv, and para's keys, tables and per-pair arrays."""
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, fast_tally, ppf, \
        voting_fast
    from objective_slam_tpu_torch.utils import validation

    argv, names, truths, diams, n_vox, capacity = uwa_files(workdir)
    records = []
    plain_match = drost.match

    def timed_match(model, scene_points, scene_normals, config, *a, **k):
        # Per-model match time and kernel launches, around the call the
        # pipeline makes (pipeline.py -> drost.match).
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
    torch.cuda.reset_peak_memory_stats()
    try:
        rc, bits = run_cli(argv, dev)
    finally:
        drost.match = plain_match
    sync(dev)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"block_tally": block_tally.launches,
                "fast_tally": fast_tally.launches}

    check(rc == 0, f"CLI exit code {rc}")
    check(len(bits) == len(names) == len(records) == 4,
          f"four match bits printed ({bits})")
    per_model = {}
    for name, bit, r in zip(names, bits, records):
        desc, cfg, res = r["desc"], r["cfg"], r["res"]
        fallback = desc.fast_tables.block is None
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
            "engine": "fallback (K2)" if fallback else "block (K1)",
            "model_points": desc.n_points,
            "occupied_keys": int((desc.table.counts > 0).sum()),
            "votes": total, "bit": bit, "trans_err": v.trans_err,
            "rot_err_deg": math.degrees(v.rot_err),
            "occlusion_pct": truths[name][1], "match_ms": r["ms"],
            "k1_launches": r["k1"], "k2_launches": r["k2"],
            "topk_saturated": bool(res.topk_saturated)}
    for name in ("trex", "para"):
        check(per_model[name]["engine"] == "fallback (K2)",
              f"{name} has no block tables")
        check(per_model[name]["k2_launches"] >= 1, f"{name} launched K2")
    for name in ("chef", "chicken"):
        check(per_model[name]["engine"] == "block (K1)",
              f"{name} has block tables")
        check(per_model[name]["k1_launches"] >= 1, f"{name} launched K1")
    check(launches["fast_tally"] >= 2, "K2 launched at least twice")
    for name in ("chef", "trex", "chicken"):
        check(per_model[name]["bit"] == 1,
              f"{name} matches, as in the JAX package ({per_model[name]})")

    # Para's own per-pair arrays, for K2 against its plain version.
    r = records[names.index("para")]
    desc, cfg = r["desc"], r["cfg"]
    ref_idx = torch.arange(0, r["sp"].shape[0], cfg.ref_point_df,
                           device=r["sp"].device)
    keys, alpha = ppf.pairwise_ppf_keys(r["sp"], r["sn"], desc.d_dist,
                                        cfg.d_angle, desc.max_dist_bin,
                                        ref_indices=ref_idx)
    vote_cap = drost._next_cap(per_model["para"]["votes"]
                               + voting_fast.TALLY_CHUNK * len(ref_idx))
    vote_cap = voting_fast._ceil_to(vote_cap, voting_fast.TALLY_CHUNK)
    pl = voting_fast._pair_lookup(keys, alpha, desc.fast_tables, vote_cap)
    numbers = {"bits": dict(zip(names, bits)), "scene_voxels": n_vox,
               "scene_capacity": capacity, "reference_rows": len(ref_idx),
               "para_vote_cap": vote_cap, "para_total_p": int(pl.total_p),
               "para_scene_pairs": int(pl.cnt.numel()),
               "para_pairs_with_votes": int((pl.cnt > 0).sum()),
               "peak_mem_gib": peak_gib, "models": per_model}
    para = dict(desc=desc, cfg=cfg, keys=keys, alpha=alpha, pl=pl,
                vote_cap=vote_cap, n=keys.shape[1])
    return numbers, launches, argv, para


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
        src_row, alpha_row, row_start_p = st["expanded"][:3]
        live = st["expanded"][5]
        pair2d = st["desc"].fast_tables.block.pair2d
        k1_args = (pair2d, src_row, alpha_row, row_start_p, live)
        n_model, n_angle = st["desc"].n_points, st["cfg"].n_angle
        got = block_tally.block_tally(*k1_args, n_model, n_angle)
        want = block_tally.block_tally_plain(*k1_args, n_model, n_angle)
        k1_err = int((got - want).abs().max())
        check(k1_err == 0, "K1 bit-equal at bench scale")
        check(int(got.sum(dtype=torch.int64)) == numbers["num_votes"],
              "K1 tallies every vote")
        k1_cluster = block_tally.cluster_size(src_row.shape[0],
                                              row_start_p.shape[0])
        print(f"k1 bench shape: pair2d {tuple(pair2d.shape)}, src_row "
              f"{tuple(src_row.shape)}, live rows {int(live)}, R "
              f"{row_start_p.shape[0]}, n_model {n_model}, cluster "
              f"{k1_cluster}, votes {numbers['num_votes']}")
        del got, want

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
        uwa, launches_uwa, uwa_argv, para = uwa_cli(
            dev, ROOT / "build" / "uwa_cli")
        pl, p_desc, p_cfg = para["pl"], para["desc"], para["cfg"]
        p_n, p_tables = p_desc.n_points, p_desc.fast_tables
        k2_args = (pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p, pl.row_tot,
                   p_tables, para["n"], para["vote_cap"])
        got = fast_tally.fast_tally(*k2_args, p_n, p_cfg.n_angle)
        want = fast_tally.fast_tally_plain_pairs(*k2_args, p_n,
                                                 p_cfg.n_angle)
        k2_err = int((got - want).abs().max())
        check(k2_err == 0, "K2 bit-equal on para's per-pair arrays")
        p_votes = uwa["models"]["para"]["votes"]
        check(int(got.sum(dtype=torch.int64)) == p_votes,
              "K2 tallies every para vote")
        # The unpacked tables' float32 α_m rounding, at para's scale.
        unpacked = voting_fast.build_fast_tables(p_desc.table,
                                                 force_unpacked=True)
        check(unpacked.pair_packed is None, "para's unpacked tables")
        args_u = (*k2_args[:5], unpacked, *k2_args[6:], p_n, p_cfg.n_angle)
        check(torch.equal(fast_tally.fast_tally(*args_u),
                          fast_tally.fast_tally_plain_pairs(*args_u)),
              "K2 bit-equal on para's unpacked tables")
        uwa["para_cluster"] = fast_tally.cluster_size(para["vote_cap"],
                                                      pl.row_start_p.numel())
        del got, want, unpacked
        print("uwa-cli: " + json.dumps(uwa))

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

        for fn in (k1, k1_plain, k1_gather, k2, k2_plain, e2e_fixed,
                   voting_only, sized, para_votes, para_expand):
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
        }
        print(f"times on {card}: " + json.dumps(times))
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
        for label, fn in (("para cast_votes_fast", para_votes),
                          ("uwa-cli call", cli_call)):
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
    R2 = pl.row_start_p.shape[0]
    table2 = p_tables.pair_packed
    k2_bytes = (pl.cnt.numel() * 4 + uwa["para_pairs_with_votes"] * 8
                + table2.numel() * 4 + R2 * 8 + R2 * p_n * 32 * 4)
    k2_bound = bound(k2_bytes, p_votes)
    print("bounds: " + json.dumps({
        "k1_bytes": k1_bytes, "k1_l2_pair_row_bytes": int(live) * 512,
        "k2_bytes": k2_bytes, "k2_l2_pair_word_bytes": p_votes * 4}))
    print(json.dumps({"kernels": [{
        "name": "block_tally", "route": "cuda",
        "source": "objective_slam_tpu_torch/csrc/block_tally.cu",
        "replaces": "objective_slam_tpu/ops/voting_block.py:590",
        "launches": launches_main["block_tally"],
        "launches_by_path": {"main": launches_main["block_tally"],
                             "uwa-cli": launches_uwa["block_tally"]},
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
        "launches_by_path": {"main": launches_main["fast_tally"],
                             "uwa-cli": launches_uwa["fast_tally"]},
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
