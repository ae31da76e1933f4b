#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (objective_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the repo's
checkout; imports nothing of JAX. Phases, each printing its own line:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    every kernel of the port built from csrc/ with nvcc
  3. k1-small kernel K1 (block tally) bit-equal to its plain version on
              small cases: sentinel words, empty rows, a full buffer, the
              largest model the block engine takes
  4. main     the bench protocol (bench.py:248-305, 419-440) on the port:
              a 280-point model, the seed-0 100k-point bin-picking scan,
              match() and match_with_state() twice, the 4-instance run at
              fixed caps, and the readable-engine flip-rate gate; K1 must
              have been launched on this path
  5. k1-bench K1 bit-equal to its plain version on the main path's arrays
  6. times    medians over repetitions, each ended by a synchronize
Then a JSON line of kernels, the card line again, and the result line.
Any failed check raises, and the script exits non-zero.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_SEEDS_FOR_CAPACITY = 3      # bench.py sizes the voxel capacity over 3
N_INSTANCES = 4


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
    """Small K1 cases: (pp, alpha_row, row_start_p, total_rows_p, n_model).
    Words past the live rows are left random, so both versions must skip
    them; the last case's live count runs past row_cap (an overflowed
    buffer) and both must stop at row_cap."""
    rng = np.random.default_rng(1)
    cases = []
    for n_model, chunk_rows, row_sizes, slack, live in [
            (24, 4, [2, 0, 3, 1, 2], 1, None),       # empty middle row
            (100, 4, [3, 3, 0, 0], 0, None),         # full buffer, empty tail
            (1023, 8, [1, 2, 1], 1, None),           # 130,944 B histogram
            (280, 64, [0, 0, 4, 1, 1, 0], 2, 1 << 20)]:  # empty lead rows
        row_cap = (sum(row_sizes) + slack) * chunk_rows
        m = rng.integers(0, n_model, size=(row_cap, 128)).astype(np.uint32)
        a_m = rng.integers(0, 1 << 22, size=(row_cap, 128)).astype(np.uint32)
        pp = (m << 22) | a_m
        pp[rng.random((row_cap, 128)) < 0.2] = 0xFFFFFFFF
        starts = np.concatenate([[0], np.cumsum(row_sizes)[:-1]]) * chunk_rows
        live = sum(row_sizes) * chunk_rows if live is None else live
        cases.append((
            torch_from(pp.view(np.int32), dev),
            torch_from(rng.integers(0, 1 << 22, row_cap).astype(np.int32),
                       dev),
            torch_from(starts.astype(np.int32), dev),
            torch.tensor(live, dtype=torch.int32, device=dev), n_model))
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


def torch_from(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def main_path(dev, inputs):
    """Phase 4: the port's main path on the bench scene. Returns the
    numbers it measured, the K1 launch count of the path, and the arrays
    that phase 5 and the timings reuse."""
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import block_tally, ppf, voting, \
        voting_block
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

    block_tally.launches = 0
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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = block_tally.launches

    check(launches > 0, "kernel K1 launched on the main path")
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
                 expanded=expanded, keys=keys, alpha=alpha)
    return numbers, launches, state


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 1
    import objective_slam_tpu_torch as pt
    from objective_slam_tpu_torch.models import drost
    from objective_slam_tpu_torch.ops import _build, block_tally, voting_block
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
        for *args, n_model in tally_cases(dev):
            got = block_tally.block_tally(*args, n_model, 30)
            want = block_tally.block_tally_plain(*args, n_model, 30)
            pp = args[0]
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K1 bit-equal at n_model {n_model}, rows {pp.shape[0]}")

    with Phase("main"):
        inputs = build_bench_inputs(dev)
        numbers, launches, st = main_path(dev, inputs)
        print("main path: " + json.dumps(numbers))

    with Phase("k1-bench"):
        pp, alpha_row, row_start_p = st["expanded"][:3]
        live = st["expanded"][5]
        k1_args = (pp, alpha_row, row_start_p, live)
        n_model, n_angle = st["desc"].n_points, st["cfg"].n_angle
        got = block_tally.block_tally(*k1_args, n_model, n_angle)
        want = block_tally.block_tally_plain(*k1_args, n_model, n_angle)
        max_abs_err = int((got - want).abs().max())
        check(max_abs_err == 0, "K1 bit-equal at bench scale")
        check(int(got.sum(dtype=torch.int64)) == numbers["num_votes"],
              "K1 tallies every vote")
        print(f"k1 bench shape: pp {tuple(pp.shape)}, live rows {int(live)}"
              f", R {row_start_p.shape[0]}, n_model {n_model}, votes "
              f"{numbers['num_votes']}")
        del got, want

    with Phase("times"):
        desc, cfg = st["desc"], st["cfg"]
        cap, seg_cap = st["cap"], st["seg_cap"]
        cap_vox, d_dist = inputs["vox_capacity"], inputs["d_dist"]
        sp, sn = st["sp"], st["sn"]

        def k1():
            block_tally.block_tally(*k1_args, n_model, n_angle)

        def k1_plain():
            block_tally.block_tally_plain(*k1_args, n_model, n_angle)

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

        for fn in (k1, k1_plain, e2e_fixed, voting_only, sized):
            fn()                                    # warm-up
        torch.cuda.synchronize()
        # Kernel and plain version in turns: plain, kernel, kernel, plain.
        t_plain = event_ms(k1_plain, 5)
        t_k1 = event_ms(k1, 20) + event_ms(k1, 20)
        t_plain += event_ms(k1_plain, 5)
        times = {
            "k1_ms": statistics.median(t_k1),
            "k1_plain_ms": statistics.median(t_plain),
            "e2e_pose_fixed_caps_ms": statistics.median(
                host_ms(e2e_fixed, 10)),
            "voting_fixed_caps_ms": statistics.median(
                event_ms(voting_only, 10)),
            "match_with_sizing_ms": statistics.median(
                host_ms(sized, 3)),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        }
        print(f"times on {card}: " + json.dumps(times))

    print(json.dumps({"kernels": [{
        "name": "block_tally", "route": "cuda",
        "source": "objective_slam_tpu_torch/csrc/block_tally.cu",
        "replaces": "objective_slam_tpu/ops/voting_block.py:590",
        "launches": launches, "max_abs_err": max_abs_err, "bitequal": True,
        "ms": times["k1_ms"], "plain_ms": times["k1_plain_ms"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
