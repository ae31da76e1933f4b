"""PPF generation microbenchmark on the PyTorch port: the port's
counterpart of tools/ppf_timer.py (the reference's matlab/ppf_timer.m).

Times the n×n pairwise PPF stage (`ops/ppf.pairwise_ppf_keys`: keys and
α of all n² pairs, default 256² = 65,536) over 20 repetitions after one
warm-up call: on the card with CUDA events around the 20 calls, on the CPU
with the host clock. `--dump PREFIX` writes the same fixture clouds as the
JAX tool (the same seeded arrays as PREFIX_points.npy / _normals.npy and a
PLY).

Usage: python tools/ppf_timer_torch.py [n=256] [--dump out_prefix]
       [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from objective_slam_tpu_torch._common import default_device  # noqa: E402
from objective_slam_tpu_torch.ops import ppf as ppf_ops  # noqa: E402
from objective_slam_tpu_torch.utils import ply  # noqa: E402

REPS = 20


def fixtures(n: int):
    """The tool's seeded cloud: n uniform points and unit normals."""
    rng = np.random.default_rng(0)
    pts = rng.random((n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def time_ppf(pts, nrm, dev) -> float:
    """Milliseconds per pairwise_ppf_keys call on `dev`, mean of REPS."""
    p = torch.from_numpy(pts).to(dev)
    q = torch.from_numpy(nrm).to(dev)
    d_angle = 2 * np.pi / 30

    def call():
        return ppf_ops.pairwise_ppf_keys(p, q, 0.1, d_angle, 64)

    call()
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    return (time.perf_counter() - t0) * 1e3 / REPS


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=256)
    p.add_argument("--dump", type=str, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()

    pts, nrm = fixtures(args.n)
    if args.dump:
        np.save(args.dump + "_points.npy", pts)
        np.save(args.dump + "_normals.npy", nrm)
        ply.write_ply(args.dump + ".ply", pts, nrm)
        print(f"fixtures written: {args.dump}_points.npy / _normals.npy "
              f"/ .ply")

    ms = time_ppf(pts, nrm, dev)
    n_ppf = args.n * args.n
    print(f"{args.n}x{args.n} = {n_ppf} PPFs (keys+alpha) on {dev}: "
          f"{ms:.3f} ms ({n_ppf / ms / 1e3:.1f} M PPF/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
