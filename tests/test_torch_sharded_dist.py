"""The sharded matcher over a torch.distributed group: 2 CPU processes in
a gloo group (tests/sharded_dist_worker.py), joined through a FileStore in
the test's own directory (no TCP port, so parallel test workers cannot
collide). Each rank's result must equal the in-process 2-shard run in
every integer field, with poses within 1e-6."""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import sharded_dist_worker as worker
from objective_slam_tpu_torch.parallel import sharded_match as tsm

WORLD = 2
TIMEOUT_S = 120


def test_gloo_group_equals_in_process_shards(tmp_path):
    ctx = mp.start_processes(
        worker.run, args=(WORLD, str(tmp_path / "store"), str(tmp_path)),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo ranks did not finish in {TIMEOUT_S} s")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = worker.match(tsm.LocalShards(WORLD))
    finally:
        torch.set_num_threads(n)
    assert not bool(want.overflowed) and int(want.num_votes) > 0
    for rank in range(WORLD):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            for name, value in want._asdict().items():
                value = value.numpy()
                if value.dtype.kind == "f":
                    np.testing.assert_allclose(got[name], value, rtol=0,
                                               atol=1e-6, err_msg=name)
                else:
                    assert got[name].dtype == value.dtype, name
                    assert np.array_equal(got[name], value), name
