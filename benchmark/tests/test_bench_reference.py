"""The plain reference against the port at toy size on the CPU, and the
TF32 control that `correct` must refuse."""

import math

import numpy as np
import pytest
import torch

from conftest import toy

from benchmark import harness
from benchmark.frozen import reference as ref
from benchmark.kinds import ppf_scan


def _rot_deg(a, b):
    R = a[:3, :3].T @ b[:3, :3]
    c = (float(torch.trace(R)) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))


@pytest.mark.parametrize("workload", ["binpick-serve", "uwa-analog-sweep"])
def test_reference_agrees_with_the_port(manifest, workload):
    cell = toy(harness.find_cell(manifest, workload))
    inputs = ppf_scan.Inputs(cell.config, cell.traffic, 3)
    program = ppf_scan.Deployment(inputs, "cpu")
    reference = ppf_scan.Reference(inputs, "cpu")
    rows = []
    for req in [r for _, r in zip(range(len(inputs.models) + 1),
                                  inputs.requests())]:
        out = program.serve(req)
        mine = reference.outcome(req.scan, req.model)
        assert int(out.num_votes) == int(mine.num_votes)
        diam = reference.model(req.model).diameter
        dt = float(torch.linalg.norm(out.pose[:3, 3] - mine.pose[:3, 3]))
        assert dt < 0.1 * diam
        assert _rot_deg(out.pose, mine.pose) < 12.0
        rows.append(ppf_scan.judge(reference, req, out, cell.config["judge"]))
    nums = ppf_scan.aggregate(rows)
    limits = cell.config["limits"]
    assert all(nums[k] <= limits[k] for k in limits), nums


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, -3.14159265])
    r = ref.tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
    assert abs(r[4] + 3.14159265) < 2 ** -9
    b = r.view(torch.int32)
    assert torch.all((b & 0x1FFF) == 0)


def test_the_tf32_control_is_refused(manifest):
    """The reference one precision step down, in the program's place,
    fails the judge on each of three seeds."""
    cell = toy(harness.find_cell(manifest, "binpick-serve"))
    limits = cell.config["limits"]
    for seed in (1, 2, 3):
        inputs = ppf_scan.Inputs(cell.config, cell.traffic, seed)
        judge = ppf_scan.Reference(inputs, "cpu")
        control = ppf_scan.Reference(inputs, "cpu",
                                     ref.Precision(tf32=True))
        nums = ppf_scan.aggregate([
            ppf_scan.judge(judge, ppf_scan.Request(s, 0, True),
                           control.outcome(s, 0), cell.config["judge"])
            for s in range(len(inputs.scans))])
        assert any(nums[k] > limits[k] for k in limits), (seed, nums)


def test_voxel_grid_matches_the_frozen_host_grid():
    rng = np.random.default_rng(0)
    p = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    n = rng.normal(size=(2000, 3)).astype(np.float32)
    from benchmark.frozen import scenes
    hp, hn = scenes.voxel_downsample_np(p, n, 0.25)
    dp, dn = ref.voxel_grid(torch.from_numpy(p), torch.from_numpy(n), 0.25)
    np.testing.assert_allclose(dp.numpy(), hp, atol=1e-6)
    np.testing.assert_allclose(dn.numpy(), hn, atol=1e-6)
