"""A run with the timed path broken underneath reads `correct` false:
for each fault that these cells can have (one card: no exchange between
chips to leave out), and a top-K ladder that stops at its first rung."""

import time

import pytest
import torch

from conftest import toy

from benchmark import harness
from objective_slam_tpu_torch.models import drost
from objective_slam_tpu_torch.ops import icp


def _run(manifest, workload="binpick-serve"):
    cell = toy(harness.find_cell(manifest, workload))
    line, checks = harness.run_cell(cell, 11, 0.5, False, "cpu",
                                    time.perf_counter())
    return line["correct"], checks


def test_sound_run_is_correct(manifest):
    correct, checks = _run(manifest)
    assert correct, checks


def _icp_returns_its_start(model_points, scene_points, init_pose, **kw):
    return icp.ICPResult(pose=init_pose.to(torch.float32),
                         rms=torch.zeros(()),
                         inliers=torch.zeros((), dtype=torch.int32))


def _half_the_rows(model, scene_points, scene_normals, ref_point_df):
    pts, nrm, ref_idx = _scene_inputs(model, scene_points, scene_normals,
                                      ref_point_df)
    return pts, nrm, ref_idx[: ref_idx.shape[0] // 2]


_scene_inputs = drost._scene_inputs
_pick_winner = drost._pick_winner
_match_sized_caps = drost._match_sized_caps


def _first_rung(model, scene_points, scene_normals, config, vote_cap,
                icp_points, icp_normals, runs_cap, max_poses_ceiling):
    return _match_sized_caps(model, scene_points, scene_normals, config,
                             vote_cap, icp_points, icp_normals, runs_cap)


def _pose_moved(model, *args, **kw):
    pose, win, cl = _pick_winner(model, *args, **kw)
    pose = pose.clone()
    pose[0, 3] += 0.01 * model.diameter
    return pose, win, cl


@pytest.mark.parametrize("target,fault,workload", [
    (icp, ("refine_pose", _icp_returns_its_start), "binpick-serve"),
    (drost, ("_scene_inputs", _half_the_rows), "binpick-serve"),
    (drost, ("_pick_winner", _pose_moved), "binpick-serve"),
    (drost, ("_match_loop", _first_rung), "binpick-oneshot"),
], ids=["step-returns-its-state", "half-the-batch", "answer-altered",
        "ladder-stops-at-first-rung"])
def test_broken_path_is_refused(manifest, monkeypatch, target, fault,
                                workload):
    monkeypatch.setattr(target, *fault)
    correct, checks = _run(manifest, workload)
    assert not correct, checks
