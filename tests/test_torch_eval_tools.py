"""The port's evaluation tools (tools/*_torch.py) against the JAX ones, on
the CPU: voxel_grid, ppf_timer, eval_instances, eval_recognition and
raycast_gap_study.

  * the voxel-grid CLI as tests/test_tools.py::test_voxel_grid_cli, and
    its output PLY equal to the JAX tool's on the same input;
  * ppf_timer runs on the CPU and dumps the JAX tool's fixtures;
  * the harnesses' scene builders give the same arrays for the same seed;
  * one small eval_instances scene through both packages' match and
    extract_instances: the same instances, poses within 1e-4;
  * eval_recognition's smallest grid writes JSON that merge_eval reads;
  * the gap study's dense march equals the JAX study's on the same volume
    (hit masks within 0.5% of the pixels, depths within 1e-4), and its
    line carries every key of the JAX study's.

The JAX tools' full runs are not repeated here (eval_instances --quick
alone takes the JAX package minutes on a CPU). torch runs on one CPU
thread, as in test_torch_drost.py.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import eval_instances as j_inst  # noqa: E402
import eval_instances_torch as t_inst  # noqa: E402
import eval_recognition as j_rec  # noqa: E402
import eval_recognition_torch as t_rec  # noqa: E402
import merge_eval  # noqa: E402
import ppf_timer  # noqa: E402
import ppf_timer_torch  # noqa: E402
import raycast_gap_study as j_gap  # noqa: E402
import raycast_gap_study_torch as t_gap  # noqa: E402
import voxel_grid  # noqa: E402
import voxel_grid_torch  # noqa: E402

import objective_slam_tpu as ost  # noqa: E402
import objective_slam_tpu_torch as pt  # noqa: E402
from objective_slam_tpu.models import drost as jd  # noqa: E402
from objective_slam_tpu.models import tsdf as jt  # noqa: E402
from objective_slam_tpu.utils import ply as jply, \
    pointcloud as jpc, synthetic, validation as jval  # noqa: E402
from objective_slam_tpu_torch.models import drost as td  # noqa: E402
from objective_slam_tpu_torch.models import tsdf as tt  # noqa: E402
from objective_slam_tpu_torch.utils import ply as tply, \
    pointcloud as tpc  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_voxel_grid_cli(tmp_path, rng):
    pts = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    inp = tmp_path / "in.ply"
    tply.write_ply(inp, pts, nrm)
    out_t, out_j = tmp_path / "out_torch.ply", tmp_path / "out_jax.ply"
    assert voxel_grid_torch.main([str(inp), str(out_t), "--leaf", "0.2"]) == 0
    cloud = tply.read_ply(out_t)
    assert 0 < cloud.points.shape[0] < 500
    assert cloud.normals is not None
    assert voxel_grid.main([str(inp), str(out_j), "--leaf", "0.2"]) == 0
    ref = jply.read_ply(out_j)
    assert np.array_equal(cloud.points, ref.points)
    assert np.array_equal(cloud.normals, ref.normals)
    assert out_t.read_bytes() == out_j.read_bytes()


def test_ppf_timer_cpu_and_fixtures(tmp_path, capsys):
    pre_t, pre_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert ppf_timer_torch.main(["32", "--dump", pre_t,
                                 "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("32x32 = 1024 PPFs (keys+alpha) on cpu:")
    assert "M PPF/s" in line
    assert ppf_timer.main(["32", "--dump", pre_j]) == 0
    for suffix in ("_points.npy", "_normals.npy"):
        assert np.array_equal(np.load(pre_t + suffix), np.load(pre_j + suffix))
    assert Path(pre_t + ".ply").read_bytes() == \
        Path(pre_j + ".ply").read_bytes()


@pytest.mark.parametrize("k", [1, 3])
def test_build_scene_same_arrays(k):
    mp, mn = synthetic.blob_cloud(np.random.default_rng(99), 600)
    got = t_inst.build_scene(np.random.default_rng(10_000 * k + 1), mp, mn,
                             k, 2400, 150)
    want = j_inst.build_scene(np.random.default_rng(10_000 * k + 1), mp, mn,
                              k, 2400, 150)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(got[2]) == len(want[2]) == k
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("occ,noise", [(0.0, 0.0), (0.3, 0.5)])
def test_build_trial_same_arrays(occ, noise):
    mp, mn = synthetic.blob_cloud(np.random.default_rng(12345), 800)
    seed = t_rec.trial_seed(noise, occ, 1)
    assert seed == hash((int(noise * 100), int(occ * 100), 1)) % 2**31
    kw = dict(n_total=5000, occlusion=occ, noise_rel=noise, leaf=0.1)
    got = t_rec.build_trial(np.random.default_rng(seed), mp, mn, **kw)
    want = j_rec.build_trial(np.random.default_rng(seed), mp, mn, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_instances_scene_through_both_packages():
    """One eval_instances scene (2 instances, 2,400 points) through both
    packages' match and extract_instances at the tool's configuration,
    the scene voxelized at d_dist (the tool: 0.5·d_dist) to keep the JAX
    package's retry ladder short. The clustered counts are float32 sums over candidates whose α bins an
    ulp of the keys may move, so they are held to 1e-4 relative."""
    mp_raw, mn_raw = synthetic.blob_cloud(np.random.default_rng(99), 1000)
    sp, sn, truths = t_inst.build_scene(np.random.default_rng(20_000), mp_raw,
                                        mn_raw, 2, 2400, 300)
    kw = dict(max_poses=1024, ref_point_df=5, cluster_center_cell=True)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    d_dist = cj.tau_d * jpc.bbox_diameter(mp_raw)
    mp, mn = jpc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    dj = ost.build_model_description(mp, mn, cj, d_dist=d_dist)
    dt = pt.build_model_description(mp, mn, ct, d_dist=d_dist, device="cpu")
    vp, vn = tpc.voxel_downsample_np(sp, sn, d_dist)
    rj = ost.match(dj, vp, vn, cj)
    rt = pt.match(dt, vp, vn, ct)
    assert int(rj.num_votes) == int(rt.num_votes)
    pj, cnt_j = jd.extract_instances(rj, dj.diameter, max_instances=4)
    pt_, cnt_t = td.extract_instances(rt, dt.diameter, max_instances=4)
    assert len(pj) == len(pt_) >= 2
    np.testing.assert_allclose(cnt_t, cnt_j, rtol=1e-4)
    for a, b in zip(pt_, pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    found = [any(jval.validate_pose(p, T, dj.diameter, cj).match
                 for p in pj) for T in truths]
    assert all(found)


def test_eval_recognition_smallest_grid_merges(tmp_path, capsys):
    out = tmp_path / "eval.json"
    assert t_rec.main(["--quick", "--seeds", "1", "--noises", "0",
                       "--occs", "0", "--device", "cpu",
                       "--out", str(out)]) == 0
    table = capsys.readouterr().out
    assert "overflows: 0" in table
    merged = merge_eval.merge([str(out)])
    engines = [r["engine"] for r in merged["results"]]
    assert engines == t_rec.ENGINES + ["agree_fast_corr"]
    for r in merged["results"]:
        assert set(r) == {"noise", "occ", "seed", "engine", "trans_err",
                          "rot_err_deg", "match", "overflowed"}
        assert not r["overflowed"]
    bits = {r["engine"]: r["match"] for r in merged["results"]}
    assert bits["fast"] == bits["reference"]
    merge_eval.summarize(merged)


def test_gap_study_dense_march_equals_jax():
    """The dense march of both studies on the same fused volume (the JAX
    package's, carried across)."""
    vol = jt.make_volume(origin=(-2.5, -2.5, -1.5), dims=(32, 32, 32),
                         voxel_size=5.0 / 32)
    intr = (28.8, 28.8, 15.5, 15.5)
    rng = np.random.default_rng(0)
    verts, faces = synthetic.bumpy_mesh(subdiv=3, bumps=0.35)
    mp, _ = jpc.sample_mesh_surface(verts, faces, 6000, rng)
    world = np.concatenate([mp + np.float32([0, 0, 1.0]), np.concatenate(
        [rng.uniform(-2.2, 2.2, size=(6000, 2)),
         np.full((6000, 1), -1.05)], axis=1)]).astype(np.float32)
    for f in range(4):
        ang = 2 * math.pi * f / 4
        T_cw = synthetic.look_at(np.float32([3.2 * math.cos(ang),
                                             3.2 * math.sin(ang), 1.6]),
                                 (0, 0, 0.5))
        vol = jt.integrate_depth(vol, synthetic.render_depth(
            world, T_cw, intr, (32, 32)), intr, T_cw)
    tvol = tt.volume_from_arrays(np.asarray(vol.tsdf), np.asarray(vol.weight),
                                 np.asarray(vol.origin), vol.voxel_size,
                                 vol.truncation, device="cpu")
    T_wc = np.linalg.inv(synthetic.look_at(np.float32([3.2, 0, 1.6]),
                                           (0, 0, 0.5)))
    want = np.asarray(j_gap.dense_trilinear_depth(vol, intr, T_wc, (32, 32),
                                                  0.1, 6.0, 100))
    got = t_gap.dense_trilinear_depth(tvol, intr, T_wc, (32, 32), 0.1, 6.0,
                                      100).numpy()
    hit_j, hit_t = want > 0, got > 0
    assert hit_j.sum() > 100
    assert (hit_j != hit_t).sum() <= 0.005 * hit_j.size
    both = hit_j & hit_t
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-4)


def test_gap_study_line_has_every_jax_key(capsys):
    assert t_gap.main(["--dims", "32", "--img", "32", "--frames", "4",
                       "--n_dense", "64", "--cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = json.loads((ROOT / "docs" / "eval" /
                      "raycast_gap_256.json").read_text())
    assert set(ref) <= set(line)
    assert line["dims"] == 32 and line["pixels"] == 32 * 32
    assert line["dense_hits"] > 0 and line["cf_hits"] > 0
    assert line["missed_by_cf"] == (line["missed_within_1px_of_silhouette"]
                                    + line["missed_interior"])
