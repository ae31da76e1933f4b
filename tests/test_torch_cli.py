"""The port's CLI against the JAX package's on the same PLY files: the same
0/1 match bits on stdout, the log lines tools/analyze_uwa.py parses, and
the visualization export. The port runs on the CPU (main(...,
device="cpu")); mirrors of the tests/test_cli.py cases."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from objective_slam_tpu import cli as jcli
from objective_slam_tpu_torch import cli as tcli
from objective_slam_tpu_torch.utils import ply, pointcloud as pc, \
    synthetic, validation

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def scene_fixture(tmp_path):
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    paths = tmp_path / "model.ply", tmp_path / "scene.ply", \
        tmp_path / "truth.txt"
    ply.write_ply(paths[0], mp, mn)
    ply.write_ply(paths[1], sp, sn)
    validation.write_truth_file(paths[2], T_true)
    return paths


def _both(argv, capsys):
    """(rc, bits) of the port's CLI and of the JAX CLI on the same argv."""
    out = []
    for run in (lambda a: tcli.main(a, device="cpu"), jcli.main):
        rc = run([str(a) for a in argv])
        out.append((rc, capsys.readouterr().out.split()))
    assert out[0] == out[1]
    return out[0]


def _base(model, scene, truth, *extra):
    return ["--scene_files", scene, "--model_files", model, "--tau_d", "0.1",
            "--scene_leaf_size", "0.05", "--validation_files", truth, *extra]


@pytest.mark.parametrize("extra", [
    [],                                             # end-to-end match bit
    ["--cpu_clustering", "true"],
    ["--icp_iterations", "10"],
    ["--icp_iterations", "10", "--icp_point_to_plane", "true"],
    ["--engine", "reference"],
    ["--cluster_center_cell", "true"],
    ["--scene_capacity", "128"],
], ids=["e2e", "cpu_clustering", "icp", "icp_plane", "reference",
        "center_cell", "scene_capacity"])
def test_cli_match_bit_same_as_jax(scene_fixture, capsys, extra):
    rc, bits = _both(_base(*scene_fixture, *extra), capsys)
    assert rc == 0 and bits == ["1"]


def test_cli_tau_d_count_mismatch(scene_fixture, capsys):
    model, scene, _ = scene_fixture
    rc, bits = _both(["--scene_files", scene, "--model_files",
                      f"{model},{model}", "--tau_d", "0.1",
                      "--scene_leaf_size", "0.05"], capsys)
    assert rc == 1 and bits == []


def test_cli_requires_normals_without_flag(tmp_path):
    mp, _ = synthetic.blob_cloud(np.random.default_rng(0), 30)
    path = tmp_path / "m.ply"
    ply.write_ply(path, mp, None)
    with pytest.raises(SystemExit):
        tcli.main(["--scene_files", str(path), "--model_files", str(path),
                   "--tau_d", "0.1"], device="cpu")


def test_cli_multi_scene_multi_model(tmp_path, capsys):
    """2 scenes x 2 models; validation files are scene-major
    (i*len(models)+j, alignment.cpp:305)."""
    rng = np.random.default_rng(0)
    models = [synthetic.blob_cloud(rng, 70) for _ in range(2)]
    model_paths, scene_paths, truth_paths = [], [], []
    for j, (mp, mn) in enumerate(models):
        model_paths.append(tmp_path / f"model{j}.ply")
        ply.write_ply(model_paths[-1], mp, mn)
    for i in range(2):
        sp = sn = None
        for j, (mp, mn) in enumerate(models):
            sp, sn, T = synthetic.plant_model(rng, mp, mn, sp, sn)
            truth_paths.append(tmp_path / f"truth_{i}_{j}.txt")
            validation.write_truth_file(truth_paths[-1], T)
        scene_paths.append(tmp_path / f"scene{i}.ply")
        ply.write_ply(scene_paths[-1], sp, sn)
    rc, bits = _both([
        "--scene_files", ",".join(map(str, scene_paths)),
        "--model_files", ",".join(map(str, model_paths)),
        "--tau_d", "0.1,0.1", "--scene_leaf_size", "0.05",
        "--validation_files", ",".join(map(str, truth_paths))], capsys)
    assert rc == 0 and len(bits) == 4
    assert sum(int(b) for b in bits) >= 3, bits


def test_cli_fallback_engine_model(tmp_path, capsys):
    """The UWA-analog trex mesh (over the block budgets, so the fallback
    engine and its tally K2) in a small cluttered scene, voxelized on the
    device at --scene_capacity: the same bit as the JAX CLI, and logs that
    tools/analyze_uwa.py reads."""
    import analyze_uwa

    v, f = synthetic.uwa_analog_models()["trex"]
    nrm = pc.mesh_vertex_normals(v, f)
    dd = 0.1 * pc.bbox_diameter(v)
    rng = np.random.default_rng(3)
    cp, cn = synthetic.clutter_cloud(rng, 200, lo=-80, hi=80)
    sp, sn, T = synthetic.plant_model(rng, v, nrm, cp, cn)
    model, scene, truth = (tmp_path / "trex_model.ply", tmp_path / "rs1.ply",
                           tmp_path / "rs1_trex_truth.txt")
    ply.write_ply(model, v, nrm, faces=f)
    ply.write_ply(scene, sp, sn)
    validation.write_truth_file(truth, T)
    logs = tmp_path / "logs"
    logs.mkdir()
    argv = ["--scene_files", scene, "--model_files", model, "--tau_d", "0.1",
            "--scene_leaf_size", str(dd), "--scene_capacity", "384",
            "--ref_point_df", "6", "--max_poses", "256",
            "--validation_files", truth, "--logfile", logs / "rs1_0.log"]
    rc, bits = _both(argv, capsys)
    assert rc == 0 and bits == ["1"]
    data = analyze_uwa.read_run_dir([["1", "trex", 50.0]], str(logs))
    trans_err, rot_err = data[0][3]
    assert trans_err < dd and rot_err < np.radians(12)


def _logged(argv, tmp_path, capsys):
    """Both CLIs on the same argv, each with its own --logfile and
    --visualize_out. Returns (bits, {package: parsed log}) where a parsed
    log holds the vote totals, the (trans, rot) distances and the Match
    lines, in order."""
    logs, bits = {}, {}
    for name, run in (("port", lambda a: tcli.main(a, device="cpu")),
                      ("jax", jcli.main)):
        log = tmp_path / f"{name}.log"
        rc = run([str(a) for a in argv] + ["--logfile", str(log),
                                           "--visualize_out",
                                           str(tmp_path / f"vis_{name}")])
        assert rc == 0
        bits[name] = capsys.readouterr().out.split()
        text = log.read_text()
        logs[name] = dict(
            votes=[int(v) for v in re.findall(r"votes=(\d+)", text)],
            dist=[(float(a), float(b)) for a, b in re.findall(
                r"Distance \(trans, rot\): ([\d.]+), ([\d.]+)", text)],
            match=re.findall(r"Match \(trans, rot\): (\d), (\d)", text),
            sizes=re.findall(r"size after filtering: (\d+)", text),
            smoothed=re.findall(r"Smoothed scene normals: .*", text))
    assert bits["port"] == bits["jax"]
    return bits["port"], logs


def _same_logs(logs, dist_atol=2e-3):
    a, b = logs["port"], logs["jax"]
    assert a["match"] == b["match"] and a["sizes"] == b["sizes"]
    assert a["smoothed"] == b["smoothed"]
    assert len(a["dist"]) == len(b["dist"]) > 0
    np.testing.assert_allclose(a["dist"], b["dist"], atol=dist_atol)
    return a


@pytest.mark.parametrize("extra", [
    ["--visualize", "true"],
    ["--smooth_normals", "1"],
    ["--smooth_normals", "2", "--smooth_normals_order", "0"],
    ["--engine", "correlation"],
    ["--engine", "correlation", "--runs_cap", "128"],
    ["--use_fnv_keys", "true"],
    ["--rescore_poses", "true"],
    ["--engine", "correlation", "--rescore_poses", "true",
     "--icp_iterations", "10", "--icp_point_to_plane", "true",
     "--normal_aware_downsample", "true"],
], ids=["visualize", "smooth_order1", "smooth_order0", "correlation",
        "runs_cap", "use_fnv_keys", "rescore_poses", "real_mesh_argv"])
def test_cli_formerly_deferred_flags(scene_fixture, tmp_path, capsys, extra):
    """The flags that used to raise NotImplementedError: the same bit, vote
    total and log lines as the JAX CLI."""
    bits, logs = _logged(_base(*scene_fixture, *extra), tmp_path, capsys)
    assert bits == ["1"]
    port = _same_logs(logs)
    assert port["votes"] == logs["jax"]["votes"] and port["votes"][0] > 0


def test_cli_estimate_normals_k(tmp_path, capsys):
    """Mirror of test_cli_missing_normals_estimation: PLYs without normals
    or faces, k-NN normals on both sides."""
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, _, T_true = synthetic.plant_model(rng, mp, mn)
    model, scene, truth = (tmp_path / "m.ply", tmp_path / "s.ply",
                           tmp_path / "t.txt")
    ply.write_ply(model, mp, None)
    ply.write_ply(scene, sp, None)
    validation.write_truth_file(truth, T_true)
    bits, logs = _logged(_base(model, scene, truth, "--estimate_normals_k",
                               "12"), tmp_path, capsys)
    assert bits == ["1"]
    _same_logs(logs)


def test_cli_smooth_normals_on_noisy_scene(tmp_path, capsys):
    """Mirror of test_cli_smooth_normals: heavy angular noise on the scene
    normals, smoothed (order 1) before matching, with ICP."""
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    noisy = sn + rng.normal(scale=0.3, size=sn.shape).astype(np.float32)
    noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
    model, scene, truth = (tmp_path / "m.ply", tmp_path / "s.ply",
                           tmp_path / "t.txt")
    ply.write_ply(model, mp, mn)
    ply.write_ply(scene, sp, noisy.astype(np.float32))
    validation.write_truth_file(truth, T_true)
    bits, logs = _logged(_base(model, scene, truth, "--smooth_normals", "1",
                               "--icp_iterations", "10"), tmp_path, capsys)
    assert bits == ["1"]
    assert _same_logs(logs)["smoothed"] == [
        "Smoothed scene normals: 1 passes, order 1, radius 0.05"]


@pytest.mark.parametrize("extra,pad_free", [
    ([], False), (["--scene_capacity", "4096"], True),
    (["--show_normals", "false"], False)],
    ids=["default", "scene_capacity", "no_normals"])
def test_cli_visualize_export(scene_fixture, tmp_path, capsys, extra,
                              pad_free):
    """Mirrors of test_cli_visualize_export, _with_scene_capacity_pad_free
    and test_cli_show_normals_export: the combined PLY and the HTML viewer
    exist, hold what the JAX CLI's hold, and no pad row."""
    _logged(_base(*scene_fixture, "--visualize", "true", *extra), tmp_path,
            capsys)
    got = ply.read_ply(str(tmp_path / "vis_port.ply"))
    want = ply.read_ply(str(tmp_path / "vis_jax.ply"))
    assert got.points.shape == want.points.shape
    assert got.points.shape[0] > 0
    assert {"red", "green", "blue"} <= set(got.extra)
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(got.extra[c], want.extra[c])
    shown = "--show_normals" not in extra
    assert (got.normals is not None) == (want.normals is not None) == shown
    if pad_free:
        assert got.points.shape[0] < 4096
    assert np.all(np.abs(got.points) < 1e3)
    n_scene = int((got.extra["green"] == 255).sum())    # scenes are white
    np.testing.assert_allclose(got.points[:n_scene], want.points[:n_scene],
                               atol=1e-5)
    np.testing.assert_allclose(got.points, want.points, atol=5e-3)
    html = (tmp_path / "vis_port.html").read_text()
    assert "model0@scene0" in html and "scene0" in html
    assert "getContext" in html
    assert len(html) == len((tmp_path / "vis_jax.html").read_text())


def test_cli_visualize_html_off(scene_fixture, tmp_path, capsys):
    vis = tmp_path / "v"
    rc = tcli.main([str(a) for a in _base(
        *scene_fixture, "--visualize", "true", "--visualize_html", "false",
        "--visualize_out", vis)], device="cpu")
    capsys.readouterr()
    assert rc == 0 and (tmp_path / "v.ply").exists()
    assert not (tmp_path / "v.html").exists()


def test_cli_without_card_asks_for_the_cpu(scene_fixture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([str(a) for a in _base(*scene_fixture)])
