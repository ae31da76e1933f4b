"""The dataset workflow on the port: CLI runs over small synthetic
occlusion-style scenes -> per-scene logs -> tools/analyze_uwa.py, with
the JAX package's CLI run on the same files into a second run directory.
Mirrors tests/test_dataset_harness.py; the bits each CLI prints and the
statistics analyze_uwa reads from each run's logs are compared. The
port's harness (tools/run_uwa_analog_torch.py) gets its --resume gate, a
one-scene sweep whose files are the JAX harness's, and the real-mesh
models from the package's copy of the meshes."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import analyze_uwa  # noqa: E402
import run_uwa_analog  # noqa: E402
import run_uwa_analog_torch  # noqa: E402

from objective_slam_tpu import cli as jcli  # noqa: E402
from objective_slam_tpu.utils import pointcloud as jpc  # noqa: E402
from objective_slam_tpu_torch import cli  # noqa: E402
from objective_slam_tpu_torch.utils import ply, pointcloud as pc, \
    synthetic, validation  # noqa: E402


def _both_clis(argv, scene_num, dirs, capsys):
    """The port's CLI and the JAX CLI on the same argv, each logging into
    its own run directory. Returns (port bits, JAX bits)."""
    bits = []
    for main, run_dir, kw in ((cli.main, dirs[0], {"device": "cpu"}),
                              (jcli.main, dirs[1], {})):
        rc = main(argv + ["--logfile", str(run_dir / f"rs{scene_num}_0.log")],
                  **kw)
        assert rc == 0
        bits.append([int(b) for b in capsys.readouterr().out.split()])
    return bits


def _analyses(occl_path, dirs):
    """analyze_uwa's (occlusion, trans/diam, rot, match) of each run
    directory, and its exit code."""
    out = []
    for run_dir in dirs:
        data = analyze_uwa.read_occlusion_txt(occl_path)
        analyze_uwa.read_run_dir(data, run_dir)
        out.append(analyze_uwa.analyze(data))
        assert analyze_uwa.main([str(occl_path), str(run_dir)]) == 0
    return out


def _same_analysis(port, jax_, rot_atol):
    """The same trials, occlusions and match bits; errors close (ICP on
    float32 in two libraries)."""
    np.testing.assert_array_equal(port[0], jax_[0])
    np.testing.assert_array_equal(port[3], jax_[3])
    np.testing.assert_allclose(port[1], jax_[1], atol=1e-3)
    np.testing.assert_allclose(port[2], jax_[2], atol=rot_atol)


def _run_dirs(tmp_path):
    dirs = (tmp_path / "run_port", tmp_path / "run_jax")
    for d in dirs:
        d.mkdir()
    return dirs


def test_cli_runs_feed_analysis(tmp_path, rng, capsys):
    # "chicken" stands in for a UWA model (its diameter constant exists).
    mp, mn = synthetic.blob_cloud(rng, 80)
    scale = analyze_uwa.MODEL_DIAMS["chicken"] / 2.6   # stretch to UWA size
    mp = (mp * scale).astype(np.float32)
    model_path = tmp_path / "chicken_model.ply"
    ply.write_ply(model_path, mp, mn)

    occl_lines = ["scene model occlusion"]
    dirs = _run_dirs(tmp_path)
    for scene_num, occl in [(1, 55.0), (2, 70.0)]:
        sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
        scene_path = tmp_path / f"rs{scene_num}.ply"
        truth_path = tmp_path / f"rs{scene_num}_truth.txt"
        ply.write_ply(scene_path, sp, sn)
        validation.write_truth_file(truth_path, T_true)
        occl_lines.append(f"{scene_num} chicken {occl}")
        got, want = _both_clis([
            "--scene_files", str(scene_path),
            "--model_files", str(model_path),
            "--tau_d", "0.1",
            "--scene_leaf_size", str(0.05 * scale),
            "--validation_files", str(truth_path),
        ], scene_num, dirs, capsys)
        assert got == want == [1]

    occl_path = tmp_path / "occlusion.txt"
    occl_path.write_text("\n".join(occl_lines) + "\n")
    port, jax_ = _analyses(occl_path, dirs)
    assert len(port[1]) == 2 and port[3].all(), port
    _same_analysis(port, jax_, rot_atol=1e-3)


def test_mesh_partial_view_workflow(tmp_path, rng, capsys):
    """A triangle-mesh model (normals from the mesh), partial-view scenes
    from z-buffer self-occlusion at two viewpoints, planar clutter, CLI
    validation and analyze_uwa's occlusion statistics."""
    verts, faces = synthetic.bumpy_mesh(subdiv=3)          # 642 verts
    scale = analyze_uwa.MODEL_DIAMS["chef"] / pc.bbox_diameter(verts)
    verts = (verts * scale).astype(np.float32)
    nrm = pc.mesh_vertex_normals(verts, faces)
    np.testing.assert_allclose(nrm, jpc.mesh_vertex_normals(verts, faces),
                               atol=1e-6)

    model_path = tmp_path / "chef_model.ply"
    ply.write_ply(model_path, verts, nrm, faces=faces)

    occl_lines = ["scene model occlusion"]
    dirs = _run_dirs(tmp_path)
    for scene_num, vp in [(1, (6.0, 0.0, 1.0)), (2, (0.0, -6.0, -2.0))]:
        visible = synthetic.partial_view(verts, nrm, np.asarray(vp) * scale)
        occl = 100.0 * (1.0 - visible.mean())
        assert 20.0 < occl < 80.0                          # partial
        mp_vis, mn_vis = verts[visible], nrm[visible]

        u = rng.uniform(-1.2, 1.2, size=(400, 2)) * scale
        cp = np.concatenate([u, rng.normal(scale=0.005 * scale,
                                           size=(400, 1))], axis=1)
        cp = (cp + np.float32([2.5 * scale, 0, 0])).astype(np.float32)
        cn = np.tile(np.float32([0, 0, 1]), (400, 1))
        sp, sn, T_true = synthetic.plant_model(rng, mp_vis, mn_vis, cp, cn)

        scene_path = tmp_path / f"rs{scene_num}.ply"
        truth_path = tmp_path / f"rs{scene_num}_truth.txt"
        ply.write_ply(scene_path, sp, sn)
        validation.write_truth_file(truth_path, T_true)
        occl_lines.append(f"{scene_num} chef {occl:.1f}")
        got, want = _both_clis([
            "--scene_files", str(scene_path),
            "--model_files", str(model_path),
            "--tau_d", "0.1",
            "--scene_leaf_size", str(0.04 * scale),
            "--ref_point_df", "2",
            "--icp_iterations", "12",
            "--icp_max_dist_factor", "1.0",
            "--validation_files", str(truth_path),
        ], scene_num, dirs, capsys)
        assert got == want == [1]

    occl_path = tmp_path / "occlusion.txt"
    occl_path.write_text("\n".join(occl_lines) + "\n")
    port, jax_ = _analyses(occl_path, dirs)
    assert len(port[1]) == 2 and port[3].all(), port
    # Point-to-point ICP over 12 iterations: the two packages' poses agree
    # within 1e-4 rad (ROADMAP queue 3, refine_pose).
    _same_analysis(port, jax_, rot_atol=1e-3)


def test_scene_log_bits_resume_gate(tmp_path):
    """--resume skips only scenes whose log carries one Match line per
    model; a partial log (a run cut mid-scene) runs again. The port's gate
    answers as the JAX harness's on each log."""
    log = tmp_path / "rs1_0.log"
    logs = [None, "[ts]: Match (trans, rot): 1, 1\n",
            "[ts]: Match (trans, rot): 1, 1\nnoise line\n"
            "[ts]: Match (trans, rot): 1, 0\n"]
    want = [None, None, [1, 0]]
    for text, bits in zip(logs, want):
        if text is not None:
            log.write_text(text)
        assert run_uwa_analog_torch.scene_log_bits(log, 2) == bits
        assert run_uwa_analog.scene_log_bits(log, 2) == bits


@pytest.fixture
def small_scenes(monkeypatch):
    """Both harnesses with scenes of 4,500 raw points instead of 26,000."""
    monkeypatch.setattr(synthetic, "N_TOTAL", 4500)
    monkeypatch.setattr(run_uwa_analog, "N_TOTAL", 4500)


def test_harness_sweep_writes_the_jax_harness_files(tmp_path, small_scenes):
    """One scene of --seed 7 through the port's harness (the scene cut to
    4,500 points): its models, scene and occlusion.txt are the JAX
    harness's (run_uwa_analog.build_models, build_scene on the same seed),
    analyze_uwa reads one trial per model from its log and agrees with the
    printed bits, and --resume takes the bits from the log."""
    argv = ["--scenes", "1", "--max_poses", "256", "--outdir",
            str(tmp_path)]
    summary = run_uwa_analog_torch.sweep(
        run_uwa_analog_torch.parse_args(argv), device="cpu")

    models = run_uwa_analog.build_models()
    normals = {n: jpc.mesh_vertex_normals(v, f)
               for n, (v, f) in models.items()}
    sp, sn, truths = run_uwa_analog.build_scene(np.random.default_rng(7),
                                                models, normals)
    scene = ply.read_ply(tmp_path / "rs1.ply")
    np.testing.assert_array_equal(scene.points, sp)
    np.testing.assert_array_equal(scene.normals, sn)
    for n, (v, _) in models.items():
        np.testing.assert_array_equal(
            ply.read_ply(tmp_path / f"{n}_model.ply").points, v)
        np.testing.assert_allclose(validation.read_truth_file(
            tmp_path / f"rs1_{n}_truth.txt"), truths[n][0], atol=1e-6)
    assert (tmp_path / "occlusion.txt").read_text() == "\n".join(
        ["scene model occlusion"]
        + [f"1 {n} {truths[n][1]:.1f}" for n in models]) + "\n"

    assert summary["models"] == list(models)
    bits = run_uwa_analog_torch.scene_log_bits(tmp_path / "run1" /
                                               "rs1_0.log", 4)
    assert summary["bits"] == [bits]
    assert [t["match"] for t in summary["trials"]] == [bool(b) for b in bits]
    assert summary["match_rate"] == float(np.mean(bits))
    resumed = run_uwa_analog_torch.sweep(run_uwa_analog_torch.parse_args(
        argv + ["--resume"]), device="cpu")
    assert resumed["bits"] == summary["bits"]


@pytest.mark.skipif(not Path(run_uwa_analog.REAL_MESH_DIR).is_dir(),
                    reason="dm_control assets not present")
def test_packaged_real_meshes_equal_the_jax_harness_models(monkeypatch):
    """The package's copy of the four bone meshes is byte for byte
    dm_control's, and the real-mesh sweep's models and first scene are the
    JAX harness's (build_models_real, build_scene). Both harnesses add the
    bones' diameters to analyze_uwa.MODEL_DIAMS: a copy takes them here."""
    monkeypatch.setattr(analyze_uwa, "MODEL_DIAMS",
                        dict(analyze_uwa.MODEL_DIAMS))
    for fname, _ in synthetic.REAL_MESHES.values():
        assert (synthetic.REAL_MESH_DIR / fname).read_bytes() == \
            (Path(run_uwa_analog.REAL_MESH_DIR) / fname).read_bytes()
    assert (synthetic.REAL_MESH_DIR / "NOTICE").exists()
    assert (synthetic.REAL_MESH_DIR / "LICENSE").exists()
    got, got_n = run_uwa_analog_torch.build_models(
        "real", synthetic.REAL_MESH_DIR)
    want, want_n = run_uwa_analog.build_models_real()
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_array_equal(got[n][0], want[n][0])
        np.testing.assert_array_equal(got_n[n], want_n[n])
    sp, _, truths = synthetic.uwa_analog_scene(
        np.random.default_rng(7), got, got_n, diams=synthetic.REAL_MODEL_DIAMS)
    sp_j, _, truths_j = run_uwa_analog.build_scene(
        np.random.default_rng(7), want, want_n)
    np.testing.assert_array_equal(sp, sp_j)
    assert {n: t[1] for n, t in truths.items()} == \
        {n: t[1] for n, t in truths_j.items()}
