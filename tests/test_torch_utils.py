"""The port's host utilities against the JAX package's: PLY files and truth
files cross-read, mesh normals, the normal-aware voxel grids, the mesh
generators, the partial-view cull, the UWA-analog models and scene against
tools/run_uwa_analog.py, and a loaded description of a model over the
block budgets."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import objective_slam_tpu as ost
from objective_slam_tpu.utils import ply as jply, pointcloud as jpc, \
    serialization as jser, synthetic as jsyn, validation as jval
from objective_slam_tpu_torch.utils import ply as tply, pointcloud as tpc, \
    serialization as tser, synthetic as tsyn, validation as tval

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))


def _mesh():
    return jsyn.bumpy_mesh(subdiv=2, bumps=0.3)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer,reader", [(jply, tply), (tply, jply)],
                         ids=["jax-to-port", "port-to-jax"])
def test_ply_cross_read(tmp_path, binary, writer, reader):
    v, f = _mesh()
    n = jpc.mesh_vertex_normals(v, f)
    path = tmp_path / "m.ply"
    writer.write_ply(path, v, n, binary=binary, faces=f)
    got = reader.read_ply(path)
    want = writer.read_ply(path)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.normals, want.normals)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.faces, f)
    np.testing.assert_allclose(got.points, v, atol=0 if binary else 1e-6)


def test_ply_points_only(tmp_path):
    v, _ = _mesh()
    tply.write_ply(tmp_path / "p.ply", v)
    got = jply.read_ply(tmp_path / "p.ply")
    assert got.normals is None and got.faces is None
    np.testing.assert_array_equal(got.points, v)


def test_truth_files_round_trip(tmp_path):
    T = np.asarray(jsyn.plant_model(np.random.default_rng(0),
                                    *jsyn.blob_cloud(np.random.default_rng(1),
                                                     10))[2])
    tval.write_truth_file(tmp_path / "a.txt", T)
    jval.write_truth_file(tmp_path / "b.txt", T)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    np.testing.assert_array_equal(tval.read_truth_file(tmp_path / "b.txt"),
                                  jval.read_truth_file(tmp_path / "a.txt"))


def test_mesh_vertex_normals_equal():
    v, f = jsyn.torus_mesh(nu=16, nv=8)
    np.testing.assert_array_equal(tpc.mesh_vertex_normals(v, f),
                                  jpc.mesh_vertex_normals(v, f))


def _thin_slab(seed=0, n=3000):
    """Both faces of a slab thinner than the leaf, normals opposite."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    side = rng.integers(0, 2, n)
    z = np.where(side, 0.01, -0.01)[:, None]
    pts = np.concatenate([xy, z], 1).astype(np.float32)
    nrm = np.zeros_like(pts)
    nrm[:, 2] = np.where(side, 1.0, -1.0)
    nrm[:, :2] = rng.normal(scale=0.05, size=(n, 2))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


@pytest.mark.parametrize("normal_aware", [False, True])
def test_voxel_grids_normal_aware_equal(normal_aware):
    pts, nrm = _thin_slab()
    leaf = 0.1
    pj, nj = jpc.voxel_downsample_np(pts, nrm, leaf, normal_aware=normal_aware)
    pt_, nt = tpc.voxel_downsample_np(pts, nrm, leaf,
                                      normal_aware=normal_aware)
    np.testing.assert_array_equal(pt_, pj)
    np.testing.assert_array_equal(nt, nj)
    vj = jpc.voxel_downsample(pts, nrm, leaf, capacity=2048,
                              normal_aware=normal_aware)
    vt = tpc.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(nrm),
                              leaf, capacity=2048, normal_aware=normal_aware)
    assert int(vt.num_voxels) == int(vj.num_voxels)
    assert bool(vt.dropped) == bool(vj.dropped)
    np.testing.assert_allclose(vt.points.numpy(), np.asarray(vj.points),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.normals.numpy(), np.asarray(vj.normals),
                               rtol=1e-5, atol=1e-6)
    if normal_aware:      # both faces of the slab keep their own points
        assert int(vt.num_voxels) > int(tpc.voxel_downsample(
            torch.from_numpy(pts), torch.from_numpy(nrm), leaf,
            capacity=2048).num_voxels)


@pytest.mark.parametrize("name,kw", [
    ("bumpy_mesh", dict(subdiv=3, bumps=0.5)),
    ("torus_mesh", dict()),
    ("superellipsoid_mesh", dict(subdiv=3, p=4.0, bumps=0.2)),
])
def test_mesh_generators_equal(name, kw):
    vj, fj = getattr(jsyn, name)(**kw)
    vt, ft = getattr(tsyn, name)(**kw)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


def test_partial_view_equal():
    v, f = jsyn.bumpy_mesh(subdiv=3)
    n = jpc.mesh_vertex_normals(v, f)
    vp = np.float64([3.0, -2.0, 1.5])
    np.testing.assert_array_equal(tsyn.partial_view(v, n, vp),
                                  jsyn.partial_view(v, n, vp))


def _fresh_tool(name):
    """A private copy of tools/<name>.py. The shared module's tables may
    have been extended by other tests in this process (the real-mesh
    models add their diameters to analyze_uwa.MODEL_DIAMS)."""
    spec = importlib.util.spec_from_file_location(f"_fresh_{name}",
                                                  TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_uwa_analog_models_and_scene_equal_harness():
    import run_uwa_analog

    assert tsyn.MODEL_DIAMS == _fresh_tool("analyze_uwa").MODEL_DIAMS
    assert tsyn.N_TOTAL == run_uwa_analog.N_TOTAL
    assert tsyn.SCENE_LEAF_FACTOR == run_uwa_analog.SCENE_LEAF_FACTOR
    mj = run_uwa_analog.build_models()
    mt = tsyn.uwa_analog_models()
    assert list(mt) == list(mj)
    for name in mj:
        np.testing.assert_array_equal(mt[name][0], mj[name][0])
        np.testing.assert_array_equal(mt[name][1], mj[name][1])
    normals = {n: jpc.mesh_vertex_normals(v, f) for n, (v, f) in mj.items()}
    sj = run_uwa_analog.build_scene(np.random.default_rng(7), mj, normals)
    st = tsyn.uwa_analog_scene(np.random.default_rng(7), mt, normals)
    np.testing.assert_array_equal(st[0], sj[0])
    np.testing.assert_array_equal(st[1], sj[1])
    assert list(st[2]) == list(sj[2])
    for name in sj[2]:
        np.testing.assert_array_equal(st[2][name][0], sj[2][name][0])
        assert st[2][name][1] == sj[2][name][1]
    assert len(st[0]) == tsyn.N_TOTAL


def test_loaded_over_budget_description_builds_fallback(tmp_path):
    """A description of the UWA-analog trex model (over the block budgets)
    saved by the JAX package loads into the port with the fallback tables
    instead of raising, and those equal the port's own build."""
    v, f = tsyn.uwa_analog_models()["trex"]
    n = tpc.mesh_vertex_normals(v, f)
    dd = 0.1 * tpc.bbox_diameter(v)
    mp, mn = tpc.voxel_downsample_np(v, n, dd)
    dj = ost.build_model_description(mp, mn, ost.PPFConfig(), d_dist=dd)
    assert dj.fast_tables.block is None
    path = tmp_path / "trex.osn.npz"
    jser.save_model_description(path, dj)
    loaded = tser.load_model_description(path, device="cpu")
    ft = loaded.fast_tables
    assert ft is not None and ft.block is None
    assert ft.cnt_off is not None and ft.pair_packed is not None
    np.testing.assert_array_equal(
        ft.cnt_off.numpy().view(np.uint32),
        np.asarray(dj.fast_tables.cnt_off.packed)[
            :dj.fast_tables.cnt_off.height].reshape(-1))
