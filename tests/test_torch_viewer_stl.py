"""The port's numpy copies against the JAX package's: the HTML viewer and
the raw array dumps (same bytes), ``read_stl`` on a hand-written triangle
soup and on the scanned bone meshes of a dm_control installation, and the
real-mesh models of ``uwa_real_models`` against those of
``tools/run_uwa_analog.build_models_real``. The mesh cases skip where the
directory is missing, as tests/test_utils.py does."""

import base64
import json
import os
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from objective_slam_tpu.utils import debug_dump as jdump, \
    html_viewer as jviewer, ply as jply, pointcloud as jpc
from objective_slam_tpu_torch.utils import debug_dump as tdump, \
    html_viewer as tviewer, ply as tply, pointcloud as tpc, synthetic as tsyn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import run_uwa_analog as rua  # noqa: E402

MESH_DIR = rua.REAL_MESH_DIR
needs_meshes = pytest.mark.skipif(not os.path.isdir(MESH_DIR),
                                  reason="dm_control assets not present")


def _clouds(rng):
    p1 = rng.normal(size=(50, 3)).astype(np.float32)
    n1 = rng.normal(size=(50, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    p2 = rng.normal(size=(33, 3)).astype(np.float32)
    return p1, n1, p2


def test_html_viewer_same_file_as_jax(tmp_path):
    p1, n1, p2 = _clouds(np.random.default_rng(0))
    clouds = [{"points": p1, "normals": n1, "name": "scene"},
              {"points": p2, "color": (10, 20, 30), "name": "model"},
              {"points": p2 + 1.0}]
    tviewer.write_html_viewer(tmp_path / "t.html", clouds, normal_stride=7,
                              title="a <title>")
    jviewer.write_html_viewer(tmp_path / "j.html", clouds, normal_stride=7,
                              title="a <title>")
    assert (tmp_path / "t.html").read_text() == \
        (tmp_path / "j.html").read_text()
    assert [tviewer.default_color(i) for i in range(8)] == \
        [jviewer.default_color(i) for i in range(8)]


def test_html_viewer_roundtrip(tmp_path):
    """Mirror of test_html_viewer_roundtrip: the embedded base64 float32
    blobs are the clouds, normals at the declared stride."""
    p1, n1, p2 = _clouds(np.random.default_rng(1))
    path = tmp_path / "view.html"
    tviewer.write_html_viewer(
        path, [{"points": torch.from_numpy(p1).numpy(), "normals": n1,
                "name": "scene"},
               {"points": p2, "color": (10, 20, 30), "name": "model"}],
        normal_stride=7)
    text = path.read_text()
    assert "__TITLE__" not in text and "__META__" not in text
    metas = json.loads(re.search(r"const META = (\[.*?\]);", text).group(1))
    blobs = json.loads(re.search(r"const BLOBS = (\[.*?\]);", text).group(1))

    def blob(i):
        return np.frombuffer(base64.b64decode(blobs[i]), np.float32) \
            .reshape(-1, 3)

    assert [m["name"] for m in metas] == ["scene", "model"]
    assert metas[1]["color"] == [10, 20, 30] and "normals" not in metas[1]
    np.testing.assert_array_equal(blob(metas[0]["points"]), p1)
    np.testing.assert_array_equal(blob(metas[0]["normals"]), n1[::7])
    np.testing.assert_array_equal(blob(metas[1]["points"]), p2)
    assert text.count("<script>") == text.count("</script>") == 1
    for token in ("getContext(\"webgl\"", "drawArrays", "__viewer_ready"):
        assert token in text, token


def test_debug_dump_roundtrip(tmp_path):
    arr = np.random.default_rng(2).normal(size=(17, 4)).astype(np.float32)
    tdump.dump_array(tmp_path / "t.bin", torch.from_numpy(arr))
    jdump.dump_array(tmp_path / "j.bin", arr)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").stat().st_size == 17 * 4 * 4
    np.testing.assert_array_equal(
        tdump.load_array(tmp_path / "j.bin", np.float32, (17, 4)), arr)
    ints = np.arange(10, dtype=np.int32)
    tdump.dump_array(tmp_path / "i.bin", ints)
    np.testing.assert_array_equal(
        jdump.load_array(tmp_path / "i.bin", np.int32), ints)


def _write_soup(path, v, tris):
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", len(tris)))
        for tri in tris:
            fh.write(np.zeros(3, "<f4").tobytes())
            for i in tri:
                fh.write(v[i].astype("<f4").tobytes())
            fh.write(struct.pack("<H", 0))


def test_read_stl_welds_triangle_soup(tmp_path):
    """Mirror of test_read_stl_welds_triangle_soup: a tetrahedron plus one
    sliver with two equal corners, which the welding drops."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    path = tmp_path / "tet.stl"
    _write_soup(path, v, f + [(0, 0, 1)])
    verts, faces = tply.read_stl(path)
    jv, jf = jply.read_stl(path)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    assert verts.shape == (4, 3) and faces.shape == (4, 3)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    got = {frozenset(map(tuple, verts[face])) for face in faces}
    assert got == {frozenset(map(tuple, v[list(face)])) for face in f}


@pytest.mark.parametrize("content", [b"\0" * 83,
                                     b"\0" * 80 + struct.pack("<I", 3)
                                     + b"\0" * 60,
                                     b"solid ascii\nendsolid\n" + b" " * 90])
def test_read_stl_rejects_what_is_not_binary_stl(tmp_path, content):
    (tmp_path / "bad.stl").write_bytes(content)
    with pytest.raises(ValueError):
        tply.read_stl(tmp_path / "bad.stl")
    with pytest.raises(ValueError):
        jply.read_stl(tmp_path / "bad.stl")


@needs_meshes
@pytest.mark.parametrize("fname", [f for f, _ in tsyn.REAL_MESHES.values()])
def test_read_stl_on_scanned_meshes(fname):
    path = Path(MESH_DIR) / fname
    verts, faces = tply.read_stl(path)
    jv, jf = jply.read_stl(path)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)
    assert len(verts) > 100 and faces.max() == len(verts) - 1


def test_real_mesh_table_equals_harness():
    assert tsyn.REAL_MESHES == rua.REAL_MESHES
    assert tsyn.REAL_MODEL_DIAMS == {n: d for n, (_, d)
                                     in rua.REAL_MESHES.items()}


def test_uwa_real_models_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="BONEMergedSkull.stl"):
        tsyn.uwa_real_models(tmp_path / "no_such_dir")


@needs_meshes
def test_uwa_real_models_equal_harness():
    """Mirror of test_real_mesh_models_load, and equal to the harness's
    models array by array; a scene built from them equals the harness's
    scene on the same seed."""
    mj, nj = rua.build_models_real(n_samples=2000)
    mt, nt = tsyn.uwa_real_models(MESH_DIR, n_samples=2000)
    assert list(mt) == list(mj) == ["skull", "pelvis", "humerus", "scapula"]
    for name in mj:
        assert mt[name][1] is None and mj[name][1] is None
        np.testing.assert_array_equal(mt[name][0], mj[name][0])
        np.testing.assert_array_equal(nt[name], nj[name])
        d = tpc.bbox_diameter(mt[name][0])
        assert 0.9 * tsyn.REAL_MODEL_DIAMS[name] < d \
            <= tsyn.REAL_MODEL_DIAMS[name] * 1.0001
        np.testing.assert_allclose(np.linalg.norm(nt[name], axis=1), 1.0,
                                   atol=1e-4)
    # build_models_real has put its diameters into analyze_uwa.MODEL_DIAMS,
    # which build_scene reads; the port takes them as an argument.
    sj = rua.build_scene(np.random.default_rng(7), mj, nj)
    st = tsyn.uwa_analog_scene(np.random.default_rng(7), mt, nt,
                               diams=tsyn.REAL_MODEL_DIAMS)
    np.testing.assert_array_equal(st[0], sj[0])
    np.testing.assert_array_equal(st[1], sj[1])
    for name in sj[2]:
        np.testing.assert_array_equal(st[2][name][0], sj[2][name][0])
        assert st[2][name][1] == sj[2][name][1]


def test_sample_mesh_surface_equal():
    from objective_slam_tpu.utils import synthetic as jsyn
    v, f = jsyn.bumpy_mesh(subdiv=3, bumps=0.3)
    pj, nj = jpc.sample_mesh_surface(v, f, 500, np.random.default_rng(5))
    pt_, nt = tpc.sample_mesh_surface(v, f, 500, np.random.default_rng(5))
    np.testing.assert_array_equal(pt_, pj)
    np.testing.assert_array_equal(nt, nj)
