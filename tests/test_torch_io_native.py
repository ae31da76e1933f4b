"""The port's ctypes bindings to the native runtime
(objective_slam_tpu_torch.io_native), mirroring tests/test_native.py with
the port's utils/ply and ops/clustering on the other side, and the JAX
package's bindings read against the port's on the same files. Skipped
where the library does not load, as tests/test_native.py is."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from objective_slam_tpu import io_native as jio
from objective_slam_tpu_torch import io_native
from objective_slam_tpu_torch.ops import clustering
from objective_slam_tpu_torch.utils import ply, synthetic

pytestmark = pytest.mark.skipif(not io_native.available(),
                                reason="native library not built")

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"


def test_library_path_is_the_repositorys():
    assert io_native._LIB_PATH == jio._LIB_PATH
    assert io_native._LIB_PATH.parent == NATIVE_DIR


def test_native_ply_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    nrm = rng.normal(size=(100, 3)).astype(np.float32)
    path = tmp_path / "c.ply"
    io_native.write_ply(path, pts, nrm)
    got_p, got_n = io_native.read_ply(path)
    np.testing.assert_array_equal(got_p, pts)
    np.testing.assert_array_equal(got_n, nrm)
    # The JAX package's bindings read the same file alike.
    want_p, want_n = jio.read_ply(path)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_n, want_n)


def test_native_reads_python_ply(tmp_path, rng):
    """Cross-implementation: the port's Python writer -> native reader and
    back."""
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    p1 = tmp_path / "py.ply"
    ply.write_ply(p1, pts, nrm, binary=True)
    got_p, got_n = io_native.read_ply(p1)
    np.testing.assert_array_equal(got_p, pts)
    np.testing.assert_array_equal(got_n, nrm)

    p2 = tmp_path / "ascii.ply"
    ply.write_ply(p2, pts, None, binary=False)
    got_p2, got_n2 = io_native.read_ply(p2)
    np.testing.assert_allclose(got_p2, pts, rtol=1e-6)
    assert got_n2 is None

    p3 = tmp_path / "native.ply"
    io_native.write_ply(p3, pts, nrm)
    cloud = ply.read_ply(p3)
    np.testing.assert_array_equal(cloud.points, pts)
    np.testing.assert_array_equal(cloud.normals, nrm)
    assert p3.read_bytes() == _jax_written(tmp_path, pts, nrm)


def _jax_written(tmp_path, pts, nrm):
    path = tmp_path / "jax_native.ply"
    jio.write_ply(path, pts, nrm)
    return path.read_bytes()


def test_native_greedy_cluster_matches_numpy(rng):
    """Native clustering agrees with the port's numpy clustering and with
    the JAX package's bindings."""
    n = 40
    poses = np.zeros((n, 4, 4), np.float32)
    # Two well-separated pose groups.
    base1 = synthetic.quat_to_matrix(synthetic.random_rotation_quat(rng))
    base2 = synthetic.quat_to_matrix(synthetic.random_rotation_quat(rng))
    for i in range(n):
        R = base1 if i % 2 == 0 else base2
        poses[i, :3, :3] = R
        poses[i, :3, 3] = (np.array([0.0, 0, 0]) if i % 2 == 0
                           else np.array([5.0, 5, 5])) + \
            rng.normal(scale=0.01, size=3)
        poses[i, 3, 3] = 1.0
    votes = rng.integers(1, 100, size=n).astype(np.float32)

    np_res = clustering.cluster_poses_greedy(poses, votes, 0.5, 0.3)
    nat_p, nat_v = io_native.cluster_poses_greedy(poses, votes, 0.5, 0.3)
    assert len(nat_v) == len(np_res.votes) == 2
    np.testing.assert_allclose(nat_v, np_res.votes, rtol=1e-5)
    np.testing.assert_allclose(nat_p, np_res.poses, atol=1e-4)
    jax_p, jax_v = jio.cluster_poses_greedy(poses, votes, 0.5, 0.3)
    np.testing.assert_array_equal(nat_p, jax_p)
    np.testing.assert_array_equal(nat_v, jax_v)


def test_native_voxel_grid_binary(tmp_path, rng):
    exe = NATIVE_DIR / "osn_voxel_grid"
    if not exe.exists():
        pytest.skip("osn_voxel_grid not built")
    pts = rng.uniform(0, 1, size=(1000, 3)).astype(np.float32)
    nrm = rng.normal(size=(1000, 3)).astype(np.float32)
    inp = tmp_path / "in.ply"
    outp = tmp_path / "out.ply"
    ply.write_ply(inp, pts, nrm, binary=True)
    proc = subprocess.run([str(exe), str(inp), str(outp), "0.2"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    cloud = ply.read_ply(outp)
    # The same voxels as the port's host voxel grid.
    from objective_slam_tpu_torch.utils import pointcloud as pc
    ref_p, _ = pc.voxel_downsample_np(pts, nrm, 0.2)
    assert cloud.points.shape[0] == ref_p.shape[0]
    np.testing.assert_allclose(
        np.sort(np.round(cloud.points, 5), axis=0),
        np.sort(np.round(ref_p, 5), axis=0), atol=1e-4)
