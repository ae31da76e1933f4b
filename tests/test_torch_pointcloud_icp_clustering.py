"""Port voxel grid, pose clustering and ICP against the JAX package on the
same arrays.

Tolerances: voxel centroids within 1e-5 × the scene extent (segment sums
may add in another order); num_voxels and dropped exact. Clustered counts
are sums of integer-valued weights (exact in float32 in any order) and
must be equal; averaged translations agree to 1e-5. ICP poses within 1e-4
(translation and rotation) while the iteration is contracting: Kabsch
steps, and the first point-to-plane steps. Further clamped point-to-plane
steps oscillate by tenths of a degree around the optimum in both packages,
so float32 differences in the nearest-neighbour tile move the end pose by
up to ~2° between them; there both must meet test_icp.py's criteria.
"""

import math

import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import clustering as jcl, icp as jicp, \
    transforms as jtr
from objective_slam_tpu.utils import pointcloud as jpc, synthetic
from objective_slam_tpu_torch.ops import clustering as tcl, icp as ticp
from objective_slam_tpu_torch.utils import pointcloud as tpc, \
    synthetic as tsyn


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("n,leaf,capacity", [(2000, 0.25, None),
                                             (2000, 0.25, 300),
                                             (1500, 0.1, 1500)])
def test_voxel_downsample(n, leaf, capacity):
    rng = np.random.default_rng(n + int(leaf * 100))
    p = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    nr = rng.normal(size=(n, 3)).astype(np.float32)
    vj = jpc.voxel_downsample(p, nr, leaf, capacity=capacity)
    vt = tpc.voxel_downsample(_t(p), _t(nr), leaf, capacity=capacity)
    assert int(vt.num_voxels) == int(vj.num_voxels)
    assert bool(vt.dropped) == bool(vj.dropped)
    assert bool(vt.dropped) == (capacity == 300)
    extent = float(np.ptp(p, axis=0).max())
    # Pad rows sit at lo − 1e7; 1e-5 × extent is below their float32 ulp,
    # so they are compared with the ulp there (1 at 1e7).
    k = int(vt.num_voxels) if capacity is None or not bool(vt.dropped) \
        else capacity
    np.testing.assert_allclose(vt.points.numpy()[:k],
                               np.asarray(vj.points)[:k], atol=1e-5 * extent)
    np.testing.assert_allclose(vt.points.numpy()[k:],
                               np.asarray(vj.points)[k:], atol=1.0)
    np.testing.assert_allclose(vt.normals.numpy(), np.asarray(vj.normals),
                               atol=1e-5)


def test_voxel_downsample_np_and_diameter():
    rng = np.random.default_rng(8)
    p, nr = synthetic.blob_cloud(rng, 3000)
    d = jpc.bbox_diameter(p)
    assert tpc.bbox_diameter(p) == d
    for a, b in zip(tpc.voxel_downsample_np(p, nr, 0.1 * d),
                    jpc.voxel_downsample_np(p, nr, 0.1 * d)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_copies_same_arrays():
    """The port's numpy copies draw the same numbers in the same order."""
    for fn in ("blob_cloud", "clutter_cloud"):
        a = getattr(tsyn, fn)(np.random.default_rng(4), 500)
        b = getattr(synthetic, fn)(np.random.default_rng(4), 500)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    mp, mn = synthetic.blob_cloud(np.random.default_rng(5), 300)
    a = tsyn.plant_model(np.random.default_rng(6), mp, mn)
    b = synthetic.plant_model(np.random.default_rng(6), mp, mn)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_bin_picking_scene_is_bench_scene():
    """The port's copy of bench.build_scene gives the same seed-0 scan."""
    import bench

    mp_raw, mn_raw = synthetic.blob_cloud(np.random.default_rng(0), 20_000)
    want = bench.build_scene(np.random.default_rng(0), mp_raw, mn_raw)
    got = tsyn.bin_picking_scene(np.random.default_rng(0), mp_raw, mn_raw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def candidates():
    """Clustered candidate lists: groups of near-identical poses (so that
    neighbours exist) plus scattered ones, some masked out."""
    rng = np.random.default_rng(12)
    P = 96
    base_t = rng.uniform(-1, 1, size=(6, 3)).astype(np.float32)
    base_q = rng.normal(size=(6, 4))
    idx = rng.integers(0, 6, P)
    t = (base_t[idx] + rng.normal(scale=0.05, size=(P, 3))).astype(np.float32)
    q = base_q[idx] + rng.normal(scale=0.02, size=(P, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    w = rng.integers(1, 40, P).astype(np.float32)
    valid = rng.random(P) > 0.15
    return t, q, w, valid


@pytest.mark.parametrize("center,l1,avg", [
    (False, False, False), (True, False, False), (False, True, True),
    (True, True, True), (False, False, True), (True, False, True)])
def test_cluster_poses_dense(candidates, center, l1, avg):
    t, q, w, valid = candidates
    kw = dict(include_center_cell=center, use_l1_norm=l1,
              use_averaged_clusters=avg)
    d_dist, rot = 0.2, 2 * 2 * math.pi / 30
    cj = jcl.cluster_poses_dense(t, q, w, valid, d_dist, rot, **kw)
    ct = tcl.cluster_poses_dense(_t(t), _t(q), _t(w), torch.from_numpy(valid),
                                 d_dist, rot, **kw)
    np.testing.assert_array_equal(ct.vote_counts.numpy(),
                                  np.asarray(cj.vote_counts))
    np.testing.assert_allclose(ct.translations.numpy(),
                               np.asarray(cj.translations), atol=1e-5)
    assert float(ct.vote_counts.max()) > float(w.max())   # clusters formed


def _pose_close(got, want, tol=1e-4):
    td, rd = (float(x) for x in jtr.ht_dist(np.asarray(got),
                                            np.asarray(want)))
    assert td < tol and rd < tol, (td, rd)


@pytest.fixture(scope="module")
def icp_scene():
    """A voxelized model against the raw scan it came from, ~6° off (the
    set-up of test_icp.py::test_icp_point_to_plane_converges). The two
    clouds sample the surface at different places, so the optimum is not
    a degenerate exact overlap."""
    rng = np.random.default_rng(0)
    mp_raw, mn_raw = synthetic.blob_cloud(rng, 4000)
    d_dist = 0.1 * jpc.bbox_diameter(mp_raw)
    mp, mn = jpc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    sp, sn, T_true = synthetic.plant_model(rng, mp_raw, mn_raw)
    T0 = T_true @ np.asarray(jtr.rotx(math.radians(6.0)))
    T0[:3, 3] += rng.normal(scale=0.02, size=3)
    return mp, mn, sp, sn, T_true, T0.astype(np.float32), 2.0 * d_dist


@pytest.mark.parametrize("kind", ["point", "point_gated", "plane",
                                  "chunked", "masked"])
def test_refine_pose_matches_jax(icp_scene, kind, monkeypatch):
    """tests/test_icp.py-style inputs through both refine_pose's."""
    mp, mn, sp, sn, T_true, T0, max_dist = icp_scene
    kw = {}
    if kind == "point_gated":
        kw = dict(scene_normals=sn, model_normals=mn, point_to_plane=False)
    elif kind == "plane":
        # 4 Kabsch steps, then 2 clamped point-to-plane steps.
        kw = dict(scene_normals=sn, model_normals=mn, iterations=6)
    elif kind == "chunked":
        # Force the multi-chunk NN path (tile budget below n_m · n_s).
        monkeypatch.setattr(jicp, "_NN_TILE_BUDGET", 1000)
        monkeypatch.setattr(jicp, "_NN_CHUNK", 512)
        monkeypatch.setattr(ticp, "_NN_TILE_BUDGET", 1000)
        monkeypatch.setattr(ticp, "_NN_CHUNK", 512)
    elif kind == "masked":
        sp = np.concatenate([sp, np.full((50, 3), 1e6, np.float32)])
        kw = dict(scene_valid=np.arange(len(sp)) < len(sp) - 50)
    rj = jicp.refine_pose(mp, sp, T0, max_dist=max_dist, **kw)
    tkw = {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    rt = ticp.refine_pose(_t(mp), _t(sp), _t(T0), max_dist=max_dist, **tkw)
    _pose_close(rt.pose.numpy(), rj.pose)
    assert int(rt.inliers) == int(rj.inliers)
    np.testing.assert_allclose(float(rt.rms), float(rj.rms), atol=1e-5)


def test_point_to_plane_converges_like_jax(icp_scene):
    """16 iterations (the oscillating regime): both packages meet
    test_icp.py::test_icp_point_to_plane_converges's criteria."""
    mp, mn, sp, sn, T_true, T0, max_dist = icp_scene
    rj = jicp.refine_pose(mp, sp, T0, iterations=16, max_dist=max_dist,
                          scene_normals=sn, model_normals=mn)
    rt = ticp.refine_pose(_t(mp), _t(sp), _t(T0), iterations=16,
                          max_dist=max_dist, scene_normals=_t(sn),
                          model_normals=_t(mn))
    for pose in (np.asarray(rj.pose), rt.pose.numpy()):
        td, rd = (float(x) for x in jtr.ht_dist(pose, T_true))
        assert math.degrees(rd) < 2.0 and td < 0.1, (td, math.degrees(rd))
    assert int(rt.inliers) == int(rj.inliers)


def test_point_to_plane_without_normals_raises(icp_scene):
    mp, _, sp, _, _, _, _ = icp_scene
    with pytest.raises(ValueError, match="point-to-plane"):
        ticp.refine_pose(_t(mp), _t(sp), torch.eye(4), max_dist=0.3,
                         point_to_plane=True)
