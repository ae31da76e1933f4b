"""The port's TSDF raycast, tracking, surface extraction and streaming
recognizer (objective_slam_tpu_torch.models.tsdf) and
tools/tsdf_smoke_torch.py against the JAX package, on the CPU.

The same seeded numpy inputs go to the JAX function and to the port with
device="cpu"; a fused JAX volume is carried across as its arrays. What
must agree:
  * raycast_depth: hit masks differ on at most 0.1% of the pixels, depths
    within 1e-5 where both hit;
  * track_frame: pose within 2e-3 (entries of T_cw) of the JAX pose,
    inliers within 1% and overlap within 0.2%; the 6×6 sums run in
    another order and the Gauss-Newton chain carries the difference;
  * extract_surface: count, overflowed and the point rows equal, order
    included; normals within 0.1° on 99% of the rows, and over 1° only
    where the orientation is undecided (|PCA normal · TSDF gradient| below
    1e-6: a plane whose gradient lies in it);
  * StreamingRecognizer.recognize: the reference criteria met by both
    packages on the same fused input.
The mirrors of tests/test_tsdf.py's tests run the port alone, with that
file's sizes and criteria. torch runs on one thread.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import objective_slam_tpu as ost
import objective_slam_tpu_torch as pt
from objective_slam_tpu.config import PPFConfig as JConfig
from objective_slam_tpu.models import tsdf as jt
from objective_slam_tpu.ops import transforms as jtr
from objective_slam_tpu.utils import synthetic as jsyn, validation as jval
from objective_slam_tpu_torch.models import tsdf as tt
from objective_slam_tpu_torch.utils import synthetic as tsyn, \
    validation as tval

ROOT = Path(__file__).resolve().parent.parent
_INTR = (160.0, 160.0, 80.0, 60.0)    # fx fy cx cy for a 120x160 image
_SHAPE = (120, 160)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sphere_cloud(rng, n, center, radius):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (center + radius * v).astype(np.float32), v.astype(np.float32)


def _depth_sphere(rng, n, r=0.8, center=(1.6, 1.6, 1.6)):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * r + np.asarray(center)).astype(np.float32), \
        v.astype(np.float32)


def _corner_scene(rng, n=70_000):
    """Sphere and two orthogonal walls (test_tsdf.py:302-311)."""
    sp, _ = _depth_sphere(rng, n // 2, r=0.6, center=(1.6, 1.6, 1.6))
    u = rng.uniform(0.4, 2.8, size=(n // 4, 2)).astype(np.float32)
    floor = np.stack([u[:, 0], u[:, 1], np.full(len(u), 0.45)],
                     axis=1).astype(np.float32)
    wall = np.stack([u[:, 0], np.full(len(u), 0.45), u[:, 1] * 0.7 + 0.5],
                    axis=1).astype(np.float32)
    return np.concatenate([sp, floor, wall])


def _perturb_pose(rng, T_cw, rot_deg, trans):
    """test_tsdf.py:314-328."""
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    th = math.radians(rot_deg)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    R = np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K
    dT = np.eye(4, dtype=np.float32)
    dT[:3, :3] = R.astype(np.float32)
    d = rng.normal(size=3)
    dT[:3, 3] = (d / np.linalg.norm(d) * trans).astype(np.float32)
    return (np.asarray(T_cw) @ dT).astype(np.float32)


def _port(jvol):
    return tt.volume_from_arrays(np.asarray(jvol.tsdf),
                                 np.asarray(jvol.weight),
                                 np.asarray(jvol.origin), jvol.voxel_size,
                                 jvol.truncation, device="cpu")


def _ht(T, T_ref):
    return (float(x) for x in jtr.ht_dist(np.asarray(T, np.float32),
                                          np.asarray(T_ref, np.float32)))


# ------------------------------------------------------------------ raycast

@pytest.fixture(scope="module")
def sphere_view():
    """One fused view of a sphere (test_tsdf.py:195-205): the JAX volume,
    the measured depth and the camera→world pose."""
    rng = np.random.default_rng(0)
    sp, _ = _depth_sphere(rng, 60_000)
    vol = jt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                         voxel_size=0.05)
    center = np.float32([1.6, 1.6, 1.6])
    T_cw = jsyn.look_at(center + np.float32([0.0, -2.2, 0.2]), center)
    depth = jsyn.render_depth(sp, T_cw, _INTR, _SHAPE)
    vol = jt.integrate_depth(vol, depth, _INTR, T_cw)
    T_wc = np.linalg.inv(np.asarray(T_cw, np.float64)).astype(np.float32)
    return vol, depth, T_wc


@pytest.mark.parametrize("kw", [dict(t_near=0.5, t_far=4.0), dict()],
                         ids=["near0.5-far4", "defaults"])
def test_raycast_equals_jax(sphere_view, kw):
    jvol, _, T_wc = sphere_view
    want = np.asarray(jt.raycast_depth(jvol, _INTR, T_wc, _SHAPE, **kw))
    got = _np(tt.raycast_depth(_port(jvol), _INTR, T_wc, _SHAPE, **kw))
    assert got.dtype == np.float32 and got.shape == _SHAPE
    hit_j, hit_t = want > 0, got > 0
    assert hit_j.mean() > 0.04
    assert (hit_j != hit_t).mean() <= 1e-3
    both = hit_j & hit_t
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-5)


def test_raycast_depth_roundtrip(sphere_view):
    """Mirror of test_tsdf.py::test_raycast_depth_roundtrip."""
    jvol, depth, T_wc = sphere_view
    cast = _np(tt.raycast_depth(_port(jvol), _INTR, T_wc, _SHAPE,
                                t_near=0.5, t_far=4.0))
    both = (depth > 0) & (cast > 0)
    assert both.mean() > 0.04
    assert np.median(np.abs(cast[both] - depth[both])) < 0.06


def _graze_volume():
    """test_tsdf.py:472-489: an observed wall at z = 2 and one phantom
    negative voxel one voxel off the central ray."""
    vs = 0.05
    dims = (64, 64, 64)
    trunc = 3 * vs
    d = 2.0 - (np.arange(64) + 0.5) * vs
    tsdf_np = np.broadcast_to(np.clip(d, -trunc, trunc)[None, None, :],
                              dims).astype(np.float32).copy()
    wgt_np = np.broadcast_to((d >= -trunc)[None, None, :],
                             dims).astype(np.float32).copy()
    tsdf_np[32, 33, 19] = -trunc
    wgt_np[32, 33, 19] = 1.0
    return tsdf_np, wgt_np, vs, trunc


def test_raycast_multi_bracket_resumes_after_graze():
    """Mirror of test_tsdf.py::test_raycast_multi_bracket_resumes_after_graze,
    with the JAX package's views of the same volume beside the port's."""
    tsdf_np, wgt_np, vs, trunc = _graze_volume()
    vol = tt.volume_from_arrays(tsdf_np, wgt_np, (0.0, 0.0, 0.0), vs, trunc,
                                device="cpu")
    jvol = dataclasses.replace(
        jt.make_volume(origin=(0.0, 0.0, 0.0), dims=tsdf_np.shape,
                       voxel_size=vs, truncation=trunc),
        tsdf=tsdf_np, weight=wgt_np)
    x0 = (32 + 0.5) * vs
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [x0, x0, 0.2]
    cast1 = _np(tt.raycast_depth(vol, _INTR, T_wc, _SHAPE, t_near=0.1,
                                 t_far=3.0, n_brackets=1))
    cast3 = _np(tt.raycast_depth(vol, _INTR, T_wc, _SHAPE, t_near=0.1,
                                 t_far=3.0))
    v_pix, u_pix = 60, 80
    assert cast1[v_pix, u_pix] == 0.0           # the graze took the window
    assert abs(cast3[v_pix, u_pix] - 1.8) < vs  # resumed onto the wall
    assert abs(cast1[v_pix, u_pix - 20] - 1.8) < vs
    assert abs(cast3[v_pix, u_pix - 20] - 1.8) < vs
    for nb, got in ((1, cast1), (3, cast3)):
        want = np.asarray(jt.raycast_depth(jvol, _INTR, T_wc, _SHAPE,
                                           t_near=0.1, t_far=3.0,
                                           n_brackets=nb))
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_raycast_t_near_zero_first_segment(rng):
    """Mirror of test_tsdf.py::test_raycast_t_near_zero_first_segment,
    with the JAX view of the same volume beside it."""
    pts, nrm = _sphere_cloud(rng, 12000, np.zeros(3), 0.6)
    jvol = jt.integrate(jt.make_volume(origin=(-1.0, -1.0, -1.0),
                                       dims=(40, 40, 40), voxel_size=0.05),
                        pts, nrm)
    vol = tt.integrate(tt.make_volume(origin=(-1.0, -1.0, -1.0),
                                      dims=(40, 40, 40), voxel_size=0.05,
                                      device="cpu"), pts, nrm)
    T_cw = tsyn.look_at(np.float32([0.68, 0.0, 0.0]), (0.0, 0.0, 0.0))
    intr = (60.0, 60.0, 31.5, 31.5)
    view = _np(tt.raycast_depth(vol, intr, np.linalg.inv(T_cw), (64, 64),
                                t_near=0.0, t_far=2.0, n_steps=64))
    c = view[32, 32]
    assert c > 0, "central ray lost despite crossing in the first segments"
    assert abs(c - 0.08) < 0.08, c
    want = np.asarray(jt.raycast_depth(jvol, intr, np.linalg.inv(T_cw),
                                       (64, 64), t_near=0.0, t_far=2.0,
                                       n_steps=64))
    assert ((view > 0) != (want > 0)).mean() <= 1e-3
    both = (view > 0) & (want > 0)
    np.testing.assert_allclose(view[both], want[both], rtol=0, atol=1e-5)


# ----------------------------------------------------------------- tracking

@pytest.fixture(scope="module")
def corner_fused():
    """The corner scene fused from three posed views, and the ground-truth
    pose and depth of an in-between view (test_tsdf.py:335-349)."""
    rng = np.random.default_rng(0)
    world = _corner_scene(rng)
    vol = jt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                         voxel_size=0.05)
    center = np.float32([1.6, 1.6, 1.4])
    for ang in (0.0, 0.5, 1.0):
        eye = center + np.float32([2.3 * math.cos(ang),
                                   2.3 * math.sin(ang), 0.9])
        T_cw = jsyn.look_at(eye, center)
        vol = jt.integrate_depth(vol, jsyn.render_depth(world, T_cw, _INTR,
                                                        _SHAPE), _INTR, T_cw)
    eye = center + np.float32([2.3 * math.cos(0.25),
                               2.3 * math.sin(0.25), 0.95])
    T_gt = jsyn.look_at(eye, center)
    return dict(world=world, vol=vol, T_gt=T_gt,
                depth=jsyn.render_depth(world, T_gt, _INTR, _SHAPE),
                center=center)


@pytest.mark.parametrize("rot_deg,trans,iters,dist", [
    (4.0, 0.12, 12, None), (5.0, 0.28, 16, 0.08)],
    ids=["perturbed", "annealed-gate"])
def test_track_frame_equals_jax(corner_fused, rot_deg, trans, iters, dist):
    """The same volume arrays, frame and start pose through both
    packages' track_frame."""
    c = corner_fused
    T_init = _perturb_pose(np.random.default_rng(1), c["T_gt"], rot_deg,
                           trans)
    want = jt.track_frame(c["vol"], c["depth"], _INTR, T_init, iters=iters,
                          dist_thresh=dist)
    got = tt.track_frame(_port(c["vol"]), c["depth"], _INTR, T_init,
                         iters=iters, dist_thresh=dist)
    assert got.inliers.dtype == got.overlap.dtype == torch.int32
    np.testing.assert_allclose(_np(got.T_cw), np.asarray(want.T_cw), rtol=0,
                               atol=2e-3)
    assert abs(int(got.inliers) - int(want.inliers)) \
        <= 0.01 * int(want.inliers)
    assert abs(int(got.overlap) - int(want.overlap)) \
        <= 0.002 * int(want.overlap)
    assert abs(float(got.rms) - float(want.rms)) <= 0.05 * float(want.rms)
    td_t, rd_t = _ht(_np(got.T_cw), c["T_gt"])
    td_j, rd_j = _ht(np.asarray(want.T_cw), c["T_gt"])
    assert abs(td_t - td_j) < 2e-3 and abs(rd_t - rd_j) < math.radians(0.1)


def test_track_frame_recovers_perturbed_pose(corner_fused):
    """Mirror of test_tsdf.py::test_track_frame_recovers_perturbed_pose."""
    c = corner_fused
    T_init = _perturb_pose(np.random.default_rng(0), c["T_gt"], rot_deg=4.0,
                           trans=0.12)
    td0, rd0 = _ht(T_init, c["T_gt"])
    assert td0 > 0.08
    res = tt.track_frame(_port(c["vol"]), c["depth"], _INTR, T_init,
                         iters=12)
    td, rd = _ht(_np(res.T_cw), c["T_gt"])
    assert int(res.inliers) > 2000
    assert td < 0.4 * td0 and rd < 0.5 * rd0, (td, td0, rd, rd0)
    assert td < 1.2 * 0.05 and rd < math.radians(1.5), \
        (td, math.degrees(rd))


def test_track_frame_annealed_gate_capture_range(corner_fused):
    """Mirror of test_tsdf.py::test_track_frame_annealed_gate_capture_range:
    a start ~3.5 final-gate radii off still converges."""
    c = corner_fused
    T_init = _perturb_pose(np.random.default_rng(0), c["T_gt"], rot_deg=5.0,
                           trans=3.5 * 0.08)
    res = tt.track_frame(_port(c["vol"]), c["depth"], _INTR, T_init,
                         iters=16, dist_thresh=0.08)
    td, rd = _ht(_np(res.T_cw), c["T_gt"])
    assert int(res.inliers) > 1000
    assert td < 0.1 and rd < math.radians(2.0), (td, math.degrees(rd))


def test_streaming_tracked_frames_bounded_drift(rng):
    """Mirror of test_tsdf.py::test_streaming_tracked_frames_bounded_drift:
    only the first frame posed; drift stays under 2.5 voxels / 2°."""
    world = _corner_scene(rng)
    rec = tt.StreamingRecognizer(tt.make_volume(
        origin=(0.0, 0.0, 0.0), dims=(64, 64, 64), voxel_size=0.05,
        device="cpu"))
    center = np.float32([1.6, 1.6, 1.4])
    drift = []
    for f in range(6):
        ang = 0.12 * f
        eye = center + np.float32([2.3 * math.cos(ang),
                                   2.3 * math.sin(ang), 0.9 + 0.03 * f])
        T_gt = tsyn.look_at(eye, center)
        depth = tsyn.render_depth(world, T_gt, _INTR, _SHAPE)
        res = rec.track_depth_frame(depth, _INTR,
                                    T_cw_hint=T_gt if f == 0 else None)
        if f == 0:
            assert res is None
            continue
        td, rd = _ht(rec.T_cw, T_gt)
        drift.append((td, math.degrees(rd)))
    tds, rds = zip(*drift)
    assert max(tds) < 2.5 * 0.05 and max(rds) < 2.0, drift


def test_track_depth_frame_lost_gate_blocks_fusion(rng):
    """Mirror of test_tsdf.py::test_track_depth_frame_lost_gate_blocks_fusion:
    a view that barely associates trips the gate (pose held, volume not
    fused); a small-motion frame clears it."""
    world = _corner_scene(rng)
    rec = tt.StreamingRecognizer(tt.make_volume(
        origin=(0.0, 0.0, 0.0), dims=(64, 64, 64), voxel_size=0.05,
        device="cpu"))
    with pytest.raises(ValueError, match="anchors the world frame"):
        rec.track_depth_frame(np.zeros(_SHAPE, np.float32), _INTR)
    center = np.float32([1.6, 1.6, 1.4])
    T0 = tsyn.look_at(center + np.float32([2.3, 0.0, 0.9]), center)
    rec.track_depth_frame(tsyn.render_depth(world, T0, _INTR, _SHAPE),
                          _INTR, T_cw_hint=T0)
    T1 = tsyn.look_at(center + np.float32([2.6, 0.0, 0.9]),
                      center + np.float32([6.0, 0.0, 1.0]))
    d1 = tsyn.render_depth(world, T1, _INTR, _SHAPE)
    tsdf_before = _np(rec.volume.tsdf).copy()
    rec.track_depth_frame(d1, _INTR)
    assert rec.tracking_lost
    np.testing.assert_array_equal(_np(rec.volume.tsdf), tsdf_before)
    np.testing.assert_array_equal(rec.T_cw, np.asarray(T0, np.float32))
    ang2 = 0.1
    T2 = tsyn.look_at(center + np.float32([2.3 * math.cos(ang2),
                                           2.3 * math.sin(ang2), 0.92]),
                      center)
    rec.track_depth_frame(tsyn.render_depth(world, T2, _INTR, _SHAPE),
                          _INTR)
    assert not rec.tracking_lost
    assert not np.array_equal(_np(rec.volume.tsdf), tsdf_before)
    td, rd = _ht(rec.T_cw, T2)
    assert td < 0.15 and rd < math.radians(3.0), (td, math.degrees(rd))


# --------------------------------------------------------------- extraction

def _hold_surface(got, want, tol_deg=0.1):
    """count, overflowed, valid and point rows equal (order included);
    normals as the module docstring says. Returns the normals' angles."""
    assert got.count.dtype == torch.int32
    assert int(got.count) == int(want.count)
    assert bool(got.overflowed) == bool(want.overflowed)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(_np(got.valid), ok)
    np.testing.assert_array_equal(_np(got.points), np.asarray(want.points))
    a, b = _np(got.normals)[ok], np.asarray(want.normals)[ok]
    np.testing.assert_array_equal(_np(got.normals)[~ok], 0.0)
    ang = np.degrees(np.arccos(np.clip(np.sum(a * b, axis=1), -1, 1)))
    assert np.quantile(ang, 0.99) < tol_deg, np.quantile(ang, 0.99)
    return ang, ok


def test_extract_surface_knn_equals_jax(sphere_view):
    """The k-NN branch (capacity ≤ 8,192) on voxel centres, a regular grid
    where the k-th neighbour ties; a fitting and an overflowing capacity."""
    jvol = sphere_view[0]
    tvol = _port(jvol)
    for cap in (2048, 128):
        want = jt.extract_surface(jvol, capacity=cap)
        got = tt.extract_surface(tvol, capacity=cap)
        ang, ok = _hold_surface(got, want)
        # Orientation flips only where the gradient lies in the plane.
        bad = np.flatnonzero(ang > 1.0)
        if len(bad):
            t = _np(tvol.tsdf)
            g = np.stack(np.gradient(t), -1).reshape(-1, 3)
            D, H, W = tvol.dims
            pts = _np(got.points)[ok][bad]
            ijk = np.round((pts - _np(tvol.origin)) / tvol.voxel_size
                           - 0.5).astype(int)
            gsel = g[(ijk[:, 0] * H + ijk[:, 1]) * W + ijk[:, 2]]
            gsel /= np.maximum(np.linalg.norm(gsel, axis=1,
                                              keepdims=True), 1e-9)
            assert np.all(np.abs(np.sum(gsel * _np(got.normals)[ok][bad],
                                        axis=1)) < 1e-6)
        assert len(bad) <= 0.01 * ok.sum()


def test_surface_capacity_overflow_and_occupancy(sphere_view):
    """Mirror of test_tsdf.py::test_surface_capacity_overflow_and_occupancy,
    with the occupancy equal to the JAX count."""
    jvol = sphere_view[0]
    vol = _port(jvol)
    occ_t = tt.surface_occupancy(vol)
    assert occ_t.dtype == torch.int32
    occ = int(occ_t)
    assert occ == int(jt.surface_occupancy(jvol))
    assert occ > 256
    tiny = tt.extract_surface(vol, capacity=128)
    assert bool(tiny.overflowed) and int(tiny.count) == occ
    sized = tt.extract_surface(vol, capacity=((occ + 127) // 128) * 128)
    assert not bool(sized.overflowed)
    assert int(torch.sum(sized.valid)) == occ


@pytest.fixture(scope="module")
def splat_sphere_96():
    """A 60,000-point splat sphere in a 96³ volume: over 8,192 surface
    voxels, so extraction takes the moment-grid branch
    (test_tsdf.py:43-48)."""
    rng = np.random.default_rng(0)
    pts, nrm = _sphere_cloud(rng, 60_000, np.zeros(3), 1.0)
    return jt.integrate(jt.make_volume(origin=(-1.5, -1.5, -1.5),
                                       dims=(96, 96, 96), voxel_size=1 / 32),
                        pts, nrm)


def test_extract_surface_grid_equals_jax(splat_sphere_96):
    jvol = splat_sphere_96
    want = jt.extract_surface(jvol, capacity=16384)
    got = tt.extract_surface(_port(jvol), capacity=16384)
    ang, _ = _hold_surface(got, want)
    assert (ang > 1.0).sum() == 0


def test_extract_sphere_grid_normals_large_capacity(splat_sphere_96):
    """Mirror of test_tsdf.py::test_extract_sphere_grid_normals_large_capacity
    (the port's own splat of the same cloud)."""
    rng = np.random.default_rng(0)
    pts, nrm = _sphere_cloud(rng, 60_000, np.zeros(3), 1.0)
    vol = tt.integrate(tt.make_volume(origin=(-1.5, -1.5, -1.5),
                                      dims=(96, 96, 96), voxel_size=1 / 32,
                                      device="cpu"), pts, nrm)
    assert int(tt.surface_occupancy(vol)) > 8192
    surf = tt.extract_surface(vol, capacity=16384)
    assert not bool(surf.overflowed)
    ok = _np(surf.valid)
    sp, sn = _np(surf.points)[ok], _np(surf.normals)[ok]
    radii = np.linalg.norm(sp, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.1
    assert np.median(np.abs(np.sum(sn * sp / radii[:, None], axis=1))) > 0.9
    assert np.median(np.sum(sn * sp, axis=1)) > 0
    far = _np(surf.points)[~ok]
    if len(far):
        assert np.all(far < -1e6)


def test_integrate_and_extract_sphere(rng):
    """Mirror of test_tsdf.py::test_integrate_and_extract_sphere."""
    vol = tt.make_volume(origin=(-1.5, -1.5, -1.5), dims=(48, 48, 48),
                         voxel_size=1 / 16, device="cpu")
    pts, nrm = _sphere_cloud(rng, 4000, np.zeros(3), 1.0)
    vol = tt.integrate(vol, pts, nrm)
    surf = tt.extract_surface(vol, capacity=2048)
    assert int(surf.count) > 500
    sp = _np(surf.points)[_np(surf.valid)]
    radii = np.linalg.norm(sp, axis=1)
    assert abs(np.median(radii) - 1.0) < 0.1
    sn = _np(surf.normals)[_np(surf.valid)]
    assert np.median(np.abs(np.sum(sn * sp / radii[:, None], axis=1))) > 0.9


# ----------------------------------------------------- streaming recognizer

def test_streaming_recognition(rng):
    """Mirror of test_tsdf.py::test_streaming_recognition: splat partial
    frames, recognize the planted model."""
    cfg = pt.PPFConfig(max_poses=512, ref_point_df=2)
    mp, mn = tsyn.blob_cloud(rng, 1500, bumps=0.5)
    sp, sn, T_true = tsyn.plant_model(rng, mp, mn)
    rec = tt.StreamingRecognizer(
        tt.make_volume(origin=sp.min(axis=0) - 0.3, dims=(40, 40, 40),
                       voxel_size=0.1, device="cpu"), cfg,
        surface_capacity=896)
    mvol = tt.integrate(tt.make_volume(origin=mp.min(axis=0) - 0.3,
                                       dims=(40, 40, 40), voxel_size=0.1,
                                       device="cpu"), mp, mn)
    msurf = tt.extract_surface(mvol, capacity=352)
    ok = _np(msurf.valid)
    rec.register_model("blob", pt.build_model_description(
        _np(msurf.points)[ok], _np(msurf.normals)[ok], cfg, device="cpu"))
    order = rng.permutation(len(sp))
    for part in np.array_split(order, 3):
        rec.integrate_frame(sp[part], sn[part])
    assert rec.frames == 3
    res = rec.recognize()["blob"]
    v = tval.validate_pose(_np(res.pose), T_true,
                           rec.models["blob"].diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))


def _fuse_views(fuse, vol, cloud, center):
    for az in (0.4, 2.5, 4.6):
        eye = center + 1.8 * np.float32([math.cos(az), math.sin(az), 0.35])
        T_cw = jsyn.look_at(eye, center)
        vol = fuse(vol, jsyn.render_depth(cloud, T_cw, _INTR, _SHAPE), T_cw)
    return vol


@pytest.fixture(scope="module")
def blob_depth_fused():
    """A blob at (1.6, 1.6, 1.6) depth-fused from three views in each
    package; the model description of each built through the same sensing
    pipeline (test_tsdf.py:239-263)."""
    rng = np.random.default_rng(0)
    mp, _ = jsyn.blob_cloud(rng, 6000, bumps=0.5)
    mp = (mp * 0.5).astype(np.float32)
    center = np.float32([1.6, 1.6, 1.6])
    sp = mp + center

    def j_fuse(v, d, T):
        return jt.integrate_depth(v, d, _INTR, T)

    jvol = _fuse_views(j_fuse, jt.make_volume(origin=(0.0, 0.0, 0.0),
                                              dims=(64, 64, 64),
                                              voxel_size=0.04), sp, center)
    return dict(jvol=jvol, sp=sp, center=center)


def test_streaming_recognizer_depth_frames(blob_depth_fused):
    """Mirror of test_tsdf.py::test_streaming_recognizer_depth_frames."""
    c = blob_depth_fused
    cfg = pt.PPFConfig(ref_point_df=2, max_poses=512)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = c["center"]

    def t_fuse(v, d, T):
        return tt.integrate_depth(v, d, _INTR, T)

    mvol = _fuse_views(t_fuse, tt.make_volume(
        origin=(0.0, 0.0, 0.0), dims=(64, 64, 64), voxel_size=0.04,
        device="cpu"), c["sp"], c["center"])
    msurf = tt.extract_surface(mvol, capacity=2048)
    ok = _np(msurf.valid)
    desc = pt.build_model_description(_np(msurf.points)[ok] - c["center"],
                                      _np(msurf.normals)[ok], cfg,
                                      device="cpu")
    rec = tt.StreamingRecognizer(tt.make_volume(
        origin=(0.0, 0.0, 0.0), dims=(64, 64, 64), voxel_size=0.04,
        device="cpu"), cfg, surface_capacity=2048)
    rec.register_model("blob", desc)
    for az in (0.4, 2.5, 4.6):
        eye = c["center"] + 1.8 * np.float32([math.cos(az), math.sin(az),
                                              0.35])
        T_cw = tsyn.look_at(eye, c["center"])
        rec.integrate_depth_frame(tsyn.render_depth(c["sp"], T_cw, _INTR,
                                                    _SHAPE), _INTR, T_cw)
    assert rec.frames == 3
    res = rec.recognize()["blob"]
    v = tval.validate_pose(_np(res.pose), T_true, desc.diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))


def test_recognize_on_the_same_fused_volume_both_packages(blob_depth_fused):
    """The JAX-fused volume's arrays given to both packages'
    StreamingRecognizer with the same model points: the extracted surfaces
    are equal and both recognitions meet the reference criteria."""
    c = blob_depth_fused
    jvol = c["jvol"]
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = c["center"]
    msurf = jt.extract_surface(jvol, capacity=2048)
    ok = np.asarray(msurf.valid)
    mpts = np.asarray(msurf.points)[ok] - c["center"]
    mnrm = np.asarray(msurf.normals)[ok]

    jcfg = JConfig(ref_point_df=2, max_poses=512)
    jrec = jt.StreamingRecognizer(jvol, jcfg, surface_capacity=2048)
    jrec.register_model("blob", ost.build_model_description(mpts, mnrm,
                                                            jcfg))
    tcfg = pt.PPFConfig(ref_point_df=2, max_poses=512)
    trec = tt.StreamingRecognizer(_port(jvol), tcfg, surface_capacity=2048)
    tdesc = pt.build_model_description(mpts, mnrm, tcfg, device="cpu")
    trec.register_model("blob", tdesc)
    _hold_surface(trec.surface(), jrec.surface())

    j_res = jrec.recognize()["blob"]
    t_res = trec.recognize()["blob"]
    vj = jval.validate_pose(np.asarray(j_res.pose), T_true,
                            jrec.models["blob"].diameter, jcfg)
    vt = tval.validate_pose(_np(t_res.pose), T_true, tdesc.diameter, tcfg)
    assert vj.match and vt.match, (vj, vt)
    assert not bool(t_res.overflowed)


# ------------------------------------------------------------ the smoke tool

def test_tsdf_smoke_torch_prints_every_key_of_the_jax_smoke(capsys):
    """tools/tsdf_smoke_torch.main at a toy size on the CPU prints one JSON
    line holding every key of tools/tsdf_smoke.py's line."""
    sys.path.insert(0, str(ROOT / "tools"))
    import tsdf_smoke_torch

    assert tsdf_smoke_torch.main(["--dims", "32", "--frames", "2", "--img",
                                  "48", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    jax_keys = {"dims", "voxel_size", "frames", "integrate_ms_per_frame",
                "integrate_banded_ms_per_frame", "band_blocks_max",
                "band_block_cap", "band_blocks_total", "surface_occupancy",
                "surface_capacity_used", "extract_ms", "extract_ms_cold",
                "raycast_ms", "raycast_ms_cold", "recognize_ms",
                "recognize_ms_cold", "trans_err", "rot_err_deg", "match",
                "tracking"}
    tracking_keys = {"frames_tracked", "deg_per_frame", "lost_frames",
                     "track_ms_per_frame", "max_drift_trans",
                     "max_drift_rot_deg", "per_frame", "recognize_trans_err",
                     "recognize_rot_err_deg", "recognize_match"}
    assert jax_keys <= set(line)
    assert tracking_keys <= set(line["tracking"])
    assert line["dims"] == 32 and line["band_blocks_total"] == 64
    assert line["tracking"]["frames_tracked"] == 47
    assert len(line["tracking"]["per_frame"]) == 47
    assert set(line["tracking"]["per_frame"][0]) == {
        "frame", "trans", "rot_deg", "inliers", "overlap", "rms", "lost"}
    assert line["tracking"]["lost_frames"] == sum(
        f["lost"] for f in line["tracking"]["per_frame"])
    assert line["device"] == "cpu"
    assert all(v is None for v in line["peak_mem_gib"].values())
    assert not any(line["overflowed"].values())
