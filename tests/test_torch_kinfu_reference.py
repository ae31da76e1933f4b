"""The port's KinFu path (objective_slam_tpu_torch.models.tsdf) against the
plain reference that decides the benchmark's `kinfu-track-512` cell
(benchmark/frozen/kinfu_reference.py), on the CPU at a small size: a 48³
volume over a 3 m cube and 64×48 depth frames of seeded random box scenes.

What must agree, and why the tolerance:
  * integrate_depth: weights equal; tsdf within 1e-6 m. The port rounds
    as XLA:CPU does (a fused multiply-add in the voxel centres, the
    rotation and the running average), the reference in plain float32:
    the sdf is a difference of depths of 1-4 m, whose float32 spacing is
    1.2e-7-2.4e-7 m, and each frame adds its roundings (seen: equal);
  * raycast_depth, at the default march and at the cell's: hit masks on
    all but 0.2% of the pixels; depths within 1e-5 m where both hit. The
    coarse march's sample positions differ by roundings, so a ray that
    grazes a bracket's edge can take another bracket (seen: equal masks,
    1.7e-6 m);
  * track_frame from a perturbed pose: the pose within 1e-5 of the cube's
    edge, its corners' largest displacement (the 6×6 sums run in another
    order, and ten Gauss-Newton steps carry the difference; seen: 1.4e-7),
    inliers and overlap within 0.5% (seen: equal);
  * three frames of track_depth_frame, a lost one among them: the same
    frames held back, the same bounds on pose, weights and tsdf;
  * the march's defaults passed explicitly give the bits of passing none.
The `tsdf.*` spans appear, nest and close under a CPU profiler.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.frozen import kinfu_reference as kr
from benchmark.generators import kinfu_orbit as orbit
from objective_slam_tpu_torch.models import tsdf
from objective_slam_tpu_torch.utils import profiling

DIMS = (48, 48, 48)
EXTENT = 3.0
VS = EXTENT / DIMS[0]
TAU = 3.0 * VS
ORIGIN = np.full(3, -EXTENT / 2, np.float32)
SHAPE = (48, 64)
K = (52.5, 52.5, 31.5, 23.5)
CELL_MARCH = (0.4, 4.0, 160)
DEFAULT_MARCH = (0.1, 6.0, 192)
ORBIT = {"radius": 1.4, "height": 0.6, "target_height": 0.05}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed):
    """A floor, a back wall and six boxes of random sizes and places."""
    rng = np.random.default_rng(seed)
    pieces = [orbit._disc(-0.75, 2.2), orbit._wall(-0.75, 1.25, 2.2)]
    for _ in range(6):
        size = rng.uniform(0.15, 0.5, size=3)
        xy = rng.uniform(-0.7, 0.7, size=2)
        pieces.append(orbit._box((xy[0], xy[1], -0.75 + size[2] / 2),
                                 size))
    return pieces


@pytest.fixture(scope="module", params=[5, 17], ids=["seed5", "seed17"])
def world(request):
    """(the scene's samples, a function: orbit degrees → (depth, T_cw))."""
    poses = [orbit.orbit_pose(ORBIT, d) for d in range(0, 360, 20)]
    pts = orbit.sample(_scene(request.param), poses, K, SHAPE, 6.0,
                       request.param, torch.device("cpu"))

    def frame(deg):
        T = orbit.orbit_pose(ORBIT, deg)
        depth, _ = orbit.render(pts, T, K, SHAPE)
        return orbit.noisy(depth, {"a": 0.0012, "b": 0.0019, "z0": 0.4},
                           request.param * 100 + int(deg)).numpy(), T
    return frame


def _volumes():
    return (tsdf.make_volume(ORIGIN, DIMS, VS, TAU, device="cpu"),
            kr.make_volume(ORIGIN, DIMS, VS, TAU, "cpu"))


def _fused(world, degs=(0, 40)):
    port, ref = _volumes()
    for d in degs:
        depth, T = world(d)
        port = tsdf.integrate_depth(port, depth, K, T)
        kr.integrate(ref, torch.as_tensor(depth), K, torch.as_tensor(T),
                     64.0)
    return port, ref


def _hold_volume(port, ref):
    np.testing.assert_array_equal(port.weight.numpy(), ref.weight.numpy())
    seen = ref.weight.numpy() > 0
    assert seen.mean() > 0.05
    np.testing.assert_allclose(port.tsdf.numpy()[seen],
                               ref.tsdf.numpy()[seen], rtol=0, atol=1e-6)


def _gap(T_a, T_b):
    return kr.corner_gap(T_a, T_b, ORIGIN, EXTENT)


def test_integrate_depth_matches_reference(world):
    _hold_volume(*_fused(world))


@pytest.mark.parametrize("march", [DEFAULT_MARCH, CELL_MARCH],
                         ids=["default-march", "cell-march"])
def test_raycast_matches_reference(world, march):
    port, ref = _fused(world)
    T_wc = np.linalg.inv(orbit.orbit_pose(ORBIT, 20)).astype(np.float32)
    got = tsdf.raycast_depth(port, K, T_wc, SHAPE, *march).numpy()
    want = kr.raycast(ref, K, torch.as_tensor(T_wc), SHAPE, *march).numpy()
    hit_p, hit_r = got > 0, want > 0
    assert hit_r.mean() > 0.2
    assert (hit_p != hit_r).mean() <= 0.002
    both = hit_p & hit_r
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-5)


def test_track_frame_matches_reference(world):
    port, ref = _fused(world)
    depth, T_gt = world(20)
    start = orbit.orbit_pose(ORBIT, 22).copy()
    start[:3, 3] += np.float32([0.02, -0.01, 0.015])
    got = tsdf.track_frame(port, depth, K, start, t_near=CELL_MARCH[0],
                           t_far=CELL_MARCH[1], n_steps=CELL_MARCH[2])
    want = kr.track(ref, torch.as_tensor(depth), K, torch.as_tensor(start),
                    10, CELL_MARCH)
    assert _gap(got.T_cw, want.T_cw) < 1e-5
    assert _gap(want.T_cw, T_gt) < 0.2 * _gap(start, T_gt)
    assert abs(int(got.inliers) - want.inliers) <= 0.005 * want.inliers
    assert abs(int(got.overlap) - want.overlap) <= 0.005 * want.overlap


def test_track_depth_frame_matches_reference(world):
    """Posed frames at 0° and 40°, then tracked frames at 2°, a frame of
    random depths (a sensor glitch: its normals pass no gate, so it is
    lost: not fused, the pose holds) and 4°."""
    port, ref = _volumes()
    rec = tsdf.StreamingRecognizer(port)
    stream = kr.Stream(ref, K, 64.0, CELL_MARCH, 10)
    for d in (0, 40):
        depth, T = world(d)
        rec.integrate_depth_frame(depth, K, T)
        stream.fuse(torch.as_tensor(depth), T)
    lost = []
    glitch = np.random.default_rng(0).uniform(0.5, 4.0, SHAPE)
    for depth in (world(2)[0], glitch.astype(np.float32), world(4)[0]):
        rec.track_depth_frame(depth, K, t_near=CELL_MARCH[0],
                              t_far=CELL_MARCH[1], n_steps=CELL_MARCH[2])
        _, gone, _ = stream.step(torch.as_tensor(depth))
        assert rec.tracking_lost == gone
        lost.append(gone)
        assert _gap(rec.T_cw, stream.T_cw) < 1e-5
    assert lost == [False, True, False]
    _hold_volume(rec.volume, stream.vol)


def test_default_march_is_the_default(world):
    """The march's defaults passed explicitly give the same bits as none,
    through track_frame and through the recognizer."""
    port, _ = _fused(world)
    depth, _ = world(20)
    start = orbit.orbit_pose(ORBIT, 21)
    a = tsdf.track_frame(port, depth, K, start)
    b = tsdf.track_frame(port, depth, K, start, t_near=0.1, t_far=6.0,
                         n_steps=192)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    recs = [tsdf.StreamingRecognizer(port) for _ in range(2)]
    for rec in recs:
        depth0, T0 = world(0)
        rec.integrate_depth_frame(depth0, K, T0)
    recs[0].track_depth_frame(depth, K)
    recs[1].track_depth_frame(depth, K, t_near=0.1, t_far=6.0, n_steps=192)
    np.testing.assert_array_equal(recs[0].T_cw, recs[1].T_cw)
    assert torch.equal(recs[0].volume.tsdf, recs[1].volume.tsdf)


def test_spans_appear_nest_and_close(world):
    port, _ = _fused(world, degs=(0,))
    rec = tsdf.StreamingRecognizer(port)
    depth0, T0 = world(0)
    rec.integrate_depth_frame(depth0, K, T0)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rec.track_depth_frame(world(2)[0], K, t_near=CELL_MARCH[0],
                              t_far=CELL_MARCH[1], n_steps=CELL_MARCH[2])
    log = profiling.spans()
    profiling.clear_spans()
    names = [s.name for s in log]
    assert names == ["tsdf.track", "tsdf.raycast", "tsdf.gauss_newton",
                     "tsdf.integrate"]
    assert [s.parent for s in log] == [-1, 0, 0, -1]
    for s in log:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = log[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert log[0].end_ns <= log[3].start_ns
    assert math.isfinite(float(rec.last_track.rms))
