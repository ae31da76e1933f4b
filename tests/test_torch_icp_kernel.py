"""ICP in one launch (ops/icp.refine_pose_kernel, csrc/icp_refine.cu).

On the CPU: the path rule of refine_pose, the spans of each path, and the
kernel's 3 × 3 solver through its torch twin (ops/icp.kabsch_rotation)
against torch.linalg.svd. On the card (marked `card`, skipped without
one): the kernel against refine_pose_plain on the same device, one launch
a call. This file imports no JAX, so the card's tests run where JAX is
absent: `python -m pytest --noconftest tests/test_torch_icp_kernel.py`.

Tolerances. Every iteration is held alone: from the plain loop's pose
after k iterations, the kernel's iteration k against the plain loop's.
The kernel rounds the distance tile and the gates as the plain loop does
on the card, so both see the same correspondences, and sum in another
order only: the inlier counts are equal, rms agrees within 1e-5 (of rms,
above 1) and the pose within test_torch_pointcloud_icp_clustering.py's
_pose_close tolerance (1e-4 in translation and in rad, measured in
float64). The translation's tolerance is in the blob's units: the
UWA-size cloud is the blob magnified 60 times, and that tolerance with it.
The whole refinement is not held that tightly: after a step the two poses
differ in their last bits, and a nearest neighbour that ties with another
scan point within a rounding of ‖mt‖² + ‖s‖² then goes either way, which
moves the rest of the trajectory by up to about 1e-3 rad. The plain loop
does the same under its own roundings (a start moved by 1e-6 of the
diameter, or the CPU in place of the card), so the whole run is held to
that class: its pose within 1e-2 of the model's diameter of the plain
loop's, measured as the largest displacement of a model point.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from objective_slam_tpu_torch.ops import _build, icp, transforms as tr
from objective_slam_tpu_torch.utils import pointcloud as pc, profiling, \
    synthetic


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _svd_rotation(H):
    """_solve_point's rotation from torch.linalg.svd."""
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    return (Vt.T @ D) @ U.T


def _random_h(seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 6)
    return rng.normal(size=(3, 3)) * scale


def _reflection_h(seed):
    """H = Q S with det Q = −1: the unconstrained optimum is a reflection."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) > 0:
        Q[:, 0] *= -1
    return Q @ np.diag([3.0, 2.0, 0.5])


def _rank2_h(seed):
    """A planar correspondence set: rank 2, the third singular value 0."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3))


@pytest.mark.parametrize("H", [
    pytest.param(_random_h(s), id=f"random{s}") for s in range(4)] + [
    pytest.param(_reflection_h(s), id=f"reflection{s}") for s in range(2)
] + [pytest.param(_rank2_h(s), id=f"rank2_{s}") for s in range(2)] + [
    pytest.param(np.zeros((3, 3)), id="zero")])
def test_kabsch_rotation_matches_svd(H):
    H = torch.from_numpy(H.astype(np.float32))
    R = icp.kabsch_rotation(H)
    np.testing.assert_allclose(R.numpy(), _svd_rotation(H).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-5)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


def _cloud(device, n):
    return SimpleNamespace(device=torch.device(device), shape=(n, 3))


@pytest.mark.parametrize("solver", ["point", "plane"])
@pytest.mark.parametrize("n_m", [0, 100_000])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_dispatch_rule(monkeypatch, device, n_m, solver):
    """The kernel for clouds on a CUDA device, whatever the model's size,
    the plain loop otherwise; the solver reaches the kernel as a bool."""
    calls = []
    monkeypatch.setattr(icp, "refine_pose_kernel",
                        lambda *a, **kw: calls.append(("kernel", kw)))
    monkeypatch.setattr(icp, "refine_pose_plain",
                        lambda *a, **kw: calls.append(("plain", kw)))
    normals = _cloud(device, 50) if solver == "plane" else None
    icp.refine_pose(_cloud(device, n_m), _cloud(device, 50), torch.eye(4),
                    max_dist=0.1, scene_normals=normals)
    want = "kernel" if device == "cuda" else "plain"
    assert _build.uses_kernel(torch.device(device)) == (want == "kernel")
    assert [c[0] for c in calls] == [want]
    plane = calls[0][1]["point_to_plane"]
    assert plane == (solver == "plane" if want == "kernel" else None)


@pytest.fixture(scope="module")
def icp_scene():
    """test_torch_pointcloud_icp_clustering.py's icp_scene from the port's
    own generators: a voxelized blob against the raw scan it came from,
    about 6° off."""
    rng = np.random.default_rng(0)
    mp_raw, mn_raw = synthetic.blob_cloud(rng, 4000)
    d_dist = 0.1 * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    sp, sn, T_true = synthetic.plant_model(rng, mp_raw, mn_raw)
    T0 = T_true @ tr.rotx(torch.tensor(math.radians(6.0))).numpy()
    T0[:3, 3] += rng.normal(scale=0.02, size=3)
    return mp, mn, sp, sn, T_true, T0.astype(np.float32), 2.0 * d_dist


def _spans_of(fn):
    profiling.clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            fn()
        return profiling.spans()
    finally:
        profiling.clear_spans()


def test_spans_of_each_path(icp_scene, monkeypatch):
    """The plain loop: icp.refine holding an icp.iteration each iteration.
    The kernel path (its launch replaced by a no-op here): icp.refine
    holding one icp.kernel and nothing else."""
    mp, _, sp, _, _, T0, max_dist = icp_scene
    args = (torch.from_numpy(mp), torch.from_numpy(sp), torch.from_numpy(T0))

    log = _spans_of(lambda: icp.refine_pose(*args, iterations=3,
                                            max_dist=max_dist))
    assert [s.name for s in log] == ["icp.refine"] + ["icp.iteration"] * 3
    assert all(s.parent == 0 for s in log[1:])

    monkeypatch.setattr(_build, "uses_kernel", lambda device: True)
    monkeypatch.setattr(icp, "refine_pose_kernel", lambda *a, **kw: None)
    log = _spans_of(lambda: icp.refine_pose(*args, iterations=3,
                                            max_dist=max_dist))
    assert [s.name for s in log] == ["icp.refine", "icp.kernel"]
    assert log[1].parent == 0


# ---------------------------------------------------------------- the card

def _tensor(x, device):
    return None if x is None else torch.as_tensor(np.asarray(x),
                                                  device=device)


KINDS = ["point", "point_gated", "plane", "masked", "chunked", "ragged",
         "tie", "no_steps", "wide", "empty"]


def _case(icp_scene, kind, device):
    """(model, scan, start, keywords) of one case on `device`."""
    mp, mn, sp, sn, _, T0, max_dist = icp_scene
    kw = {"iterations": 12, "max_dist": max_dist}
    if kind == "point_gated":
        kw.update(scene_normals=sn, model_normals=mn, point_to_plane=False)
    elif kind == "plane":
        # 4 Kabsch steps, then 2 clamped point-to-plane steps.
        kw.update(scene_normals=sn, model_normals=mn, iterations=6)
    elif kind == "masked":
        sp = np.concatenate([sp, np.full((50, 3), 1e6, np.float32)])
        kw.update(scene_valid=np.arange(len(sp)) < len(sp) - 50)
    elif kind == "ragged":
        # A scan one point past two of the kernel's 1,024-point tiles.
        sp = sp[:2049]
    elif kind == "tie":
        # Every scan point twice, the copy with its normal flipped: the
        # first index must win each tie, or the gate rejects the match.
        sp = np.concatenate([sp, sp])
        sn = np.concatenate([sn, -sn])
        kw.update(scene_normals=sn, model_normals=mn, point_to_plane=False)
    elif kind == "no_steps":
        kw.update(iterations=0)
    elif kind == "wide":
        # Over 4,096 model points (the model repeated), gated.
        reps = -(-4097 // len(mp))
        mp, mn = np.tile(mp, (reps, 1)), np.tile(mn, (reps, 1))
        kw.update(scene_normals=sn, model_normals=mn, point_to_plane=False)
    elif kind == "empty":
        # No model point: the start comes back, with no inlier.
        mp, mn = mp[:0], mn[:0]
    return ([_tensor(x, device) for x in (mp, sp, T0)],
            {k: (_tensor(v, device) if isinstance(v, np.ndarray) else v)
             for k, v in kw.items()})


def _bench_binpick():
    """The binpick cell's shapes: a 280-point model, raw[::8] of a
    100,000-point bin scan (12,500 points), 20 iterations."""
    rng = np.random.default_rng(11)
    mp_raw, mn_raw = synthetic.blob_cloud(rng, 20000)
    d_dist = 0.1 * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    sp, sn, truths = synthetic.bin_picking_scene(rng, mp_raw, mn_raw)
    return mp, mn, sp, sn, truths[0], d_dist, 20, 8, 1.0


def _bench_uwa():
    """The UWA-analog cell's shapes: about 1,100 model points at a UWA
    diameter against a 26,000-point scan, 12 iterations."""
    rng = np.random.default_rng(12)
    mp_raw, mn_raw = synthetic.blob_cloud(rng, 40000)
    mp_raw = mp_raw * np.float32(60.0)
    d_dist = 0.05 * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    cp, cn = synthetic.clutter_cloud(rng, 18000, lo=-150.0, hi=150.0)
    sel = rng.choice(len(mp_raw), size=8000, replace=False)
    sp, sn, T = synthetic.plant_model(rng, mp_raw[sel], mn_raw[sel], cp, cn)
    return mp, mn, sp, sn, T, d_dist, 12, 1, 60.0


BENCH = [_bench_binpick, _bench_uwa]


def _bench_case(make, device):
    """(model, scan, start, keywords, the planted pose, the tolerances'
    scale) at bench size, the scan a row-strided view of the raw scan as
    the benchmark's ICP cloud is."""
    mp, mn, sp, sn, T_true, d_dist, iters, stride, scale = make()
    T0 = (T_true @ tr.rotx(torch.tensor(math.radians(4.0))).numpy()) \
        .astype(np.float32)
    T0[:3, 3] += np.float32(0.01 * pc.bbox_diameter(mp))
    s = torch.as_tensor(sp, device=device)[::stride]
    n = torch.as_tensor(sn, device=device)[::stride]
    kw = dict(iterations=iters, max_dist=2.0 * d_dist, scene_normals=n,
              model_normals=_tensor(mn, device), point_to_plane=False)
    return [_tensor(mp, device), s, _tensor(T0, device)], kw, T_true, scale


@pytest.mark.card
def test_one_launch_per_call(card, icp_scene):
    """Every case and both bench sizes, each called once more under one
    profiler session: one kernel a call, the ICP kernel, and no other
    launch. (One session: on an H100, later profiler sessions of one
    pytest process have been seen to record no device activity.)"""
    calls = [_case(icp_scene, kind, card) for kind in KINDS]
    calls += [_bench_case(make, card)[:2] for make in BENCH]
    for args, kw in calls:
        icp.refine_pose(*args, **kw)
    torch.cuda.synchronize(card)
    before = icp.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args, kw in calls:
            icp.refine_pose(*args, **kw)
            torch.cuda.synchronize(card)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert icp.launches == before + len(calls)
    assert len(kernels) == len(calls), kernels
    assert all("icp_refine" in k for k in kernels), kernels


def _pose_gap(a, b):
    """(‖t_a − t_b‖, angle of R_aᵀ R_b) in float64. The angle comes from
    atan2 of the skew and the symmetric part: float32 arccos of the trace,
    as ht_dist takes it, reads a difference of a few ulp as 3e-4 rad."""
    a, b = (x.detach().cpu().double() for x in (a, b))
    R = a[:3, :3].T @ b[:3, :3]
    skew = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    ang = torch.atan2(0.5 * torch.linalg.vector_norm(skew),
                      0.5 * (torch.trace(R) - 1.0))
    return float(torch.linalg.vector_norm(a[:3, 3] - b[:3, 3])), float(ang)


def _assert_same(got, want, scale=1.0, k=None):
    """One iteration's results. `scale` is the cloud's size in blob units;
    it widens the translation's tolerance only."""
    td, rd = _pose_gap(got.pose, want.pose)
    assert td < 1e-4 * scale and rd < 1e-4, (k, td, rd)
    assert int(got.inliers) == int(want.inliers), k
    rms = float(want.rms)
    assert abs(float(got.rms) - rms) <= 1e-5 * max(1.0, rms), (k, rms)


def _steps(args, kw):
    """(k, the kernel's iteration k, the plain loop's) for every iteration
    k: the kernel runs that iteration alone (a Kabsch step, or from the
    fifth on a plane step where the solver is point-to-plane) from the
    plain loop's pose after k iterations."""
    m, s, start = args
    plane = icp._wants_plane(kw.get("point_to_plane"),
                             kw.get("scene_normals"))
    for k in range(kw["iterations"]):
        want = icp.refine_pose_plain(*args, **dict(kw, iterations=k + 1))
        got = icp.refine_pose_kernel(
            m, s, start, **dict(kw, iterations=1, point_to_plane=plane,
                                kabsch_iterations=1 if k < 4 else 0))
        yield k, got, want
        start = want.pose


def _displacement(a, b, points):
    """The largest displacement of a model point between poses a and b."""
    a, b, p = (x.detach().cpu().double() for x in (a, b, points))
    d = p @ (a[:3, :3] - b[:3, :3]).T + (a[:3, 3] - b[:3, 3])
    return float(torch.linalg.vector_norm(d, dim=1).max()) if len(p) else 0.0


def _assert_held(args, kw, scale=1.0):
    """Every iteration alone, then the whole refinement in one launch;
    returns the kernel's whole result."""
    for k, got, want in _steps(args, kw):
        _assert_same(got, want, scale, k)
    want = icp.refine_pose_plain(*args, **kw)
    before = icp.launches
    got = icp.refine_pose(*args, **kw)
    assert icp.launches == before + 1
    diameter = pc.bbox_diameter(args[0].cpu().numpy()) if len(args[0]) \
        else 1.0
    assert _displacement(got.pose, want.pose, args[0]) <= 1e-2 * diameter
    return got


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain(card, icp_scene, kind, monkeypatch):
    if kind == "chunked":
        # The plain loop's multi-chunk nearest neighbour: the same answer.
        monkeypatch.setattr(icp, "_NN_TILE_BUDGET", 1000)
        monkeypatch.setattr(icp, "_NN_CHUNK", 512)
    args, kw = _case(icp_scene, kind, card)
    got = _assert_held(args, kw)
    if kind == "tie":
        assert int(got.inliers) > 0.5 * len(args[0])
    if kind == "empty":
        assert torch.equal(got.pose, args[2]) and int(got.inliers) == 0


@pytest.mark.card
@pytest.mark.parametrize("make", BENCH, ids=["binpick", "uwa"])
def test_kernel_matches_plain_at_bench_size(card, make):
    args, kw, T_true, scale = _bench_case(make, card)
    got = _assert_held(args, kw, scale)
    td, rd = _pose_gap(got.pose, torch.from_numpy(T_true))
    diameter = pc.bbox_diameter(args[0].cpu().numpy())
    assert td < 0.05 * diameter and rd < math.radians(2.0)
