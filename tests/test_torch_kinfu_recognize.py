"""Recognition on a fused surface through the port's StreamingRecognizer
(objective_slam_tpu_torch.models.tsdf), against the plain references that
decide the benchmark's `slampp-recognize-512` cell, on the CPU at a small
size: a 64³ volume over a 1.28 m cube around the benchmark's tabletop
(its table, bumpy object and three clutter objects), fused from eight
posed 128×96 depth frames.

What must agree, and why the tolerance:
  * extract_surface against benchmark/frozen/surface_reference: the rows
    (which voxels, in which order) and the count equal, at a capacity that
    holds the surface and at one that cuts it (the k-NN branch), and over
    8,192 rows (the moment-grid branch). Normals: on the grid branch at
    most 0.5% of the rows part from the reference's by more than 1° (both
    sum the same float32 moments; seen: 3 of 2,480, two rows whose
    gradient is zero, so that nothing orients them, and one whose window
    is degenerate). On the k-NN branch the rows' k-th
    neighbours tie on the voxel grid, and the roundings of the distances
    (the port's are XLA:CPU's) pick among them: about 10% of the rows
    take another neighbourhood. Among the rows whose k-th distance is
    not tied, at most 1% part by more than 1° (a normal whose gradient
    lies in the surface may flip);
  * recognize against benchmark/frozen/reference's plain PPF on the same
    surface, judged as the cell judges it (kinds/ppf_scan.judge), each
    number within the cell's limit;
  * the counters: the occupancy is the exact count pass's, the capacity
    its bucket, the scene points each object's downsampled scene, the
    host surface the extraction's valid rows;
  * the spans: `tsdf.recognize` holds `tsdf.extract` and one `drost.match`
    a model, and each `drost.match` its own stages.
`_central_gradient` equals torch.gradient bit for bit everywhere, and a
scene voted in blocks of reference rows (`drost.PAIR_BUDGET`) gives one
pass's MatchResult, through K1, K2 and the readable engine.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.frozen import reference as ref
from benchmark.frozen import surface_reference as sr
from benchmark.generators import kinfu_orbit as orbit
from benchmark.kinds import kinfu_recognize as kind
from benchmark.kinds import ppf_scan
from objective_slam_tpu_torch.config import PPFConfig
from objective_slam_tpu_torch.models import drost, tsdf
from objective_slam_tpu_torch.utils import pointcloud as pc, profiling, \
    synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark/configs/slampp-512-vga.json")
                    .read_text())
DIMS = (64, 64, 64)
VS = 0.02
ORIGIN = np.full(3, -0.64, np.float32)
SHAPE = (96, 128)
K = (105.0, 105.0, 63.5, 47.5)
TAU_D = 0.15          # coarser than the cell's 0.05, for the CPU's time;
#                       every object's d_dist exceeds 1.5 voxels


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    """The tabletop fused from eight posed frames around the orbit."""
    params = CONFIG["scene"]
    pieces = orbit.scene(params, np.random.default_rng([kind.POOL_SEED, 0]))
    poses = [orbit.orbit_pose(params["orbit"], 45.0 * i) for i in range(8)]
    pts = orbit.sample(pieces, poses, K, SHAPE, 6.0, 3, torch.device("cpu"))
    vol = tsdf.make_volume(ORIGIN, DIMS, VS, 3 * VS, device="cpu")
    for i, T in enumerate(poses):
        depth, _ = orbit.render(pts, T, K, SHAPE)
        depth = orbit.noisy(depth, params["noise"], 100 + i)
        vol = tsdf.integrate_depth(vol, depth.numpy(), K, T)
    return vol


def _flat(points, vol):
    ijk = np.round((points - vol.origin.numpy()) / np.float32(VS) - 0.5) \
        .astype(np.int64)
    return (ijk[:, 0] * DIMS[1] + ijk[:, 1]) * DIMS[2] + ijk[:, 2]


@pytest.mark.parametrize("engine,k2", [("fast", False), ("fast", True),
                                       ("reference", False)],
                         ids=["k1", "k2", "readable"])
def test_vote_blocks_equal_one_pass(monkeypatch, engine, k2):
    """A scene voted in blocks of seven reference rows (PAIR_BUDGET cut
    down) gives one pass's result, field for field."""
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 300)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    cfg = PPFConfig(engine=engine, ref_point_df=3, max_poses=256,
                    refine_icp=True, icp_iterations=5)
    desc = drost.build_model_description(mp, mn, cfg, device="cpu")
    if k2:
        desc = dataclasses.replace(desc, fast_tables=desc.fast_tables
                                   ._replace(block=None))
    one = drost.match(desc, sp, sn, cfg)
    monkeypatch.setattr(drost, "PAIR_BUDGET", 7 * sp.shape[0])
    assert len(drost._row_blocks(100, sp.shape[0])) == 15
    blocks = drost.match(desc, sp, sn, cfg)
    assert int(blocks.num_votes) == int(one.num_votes) > 0
    for f in one._fields:
        if f != "num_votes":
            assert torch.equal(getattr(blocks, f), getattr(one, f)), f


def test_central_gradient_equals_torch_gradient():
    t = torch.randn(7, 5, 9, generator=torch.Generator().manual_seed(0))
    idx = torch.arange(t.numel())
    for axis in range(3):
        want = torch.gradient(t, dim=axis)[0].reshape(-1)
        got = tsdf._central_gradient(t, idx, axis)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _untied(points, k=sr.KNN_K):
    """Rows whose k-th and (k+1)-th nearest rows lie further apart than a
    float32 rounding of their squared distances: the k-NN set is the same
    whichever rounding computes the distances."""
    p = torch.as_tensor(points)
    d2 = torch.sum((p[:, None, :] - p[None, :, :]) ** 2, dim=-1)
    near = torch.sort(d2, dim=1).values[:, k - 1:k + 1]
    return (near[:, 1] - near[:, 0] > 1e-5 * near[:, 1]).numpy()


@pytest.mark.parametrize("capacity,share", [
    (None, 0.01), (1024, 0.01), (16384, 0.005)],
    ids=["knn-fits", "knn-cut", "grid"])
def test_extract_surface_matches_reference(fused, capacity, share):
    occ = int(tsdf.surface_occupancy(fused))
    assert 1024 < occ <= 8192
    cap = drost._next_cap(occ) if capacity is None else capacity
    got = tsdf.extract_surface(fused, cap)
    want = sr.extract(fused.tsdf, fused.weight, fused.origin, VS, cap)
    assert int(got.count) == want.count == occ
    assert bool(got.overflowed) == (occ > cap)
    ok = got.valid.numpy()
    assert ok.sum() == min(occ, cap)
    np.testing.assert_array_equal(_flat(got.points.numpy()[ok], fused),
                                  want.index.numpy())
    cos = np.clip(np.sum(got.normals.numpy()[ok] * want.normals.numpy(), 1),
                  -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    if cap <= sr.KNN_ROWS:
        ang = ang[_untied(want.points)]
    assert np.mean(ang > 1.0) <= share, (np.mean(ang > 1.0), ang.max())
    assert np.all(got.points.numpy()[~ok] < -1e6)
    np.testing.assert_array_equal(got.normals.numpy()[~ok], 0.0)


class _Inputs:
    """The attributes of kinds/kinfu_recognize.Inputs that its plain
    reference reads."""

    def __init__(self, models):
        self.config = {"match": CONFIG["match"]}
        self.models = models
        self.tau_d = TAU_D
        self.voxel_size = VS


@pytest.fixture(scope="module")
def recognized(fused):
    """The four objects registered and recognized once, under a CPU
    profiler: (recognizer, results, span log, raw models)."""
    cfg = PPFConfig(**CONFIG["match"])
    rec = tsdf.StreamingRecognizer(fused, cfg)
    models = []
    for i, (name, tris) in enumerate(zip(CONFIG["objects"]["names"],
                                         kind.object_meshes(CONFIG))):
        p, n = kind.sample_mesh(tris, 4000, np.random.default_rng([1, i]))
        models.append({"points": p, "normals": n})
        d = TAU_D * ref.f32(np.max(p.max(0) - p.min(0)))
        mp, mn = pc.voxel_downsample_np(p, n, d)
        rec.register_model(name, drost.build_model_description(
            mp, mn, cfg, d_dist=d, device="cpu"))
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = rec.recognize()
    return rec, res, profiling.spans(), models


def test_recognize_matches_the_plain_ppf(recognized):
    rec, res, _, models = recognized
    last = rec.last_recognition
    plain = kind._Matches(_Inputs(models), "cpu", ref.FP32)
    s = plain.add((last.points, last.normals))
    params = CONFIG["judge"]
    rows = [ppf_scan.judge(plain, kind._Pick(s, i), kind._host_match(
        res[name]), params) for i, name in enumerate(rec.models)]
    numbers = ppf_scan.aggregate(rows)
    for k in ("topk_gap", "survivors_gap", "winner_gap", "pose_gap"):
        assert numbers[k] <= CONFIG["limits"][k], (k, numbers)


def test_recognition_counters_are_the_surface(recognized, fused):
    rec, res, _, _ = recognized
    last = rec.last_recognition
    occ = int(tsdf.surface_occupancy(fused))
    assert last.occupancy == occ
    assert last.capacity == drost._next_cap(max(occ, 1024))
    surf = tsdf.extract_surface(fused, last.capacity)
    ok = surf.valid.numpy()
    np.testing.assert_array_equal(last.points, surf.points.numpy()[ok])
    np.testing.assert_array_equal(last.normals, surf.normals.numpy()[ok])
    assert last.points.shape == (occ, 3)
    for name, desc in rec.models.items():
        assert float(desc.d_dist) > 1.5 * VS
        vp, _ = pc.voxel_downsample_np(last.points, last.normals,
                                       float(desc.d_dist))
        assert last.scene_points[name] == vp.shape[0] < occ
        np.testing.assert_array_equal(last.poses[name],
                                      res[name].pose.numpy())


def test_recognize_spans_nest(recognized):
    rec, _, log, _ = recognized
    assert all(s.end_ns >= s.start_ns for s in log)
    top = [i for i, s in enumerate(log) if s.parent < 0]
    assert [log[i].name for i in top] == ["tsdf.recognize"]
    kids = [s.name for s in log if s.parent == top[0]]
    assert kids == ["tsdf.extract"] + ["drost.match"] * len(rec.models)
    matches = {i for i, s in enumerate(log) if s.name == "drost.match"}
    inner = {s.name for s in log if s.parent in matches}
    assert {"drost.count", "drost.core"} <= inner
