"""The port's sharded matcher (objective_slam_tpu_torch.parallel.
sharded_match) on the CPU, through in-process shards (LocalShards).

Two kinds of test:
  * the tests of tests/test_sharding.py at their sizes, on the port alone
    (pose recovered, vote totals equal to the single-chip match, padding,
    caps, FNV mode, extract_instances, correlation engine and its retry,
    the saturating sum);
  * head to head with the JAX `make_sharded_matcher` on the 8-device CPU
    mesh of tests/conftest.py: the same seeded arrays and the JAX model
    description carried across (utils/serialization.description_from_
    arrays). The scene keys are checked equal first; then the caps,
    pose_votes, pose_keep, num_votes, overflowed and topk_saturated must be
    bit-equal, the candidate poses within 1e-4, and the clusters and the
    winner equal those of the JAX clustering of the same candidates (the
    winner within 1e-4, or both valid where clustering ties).

tests/test_sharding.py::test_sharded_bench_scale (the 100k-point bench
scan through 8 shards) is not mirrored here: it runs on the card, in
chip_smoke.py's `sharded` phase (a).

torch runs on one CPU thread in this file, as in test_torch_drost.py, so
that recomputed keys reproduce the matcher's own.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import objective_slam_tpu as ost
from objective_slam_tpu.models import drost as jd
from objective_slam_tpu.parallel import sharded_match as jsm
from objective_slam_tpu.utils import synthetic
import objective_slam_tpu_torch as pt
from objective_slam_tpu_torch.models import drost as td
from objective_slam_tpu_torch.parallel import sharded_match as tsm
from objective_slam_tpu_torch.utils import serialization as tser, \
    validation as tval

INT_MAX = 2 ** 31 - 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("ref",))


def _desc(mp, mn, cfg, **kw):
    return pt.build_model_description(mp, mn, cfg, device="cpu", **kw)


def _valid(pose, T_true, desc, cfg):
    v = tval.validate_pose(pose.numpy(), T_true, desc.diameter, cfg)
    return v.match, (v.trans_err, math.degrees(v.rot_err))


# --- tests/test_sharding.py on the port ------------------------------------


def test_sharded_match_recovers_pose(rng):
    cfg = pt.PPFConfig(max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 100)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    matcher = tsm.make_sharded_matcher(tsm.LocalShards(8), desc, cfg,
                                       n_scene=len(sp),
                                       vote_cap_per_shard=1 << 18)
    res = matcher(sp, sn)
    assert not bool(res.overflowed)
    ok, err = _valid(res.pose, T_true, desc, cfg)
    assert ok, err


def test_sharded_matches_single_chip(rng):
    cfg = pt.PPFConfig(max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    single = pt.match(desc, sp, sn, cfg)
    multi = tsm.make_sharded_matcher(tsm.LocalShards(4), desc, cfg,
                                     n_scene=len(sp),
                                     vote_cap_per_shard=1 << 18)(sp, sn)
    assert int(single.num_votes) == int(multi.num_votes)
    for pose in (single.pose, multi.pose):
        assert _valid(pose, T_true, desc, cfg)[0]


def test_sharded_ref_padding(rng):
    """R = 20 over 8 shards: the 4 pad rows give no vote."""
    cfg = pt.PPFConfig(max_poses=128, ref_point_df=3)
    mp, mn = synthetic.blob_cloud(rng, 60)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    single = pt.match(desc, sp, sn, cfg)
    multi = tsm.make_sharded_matcher(tsm.LocalShards(8), desc, cfg,
                                     n_scene=len(sp),
                                     vote_cap_per_shard=1 << 16)(sp, sn)
    assert int(single.num_votes) == int(multi.num_votes)


def test_sharded_full_featured_matches_single(rng):
    """Count-pass caps, ICP and rescoring at 1,350 scene points: the vote
    total and the ICP-refined winner equal the single-chip match's."""
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=3, refine_icp=True,
                       icp_iterations=6, rescore_poses=True)
    mp, mn = synthetic.blob_cloud(rng, 150)
    cp, cn = synthetic.clutter_cloud(rng, 1200)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn, cp, cn)
    assert len(sp) >= 1300
    desc = _desc(mp, mn, cfg)
    single = pt.match(desc, sp, sn, cfg)
    vc, sc = tsm.size_sharded_caps(desc, sp, sn, cfg, 8)
    multi = tsm.make_sharded_matcher(tsm.LocalShards(8), desc, cfg,
                                     n_scene=len(sp), vote_cap_per_shard=vc,
                                     seg_cap_per_shard=sc)(sp, sn)
    assert int(single.num_votes) == int(multi.num_votes)
    assert not bool(multi.overflowed)
    assert not bool(multi.topk_saturated)
    # Entry by entry: ht_dist's arccos reads a few float32 ulps of the
    # trace as up to 2e-3 rad even for two equal rotations.
    diff = float((single.pose - multi.pose).abs().max())
    assert diff < 1e-5, diff
    ok, err = _valid(multi.pose, T_true, desc, cfg)
    assert ok, err


def test_sharded_fnv_mode(rng):
    cfg = pt.PPFConfig(max_poses=256, use_fnv_keys=True)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    single = pt.match(desc, sp, sn, cfg)
    vc, sc = tsm.size_sharded_caps(desc, sp, sn, cfg, 4)
    multi = tsm.make_sharded_matcher(tsm.LocalShards(4), desc, cfg,
                                     n_scene=len(sp), vote_cap_per_shard=vc,
                                     seg_cap_per_shard=sc)(sp, sn)
    assert int(single.num_votes) == int(multi.num_votes)
    assert _valid(multi.pose, T_true, desc, cfg)[0]


def test_sharded_extract_instances(rng):
    """drost.extract_instances takes a ShardedMatchResult unchanged."""
    cfg = pt.PPFConfig(max_poses=512, cluster_center_cell=True)
    mp, mn = synthetic.blob_cloud(rng, 100)
    cp, cn = synthetic.clutter_cloud(rng, 300)
    sp, sn, T1 = synthetic.plant_model(rng, mp, mn, cp, cn)
    diam = float(np.linalg.norm(mp.max(0) - mp.min(0)))
    sp, sn, T2 = synthetic.plant_model(
        rng, mp, mn, sp, sn, translation=T1[:3, 3] + np.float32(2.5) * diam)
    desc = _desc(mp, mn, cfg)
    vc, sc = tsm.size_sharded_caps(desc, sp, sn, cfg, 4)
    res = tsm.make_sharded_matcher(tsm.LocalShards(4), desc, cfg,
                                   n_scene=len(sp), vote_cap_per_shard=vc,
                                   seg_cap_per_shard=sc)(sp, sn)
    poses, _ = td.extract_instances(res, desc.diameter, max_instances=4)
    assert len(poses) >= 2
    found = [any(tval.validate_pose(p, T, desc.diameter, cfg).match
                 for p in poses) for T in (T1, T2)]
    assert all(found), (len(poses), found)


def test_sharded_correlation_engine(rng):
    cfg = pt.PPFConfig(max_poses=256, engine="correlation")
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    res = tsm.make_sharded_matcher(tsm.LocalShards(4), desc, cfg,
                                   n_scene=len(sp),
                                   vote_cap_per_shard=1 << 16)(sp, sn)
    ok, err = _valid(res.pose, T_true, desc, cfg)
    assert ok, err


# The six cases of test_psum_saturating_contract: per-shard totals and the
# saturating sum.
PSUM_CASES = [
    ([1, 2, 3, 4, 5, 6, 7, 8], 36),
    ([123456789, 7, 0, 0, 0, 0, 0, 0], 123456796),
    ([INT_MAX, 1, 0, 0, 0, 0, 0, 0], INT_MAX),
    ([2 ** 30, 2 ** 30, 2 ** 30, 0, 0, 0, 0, 0], INT_MAX),
    ([0x7FFE0000, 0xFFFF, 0xFFFF, 0xFFFF, 0, 0, 0, 0], INT_MAX),
    ([0x7FFE0000, 0xFFFF, 0, 0, 0, 0, 0, 0], 0x7FFEFFFF),
]


@pytest.mark.parametrize("per_shard,want", PSUM_CASES,
                         ids=[f"case{i}" for i in range(len(PSUM_CASES))])
def test_psum_saturating_contract(per_shard, want):
    """The port's sum equals the contract's value and the JAX function's
    under shard_map on the 8-device mesh."""
    got = tsm.psum_saturating(
        torch.tensor(np.asarray(per_shard, np.int32)), tsm.LocalShards(8))
    assert got.dtype == torch.int32 and int(got) == want
    f = jax.jit(jax.shard_map(
        lambda v: jsm.psum_saturating(v[0], "ref"), mesh=_mesh(8),
        in_specs=(P("ref"),), out_specs=P(), check_vma=False))
    assert int(f(jnp.asarray(np.asarray(per_shard, np.int32)))) == int(got)


def test_sharded_match_api_exact_engine(rng):
    cfg = pt.PPFConfig(max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    single = pt.match(desc, sp, sn, cfg)
    multi = tsm.sharded_match(tsm.LocalShards(4), desc, sp, sn, cfg)
    assert int(single.num_votes) == int(multi.num_votes)
    assert not bool(multi.overflowed)
    assert _valid(multi.pose, T_true, desc, cfg)[0]


def test_sharded_correlation_retry_on_overflow(rng):
    """A starved runs_cap overflows; sharded_match climbs to an untruncated
    tally equal to the single-chip one."""
    cfg = pt.PPFConfig(max_poses=256, engine="correlation")
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = _desc(mp, mn, cfg)
    group = tsm.LocalShards(4)
    starved = tsm.make_sharded_matcher(group, desc, cfg, n_scene=len(sp),
                                       vote_cap_per_shard=0,
                                       runs_cap_per_shard=1024)
    assert bool(starved(sp, sn).overflowed)
    single = pt.match(desc, sp, sn, cfg)
    multi = tsm.sharded_match(group, desc, sp, sn, cfg,
                              runs_cap_per_shard=1024)
    assert not bool(multi.overflowed)
    assert int(single.num_votes) == int(multi.num_votes)
    assert _valid(multi.pose, T_true, desc, cfg)[0]


def test_shards_on_other_devices_get_the_model_there(rng):
    """LocalShards(devices=[...]) gives each shard a copy of the model on
    its device: every tensor of the description, nested tables included,
    moves (here to the meta device, which holds shapes only)."""
    cfg = pt.PPFConfig(engine="correlation", use_fnv_keys=True)
    mp, mn = synthetic.blob_cloud(rng, 40)
    desc = _desc(mp, mn, cfg)
    meta = torch.device("meta")
    moved = tsm._model_on(desc, meta)
    assert tsm._model_on(desc, desc.device) is desc
    assert tsm.LocalShards(2, devices=["cpu", meta]).device(1, desc) == meta

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                yield from tensors(getattr(x, name))
        elif isinstance(x, tuple):
            for v in x:
                yield from tensors(v)

    before, after = list(tensors(desc)), list(tensors(moved))
    assert len(after) == len(before) > 15
    assert all(t.device == meta for t in after)
    assert all(t.device.type == "cpu" for t in before)


# --- head to head with the JAX sharded matcher -----------------------------


def _carry(dj):
    """The JAX description's arrays as a port description on the CPU."""
    arrays = {name: np.array(getattr(dj, name)) for name in
              ("points", "normals", "beta", "gamma", "vote_weights")}
    arrays.update({name: np.array(getattr(dj.table, name)) for name in
                   ("counts", "offsets", "pair_mr", "pair_alpha",
                    "max_count")})
    arrays["d_dist"] = np.asarray(dj.d_dist, np.float32)
    meta = {"n_points": dj.n_points, "num_keys": dj.num_keys,
            "max_dist_bin": dj.max_dist_bin, "diameter": dj.diameter,
            "has_fast_tables": dj.fast_tables is not None,
            "has_corr_tables": dj.corr_tables is not None,
            "corr_n_angle": (dj.corr_tables.n_angle
                             if dj.corr_tables is not None else None)}
    return tser.description_from_arrays(arrays, meta, device="cpu")


def _blob_scene(seed, n_model, n_clutter=0):
    rng = np.random.default_rng(seed)
    mp, mn = synthetic.blob_cloud(rng, n_model)
    cp, cn = synthetic.clutter_cloud(rng, n_clutter) if n_clutter else \
        (None, None)
    sp, sn, T = synthetic.plant_model(rng, mp, mn, cp, cn)
    return mp, mn, sp, sn, T, None


def _trex_scene(seed):
    """The UWA-analog trex (4,266 occupied keys: over the block budgets)
    in a small cluttered scene, as test_torch_drost.py's trex fixture."""
    from objective_slam_tpu_torch.utils import pointcloud as tpc, \
        synthetic as tsyn
    v, f = tsyn.uwa_analog_models()["trex"]
    nrm = tpc.mesh_vertex_normals(v, f)
    dd = 0.1 * tpc.bbox_diameter(v)
    mp, mn = tpc.voxel_downsample_np(v, nrm, dd)
    rng = np.random.default_rng(seed)
    cp, cn = tsyn.clutter_cloud(rng, 200, lo=-80, hi=80)
    sp_raw, sn_raw, T = tsyn.plant_model(rng, v, nrm, cp, cn)
    sp, sn = tpc.voxel_downsample_np(sp_raw, sn_raw, dd)
    return mp, mn, sp, sn, T, dd


# (id, shards, PPFConfig keywords, scene); R is not a multiple of D in
# the padded cases.
H2H = {
    "block-d4": (4, dict(max_poses=256), lambda: _blob_scene(1, 100, 60)),
    "block-d8-padded": (8, dict(max_poses=128, ref_point_df=3),
                        lambda: _blob_scene(2, 60)),
    "fallback-d8-padded": (8, dict(max_poses=256, ref_point_df=6),
                           lambda: _trex_scene(3)),
    "correlation-d4-padded": (4, dict(max_poses=256, engine="correlation"),
                              lambda: _blob_scene(4, 90)),
}


@pytest.fixture(scope="module", params=sorted(H2H))
def h2h(request):
    """One compiled JAX matcher per configuration and the port's run."""
    D, kw, scene = H2H[request.param]
    mp, mn, sp, sn, T, dd = scene()
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj, d_dist=dd)
    dt = _carry(dj)
    capj = jsm.size_sharded_caps(dj, sp, sn, cj, D)
    capt = tsm.size_sharded_caps(dt, sp, sn, ct, D)
    vote_cap = capj[0] if kw.get("engine") != "correlation" else 1 << 16
    rj = jsm.make_sharded_matcher(_mesh(D), dj, cj, len(sp), vote_cap,
                                  seg_cap_per_shard=capj[1])(sp, sn)
    rt = tsm.make_sharded_matcher(tsm.LocalShards(D), dt, ct, len(sp),
                                  vote_cap, seg_cap_per_shard=capj[1])(sp, sn)
    return dict(name=request.param, D=D, cj=cj, ct=ct, dj=dj, dt=dt, sp=sp,
                sn=sn, T=T, capj=capj, capt=capt, rj=rj, rt=rt)


def test_h2h_scene_keys_and_caps_equal(h2h):
    m = h2h
    n = len(m["sp"])
    ref = np.arange(0, n, m["cj"].ref_point_df)
    kj, _ = jd._scene_keys(m["dj"], jnp.asarray(m["sp"]),
                           jnp.asarray(m["sn"]), jnp.asarray(ref),
                           m["cj"].d_angle)
    kt, _ = td._scene_keys(m["dt"], torch.from_numpy(m["sp"]),
                           torch.from_numpy(m["sn"]), torch.from_numpy(ref),
                           m["ct"].d_angle)
    assert np.array_equal(np.asarray(kj), kt.numpy())
    assert m["capt"] == m["capj"]
    if m["name"].endswith("padded"):
        assert len(ref) % m["D"] != 0
    if m["name"].startswith("fallback"):
        assert m["dt"].fast_tables.block is None


def test_h2h_candidates_and_flags_bit_equal(h2h):
    rj, rt = h2h["rj"], h2h["rt"]
    for name in ("pose_votes", "pose_keep", "num_votes", "overflowed",
                 "topk_saturated"):
        a, b = np.asarray(getattr(rj, name)), getattr(rt, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert not bool(rt.overflowed)
    assert int(rt.pose_keep.sum()) > 0
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               rtol=0, atol=1e-4)


def _jax_global_phase(m):
    """The JAX package's clustering and winner (cluster_poses_dense, argmax,
    clustered translation) on the JAX matcher's gathered candidates, with
    d_dist passed as an argument as drost._match_jit passes it. Inside the
    JAX sharded matcher d_dist is a constant of the compiled function, and
    XLA:CPU's folded division then puts cells ±1 into a pose's own cell
    (ROADMAP.md §3)."""
    from objective_slam_tpu.ops import clustering as jcl, transforms as jtr
    rj, dj, cj = m["rj"], m["dj"], m["cj"]
    assert np.all(np.asarray(dj.vote_weights) == 1.0)
    poses = jnp.asarray(rj.poses)

    def run(poses, w, keep, d_dist):
        return jcl.cluster_poses_dense(
            poses[:, :3, 3], jtr.hrotmat2quat(poses), w, keep, d_dist,
            cj.rot_thresh, include_center_cell=cj.cluster_center_cell,
            use_l1_norm=cj.use_l1_norm,
            use_averaged_clusters=cj.use_averaged_clusters)

    cl = jax.jit(run)(poses, jnp.asarray(rj.pose_votes, jnp.float32),
                      jnp.asarray(rj.pose_keep), dj.d_dist)
    win = int(jnp.argmax(cl.vote_counts))
    pose = np.asarray(poses[win].at[:3, 3].set(cl.translations[win]))
    return np.asarray(cl.vote_counts), pose


def test_h2h_clusters_and_winner(h2h):
    """Clustered counts equal the JAX package's clustering of the same
    candidates; the winner is within 1e-4 of its pose (or, where clustering
    ties, both are valid)."""
    m = h2h
    counts_j, pj = _jax_global_phase(m)
    np.testing.assert_allclose(m["rt"].clustered_counts.numpy(), counts_j,
                               rtol=1e-6, atol=0)
    pt_ = m["rt"].pose.numpy()
    if np.abs(pj - pt_).max() > 1e-4:       # a clustering tie
        for pose in (pj, pt_):
            assert tval.validate_pose(pose, m["T"], m["dt"].diameter,
                                      m["ct"]).match


# --- the per-row count pass --------------------------------------------------


@pytest.mark.parametrize("fnv", [False, True], ids=["packed", "fnv"])
def test_count_votes_rows_bit_equal(fnv):
    """drost._count_votes_rows equals the JAX _count_votes_rows_jit row for
    row, and _count_votes' totals are the rows' int32 sums, as in the JAX
    package."""
    mp, mn, sp, sn, _, _ = _blob_scene(5, 100, 150)
    kw = dict(max_poses=256, ref_point_df=2, use_fnv_keys=fnv)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj)
    dt = _desc(mp, mn, ct)
    rows_j = jd._count_votes_rows_jit(dj, sp, sn, 2, cj.d_angle)
    rows_t = td._count_votes_rows(dt, sp, sn, 2, ct.d_angle)
    for a, b in zip(rows_j, rows_t):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())
    totals = td._count_votes(dt, sp, sn, 2, ct.d_angle)
    assert totals == jd._count_votes(dj, sp, sn, 2, cj.d_angle)
    assert totals == tuple(int(r.sum()) for r in rows_t)
    assert totals[0] > 0
