"""The port's main path as a whole against the JAX package: the same model
and cluttered scene through JAX ``ost.match`` / ``match_with_state`` and
the port's.

What must agree:
  * MatchCaps, overflowed and topk_saturated — exactly;
  * the accumulator — bit for bit when both packages computed the same
    model and scene keys and the same α fixed-point values; otherwise (an
    arccos/atan2 ulp flip, see test_torch_ppf.py) it may differ by no more
    than the votes that the flipped pairs carry in either package;
  * the winning pose — both meet the reference criteria (0.1·diameter,
    12°), and the port's is within 1e-4 of JAX's when the accumulators
    agree (float32 pose arithmetic ordered differently), else within one
    Hough cell (d_dist, 2·Δα).

torch runs on one CPU thread in this file: torch's vectorized and scalar
float32 transcendentals can differ by an ulp, and which elements take
which path depends on how the work is split across threads, so a
recomputation of the keys in the test would not always reproduce the
match's own.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch

import objective_slam_tpu as ost
from objective_slam_tpu.models import drost as jd
from objective_slam_tpu.ops import ppf as jppf
from objective_slam_tpu.utils import serialization as jser, synthetic, \
    validation as jval
import objective_slam_tpu_torch as pt
from objective_slam_tpu_torch.models import drost as td
from objective_slam_tpu_torch.ops import ppf as tppf
from objective_slam_tpu_torch.utils import serialization as tser

_ALPHA_SCALE = (1 << 22) / (2.0 * math.pi)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n_model=100, n_clutter=200):
    rng = np.random.default_rng(seed)
    mp, mn = synthetic.blob_cloud(rng, n_model)
    cp, cn = synthetic.clutter_cloud(rng, n_clutter) if n_clutter else \
        (None, None)
    sp, sn, T = synthetic.plant_model(rng, mp, mn, cp, cn)
    return mp, mn, sp, sn, T


@pytest.fixture(scope="module")
def matched():
    mp, mn, sp, sn, T = _scene(0)
    kw = dict(max_poses=256, ref_point_df=2)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj)
    dt = pt.build_model_description(mp, mn, ct, device="cpu")
    rj, capj = ost.match_with_state(dj, sp, sn, cj)
    rt, capt = pt.match_with_state(dt, sp, sn, ct)
    return dict(mp=mp, mn=mn, sp=sp, sn=sn, T=T, cj=cj, ct=ct, dj=dj, dt=dt,
                rj=rj, rt=rt, capj=capj, capt=capt)


def _alpha_fix(a):
    """α as the block engine bins it: 22-bit fixed point (float32 math)."""
    return np.round((a + np.float32(math.pi))
                    * np.float32(_ALPHA_SCALE)).astype(np.int64)


def _alpha_bits(a):
    """α as the readable engine bins it: every float32 bit counts."""
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


def _triples(table, alpha_key=None):
    """Multiset of (key, model point, α_m as binned) of a key table; the
    model side's fixed point is taken in float64 (build_block_tables)."""
    counts = np.asarray(table.counts)
    keys = np.repeat(np.arange(counts.size), counts)
    alpha = np.asarray(table.pair_alpha)
    a = (np.round((alpha.astype(np.float64) + math.pi) * _ALPHA_SCALE)
         .astype(np.int64) if alpha_key is None else alpha_key(alpha))
    return collections.Counter(zip(keys.tolist(),
                                   np.asarray(table.pair_mr).tolist(),
                                   a.tolist()))


def _flip_bound(m, ref_point_df):
    """(clean, bound): clean when both packages computed the same model
    triples and scene keys/α as the engine bins them; bound = votes carried
    by flipped model or scene pairs, summed over both packages."""
    readable = m["ct"].engine == "reference"
    scene_alpha = _alpha_bits if readable else _alpha_fix
    dj, dt = m["dj"], m["dt"]
    ref = np.arange(0, len(m["sp"]), ref_point_df)
    kj, aj = (np.asarray(x) for x in jppf.pairwise_ppf_keys(
        m["sp"], m["sn"], dj.d_dist, m["cj"].d_angle, dj.max_dist_bin,
        ref_indices=ref))
    kt, at = (x.numpy() for x in tppf.pairwise_ppf_keys(
        torch.from_numpy(m["sp"]), torch.from_numpy(m["sn"]), dt.d_dist,
        m["ct"].d_angle, dt.max_dist_bin, ref_indices=torch.from_numpy(ref)))
    flipped_s = ((kj != kt) | (scene_alpha(aj) != scene_alpha(at))).ravel()
    model_alpha = _alpha_bits if readable else None
    tri_j = _triples(dj.table, model_alpha)
    tri_t = _triples(dt.table, model_alpha)
    bound = 0
    for keys, tri, other, table in ((kj.ravel(), tri_j, tri_t, dj.table),
                                    (kt.ravel(), tri_t, tri_j, dt.table)):
        counts = np.asarray(table.counts)
        dirty = np.zeros(counts.size + 1, np.int64)
        for (k, _, _), c in (tri - other).items():
            dirty[k] += c
        safe = np.where(keys == jppf.INVALID_KEY, counts.size, keys)
        cnt = np.append(counts, 0)[safe]
        bound += int(cnt[flipped_s].sum() + dirty[safe][~flipped_s].sum())
    clean = not flipped_s.any() and tri_j == tri_t
    return clean, bound


def _check_pair(m, rj, rt, ref_point_df):
    assert bool(rt.overflowed) == bool(rj.overflowed)
    assert bool(rt.topk_saturated) == bool(rj.topk_saturated)
    acc_j, acc_t = np.asarray(rj.accumulator), rt.accumulator.numpy()
    clean, bound = _flip_bound(m, ref_point_df)
    diff = int(np.abs(acc_j.astype(np.int64) - acc_t).sum())
    print(f"{m['ct'].engine}: keys and α equal: {clean}; "
          f"|Δ accumulator| {diff} <= bound {bound}; votes "
          f"{int(rj.num_votes)}")
    if clean:
        np.testing.assert_array_equal(acc_t, acc_j)
        assert int(rt.num_votes) == int(rj.num_votes)
        np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                                   atol=1e-4)
    else:
        assert diff <= bound
        tdist, rdist = (float(x) for x in ost.ops.transforms.ht_dist(
            np.asarray(rj.pose), rt.pose.numpy()))
        assert tdist < m["dt"].d_dist and rdist < 2 * m["ct"].d_angle
    for pose, cfg in ((np.asarray(rj.pose), m["cj"]),
                      (rt.pose.numpy(), m["cj"])):
        assert jval.validate_pose(pose, m["T"], m["dj"].diameter, cfg).match


def test_match_caps_and_flags(matched):
    m = matched
    assert tuple(m["capt"]) == tuple(m["capj"])
    assert bool(m["rt"].overflowed) is False
    assert m["dt"].max_dist_bin == m["dj"].max_dist_bin
    assert m["dt"].num_keys == m["dj"].num_keys
    assert m["dt"].diameter == m["dj"].diameter


def test_match_accumulator_and_pose(matched):
    _check_pair(matched, matched["rj"], matched["rt"], 2)


def test_reference_engine(matched):
    """engine="reference" (the readable engine) end to end."""
    m = matched
    cj = ost.PPFConfig(max_poses=256, ref_point_df=2, engine="reference")
    ct = pt.PPFConfig(max_poses=256, ref_point_df=2, engine="reference")
    dj = ost.build_model_description(m["mp"], m["mn"], cj)
    dt = pt.build_model_description(m["mp"], m["mn"], ct, device="cpu")
    assert dt.fast_tables is None
    rj = ost.match(dj, m["sp"], m["sn"], cj)
    rt = pt.match(dt, m["sp"], m["sn"], ct)
    _check_pair(dict(m, dj=dj, dt=dt, cj=cj, ct=ct), rj, rt, 2)


def test_match_with_state_reuses_caps(matched, monkeypatch):
    """Mirror of test_match_with_state_steady_state_skips_count: the second
    call runs without the count pass on the same caps with the same
    result; undersized caps fall back to exact sizing."""
    m = matched

    def boom(*a, **k):
        raise AssertionError("count pass ran on the steady-state path")

    monkeypatch.setattr(td, "_count_votes", boom)
    rt2, caps2 = pt.match_with_state(m["dt"], m["sp"], m["sn"], m["ct"],
                                     state=m["capt"])
    assert caps2 == m["capt"]
    assert torch.equal(rt2.accumulator, m["rt"].accumulator)
    assert torch.equal(rt2.pose, m["rt"].pose)
    monkeypatch.undo()

    bad = td.MatchCaps(1024, m["capt"].seg_cap, None, 256)
    rt3, caps3 = pt.match_with_state(m["dt"], m["sp"], m["sn"], m["ct"],
                                     state=bad)
    assert caps3 == m["capt"] and not bool(rt3.overflowed)
    assert torch.equal(rt3.pose, m["rt"].pose)


def test_match_with_state_terminal_saturation(monkeypatch):
    """Mirror of test_match_with_state_terminal_saturation, with the JAX
    package's flags and caps on the same scene."""
    mp, mn, sp, sn, _ = _scene(1)
    cj, ct = ost.PPFConfig(max_poses=4), pt.PPFConfig(max_poses=4)
    dj = ost.build_model_description(mp, mn, cj)
    dt = pt.build_model_description(mp, mn, ct, device="cpu")
    rj, capj = ost.match_with_state(dj, sp, sn, cj, max_poses_ceiling=4)
    rt, capt = pt.match_with_state(dt, sp, sn, ct, max_poses_ceiling=4)
    assert tuple(capt) == tuple(capj)
    assert bool(rt.topk_saturated) and bool(rj.topk_saturated)
    assert capt.max_poses == 4

    def boom(*a, **k):
        raise AssertionError("count pass ran on terminal saturation")

    monkeypatch.setattr(td, "_count_votes", boom)
    rt2, capt2 = pt.match_with_state(dt, sp, sn, ct, state=capt,
                                     max_poses_ceiling=4)
    assert capt2 == capt and bool(rt2.topk_saturated)
    assert torch.equal(rt2.pose, rt.pose)


def test_topk_saturated_retry_ladder():
    """Mirror of test_topk_saturated_auto_retry: the ladder clears the
    flag; with the ceiling at the start it comes back set."""
    mp, mn, sp, sn, T = _scene(2, n_model=90, n_clutter=0)
    cfg = pt.PPFConfig(max_poses=2)
    dt = pt.build_model_description(mp, mn, cfg, device="cpu")
    assert bool(td._match_sized(dt, sp, sn, cfg).topk_saturated)
    res = pt.match(dt, sp, sn, cfg)
    assert not bool(res.topk_saturated)
    assert jval.validate_pose(res.pose.numpy(), T, dt.diameter,
                              ost.PPFConfig()).match
    assert bool(pt.match(dt, sp, sn, cfg, max_poses_ceiling=2).topk_saturated)


def test_extract_instances_matches_jax_function(matched):
    """The port's extract_instances gives what the JAX package's gives on
    the same candidate arrays."""
    rt = matched["rt"]
    got = td.extract_instances(rt, matched["dt"].diameter, max_instances=5)
    want = jd.extract_instances(rt._replace(**{
        f: np.asarray(getattr(rt, f)) for f in rt._fields}),
        matched["dj"].diameter, max_instances=5)
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_carry_jax_saved_description(matched, tmp_path):
    """A description saved by the JAX package loads into the port and
    matches like the port's own build."""
    m = matched
    path = tmp_path / "model.osn.npz"
    jser.save_model_description(path, m["dj"])
    loaded = tser.load_model_description(path, device="cpu")
    assert loaded.n_points == m["dt"].n_points
    assert loaded.max_dist_bin == m["dt"].max_dist_bin
    assert loaded.d_dist == m["dt"].d_dist
    bt, bl = m["dt"].fast_tables.block, loaded.fast_tables.block
    if _triples(m["dj"].table) == _triples(m["dt"].table):
        assert torch.equal(bl.pair2d, bt.pair2d)
        assert torch.equal(bl.occ_keys, bt.occ_keys)
    res = pt.match(loaded, m["sp"], m["sn"], m["ct"])
    assert torch.equal(res.accumulator, m["rt"].accumulator) or \
        _triples(m["dj"].table) != _triples(m["dt"].table)
    td_, rd_ = (float(x) for x in pt.ops.transforms.ht_dist(res.pose,
                                                             m["rt"].pose))
    assert td_ < 1e-4 and rd_ < 1e-3


def _both_packages(kw, seed=0, **scene_kw):
    """The same model and scene through both packages' match_with_state
    under PPFConfig(**kw)."""
    mp, mn, sp, sn, T = _scene(seed, **scene_kw)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj)
    dt = pt.build_model_description(mp, mn, ct, device="cpu")
    rj, capj = ost.match_with_state(dj, sp, sn, cj)
    rt, capt = pt.match_with_state(dt, sp, sn, ct)
    return dict(mp=mp, mn=mn, sp=sp, sn=sn, T=T, cj=cj, ct=ct, dj=dj, dt=dt,
                rj=rj, rt=rt, capj=capj, capt=capt)


@pytest.fixture(scope="module")
def corr_matched():
    return _both_packages(dict(max_poses=256, ref_point_df=2,
                               engine="correlation"))


def test_correlation_engine_e2e(corr_matched):
    """engine="correlation" end to end: the JAX package's caps (no vote
    buffer, the engine's own runs_cap), flags, accumulator and pose. Both
    descriptions carry the block tables too, as bench.py relies on."""
    m = corr_matched
    assert tuple(m["capt"]) == tuple(m["capj"]) == (0, None, None, 256)
    assert m["dt"].corr_tables is not None
    assert m["dt"].fast_tables.block is not None
    assert m["dt"].corr_tables.k_occ == m["dj"].corr_tables.k_occ
    _check_pair(m, m["rj"], m["rt"], 2)
    assert int(m["rt"].accumulator.sum()) == int(m["rt"].num_votes)


def test_correlation_forced_runs_cap_overflow_retry(corr_matched):
    """Mirror of test_correlation_runs_cap_overflow_and_retry: a starting
    runs_cap far too small climbs the same capacity buckets in both
    packages, and the result equals the uncapped one."""
    m = corr_matched
    rj, capj = jd._match_sized_caps(m["dj"], m["sp"], m["sn"], m["cj"],
                                    runs_cap=128)
    rt, capt = td._match_sized_caps(m["dt"], m["sp"], m["sn"], m["ct"],
                                    runs_cap=128)
    assert tuple(capt) == tuple(capj)
    assert capt.runs_cap > 128 and capt.vote_cap == 0
    assert not bool(rt.overflowed) and not bool(rj.overflowed)
    assert torch.equal(rt.accumulator, m["rt"].accumulator)
    assert int(rt.num_votes) == int(m["rt"].num_votes)
    res = pt.match(m["dt"], m["sp"], m["sn"], m["ct"], runs_cap=128)
    assert torch.equal(res.pose, m["rt"].pose)
    # One bucket short of the need: one retry, the same final bucket.
    short = capt.runs_cap // 2
    assert tuple(td._match_sized_caps(m["dt"], m["sp"], m["sn"], m["ct"],
                                      runs_cap=short)[1]) == \
        tuple(jd._match_sized_caps(m["dj"], m["sp"], m["sn"], m["cj"],
                                   runs_cap=short)[1])


def test_match_with_state_correlation_engine(corr_matched):
    """Mirror of the JAX package's test: the state carries runs_cap, and
    its reuse gives the same pose."""
    m = corr_matched
    _, caps = td._match_loop(m["dt"], m["sp"], m["sn"], m["ct"], None, None,
                             None, 128, 8192)
    assert caps.runs_cap is not None
    res2, caps2 = pt.match_with_state(m["dt"], m["sp"], m["sn"], m["ct"],
                                      state=caps)
    assert caps2 == caps
    assert torch.equal(res2.pose, m["rt"].pose)
    # A state whose runs_cap overflows falls back to exact sizing.
    bad = td.MatchCaps(0, None, 128, 256)
    res3, caps3 = pt.match_with_state(m["dt"], m["sp"], m["sn"], m["ct"],
                                      state=bad)
    assert not bool(res3.overflowed) and caps3 == m["capt"]
    assert torch.equal(res3.pose, m["rt"].pose)


def test_correlation_without_tables_raises(matched):
    m = matched
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=2, engine="correlation")
    with pytest.raises(ValueError, match="corr_tables"):
        pt.match(m["dt"], m["sp"], m["sn"], cfg)
    with pytest.raises(ValueError, match="corr_tables"):
        td._match_core(m["dt"], m["sp"], m["sn"], ref_point_df=2, vote_cap=0,
                       config=cfg)


@pytest.mark.parametrize("engine", ["fast", "reference", "correlation"])
def test_fnv_mode_equals_packed_mode_without_collisions(matched, engine):
    """Mirror of test_fnv_mode_tallies_equal_packed_when_no_collisions, for
    every engine: where the model's occupied keys hash without collision
    (checked), FNV keying is a bijection of the key space and the
    accumulator is the packed-key run's, bit for bit. Caps and flags are
    the JAX package's FNV-mode ones."""
    from objective_slam_tpu_torch.ops import hashing as th
    m = matched
    kw = dict(max_poses=256, ref_point_df=2, engine=engine)
    cp, cf = pt.PPFConfig(**kw), pt.PPFConfig(**kw, use_fnv_keys=True)
    dp = pt.build_model_description(m["mp"], m["mn"], cp, device="cpu")
    df = pt.build_model_description(m["mp"], m["mn"], cf, device="cpu")
    occ = torch.nonzero(dp.table.counts)[:, 0].to(torch.int32)
    h = th.packed_key_fnv(occ, dp.d_dist, cp.d_angle)
    assert len(torch.unique(h)) == len(h) and bool((h != 0).all())
    assert df.fnv_remap.k_occ == len(occ)
    assert df.num_keys == df.fnv_remap.occ_hashes.shape[0] == \
        df.table.counts.shape[0]
    rp, capp = pt.match_with_state(dp, m["sp"], m["sn"], cp)
    rf, capf = pt.match_with_state(df, m["sp"], m["sn"], cf)
    assert torch.equal(rf.accumulator, rp.accumulator)
    assert int(rf.num_votes) == int(rp.num_votes)
    assert capf == capp
    torch.testing.assert_close(rf.pose, rp.pose, atol=1e-5, rtol=0)
    cj = ost.PPFConfig(**kw, use_fnv_keys=True)
    dj = ost.build_model_description(m["mp"], m["mn"], cj)
    assert dj.fnv_remap.k_occ == df.fnv_remap.k_occ
    assert dj.num_keys == df.num_keys
    np.testing.assert_array_equal(
        df.fnv_remap.occ_hashes.numpy().astype(np.uint32),
        np.asarray(dj.fnv_remap.occ_hashes))
    rj, capj = ost.match_with_state(dj, m["sp"], m["sn"], cj)
    assert tuple(capf) == tuple(capj)
    assert bool(rf.topk_saturated) == bool(rj.topk_saturated)
    clean, bound = _flip_bound(dict(m, cj=ost.PPFConfig(**kw), ct=cp,
                                    dj=ost.build_model_description(
                                        m["mp"], m["mn"], ost.PPFConfig(**kw)),
                                    dt=dp), 2)
    diff = int(np.abs(np.asarray(rj.accumulator).astype(np.int64)
                      - rf.accumulator.numpy()).sum())
    assert diff == 0 if clean else diff <= bound


def test_rescoring_with_distractors():
    """Mirror of test_rescoring_with_distractors: the correlation engine
    with rescoring among curved distractors, both packages on the same
    scene: both recover the pose, and the port's is the JAX package's."""
    rng = np.random.default_rng(0)
    mp, mn = synthetic.blob_cloud(rng, 150, bumps=0.25)
    dp1, dn1 = synthetic.blob_cloud(rng, 80, bumps=0.3)
    dp2, dn2 = synthetic.blob_cloud(rng, 80, bumps=0.3)
    cp = np.concatenate([dp1 * 1.2 + np.array([3.0, 0, 0]),
                         dp2 * 0.9 + np.array([0, 3.0, 0])]) \
        .astype(np.float32)
    cn = np.concatenate([dn1, dn2]).astype(np.float32)
    sp, sn, T = synthetic.plant_model(rng, mp, mn, cp, cn)
    kw = dict(max_poses=512, engine="correlation", rescore_poses=True)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj)
    dt = pt.build_model_description(mp, mn, ct, device="cpu")
    rj, rt = ost.match(dj, sp, sn, cj), pt.match(dt, sp, sn, ct)
    for pose in (np.asarray(rj.pose), rt.pose.numpy()):
        assert jval.validate_pose(pose, T, dj.diameter, cj).match
    tdist, rdist = (float(x) for x in ost.ops.transforms.ht_dist(
        np.asarray(rj.pose), rt.pose.numpy()))
    assert tdist < dt.d_dist and rdist < 2 * ct.d_angle
    if np.array_equal(np.asarray(rj.accumulator), rt.accumulator.numpy()):
        np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose),
                                   atol=1e-4)
        np.testing.assert_allclose(float(rt.cluster_votes),
                                   float(rj.cluster_votes), rtol=1e-5)


def test_rescoring_rule_first_maximum_wins(matched, monkeypatch):
    """The rescoring branch by its rule: only peaks within
    rescore_min_vote_frac of the best clustered count are scored, the
    winner maximises votes · (1 + score), the first maximum wins, and the
    pose carries the clustered translation."""
    from objective_slam_tpu_torch.ops import verify_pose
    m = matched
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=2, rescore_poses=True)
    seen = {}

    def spy(poses, valid, *a, **k):
        seen["valid"] = valid.clone()
        seen["poses"] = poses.clone()
        scores = torch.zeros(len(poses))
        seen["scores"] = torch.where(valid, scores, -1.0)
        return seen["scores"]

    monkeypatch.setattr(verify_pose, "inlier_scores", spy)
    res = pt.match(m["dt"], m["sp"], m["sn"], cfg)
    near = res.clustered_counts >= np.float32(cfg.rescore_min_vote_frac) \
        * res.clustered_counts.max()
    assert torch.equal(seen["valid"], res.pose_keep & near)
    combined = torch.where(seen["valid"], res.clustered_counts, -1.0)
    win = int(torch.argmax(combined))
    assert torch.equal(seen["poses"][win, :3, 3],
                       res.clustered_translations[win])
    monkeypatch.undo()
    plain = pt.match(m["dt"], m["sp"], m["sn"], m["ct"])
    assert torch.equal(res.accumulator, plain.accumulator)
    # With every score equal, the rule falls back to the plain winner.
    assert float(res.cluster_votes) == float(plain.cluster_votes)


def test_rescoring_preserves_easy_recovery(matched):
    m = matched
    kw = dict(max_poses=256, ref_point_df=2, rescore_poses=True)
    rj = ost.match(m["dj"], m["sp"], m["sn"], ost.PPFConfig(**kw))
    rt = pt.match(m["dt"], m["sp"], m["sn"], pt.PPFConfig(**kw))
    _check_pair(m, rj, rt, 2)


@pytest.mark.parametrize("kind,kw", [
    ("plain", {}), ("fnv", {"use_fnv_keys": True}),
    ("correlation", {"engine": "correlation"})])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_description_files_cross_load(matched, tmp_path, kind, kw, direction):
    """A description saved by one package loads into the other and matches
    like that package's own build, for packed, FNV-keyed and correlation
    descriptions. The two files hold the same arrays with the same types."""
    m = matched
    kw = dict(max_poses=256, ref_point_df=2, **kw)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(m["mp"], m["mn"], cj)
    dt = pt.build_model_description(m["mp"], m["mn"], ct, device="cpu")
    pj, pt_ = tmp_path / "j.npz", tmp_path / "t.npz"
    jser.save_model_description(pj, dj)
    tser.save_model_description(pt_, dt)
    same_tables = _triples(dj.table) == _triples(dt.table)
    with np.load(pj) as zj, np.load(pt_) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert ("fnv_occ_hashes" in zt.files) == (kind == "fnv")
        for name in zj.files:
            assert zt[name].dtype == zj[name].dtype, name
            assert zt[name].shape == zj[name].shape, name
            if same_tables or name in ("points", "normals", "vote_weights",
                                       "d_dist", "meta", "fnv_occ_hashes",
                                       "counts", "offsets", "max_count"):
                np.testing.assert_array_equal(zt[name], zj[name], name)
    if direction == "jax-to-port":
        loaded = tser.load_model_description(pj, device="cpu")
        assert (loaded.corr_tables is not None) == (kind == "correlation")
        assert (loaded.fnv_remap is not None) == (kind == "fnv")
        own = pt.match(dt, m["sp"], m["sn"], ct)
        res = pt.match(loaded, m["sp"], m["sn"], ct)
        if same_tables:
            assert torch.equal(res.accumulator, own.accumulator)
        td_, rd_ = (float(x) for x in pt.ops.transforms.ht_dist(res.pose,
                                                                 own.pose))
    else:
        loaded = jser.load_model_description(pt_)
        assert (loaded.corr_tables is not None) == (kind == "correlation")
        assert (loaded.fnv_remap is not None) == (kind == "fnv")
        own = ost.match(dj, m["sp"], m["sn"], cj)
        res = ost.match(loaded, m["sp"], m["sn"], cj)
        if same_tables:
            np.testing.assert_array_equal(np.asarray(res.accumulator),
                                          np.asarray(own.accumulator))
        td_, rd_ = (float(x) for x in ost.ops.transforms.ht_dist(
            np.asarray(res.pose), np.asarray(own.pose)))
    assert td_ < 1e-4 and rd_ < 1e-3


@pytest.mark.parametrize("kw", [{"engine": "correlation"},
                                {"use_fnv_keys": True},
                                {"rescore_poses": True}],
                         ids=["correlation", "use_fnv_keys", "rescore_poses"])
def test_ported_features_run(matched, kw):
    """The three modes that used to raise NotImplementedError build and
    match, and localize the planted model."""
    m = matched
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=2, **kw)
    desc = pt.build_model_description(m["mp"], m["mn"], cfg, device="cpu")
    res = pt.match(desc, m["sp"], m["sn"], cfg)
    assert not bool(res.overflowed)
    assert jval.validate_pose(res.pose.numpy(), m["T"], desc.diameter,
                              m["cj"]).match


@pytest.fixture(scope="module")
def trex_matched():
    """The UWA-analog trex model (170 points, 4,266 occupied keys: over the
    block engine's budget) against a small cluttered scene with 62
    reference rows, through both packages' fallback engine."""
    from objective_slam_tpu_torch.utils import pointcloud as tpc, \
        synthetic as tsyn
    v, f = tsyn.uwa_analog_models()["trex"]
    nrm = tpc.mesh_vertex_normals(v, f)
    diam = tpc.bbox_diameter(v)
    dd = 0.1 * diam
    mp, mn = tpc.voxel_downsample_np(v, nrm, dd)
    rng = np.random.default_rng(3)
    cp, cn = tsyn.clutter_cloud(rng, 200, lo=-80, hi=80)
    sp_raw, sn_raw, T = tsyn.plant_model(rng, v, nrm, cp, cn)
    sp, sn = tpc.voxel_downsample_np(sp_raw, sn_raw, dd)
    kw = dict(max_poses=256, ref_point_df=6)
    cj, ct = ost.PPFConfig(**kw), pt.PPFConfig(**kw)
    dj = ost.build_model_description(mp, mn, cj, d_dist=dd)
    dt = pt.build_model_description(mp, mn, ct, d_dist=dd, device="cpu")
    rj, capj = ost.match_with_state(dj, sp, sn, cj)
    rt, capt = pt.match_with_state(dt, sp, sn, ct)
    return dict(mp=mp, mn=mn, sp=sp, sn=sn, T=T, cj=cj, ct=ct, dj=dj, dt=dt,
                rj=rj, rt=rt, capj=capj, capt=capt)


def test_fallback_engine_over_block_budget(trex_matched):
    m = trex_matched
    assert m["dj"].fast_tables.block is None
    assert m["dt"].fast_tables.block is None
    assert int((m["dt"].table.counts > 0).sum()) > 4096
    assert tuple(m["capt"]) == tuple(m["capj"])
    assert m["capt"].seg_cap is None
    assert len(range(0, len(m["sp"]), 6)) <= 64
    _check_pair(m, m["rj"], m["rt"], 6)


def test_match_e2e_block_vs_legacy():
    """Mirror of test_match_e2e_block_vs_legacy: with its block tables
    stripped, the same model takes the fallback engine (kernel K2's path)
    and gives the same accumulator and pose as the block engine."""
    rng = np.random.default_rng(0)
    m_pts, m_nrm = synthetic.blob_cloud(rng, 220)
    c_pts, c_nrm = synthetic.blob_cloud(rng, 420)
    c_pts = c_pts * 1.8 + np.float32([2.5, 0.0, 0.0])
    scene, scene_n, T = synthetic.plant_model(rng, m_pts, m_nrm, c_pts,
                                              c_nrm)
    cfg = pt.PPFConfig(max_poses=256, ref_point_df=3)
    desc = pt.build_model_description(m_pts, m_nrm, cfg, device="cpu")
    assert desc.fast_tables.block is not None
    res, caps = pt.match_with_state(desc, scene, scene_n, cfg)
    legacy = dataclasses.replace(
        desc, fast_tables=desc.fast_tables._replace(block=None))
    res_l, caps_l = pt.match_with_state(legacy, scene, scene_n, cfg)
    assert caps_l.seg_cap is None and caps.seg_cap is not None
    assert not bool(res.overflowed) and not bool(res_l.overflowed)
    assert torch.equal(res.accumulator, res_l.accumulator)
    torch.testing.assert_close(res.pose, res_l.pose, atol=1e-5, rtol=0)
    assert jval.validate_pose(res.pose.numpy(), T, desc.diameter,
                              ost.PPFConfig()).match


def test_match_accumulator_only(matched):
    """The readable engine's dense accumulator, as the JAX package's
    match_accumulator_only gives it, within the flip bound."""
    m = matched
    rj = jd.match_accumulator_only(m["dj"], m["sp"], m["sn"], m["cj"])
    rt = td.match_accumulator_only(m["dt"], m["sp"], m["sn"], m["ct"])
    assert int(rt.num_votes) == int(rj.num_votes)
    assert not bool(rt.overflowed)
    ref_cfg = pt.PPFConfig(max_poses=256, ref_point_df=2, engine="reference")
    clean, bound = _flip_bound(dict(m, ct=ref_cfg), 2)
    diff = int(np.abs(np.asarray(rj.accumulator).astype(np.int64)
                      - rt.accumulator.numpy()).sum())
    assert diff == 0 if clean else diff <= bound


def test_match_greedy_cpu(matched):
    """The reference's CPU clustering mode: the same greedy clusters as the
    JAX package's on the same candidates, and the winner localizes."""
    m = matched
    pj, gj = jd.match_greedy_cpu(m["dj"], m["sp"], m["sn"], m["cj"])
    pt_, gt = td.match_greedy_cpu(m["dt"], m["sp"], m["sn"], m["ct"])
    assert gt.poses.shape == gj.poses.shape
    np.testing.assert_allclose(gt.votes, gj.votes)
    np.testing.assert_allclose(pt_, np.asarray(pj), atol=1e-4)
    assert jval.validate_pose(pt_, m["T"], m["dt"].diameter, m["cj"]).match
