"""The port's correlation vote engine against the JAX package's on the same
key and α arrays: CorrTables array by array, and cast_votes_corr's
accumulator, num_votes and overflowed, all bit-equal. The port builds the
scene histogram with one index_add_ where the JAX package sorts and
coalesces runs, so the flags are the thing to hold: the same runs_cap,
chunk budget and flat-id limit give the same `overflowed`. The JAX package
truncates its tallies and its vote total when it overflows and the port
does not, so both are compared where the flag is clear. Mirrors of the
correlation cases of tests/test_voting.py."""

import math
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import objective_slam_tpu.ops.voting_corr as jvc
from objective_slam_tpu.ops import hashing as jh, ppf as jppf, voting as jv
import objective_slam_tpu_torch.ops.voting_corr as tvc
from objective_slam_tpu_torch.ops import hashing as th, voting as tv, \
    voting_block as tvb, voting_fast as tvf

D_ANGLE = 2 * math.pi / 30


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _keyed(seed, n_m=30, n_s=50, ref_point_df=1, fnv=False):
    """Model and scene keys/α from the JAX package, the model planted in
    the scene; with `fnv`, remapped to FNV-bucket ranks."""
    rng = np.random.default_rng(seed)
    mp, mn = rng.normal(size=(n_m, 3)).astype(np.float32), _unit(rng, (n_m, 3))
    sp, sn = rng.normal(size=(n_s, 3)).astype(np.float32), _unit(rng, (n_s, 3))
    sp, sn = np.concatenate([sp, mp]), np.concatenate([sn, mn])
    nk = jppf.num_keys(32)
    mk, ma = (np.array(x) for x in
              jppf.pairwise_ppf_keys(mp, mn, 0.5, D_ANGLE, 32))
    ref = np.arange(0, len(sp), ref_point_df, dtype=np.int32)
    sk, sa = (np.array(x) for x in
              jppf.pairwise_ppf_keys(sp, sn, 0.5, D_ANGLE, 32,
                                     ref_indices=ref))
    if fnv:
        remap = jh.build_fnv_remap(mk, 0.5, D_ANGLE)
        nk = int(remap.occ_hashes.shape[0])
        mk = np.array(jh.fnv_remap_keys(mk, remap, 0.5, D_ANGLE))
        sk = np.array(jh.fnv_remap_keys(sk, remap, 0.5, D_ANGLE))
    return mk, ma, sk, sa, nk, n_m


def _tables(mk, ma, nk, n_m, n_angle=30):
    tj = jv.build_key_table(jnp.asarray(mk), jnp.asarray(ma), nk)
    tt = tv.build_key_table(torch.from_numpy(mk), torch.from_numpy(ma), nk)
    return (jvc.build_corr_tables(tj, n_m, n_angle),
            tvc.build_corr_tables(tt, n_m, n_angle), tt)


def _cast_both(sk, sa, cj, ct, n_m, **kw):
    rj = jvc.cast_votes_corr(jnp.asarray(sk), jnp.asarray(sa), cj, n_m, **kw)
    rt = tvc.cast_votes_corr(torch.from_numpy(sk), torch.from_numpy(sa), ct,
                             n_m, **kw)
    assert rt.accumulator.dtype == torch.int32
    assert tuple(rt.accumulator.shape) == tuple(rj.accumulator.shape)
    assert bool(rt.overflowed) == bool(rj.overflowed), kw
    if not bool(rj.overflowed):
        assert int(rt.num_votes) == int(rj.num_votes)
        np.testing.assert_array_equal(rt.accumulator.numpy(),
                                      np.asarray(rj.accumulator))
    return rt


def _n_runs(sk, sa, ct):
    """Occupied histogram cells plus the run of invalid pairs: the count
    the JAX package compares with runs_cap."""
    valid = sk.reshape(-1) != jppf.INVALID_KEY
    rank = np.full(sk.size, ct.k_occ, np.int64)
    dr = ct.dense_rank.numpy()
    rank[valid] = dr[sk.reshape(-1)[valid]]
    b_s = (tvf.alpha_to_fix(torch.from_numpy(sa.reshape(-1))).numpy()
           .astype(np.int64) * ct.n_angle) >> tvc.ALPHA_BITS
    row = np.repeat(np.arange(sk.shape[0]), sk.shape[1])
    cell = (row * (ct.k_occ + 1) + rank) * ct.n_angle + b_s
    return len(np.unique(cell[valid])) + int((~valid).any())


@pytest.mark.parametrize("seed,fnv,n_angle", [(0, False, 30), (1, True, 30),
                                              (2, False, 12)])
def test_corr_tables_equal(seed, fnv, n_angle):
    mk, ma, _, _, nk, n_m = _keyed(seed, fnv=fnv)
    cj, ct, _ = _tables(mk, ma, nk, n_m, n_angle)
    assert (ct.k_occ, ct.n_angle) == (cj.k_occ, cj.n_angle)
    for name in ("occ_keys", "m3_dup", "dense_rank"):
        a, b = getattr(ct, name), np.asarray(getattr(cj, name))
        assert a.numpy().dtype == b.dtype and tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b)
    assert float(ct.m3_dup[ct.k_occ].sum()) == 0.0


def test_build_corr_tables_m3_matches_host_histogram():
    """Mirror of the JAX package's test: random keys with invalid pairs
    against a numpy histogram."""
    rng = np.random.default_rng(3)
    n_m, num_keys, n_angle = 37, 512, 30
    keys = rng.integers(0, num_keys, size=(n_m, n_m)).astype(np.int32)
    keys[rng.random((n_m, n_m)) < 0.15] = np.int32(jppf.INVALID_KEY)
    alpha = rng.uniform(-np.pi, np.pi, size=(n_m, n_m)).astype(np.float32)
    table = tv.build_key_table(torch.from_numpy(keys),
                               torch.from_numpy(alpha), num_keys)
    tabs = tvc.build_corr_tables(table, n_m, n_angle)
    counts = table.counts.numpy()
    occ = np.nonzero(counts)[0]
    rank = np.repeat(np.arange(len(occ)), counts[occ])
    n_pairs = rank.shape[0]
    a_fix = np.clip(np.round((table.pair_alpha.numpy().astype(np.float64)
                              + math.pi) * tvc._ALPHA_SCALE), 0,
                    (1 << tvc.ALPHA_BITS) - 1).astype(np.int64)
    b_m = (a_fix * n_angle) >> tvc.ALPHA_BITS
    m3 = np.zeros((len(occ) + 1, n_angle, n_m), np.float32)
    np.add.at(m3, (rank, b_m[:n_pairs], table.pair_mr.numpy()[:n_pairs]), 1.0)
    assert tabs.k_occ == len(occ)
    np.testing.assert_array_equal(tabs.m3_dup.numpy(),
                                  np.concatenate([m3, m3], axis=1))
    np.testing.assert_array_equal(tabs.occ_keys.numpy()[:len(occ)], occ)
    assert (tabs.occ_keys.numpy()[len(occ):] == -2).all()


@pytest.mark.parametrize("seed,ref_df,fnv", [(0, 1, False), (4, 3, False),
                                            (5, 1, True), (6, 2, True)])
def test_cast_votes_corr_bit_equal(seed, ref_df, fnv):
    mk, ma, sk, sa, nk, n_m = _keyed(seed, ref_point_df=ref_df, fnv=fnv)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    rt = _cast_both(sk, sa, cj, ct, n_m)
    assert not bool(rt.overflowed)
    assert int(rt.accumulator.sum()) == int(rt.num_votes) > 0
    assert int(rt.accumulator[:, :, 30:].sum()) == 0


def test_lut_rank_path_of_the_jax_package():
    """The JAX package's dense-LUT rank path (big dictionaries) gives the
    port's ranks too: the port has only that route."""
    mk, ma, sk, sa, nk, n_m = _keyed(7)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    with mock.patch.object(jvc, "_DICT_MATMUL_MAX_K", 0):
        _cast_both(sk, sa, cj, ct, n_m)


def test_runs_cap_flag_flips_where_the_jax_flag_flips():
    """runs_cap is rounded up to 128 and clamped to the pair count; the
    flag is n_runs > runs_cap. Caps on both sides of the run count give
    the JAX package's flag, and its accumulator wherever that is clear."""
    mk, ma, sk, sa, nk, n_m = _keyed(8, n_s=60)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    n_runs = _n_runs(sk, sa, ct)
    assert 256 < n_runs < sk.size
    below, above = n_runs // 128 * 128, -(-n_runs // 128) * 128
    flags = {}
    for cap in (128, below - 128, below, above, above + 128, sk.size,
                10 * sk.size, None):
        rt = _cast_both(sk, sa, cj, ct, n_m, runs_cap=cap)
        flags[cap] = bool(rt.overflowed)
    assert flags[128] and flags[below - 128]
    assert flags[below] == (n_runs > below)
    assert not flags[above] and not flags[sk.size] and not flags[None]


@pytest.mark.parametrize("rows_per_chunk", [1, 7, 8, 33])
def test_chunked_path_bit_equal(rows_per_chunk):
    """Mirror of test_correlation_chunked_and_lut_paths_bit_equal: a chunk
    budget below the dense histogram gives the single-chunk accumulator."""
    mk, ma, sk, sa, nk, n_m = _keyed(9, n_m=12, n_s=28)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    base = _cast_both(sk, sa, cj, ct, n_m)
    budget = (ct.k_occ + 1) * 30 * 4 * rows_per_chunk
    chunked = _cast_both(sk, sa, cj, ct, n_m, chunk_budget_bytes=budget)
    assert not bool(chunked.overflowed)
    assert torch.equal(chunked.accumulator, base.accumulator)
    assert int(chunked.num_votes) == int(base.num_votes)


@pytest.mark.parametrize("budget_rows", [None, 7])
def test_flat_id_limit_branch_bit_equal(budget_rows):
    """With the flat-id limit forced down, the JAX package sorts (row, col)
    pairs and caps the rows per chunk; the port's int64 ids need neither,
    but it derives the same chunking and so the same flags."""
    mk, ma, sk, sa, nk, n_m = _keyed(10, n_m=12, n_s=28)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    base = _cast_both(sk, sa, cj, ct, n_m)
    kw = {} if budget_rows is None else dict(
        chunk_budget_bytes=(ct.k_occ + 1) * 30 * 4 * budget_rows)
    with mock.patch.object(jvc, "_FLAT_ID_MAX", 1), \
            mock.patch.object(tvc, "_FLAT_ID_MAX", 1):
        lex = _cast_both(sk, sa, cj, ct, n_m, **kw)
    assert torch.equal(lex.accumulator, base.accumulator)


def test_chunk_run_budget_flag():
    """On the chunked path a row chunk with more than B runs sets the flag
    even where runs_cap holds the total. B is four times a chunk's even
    share of runs_cap and at least 65,536, so the case needs more than four
    chunks and one of them holding over 65,536 occupied cells: eight chunks
    of 48 rows, only the first with valid keys, drawn from a dictionary of
    some 1,400 keys so that nearly every pair is a cell of its own."""
    rng = np.random.default_rng(11)
    n_m, nk, rows, n = 50, 4096, 48, 1500
    mk = rng.integers(0, 2000, size=(n_m, n_m)).astype(np.int32)
    ma = rng.uniform(-np.pi, np.pi, size=(n_m, n_m)).astype(np.float32)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    sk = np.full((8 * rows, n), jppf.INVALID_KEY, np.int32)
    sk[:rows] = rng.choice(np.unique(mk), size=(rows, n))
    sa = rng.uniform(-np.pi, np.pi, size=sk.shape).astype(np.float32)
    n_runs = _n_runs(sk, sa, ct)
    assert n_runs > 65536 + 128
    cap = -(-n_runs // 128) * 128
    budget = (ct.k_occ + 1) * 30 * 4 * rows
    with mock.patch.object(jvc, "_DICT_MATMUL_MAX_K", 0):
        rt = _cast_both(sk, sa, cj, ct, n_m, runs_cap=cap,
                        chunk_budget_bytes=budget)
        assert bool(rt.overflowed)
        rt = _cast_both(sk, sa, cj, ct, n_m, runs_cap=cap)
        assert not bool(rt.overflowed)


def test_blurs_within_one_alpha_bin_of_the_exact_engine():
    """Mirror of test_correlation_engine_blurs_within_one_alpha_bin, against
    the port's block engine: per-(row, model point) totals equal, every vote
    within one α bin (cyclically)."""
    mk, ma, sk, sa, nk, n_m = _keyed(12)
    _, ct, table = _tables(mk, ma, nk, n_m)
    skt, sat = torch.from_numpy(sk), torch.from_numpy(sa)
    corr = tvc.cast_votes_corr(skt, sat, ct, n_m)
    block = tvb.cast_votes_block(skt, sat,
                                 tvf.build_fast_tables(table).block, n_m,
                                 D_ANGLE, 1 << 20)
    assert int(corr.num_votes) == int(block.num_votes)
    c = corr.accumulator[:, :, :30].to(torch.int64)
    e = block.accumulator[:, :, :30].to(torch.int64)
    assert int(block.accumulator[:, :, 30:].sum()) == 0
    assert torch.equal(c.sum(dim=2), e.sum(dim=2))
    assert not torch.equal(c, e)
    blur_e = torch.roll(e, 1, 2) + e + torch.roll(e, -1, 2)
    blur_c = torch.roll(c, 1, 2) + c + torch.roll(c, -1, 2)
    assert bool((blur_e >= c).all()) and bool((blur_c >= e).all())


def test_keys_outside_the_model_tally_nothing():
    """Valid scene keys the model does not hold land on the all-zero rank
    k_occ: they count as histogram cells (runs) but cast no vote."""
    mk, ma, sk, sa, nk, n_m = _keyed(13)
    cj, ct, _ = _tables(mk, ma, nk, n_m)
    free = np.setdiff1d(np.arange(nk), mk.reshape(-1))[:sk.shape[1]]
    sk2 = np.concatenate([sk, free[None, :].astype(np.int32)])
    sa2 = np.concatenate([sa, sa[:1]])
    rt = _cast_both(sk2, sa2, cj, ct, n_m)
    assert int(rt.accumulator[-1].sum()) == 0
    base = _cast_both(sk, sa, cj, ct, n_m)
    assert int(rt.num_votes) == int(base.num_votes)
    assert _n_runs(sk2, sa2, ct) > _n_runs(sk, sa, ct)
