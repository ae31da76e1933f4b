"""The port's fallback vote engine and the K2 plain tally against the JAX
package on the same arrays: flat tables against the unrotated block of the
JAX PackedTable, cast_votes_fast accumulator / num_votes / overflowed, and
fast_tally_plain against the JAX CPU twin _mxu_tally — all bit for bit.
Small `chunk` values keep the JAX package's one-hot tally cheap on the CPU;
both packages get the same chunk."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import ppf as jppf, voting as jv, \
    voting_fast as jvf
from objective_slam_tpu_torch.ops import fast_tally, voting as tv, \
    voting_block as tvb, voting_fast as tvf

D_ANGLE = 2 * math.pi / 30
_FIELDS = ("cnt_off", "pair_packed", "counts", "offsets", "pair_mr",
           "pair_alpha")


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _keyed(seed, n_m=30, n_s=50, ref_point_df=1):
    """Model keys/α and scene keys/α from the JAX package, the model planted
    in the scene so that many scene pairs match."""
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
    return mk, ma, sk, sa, nk, n_m


def _tables(mk, ma, nk, force_unpacked=False):
    tj = jv.build_key_table(jnp.asarray(mk), jnp.asarray(ma), nk)
    tt = tv.build_key_table(torch.from_numpy(mk), torch.from_numpy(ma), nk)
    return (jvf.build_fast_tables(tj, force_unpacked=force_unpacked),
            tvf.build_fast_tables(tt, force_unpacked=force_unpacked))


@pytest.mark.parametrize("force_unpacked", [False, True])
def test_flat_tables_equal_unrotated_packed_tables(force_unpacked):
    mk, ma, _, _, nk, _ = _keyed(0)
    fj, ft = _tables(mk, ma, nk, force_unpacked)
    for name in _FIELDS:
        pj, t = getattr(fj, name), getattr(ft, name)
        assert (pj is None) == (t is None), name
        if pj is None:
            continue
        want = np.asarray(pj.packed)[:pj.height].reshape(-1)
        got = t.numpy().view(np.uint32) if want.dtype == np.uint32 \
            else t.numpy()
        np.testing.assert_array_equal(got, want)
    assert (ft.block is None) == force_unpacked


def _cast_both(sk, sa, fj, ft, n_m, vote_cap, chunk, mxu=True):
    rj = jvf.cast_votes_fast(jnp.asarray(sk), jnp.asarray(sa), fj, n_m,
                             D_ANGLE, vote_cap, chunk=chunk,
                             use_mxu_tally=mxu)
    rt = tvf.cast_votes_fast(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                             n_m, D_ANGLE, vote_cap, chunk=chunk,
                             use_mxu_tally=mxu)
    assert int(rt.num_votes) == int(rj.num_votes)
    assert bool(rt.overflowed) == bool(rj.overflowed)
    np.testing.assert_array_equal(rt.accumulator.numpy(),
                                  np.asarray(rj.accumulator))
    return rt


@pytest.mark.parametrize("seed,ref_df,vote_cap,chunk,unpacked,mxu,ovf", [
    (0, 1, 1 << 16, 256, False, True, False),     # packed tables
    (1, 1, 1 << 16, 256, True, True, False),      # force_unpacked
    (2, 3, 1 << 16, 128, False, True, False),     # ref_point_df > 1
    (3, 1, 1 << 10, 512, False, True, True),      # overflowed cap
    (4, 2, 1 << 16, 256, False, False, False),    # scatter tally
    (5, 1, 1 << 16, 256, True, False, False),     # unpacked, scatter
])
def test_cast_votes_fast_bit_equal(seed, ref_df, vote_cap, chunk, unpacked,
                                   mxu, ovf):
    mk, ma, sk, sa, nk, n_m = _keyed(seed, ref_point_df=ref_df)
    fj, ft = _tables(mk, ma, nk, unpacked)
    rt = _cast_both(sk, sa, fj, ft, n_m, vote_cap, chunk, mxu)
    assert bool(rt.overflowed) == ovf


def test_cast_votes_fast_exactly_full_cap():
    """vote_cap equal to the padded vote count, the last reference row
    empty: its start equals vote_cap and it must get nothing."""
    mk, ma, sk, sa, nk, n_m = _keyed(6)
    sk[-1, :] = jppf.INVALID_KEY
    fj, ft = _tables(mk, ma, nk)
    chunk = 256
    probe = tvf.expand_fast(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                            D_ANGLE, 1 << 16, chunk)
    vote_cap = int(probe.total_p)
    assert vote_cap % chunk == 0 and int(probe.row_start_p[-1]) == vote_cap
    rt = _cast_both(sk, sa, fj, ft, n_m, vote_cap, chunk)
    assert not bool(rt.overflowed)
    assert int(rt.accumulator[-1].sum()) == 0
    assert int(rt.accumulator.sum()) == int(rt.num_votes)


@pytest.mark.parametrize("n_s,ref_df", [(40, 1), (33, 4)])
def test_fast_engine_equals_block_engine(n_s, ref_df):
    """Mirror of test_block_matches_fast_exactly and _with_ref_df: the
    port's two exact engines give the same tallies."""
    mk, ma, sk, sa, nk, n_m = _keyed(7, n_s=n_s, ref_point_df=ref_df)
    _, ft = _tables(mk, ma, nk)
    assert ft.block is not None
    skt, sat = torch.from_numpy(sk), torch.from_numpy(sa)
    fast = tvf.cast_votes_fast(skt, sat, ft, n_m, D_ANGLE, 1 << 20)
    block = tvb.cast_votes_block(skt, sat, ft.block, n_m, D_ANGLE, 1 << 20)
    assert not bool(fast.overflowed) and not bool(block.overflowed)
    assert int(fast.num_votes) == int(block.num_votes)
    assert torch.equal(fast.accumulator, block.accumulator)


def _tally_inputs(rng, n_model, chunk, row_chunks, slack_chunks):
    """Per-vote arrays as cast_votes_fast leaves them: chunk-aligned row
    starts, vote_ok false past total_p, m_r/a_bin random everywhere."""
    n_chunks = sum(row_chunks) + slack_chunks
    vote_cap = n_chunks * chunk
    m_r = rng.integers(0, n_model, vote_cap).astype(np.int32)
    a_bin = rng.integers(0, 32, vote_cap).astype(np.int32)
    total_p = sum(row_chunks) * chunk
    ok = rng.random(vote_cap) < 0.7
    ok[total_p:] = False
    starts = (np.concatenate([[0], np.cumsum(row_chunks)[:-1]])
              * chunk).astype(np.int32)
    return m_r, a_bin, ok, starts, np.int32(total_p)


@pytest.mark.parametrize("n_model,row_chunks,slack", [
    (24, [2, 0, 3, 1, 2], 1),       # empty middle row, slack chunk
    (100, [3, 3, 0, 0], 0),         # full buffer, empty trailing rows
    (130, [0, 0, 4, 1, 1, 0], 2),   # empty leading rows (m_pad 256)
])
def test_fast_tally_plain_matches_jax_mxu_tally(n_model, row_chunks, slack):
    chunk = 128
    rng = np.random.default_rng(n_model)
    m_r, a_bin, ok, starts, total_p = _tally_inputs(rng, n_model, chunk,
                                                    row_chunks, slack)
    want = jvf._mxu_tally(jnp.asarray(m_r), jnp.asarray(a_bin),
                          jnp.asarray(ok), jnp.asarray(starts),
                          R=len(starts), n_model=n_model, chunk=chunk,
                          vote_cap=len(m_r))
    got = fast_tally.fast_tally(
        torch.from_numpy(m_r), torch.from_numpy(a_bin), torch.from_numpy(ok),
        torch.from_numpy(starts), torch.tensor(total_p), n_model, chunk)
    assert got.dtype == torch.int32 and got.shape == (len(starts), n_model,
                                                      32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cpu_args(n_model=10, chunk=64):
    m_r, a_bin, ok, starts, total_p = _tally_inputs(
        np.random.default_rng(3), n_model, chunk, [1, 2], 1)
    return [torch.from_numpy(m_r), torch.from_numpy(a_bin),
            torch.from_numpy(ok), torch.from_numpy(starts),
            torch.tensor(total_p)]


def test_k2_wrapper_cpu_runs_plain_and_counts_nothing():
    args = _cpu_args()
    before = fast_tally.launches
    out = fast_tally.fast_tally(*args, 10, 64)
    assert fast_tally.launches == before
    assert torch.equal(out, fast_tally.fast_tally_plain(*args, 10, 64))
    assert int(out.sum()) == int(args[2][:int(args[4])].sum())


@pytest.mark.parametrize("change,exc,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int64)), TypeError, "m_r"),
    (lambda a: a.__setitem__(2, a[2].to(torch.int32)), TypeError,
     "vote_ok"),
    (lambda a: a.__setitem__(1, a[1][:-1].clone()), ValueError, "shaped"),
    (lambda a: a.__setitem__(3, a[3][:0]), ValueError, "row_start_p"),
    (lambda a: a.__setitem__(4, torch.zeros(2, dtype=torch.int32)),
     ValueError, "total_p"),
    (lambda a: a.__setitem__(0, torch.stack([a[0], a[0]], 1)[:, 0]),
     ValueError, "contiguous"),
])
def test_k2_wrapper_checks_arguments(change, exc, match):
    args = _cpu_args()
    fast_tally._check(*args, 10, 64)
    change(args)
    with pytest.raises(exc, match=match):
        fast_tally._check(*args, 10, 64)


@pytest.mark.parametrize("n_model,chunk,match", [(0, 64, "n_model"),
                                                 (10, 48, "chunk")])
def test_k2_wrapper_checks_sizes(n_model, chunk, match):
    with pytest.raises(ValueError, match=match):
        fast_tally._check(*_cpu_args(), n_model, chunk)


def test_unpacked_large_bucket_tallies_every_vote():
    """A planar model puts over 4096 pairs in one key, so the tables are
    unpacked. The port carries (offset, count) in one int64 fill with 32
    bits each and tallies every vote; it matches the readable engine but
    for fixed-point boundary flips. (The JAX package packs both into one
    uint32 with 12 count bits here and loses votes: ROADMAP queue 3.)"""
    rng = np.random.default_rng(0)
    n = 150
    mp = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))],
                        1).astype(np.float32)
    mn = np.tile(np.float32([0, 0, 1]), (n, 1))
    mk, ma = (np.array(x) for x in
              jppf.pairwise_ppf_keys(mp, mn, 0.5, D_ANGLE, 8))
    tt = tv.build_key_table(torch.from_numpy(mk), torch.from_numpy(ma),
                            jppf.num_keys(8))
    assert int(tt.max_count) >= 1 << tvf.CNT_BITS
    ft = tvf.build_fast_tables(tt)
    assert ft.cnt_off is None and ft.counts is not None
    sk, sa = (np.array(x) for x in
              jppf.pairwise_ppf_keys(mp[:20], mn[:20], 0.5, D_ANGLE, 8))
    skt, sat = torch.from_numpy(sk), torch.from_numpy(sa)
    ref = tv.cast_votes(skt, sat, tt, n, D_ANGLE, 1 << 22)
    fast = tvf.cast_votes_fast(skt, sat, ft, n, D_ANGLE,
                               int(ref.num_votes) + 256 * 20, chunk=256)
    assert not bool(fast.overflowed)
    assert int(fast.num_votes) == int(ref.num_votes)
    assert int(fast.accumulator.sum()) == int(ref.num_votes)
    diff = (fast.accumulator - ref.accumulator).abs().sum()
    assert int(diff) < 1e-3 * int(ref.num_votes)
