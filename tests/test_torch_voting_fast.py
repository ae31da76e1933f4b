"""The port's fallback vote engine and the K2 plain tally against the JAX
package on the same arrays: flat tables against the unrotated block of the
JAX PackedTable, cast_votes_fast accumulator / num_votes / overflowed, the
per-pair lookup against the JAX engine's intermediates, fast_tally_plain
against the JAX CPU twin _mxu_tally, and K2's plain version on per-pair
arrays against the per-slot route — all bit for bit. Small `chunk` values
keep the JAX package's one-hot tally cheap on the CPU; both packages get
the same chunk."""

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
    got = fast_tally.fast_tally_plain(
        torch.from_numpy(m_r), torch.from_numpy(a_bin), torch.from_numpy(ok),
        torch.from_numpy(starts), torch.tensor(total_p), n_model, chunk)
    assert got.dtype == torch.int32 and got.shape == (len(starts), n_model,
                                                      32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lookup(seed=3, force_unpacked=False, vote_cap=1 << 16, chunk=256):
    """(pair lookup, tables, n, n_model) of a small planted scene."""
    mk, ma, sk, sa, nk, n_m = _keyed(seed)
    _, ft = _tables(mk, ma, nk, force_unpacked)
    pl = tvf._pair_lookup(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                          vote_cap, chunk)
    return pl, ft, sk.shape[1], n_m


def _cpu_args(vote_cap=1 << 16):
    """fast_tally's arguments, up to n_model and n_angle."""
    pl, ft, n, _ = _lookup(vote_cap=vote_cap)
    return [pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p, pl.row_tot, ft, n,
            vote_cap]


def test_k2_wrapper_cpu_runs_plain_and_counts_nothing():
    args = _cpu_args()
    n_m = _keyed(3)[5]
    before = fast_tally.launches
    out = fast_tally.fast_tally(*args, n_m, 30)
    assert fast_tally.launches == before
    assert torch.equal(out, fast_tally.fast_tally_plain_pairs(*args, n_m, 30))
    assert int(out.sum()) == int(args[0].sum()) > 0


def _replace_table(a, **kw):
    a[5] = a[5]._replace(**kw)


@pytest.mark.parametrize("change,exc,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int64)), TypeError, "cnt"),
    (lambda a: _replace_table(a, pair_packed=a[5].pair_packed.float()),
     TypeError, "pair_packed"),
    (lambda a: a.__setitem__(1, a[1][:-1].clone()), ValueError, "shaped"),
    (lambda a: a.__setitem__(3, a[3][:0]), ValueError, "row_start_p"),
    (lambda a: a.__setitem__(4, torch.zeros(2, dtype=torch.int32)),
     ValueError, "row_tot"),
    (lambda a: a.__setitem__(2, torch.stack([a[2], a[2]], 1)[:, 0]),
     ValueError, "contiguous"),
])
def test_k2_wrapper_checks_arguments(change, exc, match):
    args = _cpu_args()
    fast_tally._check(*args, 10, 30)
    change(args)
    with pytest.raises(exc, match=match):
        fast_tally._check(*args, 10, 30)


@pytest.mark.parametrize("n_model,vote_cap,match", [(0, 1 << 16, "n_model"),
                                                    (10, 1 << 31,
                                                     "vote_cap")])
def test_k2_wrapper_checks_sizes(n_model, vote_cap, match):
    args = _cpu_args()
    args[7] = vote_cap
    with pytest.raises(ValueError, match=match):
        fast_tally._check(*args, n_model, 30)


@pytest.mark.parametrize("vote_cap,R,want", [
    (83_886_080, 4_992, 1),   # UWA-analog para: 16,804 slots a row
    (58_720_256, 564, 3),     # the bench scene through the fallback engine
    (1 << 30, 8, 8),          # clipped to the portable cluster size
    (8192, 64, 1),            # fewer slots than reference rows
])
def test_k2_cluster_size(vote_cap, R, want):
    assert fast_tally.cluster_size(vote_cap, R) == want


def _jax_pair_intermediates(sk, fj, vote_cap, chunk):
    """row_start_p, total_p, total and overflow as the JAX package's
    cast_votes_fast computes them (voting_fast.py:255-294), recomputed here
    with its own lookup from the same keys."""
    R, n = sk.shape
    S = R * n
    keys = jnp.asarray(sk).reshape(-1)
    valid = keys != jppf.INVALID_KEY
    safe = jnp.where(valid, keys, 0)
    S_pad = jvf._ceil_to(S, 128)
    keys_q = jvf._as_q(jnp.concatenate(
        [safe, jnp.zeros((S_pad - S,), jnp.int32)]), S_pad)
    if fj.cnt_off is not None:
        co = jvf.packed_lookup(fj.cnt_off, keys_q).reshape(-1)[:S]
        cnt_q = (co & jnp.uint32((1 << jvf.CNT_BITS) - 1)).astype(jnp.int32)
    else:
        cnt_q = jvf.packed_lookup(fj.counts, keys_q).reshape(-1)[:S]
    cnt = jnp.where(valid, cnt_q, 0)
    row_tot = jnp.sum(cnt.reshape(R, n), axis=1)
    row_tot_p = row_tot + (-row_tot) % chunk
    row_start_p = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                   jnp.cumsum(row_tot_p,
                                              dtype=jnp.int32)[:-1]])
    row_cum = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(row_tot, dtype=jnp.int32)[:-1]])
    total_p = row_start_p[-1] + row_tot_p[-1]
    total = row_cum[-1] + row_tot[-1]
    return (np.asarray(row_start_p), int(total_p), int(total),
            bool(total_p > vote_cap))


@pytest.mark.parametrize("seed,unpacked,vote_cap,chunk", [
    (0, False, 1 << 16, 256),
    (1, True, 1 << 16, 256),          # force_unpacked
    (3, False, 1 << 10, 512),         # overflowed cap
    (2, False, 1 << 16, 128),
])
def test_pair_lookup_matches_jax_intermediates(seed, unpacked, vote_cap,
                                               chunk):
    mk, ma, sk, sa, nk, _ = _keyed(seed)
    sk[2, :] = jppf.INVALID_KEY                       # an empty row
    fj, ft = _tables(mk, ma, nk, unpacked)
    vote_cap = tvf._ceil_to(vote_cap, max(128, chunk))
    pl = tvf._pair_lookup(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                          vote_cap, chunk)
    row_start_p, total_p, total, overflow = _jax_pair_intermediates(
        sk, fj, vote_cap, chunk)
    np.testing.assert_array_equal(pl.row_start_p.numpy(), row_start_p)
    assert int(pl.total_p) == total_p
    assert int(pl.total) == total
    assert bool(pl.overflow) == overflow
    assert int(pl.row_tot[2]) == 0
    assert int(pl.cnt.sum()) == total


def _segment_cut_cap(sk, sa, ft, chunk):
    """A vote_cap, a multiple of max(128, chunk), that falls strictly
    inside one scene pair's vote segment."""
    fv = tvf.expand_fast(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                         D_ANGLE, 1 << 16, chunk)
    cnt = tvf._pair_lookup(torch.from_numpy(sk), torch.from_numpy(sa), ft,
                           1 << 16, chunk).cnt
    heads, tails = fv.heads.numpy(), (fv.heads + cnt).numpy()
    step = max(128, chunk)
    for cap in range(step, int(fv.total_p), step):
        if np.any((heads < cap) & (cap < tails)):
            return cap
    raise AssertionError("no capacity cuts a segment")


@pytest.mark.parametrize("seed,n_m,unpacked,vote_cap,chunk,empty_rows", [
    (3, 30, False, 1 << 10, 512, ()),         # overflowed cap
    # A cap that cuts a segment: rows of about 95 votes in 64-vote chunks,
    # so some rows run past a multiple of 128.
    (4, 60, False, None, 64, ()),
    (1, 30, True, 1 << 16, 256, ()),          # force_unpacked
    (5, 30, False, 1 << 16, 256, (0, 4, -1)),  # empty rows, empty tail
    (6, 60, True, None, 64, (2,)),            # unpacked, cut segment
])
def test_fast_tally_plain_pairs_bit_equal(seed, n_m, unpacked, vote_cap,
                                          chunk, empty_rows):
    """K2's plain version on the per-pair arrays equals the per-slot route
    (expand_fast, then fast_tally_plain) and the JAX package's
    cast_votes_fast."""
    mk, ma, sk, sa, nk, n_m = _keyed(seed, n_m=n_m)
    for r in empty_rows:
        sk[r, :] = jppf.INVALID_KEY
    fj, ft = _tables(mk, ma, nk, unpacked)
    if vote_cap is None:
        vote_cap = _segment_cut_cap(sk, sa, ft, chunk)
    skt, sat = torch.from_numpy(sk), torch.from_numpy(sa)
    pl = tvf._pair_lookup(skt, sat, ft, vote_cap, chunk)
    n_angle = int(round(2 * math.pi / D_ANGLE))
    got = fast_tally.fast_tally_plain_pairs(
        pl.cnt, pl.off, pl.alpha_fix, pl.row_start_p, pl.row_tot, ft,
        sk.shape[1], vote_cap, n_m, n_angle)
    fv = tvf.expand_fast(skt, sat, ft, D_ANGLE, vote_cap, chunk)
    slots = fast_tally.fast_tally_plain(fv.m_r, fv.a_bin, fv.vote_ok,
                                        fv.row_start_p, fv.total_p, n_m,
                                        chunk)
    assert torch.equal(got, slots)
    rt = _cast_both(sk, sa, fj, ft, n_m, vote_cap, chunk)
    assert torch.equal(got, rt.accumulator)
    for r in empty_rows:
        assert int(got[r].sum()) == 0
    if bool(pl.overflow):
        assert int(got.sum()) < int(pl.total)
    else:
        assert int(got.sum()) == int(pl.total)


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


def test_fused_tally_large_bucket_matches_per_slot_route():
    """On the planar model of test_unpacked_large_bucket_tallies_every_vote
    (a key bucket of 6,988 pairs, unpacked tables), K2's plain version on
    the per-pair arrays tallies what the port's per-slot routes tally: the
    chunked tally of expand_fast's arrays and the scatter tally."""
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
    sk, sa = (torch.from_numpy(np.array(x)) for x in
              jppf.pairwise_ppf_keys(mp[:20], mn[:20], 0.5, D_ANGLE, 8))
    chunk = 256
    vote_cap = tvf._ceil_to(3_000_000, chunk)
    pl = tvf._pair_lookup(sk, sa, ft, vote_cap, chunk)
    assert int(pl.cnt.max()) >= 1 << tvf.CNT_BITS
    fused = fast_tally.fast_tally(pl.cnt, pl.off, pl.alpha_fix,
                                  pl.row_start_p, pl.row_tot, ft,
                                  sk.shape[1], vote_cap, n, 30)
    fv = tvf.expand_fast(sk, sa, ft, D_ANGLE, vote_cap, chunk)
    slots = fast_tally.fast_tally_plain(fv.m_r, fv.a_bin, fv.vote_ok,
                                        fv.row_start_p, fv.total_p, n, chunk)
    scatter = tvf.cast_votes_fast(sk, sa, ft, n, D_ANGLE, vote_cap,
                                  chunk=chunk, use_mxu_tally=False)
    assert not bool(pl.overflow)
    assert torch.equal(fused, slots)
    assert torch.equal(fused, scatter.accumulator)
    assert int(fused.sum()) == int(pl.total)
