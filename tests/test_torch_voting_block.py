"""Port block-expansion engine and the K1 plain tally against the JAX
package on the same arrays: block tables (pair2d as uint32 bits),
cast_votes_block accumulator / num_votes / overflowed, and the K1 plain
version against the JAX CPU twin of _tally — all bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import ppf as jppf, voting as jv, \
    voting_block as jvb
from objective_slam_tpu_torch.ops import block_tally, voting as tv, \
    voting_block as tvb, voting_fast as tvf

D_ANGLE = 2 * math.pi / 30
N_ANGLE = 30


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _keyed(seed, n_m=24, n_s=40, d_dist=0.5, ref_point_df=1, plant=False):
    """JAX model and scene keys/α (the inputs of tests/test_voting_block.py);
    plant=True puts the model's points into the scene, so that many scene
    pairs match."""
    rng = np.random.default_rng(seed)
    mp, mn = rng.normal(size=(n_m, 3)).astype(np.float32), _unit(rng, (n_m, 3))
    sp, sn = rng.normal(size=(n_s, 3)).astype(np.float32), _unit(rng, (n_s, 3))
    if plant:
        sp, sn = np.concatenate([sp, mp]), np.concatenate([sn, mn])
        n_s += n_m
    max_bin = 32
    nk = jppf.num_keys(max_bin)
    mk, ma = (np.array(x) for x in
              jppf.pairwise_ppf_keys(mp, mn, d_dist, D_ANGLE, max_bin))
    ref = np.arange(0, n_s, ref_point_df, dtype=np.int32)
    sk, sa = (np.array(x) for x in
              jppf.pairwise_ppf_keys(sp, sn, d_dist, D_ANGLE, max_bin,
                                     ref_indices=ref))
    return mk, ma, sk, sa, nk, n_m


def _both_tables(mk, ma, nk):
    tj = jv.build_key_table(jnp.asarray(mk), jnp.asarray(ma), nk)
    tt = tv.build_key_table(torch.from_numpy(mk), torch.from_numpy(ma), nk)
    return tj, tt, jvb.build_block_tables(tj), tvb.build_block_tables(tt)


def test_block_tables_bit_equal():
    mk, ma, _, _, nk, _ = _keyed(0)
    _, _, bj, bt = _both_tables(mk, ma, nk)
    assert bt.k_occ == bj.k_occ and bt.n_rows == bj.n_rows
    np.testing.assert_array_equal(bt.occ_keys.numpy(),
                                  np.asarray(bj.occ_keys))
    np.testing.assert_array_equal(bt.occ_vals.numpy(),
                                  np.asarray(bj.occ_vals))
    np.testing.assert_array_equal(bt.pair2d.numpy().view(np.uint32),
                                  np.asarray(bj.pair2d))


def _cast_both(sk, sa, bj, bt, n_m, vote_cap, seg_cap=None, chunk_rows=64):
    rj = jvb.cast_votes_block(jnp.asarray(sk), jnp.asarray(sa), bj, n_m,
                              D_ANGLE, vote_cap, chunk_rows=chunk_rows,
                              seg_cap=seg_cap)
    rt = tvb.cast_votes_block(torch.from_numpy(sk), torch.from_numpy(sa), bt,
                              n_m, D_ANGLE, vote_cap, chunk_rows=chunk_rows,
                              seg_cap=seg_cap)
    assert int(rt.num_votes) == int(rj.num_votes)
    assert bool(rt.overflowed) == bool(rj.overflowed)
    np.testing.assert_array_equal(rt.accumulator.numpy(),
                                  np.asarray(rj.accumulator))
    return rt


@pytest.mark.parametrize(
    "seed,n_s,ref_df,vote_cap,seg_cap,chunk_rows,overflows", [
        (0, 40, 1, 1 << 18, None, 64, False),
        (1, 33, 4, 1 << 18, None, 64, False),    # ref_point_df > 1
        (2, 40, 1, 128, None, 64, True),         # vote_cap overflow
        (3, 40, 1, 1 << 18, 128, 64, True),      # seg_cap overflow
        (5, 40, 2, 1 << 18, 1024, 64, False),    # planted, seg_cap room
        # chunk_rows 1: no padding, so a row's first segment starts at the
        # previous row's last tail and the fills must not carry across.
        (6, 30, 1, 1 << 18, None, 1, False),
    ])
def test_cast_votes_block_bit_equal(seed, n_s, ref_df, vote_cap, seg_cap,
                                    chunk_rows, overflows):
    mk, ma, sk, sa, nk, n_m = _keyed(seed, n_s=n_s, ref_point_df=ref_df,
                                     plant=seed >= 3)
    _, _, bj, bt = _both_tables(mk, ma, nk)
    rt = _cast_both(sk, sa, bj, bt, n_m, vote_cap, seg_cap, chunk_rows)
    assert bool(rt.overflowed) == overflows


def test_block_vs_readable_engine_same_flips():
    """The fixed-point block engine and the float32 readable engine bin a
    few boundary votes differently (PARITY.md §9); on the same arrays the
    port must move exactly the votes the JAX package moves."""
    mk, ma, sk, sa, nk, n_m = _keyed(4, plant=True)
    tj, tt, bj, bt = _both_tables(mk, ma, nk)
    skt, sat = torch.from_numpy(sk), torch.from_numpy(sa)
    rb = tvb.cast_votes_block(skt, sat, bt, n_m, D_ANGLE, 1 << 18)
    rr = tv.cast_votes(skt, sat, tt, n_m, D_ANGLE, 1 << 18)
    jb = jvb.cast_votes_block(jnp.asarray(sk), jnp.asarray(sa), bj, n_m,
                              D_ANGLE, 1 << 18)
    jr = jv.cast_votes(jnp.asarray(sk), jnp.asarray(sa), tj, n_m, D_ANGLE,
                       1 << 18)
    assert int(rb.num_votes) == int(rr.num_votes) == int(jr.num_votes)
    np.testing.assert_array_equal(
        (rb.accumulator - rr.accumulator).numpy(),
        np.asarray(jb.accumulator) - np.asarray(jr.accumulator))


def test_exact_full_vote_cap_empty_trailing_row():
    """Mirror of test_block_exact_full_vote_cap_bit_equal: vote_cap sized
    exactly to the padded rows, the last reference row empty (its start
    equals row_cap and must drop out of the row map)."""
    rng = np.random.default_rng(7)
    n_m, n_s, nk = 40, 36, 4096
    mk = rng.integers(0, nk, size=(n_m, n_m)).astype(np.int32)
    ma = rng.uniform(-math.pi, math.pi, size=(n_m, n_m)).astype(np.float32)
    sk = rng.integers(0, nk, size=(n_s, n_s)).astype(np.int32)
    sk[-1, :] = jppf.INVALID_KEY
    sa = rng.uniform(-math.pi, math.pi, size=(n_s, n_s)).astype(np.float32)
    tj, tt, bj, bt = _both_tables(mk, ma, nk)
    probe = tvb._expand(torch.from_numpy(sk), torch.from_numpy(sa), bt,
                        1 << 20, tvb.CHUNK_ROWS)
    total_rows_p = int(probe[5])
    assert total_rows_p == int(jvb._expand(
        jnp.asarray(sk), jnp.asarray(sa), bj, 1 << 20, jvb.CHUNK_ROWS)[6])
    assert total_rows_p % tvb.CHUNK_ROWS == 0
    vote_cap = total_rows_p * tvb.LANES
    rt = _cast_both(sk, sa, bj, bt, n_m, vote_cap)
    assert not bool(rt.overflowed)
    assert int(rt.accumulator[-1].sum()) == 0
    rr = tv.cast_votes(torch.from_numpy(sk), torch.from_numpy(sa), tt, n_m,
                       D_ANGLE, 1 << 20)
    np.testing.assert_array_equal(rt.accumulator.numpy(),
                                  rr.accumulator.numpy())


@pytest.mark.parametrize("starts,R,n_chunks", [
    ([0, 16], 2, 4),          # empty trailing row at a full buffer's end
    ([0, 0, 8], 3, 4),        # empty middle row shares row 1's start
    ([0, 4, 4, 12], 4, 5),    # empty row 1, slack chunk at the end
])
def test_chunk_row_map_matches_jax(starts, R, n_chunks):
    """Mirror of test_chunk_row_map_full_buffer_empty_trailing_row."""
    cj, sj = jvb._chunk_row_map(jnp.asarray(starts, jnp.int32), R=R,
                                chunk_rows=4, n_chunks=n_chunks)
    ct, st = block_tally._chunk_row_map(torch.tensor(starts, dtype=torch.int32),
                                        R, 4, n_chunks)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _tally_inputs(rng, n_model, row_cap, chunk_rows, row_sizes):
    """pp words with sentinels, α rows and chunk-aligned row starts; rows
    past the live count hold only sentinels, as _expand leaves them."""
    m = rng.integers(0, n_model, size=(row_cap, 128)).astype(np.uint32)
    a_m = rng.integers(0, 1 << 22, size=(row_cap, 128)).astype(np.uint32)
    pp = (m << 22) | a_m
    pp[rng.random((row_cap, 128)) < 0.2] = 0xFFFFFFFF
    live = sum(row_sizes) * chunk_rows
    pp[live:] = 0xFFFFFFFF
    alpha_row = rng.integers(0, 1 << 22, size=row_cap).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(row_sizes)[:-1]]) * chunk_rows
    return (pp.view(np.int32), alpha_row, starts.astype(np.int32),
            np.int32(live))


@pytest.mark.parametrize("R,n_model,n_chunks,row_sizes", [
    (5, 24, 8, [2, 0, 3, 1, 2]),         # empty middle row
    (4, 100, 6, [3, 3, 0, 0]),           # full buffer, empty trailing rows
    (3, 1023, 4, [1, 2, 1]),             # n_model at the budget edge
    (6, 200, 8, [0, 0, 4, 1, 1, 0]),     # empty leading rows, slack chunks
])
def test_k1_plain_matches_jax_twin(R, n_model, n_chunks, row_sizes):
    """The K1 plain version against the JAX CPU twin of _tally on the same
    pp / alpha_row / row_start_p / total_rows_p."""
    chunk_rows = 4
    rng = np.random.default_rng(R * 1000 + n_model)
    row_cap = n_chunks * chunk_rows
    pp, alpha_row, starts, live = _tally_inputs(rng, n_model, row_cap,
                                                chunk_rows, row_sizes)
    want = jvb._tally(jnp.asarray(pp.view(np.uint32)), jnp.asarray(alpha_row),
                      r_of_chunk_start=jnp.asarray(starts), R=R,
                      n_model=n_model, d_angle=D_ANGLE,
                      chunk_rows=chunk_rows, row_cap=row_cap,
                      total_rows_p=jnp.asarray(live))
    got = block_tally.block_tally(
        torch.from_numpy(pp), torch.from_numpy(alpha_row),
        torch.from_numpy(starts), torch.tensor(live), n_model, N_ANGLE)
    assert got.dtype == torch.int32 and got.shape == (R, n_model, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k1_plain_skips_rows_past_live():
    """Rows at or past total_rows_p are not tallied (the TPU kernel's
    `live` predicate), whatever they hold; a live count past row_cap (an
    overflowed buffer) reads to row_cap."""
    rng = np.random.default_rng(10)
    pp, alpha_row, starts, live = _tally_inputs(rng, 50, 32, 4, [2, 3, 1])
    pp_t, a_t, s_t = (torch.from_numpy(x) for x in (pp, alpha_row, starts))
    base = block_tally.block_tally(pp_t, a_t, s_t, torch.tensor(live), 50,
                                   N_ANGLE)
    pp_t[live:] = 5 << 22                        # real words past live
    assert torch.equal(block_tally.block_tally(
        pp_t, a_t, s_t, torch.tensor(live), 50, N_ANGLE), base)
    more = block_tally.block_tally(pp_t, a_t, s_t, torch.tensor(1 << 20), 50,
                                   N_ANGLE)
    assert int(more.sum() - base.sum()) == (32 - live) * 128
    assert int(more[-1, 5].sum() - base[-1, 5].sum()) == (32 - live) * 128


def test_k1_wrapper_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(np.asarray(x))
            for x in _tally_inputs(rng, 10, 8, 4, [1, 1])]
    before = block_tally.launches
    out = block_tally.block_tally(*args, 10, N_ANGLE)
    assert block_tally.launches == before
    np.testing.assert_array_equal(
        out.numpy(), block_tally.block_tally_plain(*args, 10, N_ANGLE).numpy())


@pytest.mark.parametrize("n_model,ok", [(1, True), (1023, True), (0, False),
                                        (1024, False)])
def test_k1_wrapper_checks_model_width(n_model, ok):
    """The kernel path takes every model the block engine builds tables
    for (n_model <= 1023, m = 1023 being the sentinel) and no wider."""
    args = [torch.from_numpy(np.asarray(x)) for x in
            _tally_inputs(np.random.default_rng(2), 1, 8, 4, [1, 1])]
    if ok:
        block_tally._check(*args, n_model, N_ANGLE)
    else:
        with pytest.raises(ValueError, match="n_model"):
            block_tally._check(*args, n_model, N_ANGLE)


def test_budget_decline_raises():
    """A model over the block budgets gets no block tables, in both
    packages, and build_fast_tables no longer raises for it: it builds the
    fallback engine's tables (kernel K2's path) instead."""
    mk, ma, _, _, nk, _ = _keyed(0)
    _, tt, _, _ = _both_tables(mk, ma, nk)
    assert tvb.build_block_tables(tt, max_kocc=1) is None
    assert jvb.build_block_tables(
        jv.build_key_table(jnp.asarray(mk), jnp.asarray(ma), nk),
        max_kocc=1) is None
    big = tt._replace(pair_mr=torch.full_like(tt.pair_mr, 1023))
    ft = tvf.build_fast_tables(big)
    assert ft.block is None
    assert ft.cnt_off is not None and ft.pair_packed is not None
