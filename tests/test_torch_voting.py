"""Port key table, readable vote engine, saturating total and top-K
against the JAX package on the same arrays. All integer outputs are
compared bit for bit; top_votes ties must resolve as lax.top_k does
(lower flat index first) on both the small and the block-max path."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import ppf as jppf, voting as jv
from objective_slam_tpu_torch.ops import voting as tv

D_ANGLE = 2 * math.pi / 30


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def keyed():
    """JAX-computed model and scene keys/α (both packages get these)."""
    rng = np.random.default_rng(21)
    mp, mn = rng.normal(size=(40, 3)).astype(np.float32), _unit(rng, (40, 3))
    sp, sn = rng.normal(size=(70, 3)).astype(np.float32), _unit(rng, (70, 3))
    max_bin = 24
    mk, ma = (np.array(x) for x in
              jppf.pairwise_ppf_keys(mp, mn, 0.45, D_ANGLE, max_bin))
    ref = np.arange(0, 70, 2, dtype=np.int32)
    sk, sa = (np.array(x) for x in
              jppf.pairwise_ppf_keys(sp, sn, 0.45, D_ANGLE, max_bin,
                                     ref_indices=ref))
    return mk, ma, sk, sa, jppf.num_keys(max_bin)


def _tables(keyed):
    mk, ma, _, _, nk = keyed
    return (jv.build_key_table(jnp.asarray(mk), jnp.asarray(ma), nk),
            tv.build_key_table(torch.from_numpy(mk), torch.from_numpy(ma),
                               nk))


def test_build_key_table_bit_equal(keyed):
    tj, tt = _tables(keyed)
    for f in tj._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)


@pytest.mark.parametrize("cap", [1 << 16, 1 << 20, 4096])
def test_cast_votes_bit_equal(keyed, cap):
    """Readable engine: accumulator, num_votes and overflowed equal,
    including an overflowing capacity (4096)."""
    _, _, sk, sa, _ = keyed
    tj, tt = _tables(keyed)
    rj = jv.cast_votes(jnp.asarray(sk), jnp.asarray(sa), tj, 40, D_ANGLE, cap)
    rt = tv.cast_votes(torch.from_numpy(sk), torch.from_numpy(sa), tt, 40,
                       D_ANGLE, cap)
    assert int(rt.num_votes) == int(rj.num_votes)
    assert bool(rt.overflowed) == bool(rj.overflowed)
    np.testing.assert_array_equal(rt.accumulator.numpy(),
                                  np.asarray(rj.accumulator))


@pytest.mark.parametrize("rows", [
    np.asarray([0, 1, 65535, 65536, 123456], np.int32),
    np.full((100_000,), 20_000, np.int32),
    np.full((150_000,), 20_000, np.int32),
    np.random.default_rng(3).integers(0, 1 << 20, 5000).astype(np.int32)])
def test_saturating_total(rows):
    want = int(jv.saturating_total(jnp.asarray(rows)))
    got = tv.saturating_total(torch.from_numpy(rows))
    assert got.dtype == torch.int32
    assert int(got) == want
    if rows.size == 150_000:
        assert want == 2 ** 31 - 1


def _top_both(acc, thresh, max_poses):
    tj = jv.top_votes(jnp.asarray(acc), thresh, max_poses)
    tt = tv.top_votes(torch.from_numpy(acc), thresh, max_poses)
    for f in tj._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    return tt


@pytest.mark.parametrize("shape,max_poses,levels", [
    ((2, 3, 32), 8, 4),          # small path (n <= 512)
    ((4, 6, 32), 16, 3),         # small path (n <= 64·max_poses)
    ((64, 64, 32), 4, 5),        # block-max path, few poses
    ((48, 40, 32), 64, 3),       # block-max path, many ties per block
])
def test_top_votes_ties_element_for_element(shape, max_poses, levels):
    """Accumulators with few distinct values: most selected cells tie."""
    rng = np.random.default_rng(sum(shape) + max_poses)
    acc = rng.integers(0, levels, size=shape).astype(np.int32) * 7
    _top_both(acc, 0.4, max_poses)


def test_top_votes_hierarchical_sparse_ties():
    """Equal peaks spread over more blocks than max_poses (saturated)."""
    R, n_m, A = 64, 64, 32
    acc = np.zeros((R * n_m * A,), np.int32)
    acc[np.linspace(0, acc.size - 1, 40).astype(np.int64)] = 100
    tt = _top_both(acc.reshape(R, n_m, A), 0.4, 4)
    assert bool(tt.saturated)


def test_top_votes_max_poses_exceeds_accumulator():
    """Mirror of test_voting.py::test_top_votes_max_poses_exceeds_
    accumulator: k clamps to the accumulator and pads with keep=False."""
    acc = np.zeros((4, 3, 32), np.int32)
    acc[1, 2, 5] = 9
    tt = _top_both(acc, 0.4, 1024)
    assert tt.counts.shape == (1024,)
    assert int(tt.counts[0]) == 9 and bool(tt.keep[0])
    assert int(tt.keep.sum()) == 1
    assert not bool(tt.saturated)
