"""The port's FNV-1a hashing and FNV keying mode against the JAX package on
the same arrays: hashes, the remap dictionary and the remapped ranks are
bit-equal (the port carries uint32 values in int64 tensors), and against a
byte-level FNV-1a (tests/reference_impl.py). Mirrors of the hashing cases
of tests/test_ppf.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from objective_slam_tpu.ops import hashing as jh, ppf as jppf
from objective_slam_tpu_torch.ops import hashing as th, ppf as tppf

D_ANGLE = 2 * math.pi / 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    return pts, nrm


def _u32(t):
    """An int64 hash tensor as the uint32 array the JAX package returns."""
    a = t.numpy()
    assert a.dtype == np.int64 and (a >= 0).all() and (a < 2 ** 32).all()
    return a.astype(np.uint32)


def test_fnv1a_float4_bit_parity():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(50, 4)).astype(np.float32)
    f[0] = [0.0, -0.0, np.inf, -1.5]            # sign bit set: bits >= 2^31
    got = _u32(th.fnv1a_float4(torch.from_numpy(f)))
    np.testing.assert_array_equal(got, np.asarray(jh.fnv1a_float4(f)))
    for i in range(50):
        assert int(got[i]) == ref.fnv1a_bytes(f[i].tobytes())


def test_fnv1a_int3_bit_parity():
    rng = np.random.default_rng(1)
    v = rng.integers(-100, 100, size=(50, 3)).astype(np.int32)
    got = _u32(th.fnv1a_int3(torch.from_numpy(v)))
    np.testing.assert_array_equal(got, np.asarray(jh.fnv1a_int3(v)))
    for i in range(50):
        assert int(got[i]) == ref.fnv1a_bytes(v[i].tobytes())


def test_fnv1a_words_bit_parity():
    rng = np.random.default_rng(2)
    w = rng.integers(0, 2 ** 32, size=(7, 9, 5), dtype=np.uint64)
    got = _u32(th.fnv1a_words(torch.from_numpy(w.astype(np.int64))))
    want = np.asarray(jh.fnv1a_words(jnp.asarray(w.astype(np.uint32))))
    np.testing.assert_array_equal(got, want)


def test_packed_key_fnv_matches_quantized_feature_hash():
    """Mirror of the JAX package's test: hashing bin·step equals hashing
    the quantized feature floats (disc_feature of compute_ppf), and the
    port's hashes equal the JAX package's on the same keys."""
    pts, nrm = _cloud(np.random.default_rng(3), 24)
    d_dist = 0.3
    keys = np.array(jppf.pairwise_ppf_keys(pts, nrm, d_dist, D_ANGLE,
                                           64)[0])
    got = _u32(th.packed_key_fnv(torch.from_numpy(keys), d_dist, D_ANGLE))
    np.testing.assert_array_equal(
        got, np.asarray(jh.packed_key_fnv(keys, d_dist, D_ANGLE)))
    p, n = torch.from_numpy(pts), torch.from_numpy(nrm)
    f = tppf.compute_ppf(p[:, None, :], n[:, None, :], p[None, :, :],
                         n[None, :, :])
    q = tppf.disc_feature(f, d_dist, D_ANGLE)
    # The port's own keys decide which of its quantized features to hold
    # the hashes against (an arccos ulp may move a JAX key over a bin edge).
    own = tppf.pairwise_ppf_keys(p, n, d_dist, D_ANGLE, 64)[0]
    own_h = _u32(th.packed_key_fnv(own, d_dist, D_ANGLE))
    valid = own.numpy() != tppf.INVALID_KEY
    np.testing.assert_array_equal(own_h[valid],
                                  _u32(th.fnv1a_float4(q))[valid])
    assert (own_h[~valid] == 0).all()
    print("keys equal to the JAX package's:",
          float((own.numpy() == keys).mean()))


def test_fnv_remap_bit_equal():
    """The remap dictionary (uint32 in the JAX package, int64 here, same
    values, pads and k_occ) and the remapped scene ranks."""
    rng = np.random.default_rng(4)
    mp, mn = _cloud(rng, 30)
    sp, sn = _cloud(rng, 20)
    sp, sn = np.concatenate([sp, mp]), np.concatenate([sn, mn])
    mk = np.array(jppf.pairwise_ppf_keys(mp, mn, 0.5, D_ANGLE, 32)[0])
    sk = np.array(jppf.pairwise_ppf_keys(sp, sn, 0.5, D_ANGLE, 32)[0])
    rj = jh.build_fnv_remap(mk, 0.5, D_ANGLE)
    rt = th.build_fnv_remap(torch.from_numpy(mk), 0.5, D_ANGLE)
    assert rt.k_occ == rj.k_occ and rt.k_occ % 128 != 0
    np.testing.assert_array_equal(_u32(rt.occ_hashes),
                                  np.asarray(rj.occ_hashes))
    for keys in (mk, sk):
        got = th.fnv_remap_keys(torch.from_numpy(keys), rt, 0.5, D_ANGLE)
        assert got.dtype == torch.int32
        want = np.asarray(jh.fnv_remap_keys(keys, rj, 0.5, D_ANGLE))
        np.testing.assert_array_equal(got.numpy(), want)
    ranks = th.fnv_remap_keys(torch.from_numpy(sk), rt, 0.5, D_ANGLE).numpy()
    hit = ranks != tppf.INVALID_KEY
    assert hit.any() and (~hit).any() and ranks[hit].max() < rt.k_occ


def test_fnv_remap_pad_rows_never_match():
    """Pad rows repeat the last hash; a key with that hash still gets the
    rank of its first occurrence, below k_occ. Hash 0 never matches."""
    keys = torch.tensor([[5, 17, 300]], dtype=torch.int32)
    remap = th.build_fnv_remap(keys, 0.25, D_ANGLE)
    assert remap.k_occ == 3 and remap.occ_hashes.shape == (128,)
    assert (remap.occ_hashes[3:] == remap.occ_hashes[2]).all()
    ranks = th.fnv_remap_keys(keys, remap, 0.25, D_ANGLE)[0].tolist()
    assert sorted(ranks) == [0, 1, 2]
    probe = torch.tensor([tppf.INVALID_KEY, 23], dtype=torch.int32)
    assert th.fnv_remap_keys(probe, remap, 0.25, D_ANGLE).tolist() == \
        [tppf.INVALID_KEY] * 2
    empty = th.build_fnv_remap(torch.tensor([tppf.INVALID_KEY]), 0.25,
                               D_ANGLE)
    assert empty.k_occ == 0
    assert th.fnv_remap_keys(probe, empty, 0.25, D_ANGLE).tolist() == \
        [tppf.INVALID_KEY] * 2


def test_fnv_remap_conflates_collisions():
    """Mirror of the JAX package's brute-forced collision: two packed keys
    with one hash share a rank, in both packages."""
    d_dist, max_db = 0.25, 60
    n_keys = jppf.num_keys(max_db)
    all_keys = torch.arange(n_keys, dtype=torch.int32)
    h = _u32(th.packed_key_fnv(all_keys, d_dist, D_ANGLE))
    np.testing.assert_array_equal(h, np.asarray(jh.packed_key_fnv(
        jnp.arange(n_keys, dtype=jnp.int32), d_dist, D_ANGLE)))
    order = np.argsort(h, kind="stable")
    hs = h[order]
    dup = np.nonzero((hs[1:] == hs[:-1]) & (hs[1:] != 0))[0]
    if len(dup) == 0:
        pytest.skip("no FNV collision in this key space")
    k1, k2 = int(order[dup[0]]), int(order[dup[0] + 1])
    assert k1 != k2 and h[k1] == h[k2]
    model_keys = np.asarray([[k1, k2, 17]], np.int32)
    rt = th.build_fnv_remap(torch.from_numpy(model_keys), d_dist, D_ANGLE)
    rj = jh.build_fnv_remap(model_keys, d_dist, D_ANGLE)
    assert rt.k_occ == rj.k_occ == 2
    rk = th.fnv_remap_keys(torch.from_numpy(model_keys), rt, d_dist,
                           D_ANGLE).numpy()[0]
    np.testing.assert_array_equal(rk, np.asarray(jh.fnv_remap_keys(
        model_keys, rj, d_dist, D_ANGLE))[0])
    assert rk[0] == rk[1] and rk[2] != rk[0]
    probe = torch.tensor([[k1, 23]], dtype=torch.int32)
    rp = th.fnv_remap_keys(probe, rt, d_dist, D_ANGLE)[0].tolist()
    assert rp == [int(rk[0]), tppf.INVALID_KEY]


def test_fnv_rank_table_equals_per_pair_remap():
    """The matcher's route (hash the packed key space once, then gather)
    gives the ranks of the per-pair route, which are the JAX package's."""
    rng = np.random.default_rng(5)
    mp, mn = _cloud(rng, 30)
    mk = np.array(jppf.pairwise_ppf_keys(mp, mn, 0.5, D_ANGLE, 32)[0])
    remap = th.build_fnv_remap(torch.from_numpy(mk), 0.5, D_ANGLE)
    table = th.fnv_rank_table(remap, tppf.num_keys(32), 0.5, D_ANGLE)
    assert table.dtype == torch.int32 and table.shape == (tppf.num_keys(32),)
    valid = torch.from_numpy(mk != tppf.INVALID_KEY)
    want = th.fnv_remap_keys(torch.from_numpy(mk), remap, 0.5, D_ANGLE)
    safe = torch.where(valid, torch.from_numpy(mk), 0).long()
    got = torch.where(valid, table[safe], tppf.INVALID_KEY)
    assert torch.equal(got, want)
    assert int((table != tppf.INVALID_KEY).sum()) >= remap.k_occ
