"""Port transforms and PPF keys against the JAX package on the same arrays.

Tolerances: transforms agree to float32 rounding (atol 1e-5 on unit-scale
values: XLA and torch may order or fuse the float32 products differently).
PPF keys are bins of arccos/division results, which may differ by an ulp
between the frameworks; they are held as an equality rate of at least
1 − 1e-4 (printed), and α to 1e-5 rad where the keys agree. Invalid and
self pairs are decided by integer rules and must agree exactly.
"""

import math

import numpy as np
import pytest
import torch

from objective_slam_tpu.ops import ppf as jppf, transforms as jtr
from objective_slam_tpu.utils import pointcloud as jpc
from objective_slam_tpu_torch.ops import ppf as tppf, transforms as ttr

D_ANGLE = 2 * math.pi / 30
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(11)
    beta = rng.uniform(-math.pi, math.pi, 64).astype(np.float32)
    gamma = rng.uniform(-math.pi, math.pi, 64).astype(np.float32)
    R = np.asarray(jtr.canonical_rotation(beta, gamma))
    T = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(64, 3))
    return rng, beta, gamma, T


def test_canonical_angles_and_rotation(poses):
    rng, beta, gamma, _ = poses
    p = rng.normal(size=(64, 3)).astype(np.float32)
    n = _unit(rng, (64, 3))
    for a, b in zip(jtr.canonical_angles(p, n),
                    ttr.canonical_angles(_t(p), _t(n))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    np.testing.assert_allclose(
        ttr.canonical_rotation(_t(beta), _t(gamma)).numpy(),
        np.asarray(jtr.canonical_rotation(beta, gamma)), atol=ATOL)


def test_quaternions_and_inverse(poses):
    _, _, _, T = poses
    qj = np.asarray(jtr.hrotmat2quat(T))
    qt = ttr.hrotmat2quat(_t(T)).numpy()
    np.testing.assert_allclose(qt, qj, atol=ATOL)
    np.testing.assert_allclose(ttr.quat2hrotmat(_t(qj)).numpy(),
                               np.asarray(jtr.quat2hrotmat(qj)), atol=ATOL)
    np.testing.assert_allclose(ttr.invht(_t(T)).numpy(),
                               np.asarray(jtr.invht(T)), atol=ATOL)
    p = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(ttr.transform_points(_t(T), _t(p)).numpy(),
                               np.asarray(jtr.transform_points(T, p)),
                               atol=ATOL)


def test_ht_dist(poses):
    _, _, _, T = poses
    T2 = T[::-1].copy()
    for a, b in zip(jtr.ht_dist(T, T2), ttr.ht_dist(_t(T), _t(T2))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    _, rd = ttr.ht_dist(_t(T), _t(T))
    assert float(rd.max()) < 1e-3


def test_pose_from_vote(poses):
    rng, _, _, _ = poses
    k = 128
    args = (rng.integers(0, 31, k).astype(np.int32),
            rng.normal(size=(k, 3)).astype(np.float32),
            rng.uniform(-math.pi, math.pi, k).astype(np.float32),
            rng.uniform(-math.pi, math.pi, k).astype(np.float32),
            rng.normal(size=(k, 3)).astype(np.float32),
            rng.uniform(-math.pi, math.pi, k).astype(np.float32),
            rng.uniform(-math.pi, math.pi, k).astype(np.float32))
    want = np.asarray(jtr.pose_from_vote(*args, D_ANGLE))
    got = ttr.pose_from_vote(torch.from_numpy(args[0]),
                             *(torch.from_numpy(a) for a in args[1:]),
                             D_ANGLE).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _keys_both(points, normals, d_dist, max_bin, ref_idx=None):
    kj, aj = jppf.pairwise_ppf_keys(points, normals, d_dist, D_ANGLE,
                                    max_bin, ref_indices=ref_idx)
    kt, at = tppf.pairwise_ppf_keys(
        _t(points), _t(normals), d_dist, D_ANGLE, max_bin,
        ref_indices=None if ref_idx is None else torch.from_numpy(
            np.asarray(ref_idx, np.int64)))
    return np.asarray(kj), np.asarray(aj), kt.numpy(), at.numpy()


@pytest.mark.parametrize("seed,n,ref_df", [(0, 300, 1), (1, 400, 3),
                                           (2, 250, 5)])
def test_pairwise_keys_rate(seed, n, ref_df):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    nr = _unit(rng, (n, 3))
    ref_idx = np.arange(0, n, ref_df, dtype=np.int32)
    kj, aj, kt, at = _keys_both(p, nr, 0.4, 24, ref_idx)
    agree = kj == kt
    rate = float(agree.mean())
    print(f"pairwise_ppf_keys equality rate {rate:.7f} "
          f"({int((~agree).sum())} of {agree.size} differ)")
    assert rate >= 1 - 1e-4
    inv_j = kj == jppf.INVALID_KEY
    inv_t = kt == tppf.INVALID_KEY
    # Invalid pairs from integer rules (self pairs, out-of-range bins)
    # agree exactly; a flip can only move a key between two valid bins or
    # across the max_dist_bin edge, which the rate above bounds.
    self_pair = ref_idx[:, None] == np.arange(n)[None, :]
    assert np.all(inv_j[self_pair]) and np.all(inv_t[self_pair])
    assert float((inv_j == inv_t).mean()) >= 1 - 1e-4
    np.testing.assert_allclose(at[agree], aj[agree], atol=1e-5)


def test_pad_sentinel_rows_invalid():
    """Voxel pad rows at _PAD_OFFSET: every pair touching one is invalid
    on both sides, whatever the float->int conversion does."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(60, 3)).astype(np.float32)
    nr = _unit(rng, (60, 3))
    lo = p.min(axis=0)
    p[50:] = lo - jpc._PAD_OFFSET
    nr[50:] = 0.0
    kj, _, kt, _ = _keys_both(p, nr, 0.3, 20)
    assert np.all(kj[50:] == jppf.INVALID_KEY)
    assert np.all(kj[:, 50:] == jppf.INVALID_KEY)
    np.testing.assert_array_equal(kt[50:], kj[50:])
    np.testing.assert_array_equal(kt[:, 50:], kj[:, 50:])


def test_pack_key_and_num_keys():
    rng = np.random.default_rng(6)
    db = rng.integers(-2, 30, 500).astype(np.int32)
    ab = rng.integers(0, 17, (500, 3)).astype(np.int32)
    want = np.asarray(jppf.pack_key(db, ab, 25))
    got = tppf.pack_key(torch.from_numpy(db), torch.from_numpy(ab), 25)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tppf.num_keys(25) == jppf.num_keys(25)
    x = rng.uniform(0, 5, 200).astype(np.float32)
    np.testing.assert_array_equal(tppf.quant_downf(_t(x), 0.3).numpy(),
                                  np.asarray(jppf.quant_downf(x, 0.3)))
