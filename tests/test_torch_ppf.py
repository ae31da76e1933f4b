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


@pytest.mark.parametrize("name", ["rotx", "roty", "rotz"])
def test_axis_rotations(name):
    thetas = np.float32([0.0, 0.7, -2.1, math.pi, 3 * math.pi / 2])
    want = np.asarray(getattr(jtr, name)(thetas))
    got = getattr(ttr, name)(_t(thetas)).numpy()
    assert got.shape == (5, 4, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(getattr(ttr, name)(0.7).numpy(),
                               np.asarray(getattr(jtr, name)(0.7)), atol=ATOL)


def test_trans_mat_and_rotate_vectors(poses):
    rng, _, _, T = poses
    v = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttr.trans_mat(_t(v)).numpy(),
                                  np.asarray(jtr.trans_mat(v)))
    np.testing.assert_allclose(ttr.rotate_vectors(_t(T), _t(v)).numpy(),
                               np.asarray(jtr.rotate_vectors(T, v)),
                               atol=ATOL)


def test_canonical_transform(poses):
    """Mirror of test_canonical_transform_sends_ref_to_origin_normal_to_x,
    and equal to the JAX package's matrices."""
    rng = poses[0]
    p = rng.normal(size=(64, 3)).astype(np.float32)
    n = _unit(rng, (64, 3))
    T = ttr.canonical_transform(_t(p), _t(n))
    np.testing.assert_allclose(T.numpy(),
                               np.asarray(jtr.canonical_transform(p, n)),
                               atol=ATOL)
    np.testing.assert_allclose(ttr.transform_points(T, _t(p)).numpy(), 0.0,
                               atol=1e-4)
    n0 = ttr.rotate_vectors(T, _t(n)).numpy()
    np.testing.assert_allclose(n0[:, 1:], 0.0, atol=ATOL)
    assert (n0[:, 0] > 0.99).all()


def test_alpha_functions_and_wrap(poses):
    rng = poses[0]
    a, b, c = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(3))
    n = _unit(rng, (64, 3))
    np.testing.assert_allclose(ttr.alpha_about_x(_t(a), _t(b)).numpy(),
                               np.asarray(jtr.alpha_about_x(a, b)), atol=ATOL)
    np.testing.assert_allclose(ttr.alpha_angle(_t(a), _t(n), _t(c)).numpy(),
                               np.asarray(jtr.alpha_angle(a, n, c)),
                               atol=ATOL)
    w = np.float32([0.0, 3.5, -3.5, math.pi, -math.pi, 6.4, -6.4, 100.0])
    np.testing.assert_allclose(ttr.wrap_angle(_t(w)).numpy(),
                               np.asarray(jtr.wrap_angle(w)), atol=ATOL)


def test_trans_model_scene(poses):
    """Mirror of test_trans_model_scene_matches_reference and of
    test_alpha_decomposition: α = wrap(α_s − α_m)."""
    rng = poses[0]
    m_r, m_i, s_r, s_i = (rng.normal(size=(32, 3)).astype(np.float32)
                          for _ in range(4))
    n_m, n_s = _unit(rng, (32, 3)), _unit(rng, (32, 3))
    want = jtr.trans_model_scene(m_r, n_m, m_i, s_r, n_s, s_i)
    got = ttr.trans_model_scene(*(_t(x) for x in
                                  (m_r, n_m, m_i, s_r, n_s, s_i)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    alpha = ttr.wrap_angle(ttr.alpha_angle(_t(s_r), _t(n_s), _t(s_i))
                           - ttr.alpha_angle(_t(m_r), _t(n_m), _t(m_i)))
    diff = (alpha - got[2]).abs().numpy()
    assert np.minimum(diff, 2 * math.pi - diff).max() < 1e-4


def test_compute_ppf_disc_feature_and_bins():
    rng = np.random.default_rng(12)
    p = rng.normal(size=(40, 3)).astype(np.float32)
    n = _unit(rng, (40, 3))
    n[3] = 0.0                                  # a zero normal
    args = (p[:, None], n[:, None], p[None], n[None])   # self pairs included
    fj = np.asarray(jppf.compute_ppf(*args))
    ft = tppf.compute_ppf(*(_t(a) for a in args))
    assert tuple(ft.shape) == fj.shape == (40, 40, 4)
    np.testing.assert_allclose(ft.numpy(), fj, atol=ATOL)
    # Quantization of the same floats is exact in both packages.
    np.testing.assert_array_equal(
        tppf.disc_feature(_t(fj), 0.3, D_ANGLE).numpy(),
        np.asarray(jppf.disc_feature(fj, 0.3, D_ANGLE)))
    for g, w in zip(tppf.feature_bins(_t(fj), 0.3, D_ANGLE),
                    jppf.feature_bins(fj, 0.3, D_ANGLE)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
