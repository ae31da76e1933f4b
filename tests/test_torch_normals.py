"""The port's normal estimators and smoother against the JAX package's on
the same clouds (CPU). Normals are held by angle: the closed-form
eigenvector, arccos and the order of the float sums differ by ulps, and
``topk`` may break a tie at the k-th neighbour differently from
``lax.top_k``. Stated per test: the median and the 99th percentile of the
angle between the two packages' normals, and the share of points allowed
outside the tolerance. Degenerate neighbourhoods fall back to +z in both.
Mirrors of tests/test_utils.py:131-194, 451-508."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objective_slam_tpu.utils import pointcloud as jpc
from objective_slam_tpu_torch.utils import pointcloud as tpc


def _angles_deg(a, b):
    cos = np.clip(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64),
                         axis=1), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def _held(got, want, median=1e-2, p99=0.1, outside=0.002, tol=5.0):
    """Angles between two normal fields: median and 99th percentile under
    the given degrees, at most `outside` of the points over `tol`."""
    ang = _angles_deg(got, want)
    print(f"angle to the JAX package's normals: median {np.median(ang):.2e} "
          f"deg, p99 {np.quantile(ang, 0.99):.2e} deg, over {tol} deg: "
          f"{(ang > tol).mean():.4f}")
    assert np.median(ang) < median
    assert np.quantile(ang, 0.99) < p99
    assert (ang > tol).mean() <= outside
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)


def _sphere(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def _blob(rng, n):
    """A bumpy closed surface with anisotropic scale, off the origin."""
    v = _sphere(rng, n)
    r = 1.0 + 0.2 * np.sin(3 * v[:, 0]) * np.cos(2 * v[:, 1])
    return (v * r[:, None] * [1.0, 0.7, 0.5] + [3.0, -2.0, 1.0]) \
        .astype(np.float32)


def test_smallest_eigvec_sym3_vs_jax_and_eigh():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 12, 3)).astype(np.float32)
    pts *= np.float32([1.0, 0.6, 0.15])
    c = pts - pts.mean(axis=1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", c, c) / c.shape[1]).astype(np.float32)
    got = tpc._smallest_eigvec_sym3(torch.from_numpy(cov)).numpy()
    want = np.asarray(jpc._smallest_eigvec_sym3(jnp.asarray(cov)))
    np.testing.assert_allclose(got, want, atol=2e-4)
    for i in range(len(cov)):
        assert abs(float(got[i] @ np.linalg.eigh(cov[i])[1][:, 0])) > 0.999
    # Isotropic and rank-1 covariances: +z, or a unit vector across the
    # line, in both packages.
    deg = np.zeros((4, 3, 3), np.float32)
    deg[:2] = np.eye(3)
    deg[2:, 0, 0] = 1.0
    got = tpc._smallest_eigvec_sym3(torch.from_numpy(deg)).numpy()
    want = np.asarray(jpc._smallest_eigvec_sym3(jnp.asarray(deg)))
    np.testing.assert_array_equal(got[:2], [[0, 0, 1]] * 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(np.abs(got[2:, 0]) < 1e-3)


def test_det3_closed_form():
    m = np.random.default_rng(1).normal(size=(50, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tpc._det3(torch.from_numpy(m)).numpy(),
                               np.linalg.det(m.astype(np.float64)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("orient,k", [("outward", 12), ("viewpoint", 10),
                                      ("outward", 16)])
def test_knn_normals_match_jax(orient, k):
    pts = _blob(np.random.default_rng(2), 700)
    kw = dict(k=k, orient=orient, viewpoint=(10.0, 0.0, 0.0))
    got = tpc.estimate_normals_knn(pts, device="cpu", **kw).numpy()
    want = np.asarray(jpc.estimate_normals_knn(pts, **kw))
    _held(got, want)


def test_knn_normals_on_plane_and_ties():
    """A regular grid on a plane: every k-th neighbour is tied, the two
    libraries may pick different ones, and the normal is ±z whichever is
    picked; flipped toward the viewpoint."""
    g = np.stack(np.meshgrid(np.arange(15.0), np.arange(15.0)), -1) \
        .reshape(-1, 2)
    pts = np.concatenate([g, np.zeros((len(g), 1))], 1).astype(np.float32)
    kw = dict(k=10, viewpoint=(7.0, 7.0, 50.0))
    got = tpc.estimate_normals_knn(pts, device="cpu", **kw).numpy()
    want = np.asarray(jpc.estimate_normals_knn(pts, **kw))
    np.testing.assert_allclose(got[:, 2], 1.0, atol=1e-4)
    np.testing.assert_allclose(want[:, 2], 1.0, atol=1e-4)


def test_knn_degenerate_neighbourhoods_fall_back_to_z():
    """All points on one spot: zero covariance, +z (then flipped toward the
    viewpoint) in both packages."""
    pts = np.ones((20, 3), np.float32)
    kw = dict(k=5, viewpoint=(1.0, 1.0, -5.0))
    got = tpc.estimate_normals_knn(pts, device="cpu", **kw).numpy()
    want = np.asarray(jpc.estimate_normals_knn(pts, **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 0.0, -1.0]] * 20)


@pytest.mark.parametrize("orient,box_filter,dims", [
    ("outward", True, None), ("viewpoint", True, None),
    ("outward", False, None), ("viewpoint", True, (40, 30, 22))])
def test_grid_normals_match_jax(orient, box_filter, dims):
    pts = _blob(np.random.default_rng(3), 6000)
    kw = dict(radius=0.12, orient=orient, viewpoint=(3.0, -20.0, 9.0),
              box_filter=box_filter, dims=dims)
    got = tpc.estimate_normals_grid(pts, device="cpu", **kw).numpy()
    want = np.asarray(jpc.estimate_normals_grid(pts, **kw))
    # Own-cell windows hold few points: their covariance E[ppᵀ] − μμᵀ
    # cancels in float32 and the sum order shows on a few of them (7 of
    # 10,000 points over 5 degrees when this was written).
    _held(got, want)


def test_grid_normals_on_plane_and_sphere():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(0, 1, size=(400, 2)),
                          np.zeros((400, 1))], axis=1).astype(np.float32)
    n = tpc.estimate_normals_grid(pts, radius=0.12, viewpoint=(0.5, 0.5, 5.0),
                                  device="cpu").numpy()
    np.testing.assert_allclose(n[:, 2], 1.0, atol=1e-3)
    v = _sphere(rng, 1500)
    p = v.astype(np.float32)
    n_grid = tpc.estimate_normals_grid(p, radius=0.15, orient="outward",
                                       device="cpu").numpy()
    n_knn = tpc.estimate_normals_knn(p, k=12, orient="outward",
                                     device="cpu").numpy()
    assert np.abs(np.sum(n_grid * n_knn, axis=1)).mean() > 0.99
    assert np.quantile(np.sum(n_grid * v, axis=1), 0.05) > 0.9


def test_box3_matches_jax():
    x = np.random.default_rng(5).normal(size=(4, 1, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tpc._box3(torch.from_numpy(x)).numpy(),
                               np.asarray(jpc._box3(jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("order,iterations", [(0, 1), (1, 1), (0, 2), (1, 2)])
def test_smooth_normals_match_jax(order, iterations):
    rng = np.random.default_rng(6)
    v = _sphere(rng, 4000)
    pts = (v + [2.0, 1.0, -3.0]).astype(np.float32)
    noisy = v + rng.normal(scale=0.25, size=v.shape)
    noisy = (noisy / np.linalg.norm(noisy, axis=1, keepdims=True)) \
        .astype(np.float32)
    kw = dict(radius=0.18, order=order, iterations=iterations)
    got = tpc.smooth_normals_grid(pts, noisy, device="cpu", **kw).numpy()
    want = np.asarray(jpc.smooth_normals_grid(pts, noisy, **kw))
    _held(got, want, outside=0.0)
    err_in, err_out = _angles_deg(noisy, v), _angles_deg(got, v)
    assert err_out.mean() < 0.6 * err_in.mean()
    assert (np.sum(got * v, axis=1) > 0).mean() > 0.99


def test_smooth_order1_cancels_window_bias():
    v = _sphere(np.random.default_rng(7), 6000)
    pts = v.astype(np.float32)

    def bias(order):
        sm = tpc.smooth_normals_grid(pts, pts.copy(), radius=0.3, order=order,
                                     device="cpu").numpy()
        return np.degrees(np.arccos(np.clip(np.abs(np.sum(sm * v, axis=1)),
                                            0, 1))).mean()

    assert bias(1) < 0.6 * bias(0)


def test_cancelled_average_keeps_the_input_normal():
    """Two opposite normals in one cell cancel: order 0 returns the inputs,
    as the JAX package does."""
    pts = np.zeros((2, 3), np.float32)
    nrm = np.float32([[0, 0, 1], [0, 0, -1]])
    got = tpc.smooth_normals_grid(pts, nrm, radius=1.0, order=0,
                                  device="cpu").numpy()
    np.testing.assert_array_equal(got, nrm)
    np.testing.assert_array_equal(
        got, np.asarray(jpc.smooth_normals_grid(pts, nrm, radius=1.0,
                                                order=0)))
