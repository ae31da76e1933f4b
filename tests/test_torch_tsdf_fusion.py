"""The port's TSDF fusion (objective_slam_tpu_torch.models.tsdf: volume,
point splat, depth integration, banded integration) and
synthetic.look_at / render_depth against the JAX package, on the CPU.

The same seeded numpy inputs go to the JAX function and to the port with
device="cpu"; a JAX volume is carried across as its arrays
(`volume_from_arrays`). What must agree:
  * look_at, render_depth: equal (both numpy);
  * integrate: weights exactly, tsdf within 1e-6;
  * integrate_depth: the pixel each voxel projects to — a flip rate of at
    most 1e-4 of the voxels in view — weights exactly where no pixel
    flipped, tsdf within 1e-6 there;
  * band_block_occupancy and the banded `overflowed`: equal; the banded
    result equals the port's own integrate_depth bit for bit on every
    voxel the banded pass touched.
The mirrors of tests/test_tsdf.py's fusion tests run the port alone, with
that file's sizes and criteria. torch runs on one thread: the splat's
per-voxel sums and the held-to-the-bit products then take one order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objective_slam_tpu.models import tsdf as jt
from objective_slam_tpu.utils import synthetic as jsyn
from objective_slam_tpu_torch.models import tsdf as tt
from objective_slam_tpu_torch.utils import synthetic as tsyn

_INTR = (160.0, 160.0, 80.0, 60.0)    # fx fy cx cy for a 120x160 image
_SHAPE = (120, 160)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_cloud(rng, n, center, radius):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (center + radius * v).astype(np.float32), v.astype(np.float32)


def _depth_sphere(rng, n, r=0.8, center=(1.6, 1.6, 1.6)):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * r + np.asarray(center)).astype(np.float32), \
        v.astype(np.float32)


def _corner_scene(rng, n=70_000):
    """Sphere and two orthogonal walls (test_tsdf.py:302-311)."""
    sp, _ = _depth_sphere(rng, n // 2, r=0.6, center=(1.6, 1.6, 1.6))
    u = rng.uniform(0.4, 2.8, size=(n // 4, 2)).astype(np.float32)
    floor = np.stack([u[:, 0], u[:, 1], np.full(len(u), 0.45)],
                     axis=1).astype(np.float32)
    wall = np.stack([u[:, 0], np.full(len(u), 0.45), u[:, 1] * 0.7 + 0.5],
                    axis=1).astype(np.float32)
    return np.concatenate([sp, floor, wall])


def _port(jvol):
    """The JAX volume's state as a port volume on the CPU."""
    return tt.volume_from_arrays(np.asarray(jvol.tsdf),
                                 np.asarray(jvol.weight),
                                 np.asarray(jvol.origin), jvol.voxel_size,
                                 jvol.truncation, device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- synthetic

def test_look_at_and_render_depth_equal_jax(rng):
    """Both are numpy copies: equal arrays, the degenerate up-vector case
    and the z-buffer's exact minimum included."""
    sp, _ = _depth_sphere(rng, 20_000)
    center = np.float32([1.6, 1.6, 1.6])
    for eye in (center + np.float32([2.2, 0.3, 0.5]),
                center + np.float32([0.0, -2.2, 0.2]),
                center + np.float32([0.0, 0.0, 2.5])):   # looking along −z
        T_j = jsyn.look_at(eye, center)
        T_t = tsyn.look_at(eye, center)
        np.testing.assert_array_equal(T_t, T_j)
        d_j = jsyn.render_depth(sp, T_j, _INTR, _SHAPE)
        d_t = tsyn.render_depth(sp, T_t, _INTR, _SHAPE)
        assert d_t.dtype == np.float32 and d_t.shape == _SHAPE
        np.testing.assert_array_equal(d_t, d_j)
        assert (d_t > 0).mean() > 0.05


# ------------------------------------------------------------------- volume

def test_make_volume_and_replace():
    vol = tt.make_volume(origin=(0.0, -1.0, 2.0), dims=(8, 16, 24),
                         voxel_size=0.05, device="cpu")
    jvol = jt.make_volume(origin=(0.0, -1.0, 2.0), dims=(8, 16, 24),
                          voxel_size=0.05)
    for name in ("tsdf", "weight", "origin"):
        got = getattr(vol, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jvol, name)))
    assert vol.dims == jvol.dims == (8, 16, 24)
    assert vol.voxel_size == jvol.voxel_size
    assert vol.truncation == jvol.truncation
    with pytest.raises(dataclasses.FrozenInstanceError):
        vol.voxel_size = 1.0
    v2 = dataclasses.replace(vol, weight=vol.weight + 1.0)
    assert float(v2.weight.min()) == 1.0 and v2.dims == vol.dims
    # Tensors passed in keep their device.
    v3 = tt.make_volume(origin=torch.zeros(3), dims=(8, 8, 8),
                        voxel_size=0.1)
    assert v3.device.type == "cpu"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.make_volume(origin=(0.0, 0.0, 0.0), dims=(8, 8, 8),
                       voxel_size=0.1)


# -------------------------------------------------------------- point splat

@pytest.mark.parametrize("dims,vs,n_pts,frames",
                         [(48, 1 / 16, 4000, 1), (32, 0.1, 1000, 2)])
def test_integrate_equals_jax(rng, dims, vs, n_pts, frames):
    """Weights (splat counts) exact, so the set of touched voxels is equal;
    tsdf within 1e-6 (it comes out bit-equal on the CPU)."""
    jvol = jt.make_volume(origin=(-1.5,) * 3, dims=(dims,) * 3,
                          voxel_size=vs)
    tvol = tt.make_volume(origin=(-1.5,) * 3, dims=(dims,) * 3,
                          voxel_size=vs, device="cpu")
    for _ in range(frames):
        pts, nrm = _sphere_cloud(rng, n_pts, np.zeros(3), 1.0)
        jvol = jt.integrate(jvol, pts, nrm)
        tvol = tt.integrate(tvol, pts, nrm)
    np.testing.assert_array_equal(_np(tvol.weight), _np(jvol.weight))
    np.testing.assert_allclose(_np(tvol.tsdf), _np(jvol.tsdf), rtol=0,
                               atol=1e-6)
    assert (_np(tvol.weight) > 0).sum() > 1000


def test_weighted_average_multiframe(rng):
    """Mirror of test_tsdf.py::test_weighted_average_multiframe: two
    identical frames keep the fused tsdf and double the weights."""
    vol = tt.make_volume(origin=(-1.5, -1.5, -1.5), dims=(32, 32, 32),
                         voxel_size=0.1, device="cpu")
    pts, nrm = _sphere_cloud(rng, 1000, np.zeros(3), 1.0)
    v1 = tt.integrate(vol, pts, nrm)
    v2 = tt.integrate(v1, pts, nrm)
    m = _np(v1.weight) > 0
    np.testing.assert_allclose(_np(v2.tsdf)[m], _np(v1.tsdf)[m], atol=1e-5)
    np.testing.assert_allclose(_np(v2.weight)[m], 2 * _np(v1.weight)[m],
                               atol=1e-4)


# ------------------------------------------------------- depth integration

def _jax_pixels(jvol, T_cw):
    """(u, v, z) of every voxel centre as the JAX package's integrate_depth
    computes them (tsdf.py:147-152)."""
    @jax.jit
    def f(vol, T, fx, fy, cx, cy):
        pw = jt._voxel_centers(vol)
        pc = jnp.einsum("ij,dhwj->dhwi", T[:3, :3], pw,
                        precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        u = jnp.round(fx * x / jnp.maximum(z, 1e-9) + cx).astype(jnp.int32)
        v = jnp.round(fy * y / jnp.maximum(z, 1e-9) + cy).astype(jnp.int32)
        return u, v, z

    fx, fy, cx, cy = (np.float32(c) for c in _INTR)
    return (np.asarray(a) for a in f(jvol, jnp.asarray(T_cw), fx, fy, cx,
                                     cy))


def test_integrate_depth_equals_jax(rng):
    """Three views of a sphere fused in both packages from the same prior
    state each time. Pixel flips (a voxel's u or v differs from the JAX
    package's) at most 1e-4 of the voxels in view; away from them weights
    are equal and tsdf within 1e-6."""
    sp, _ = _depth_sphere(rng, 60_000)
    jvol = jt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                          voxel_size=0.05)
    center = np.float32([1.6, 1.6, 1.6])
    h, w = _SHAPE
    for az in (0.0, 2.1, 4.2):
        eye = center + 2.2 * np.float32([math.cos(az), math.sin(az), 0.3])
        T_cw = jsyn.look_at(eye, center)
        depth = jsyn.render_depth(sp, T_cw, _INTR, _SHAPE)
        tvol = tt.integrate_depth(_port(jvol), depth, _INTR, T_cw)
        u_j, v_j, z_j = _jax_pixels(jvol, T_cw)
        px, py, pz = tt._voxel_grid_coords(_port(jvol))
        u_t, v_t, z_t = (_np(a) for a in tt._project(
            px, py, pz, _INTR, torch.from_numpy(T_cw)))
        in_view = (z_j > 0) & (u_j >= 0) & (u_j < w) & (v_j >= 0) \
            & (v_j < h)
        flipped = (u_t != u_j) | (v_t != v_j)
        assert in_view.sum() > 10_000
        assert (flipped & in_view).sum() <= 1e-4 * in_view.sum()
        jvol = jt.integrate_depth(jvol, depth, _INTR, T_cw)
        same = ~flipped
        np.testing.assert_array_equal(_np(tvol.weight)[same],
                                      _np(jvol.weight)[same])
        np.testing.assert_allclose(_np(tvol.tsdf)[same],
                                   _np(jvol.tsdf)[same], rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(z_t), z_j, rtol=0, atol=1e-6)


def test_integrate_depth_reconstructs_sphere(rng):
    """Mirror of test_tsdf.py::test_integrate_depth_reconstructs_sphere:
    three fused views put the zero crossing on the sphere."""
    sp, _ = _depth_sphere(rng, 60_000)
    vol = tt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                         voxel_size=0.05, device="cpu")
    center = np.float32([1.6, 1.6, 1.6])
    for az in (0.0, 2.1, 4.2):
        eye = center + 2.2 * np.float32([math.cos(az), math.sin(az), 0.3])
        T_cw = tsyn.look_at(eye, center)
        depth = tsyn.render_depth(sp, T_cw, _INTR, _SHAPE)
        assert (depth > 0).mean() > 0.05
        vol = tt.integrate_depth(vol, depth, _INTR, T_cw)
    surf = tt.extract_surface(vol, capacity=4096)
    pts = _np(surf.points)[_np(surf.valid)]
    assert len(pts) > 300
    radii = np.linalg.norm(pts - center, axis=1)
    assert abs(np.median(radii) - 0.8) < 0.08, np.median(radii)
    assert np.quantile(np.abs(radii - 0.8), 0.9) < 0.12


def test_integrate_depth_carves_free_space(rng):
    """Mirror of test_tsdf.py::test_integrate_depth_carves_free_space: a
    blob fused in frame 1 is erased by frames that see the wall behind it;
    the wall survives."""
    center = np.float32([1.6, 1.6, 1.6])
    wall_y = 2.79
    gx, gz = np.meshgrid(np.linspace(0.3, 2.9, 160),
                         np.linspace(0.3, 2.9, 160))
    wall = np.stack([gx.ravel(), np.full(gx.size, wall_y), gz.ravel()],
                    axis=1).astype(np.float32)
    blob, _ = _depth_sphere(rng, 4000, r=0.25, center=(1.6, 1.6, 1.6))
    vol = tt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                         voxel_size=0.05, device="cpu")
    T_cw = tsyn.look_at(center + np.float32([0.0, -2.2, 0.0]), center)
    d1 = tsyn.render_depth(np.concatenate([wall, blob]), T_cw, _INTR, _SHAPE)
    vol = tt.integrate_depth(vol, d1, _INTR, T_cw)
    t_front = float(vol.tsdf[32, 27, 32])
    assert abs(t_front) < 0.06, t_front                     # blob present
    d2 = tsyn.render_depth(wall, T_cw, _INTR, _SHAPE)
    for _ in range(8):
        vol = tt.integrate_depth(vol, d2, _INTR, T_cw)
    assert float(vol.tsdf[32, 27, 32]) > 0.05
    surf = tt.extract_surface(vol, capacity=8192)
    pts = _np(surf.points)[_np(surf.valid)]
    assert (np.linalg.norm(pts - center, axis=1) < 0.32).sum() == 0
    assert (np.abs(pts[:, 1] - wall_y) < 0.1).mean() > 0.8


# ------------------------------------------------------ banded integration

@pytest.fixture(scope="module")
def banded_case():
    """A corner scene fused once (a non-trivial prior) and a second view:
    the JAX volume, that view's depth and pose (test_tsdf.py:405-414)."""
    rng = np.random.default_rng(0)
    world = _corner_scene(rng)
    vol = jt.make_volume(origin=(0.0, 0.0, 0.0), dims=(64, 64, 64),
                         voxel_size=0.05)
    center = np.float32([1.6, 1.6, 1.4])
    T1 = jsyn.look_at(center + np.float32([2.3, 0.2, 0.9]), center)
    d1 = jsyn.render_depth(world, T1, _INTR, _SHAPE)
    vol = jt.integrate_depth(vol, d1, _INTR, T1)
    T2 = jsyn.look_at(center + np.float32([1.9, 1.3, 1.0]), center)
    d2 = jsyn.render_depth(world, T2, _INTR, _SHAPE)
    return vol, d2, T2


def test_band_block_occupancy_and_overflow_equal_jax(banded_case):
    """The candidate mask, its count and the overflow flag at a fitting, a
    halved and a starved cap equal the JAX package's. The banded weights
    equal JAX's too; its tsdf is within 1e-6 (the JAX banded pass rounds
    voxel centres as i·vs + origin + vs/2, the dense pass and the port as
    (i + 0.5)·vs + origin)."""
    jvol, d2, T2 = banded_case
    tvol = _port(jvol)
    np.testing.assert_array_equal(
        _np(tt._band_block_mask(tvol, d2, _INTR, T2)),
        np.asarray(jt._band_block_mask(jvol, d2, _INTR, T2)))
    occ = int(jt.band_block_occupancy(jvol, d2, _INTR, T2))
    t_occ = tt.band_block_occupancy(tvol, d2, _INTR, T2)
    assert t_occ.dtype == torch.int32 and int(t_occ) == occ
    for cap in (occ, occ // 2, 4):
        jb, jo = jt.integrate_depth_banded(jvol, d2, _INTR, T2,
                                           block_cap=cap)
        tb, to = tt.integrate_depth_banded(tvol, d2, _INTR, T2,
                                           block_cap=cap)
        assert bool(to) == bool(jo) == (cap < occ)
        np.testing.assert_array_equal(_np(tb.weight), _np(jb.weight))
        np.testing.assert_allclose(_np(tb.tsdf), _np(jb.tsdf), rtol=0,
                                   atol=1e-6)


def test_banded_integrate_equals_dense_within_band(banded_case):
    """Mirror of test_tsdf.py::test_banded_integrate_equals_dense_within_band,
    held tighter: on every voxel within the frame's band, and on every
    voxel the banded pass touched, tsdf and weight equal the port's
    integrate_depth bit for bit; untouched voxels keep the prior state."""
    jvol, d2, T2 = banded_case
    vol = _port(jvol)
    dense = tt.integrate_depth(vol, d2, _INTR, T2)
    occ = int(tt.band_block_occupancy(vol, d2, _INTR, T2))
    assert 0 < occ < 512                 # the mask is selective
    banded, ovf = tt.integrate_depth_banded(vol, d2, _INTR, T2,
                                            block_cap=occ)
    assert not bool(ovf)

    # Per-voxel band membership of the frame, by the dense projection.
    D, H, W = vol.dims
    h, w = _SHAPE
    u, v, z = (_np(a) for a in tt._project(*tt._voxel_grid_coords(vol),
                                           _INTR, torch.from_numpy(T2)))
    in_img = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    dm = d2[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)]
    band = in_img & np.isfinite(dm) & (dm > 0) \
        & (np.abs(dm - z) <= vol.truncation)
    assert band.sum() > 1000

    t_d, w_d = _np(dense.tsdf), _np(dense.weight)
    t_b, w_b = _np(banded.tsdf), _np(banded.weight)
    np.testing.assert_array_equal(w_b[band], w_d[band])
    np.testing.assert_array_equal(t_b[band], t_d[band])
    touched = (w_b != _np(vol.weight)) | (t_b != _np(vol.tsdf))
    np.testing.assert_array_equal(t_b[touched], t_d[touched])
    np.testing.assert_array_equal(w_b[touched], w_d[touched])
    untouched = w_b == _np(vol.weight)
    assert np.all((t_b == _np(vol.tsdf))[untouched & ~band])

    _, ovf2 = tt.integrate_depth_banded(vol, d2, _INTR, T2, block_cap=4)
    assert bool(ovf2)


def test_banded_starved_cap_updates_first_blocks_in_index_order(
        banded_case):
    """Over block_cap, exactly the first block_cap candidate blocks in
    index order are updated (with the dense math); every other voxel keeps
    its state."""
    jvol, d2, T2 = banded_case
    vol = _port(jvol)
    mask = _np(tt._band_block_mask(vol, d2, _INTR, T2))
    cand = np.flatnonzero(mask)
    cap = len(cand) // 3
    banded, ovf = tt.integrate_depth_banded(vol, d2, _INTR, T2,
                                            block_cap=cap)
    assert bool(ovf)
    dense = tt.integrate_depth(vol, d2, _INTR, T2)
    D, H, W = vol.dims
    B = 8
    blk = (np.arange(D)[:, None, None] // B * (H // B)
           + np.arange(H)[None, :, None] // B) * (W // B) \
        + np.arange(W)[None, None, :] // B
    in_sel = np.isin(blk, cand[:cap])
    t_b, w_b = _np(banded.tsdf), _np(banded.weight)
    np.testing.assert_array_equal(t_b[in_sel], _np(dense.tsdf)[in_sel])
    np.testing.assert_array_equal(w_b[in_sel], _np(dense.weight)[in_sel])
    np.testing.assert_array_equal(t_b[~in_sel], _np(vol.tsdf)[~in_sel])
    np.testing.assert_array_equal(w_b[~in_sel], _np(vol.weight)[~in_sel])
    assert (w_b[in_sel] != _np(vol.weight)[in_sel]).any()
