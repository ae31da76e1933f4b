"""The KinFu raycast in three launches (ops/raycast.raycast_depth,
csrc/raycast.cu) against the plain version it replaces on the card
(models/tsdf._raycast_depth).

On the CPU: the wrapper's refusals, the path rule and the spans of each
path, and the kernel path's small tables (ts, offs, the pixel rays) equal
to the values the plain version computes. On the card (marked `card`,
skipped without one): the kernel's depths equal the plain version's bit
for bit on the same device, at the deployment's size (a 512³ volume fused
from the `kinfu-track-512` cell's scene generator, 640 × 480, the march
0.4-4.0 m in 160 steps), at 64 × 64 with the defaults, in the grazing
case with one and three brackets, on an unobserved volume and on one that
holds an observed NaN; and track_frame's pose, inliers and overlap equal
to those computed from the plain raycast. This file imports no JAX, so
the card's tests run where JAX is absent:
`python -m pytest --noconftest tests/test_torch_raycast_kernel.py`.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

from objective_slam_tpu_torch.models import tsdf
from objective_slam_tpu_torch.ops import _build, raycast
from objective_slam_tpu_torch.utils import profiling, synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
CENTER = np.float32([1.6, 1.6, 1.4])
SMALL_SHAPE, SMALL_INTR = (64, 64), (64.0, 64.0, 31.5, 31.5)
GRAZE_SHAPE, GRAZE_INTR = (120, 160), (160.0, 160.0, 80.0, 60.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _view(ang, lift):
    eye = CENTER + np.float32([2.3 * math.cos(ang), 2.3 * math.sin(ang),
                               lift])
    return synthetic.look_at(eye, CENTER)


def _sphere_depth(T_cw, intr, shape):
    """The exact depth of a sphere of radius 0.6 at (1.6, 1.6, 1.6) over a
    floor z = 0.45 (float32, 0 where the ray misses)."""
    h, w = shape
    fx, fy, cx, cy = intr
    T = np.asarray(T_cw, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    eye = -R.T @ t
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1) @ R
    oc = eye - np.float64([1.6, 1.6, 1.6])
    a = np.sum(d * d, -1)
    b = 2.0 * (d @ oc)
    disc = b * b - 4.0 * a * (oc @ oc - 0.36)
    s = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
    best = np.where((disc >= 0) & (s > 0), s, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (0.45 - eye[2]) / d[..., 2]
    p = eye + s[..., None] * d
    floor = (s > 0) & (np.abs(p[..., 0] - 1.6) < 1.2) & \
        (np.abs(p[..., 1] - 1.6) < 1.2)
    best = np.where(floor & (s < best), s, best)
    return np.where(np.isfinite(best), best, 0.0).astype(np.float32)


def _small_scene(device):
    """The sphere fused from three views into a 64³ volume of 5 cm voxels,
    and the camera→world pose of an in-between view."""
    vol = tsdf.make_volume((0.0, 0.0, 0.0), (64, 64, 64), 0.05,
                           device=device)
    for ang in (0.0, 0.5, 1.0):
        T_cw = _view(ang, 0.9)
        vol = tsdf.integrate_depth(
            vol, _sphere_depth(T_cw, SMALL_INTR, SMALL_SHAPE), SMALL_INTR,
            T_cw)
    T_cw = _view(0.25, 0.95)
    return vol, np.linalg.inv(T_cw.astype(np.float64)).astype(np.float32), \
        T_cw


def _graze_volume(device, nan=False, width=64, wall=2.0):
    """test_torch_tsdf_tracking.py's grazing case: an observed wall at
    z = `wall` and one phantom negative voxel one voxel off the central
    ray, in a volume `width` voxels deep along z (W); with `nan`, one
    observed voxel of the wall holds NaN. Returns the volume and the
    camera→world pose."""
    vs, dims = 0.05, (64, 64, width)
    trunc = 3 * vs
    d = wall - (np.arange(width) + 0.5) * vs
    t = np.broadcast_to(np.clip(d, -trunc, trunc)[None, None, :],
                        dims).astype(np.float32).copy()
    w = np.broadcast_to((d >= -trunc)[None, None, :],
                        dims).astype(np.float32).copy()
    t[32, 33, 19] = -trunc
    w[32, 33, 19] = 1.0
    if nan:
        t[32, 30, 39] = np.nan
    x0 = (32 + 0.5) * vs
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [x0, x0, 0.2]
    return tsdf.volume_from_arrays(t, w, (0.0, 0.0, 0.0), vs, trunc,
                                   device=device), T_wc


def _plain(vol, intr, T_wc, shape, t_near=0.1, t_far=6.0, n_steps=192,
           fine_steps=32, n_brackets=3):
    return tsdf._raycast_depth(vol, intr, T_wc, shape, t_near, t_far,
                               n_steps, fine_steps, n_brackets)


def _spans_of(fn):
    profiling.clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, [s.name for s in profiling.spans()]
    finally:
        profiling.clear_spans()


# ----------------------------------------------------------------- the CPU

@pytest.fixture(scope="module")
def cpu_scene():
    return _small_scene("cpu")


@pytest.mark.parametrize("kw", [dict(), dict(t_near=0.4, t_far=4.0,
                                             n_steps=160),
                                dict(n_brackets=1)],
                         ids=["defaults", "deployment_march", "one_bracket"])
def test_cpu_path_is_the_plain_version(cpu_scene, kw):
    """On the CPU raycast_depth returns _raycast_depth's depths exactly,
    inside `tsdf.raycast` with no `tsdf.raycast_kernel` span, and launches
    nothing."""
    vol, T_wc, _ = cpu_scene
    before = raycast.launches
    got, names = _spans_of(lambda: tsdf.raycast_depth(
        vol, SMALL_INTR, T_wc, SMALL_SHAPE, **kw))
    want = _plain(vol, SMALL_INTR, T_wc, SMALL_SHAPE, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert (want > 0).float().mean() > 0.3
    assert names == ["tsdf.raycast"]
    assert raycast.launches == before


def test_kernel_path_spans_and_tables(cpu_scene, monkeypatch):
    """With the device rule forced, raycast_depth calls the wrapper once
    inside `tsdf.raycast_kernel` within `tsdf.raycast`, with the volume,
    the pose, the 1/voxel size and τ, and tables equal to the plain
    version's: its ts and offs, and its pixel rays' x along a row and y
    along a column. (The launch is replaced here by the plain version.)"""
    vol, T_wc, _ = cpu_scene
    calls = []

    def kernel(*args):
        calls.append(args)
        return _plain(vol, SMALL_INTR, T_wc, SMALL_SHAPE)

    monkeypatch.setattr(raycast, "raycast_depth", kernel)
    monkeypatch.setattr(_build, "uses_kernel", lambda d: True)
    got, names = _spans_of(lambda: tsdf.raycast_depth(
        vol, SMALL_INTR, T_wc, SMALL_SHAPE))
    assert names == ["tsdf.raycast", "tsdf.raycast_kernel"]
    assert torch.equal(got, _plain(vol, SMALL_INTR, T_wc, SMALL_SHAPE))
    (args,) = calls
    tsdf_, weight, origin, T, ts, offs, ray_u, ray_v, vs_inv, trunc, nb = \
        args
    assert tsdf_ is vol.tsdf and weight is vol.weight
    assert torch.equal(origin, vol.origin)
    assert torch.equal(T, torch.from_numpy(T_wc))
    want_ts = tsdf._linspace(0.1, 6.0, 192, "cpu", fused=True)
    dt = want_ts[1] - want_ts[0]
    want_offs = tsdf._linspace(-dt, 9.0 * dt, 32, "cpu", fused=True)
    dcx, dcy, _ = tsdf._pixel_rays(SMALL_INTR, SMALL_SHAPE, "cpu")
    for a, b in ((ts, want_ts), (offs, want_offs), (ray_u, dcx[0]),
                 (ray_v, dcy[:, 0])):
        assert a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b)
    assert (vs_inv, trunc, nb) == (tsdf._inv(0.05), tsdf.f32(0.15), 3)


def test_cuda_uses_the_kernel():
    assert _build.uses_kernel(torch.device("cuda", 0))
    assert not _build.uses_kernel(torch.device("cpu"))


def _wrapper_args(vol, n_steps=8):
    return [vol.tsdf, vol.weight, vol.origin, torch.eye(4),
            torch.linspace(0.1, 1.0, n_steps), torch.zeros(4),
            torch.zeros(5), torch.zeros(6), 20.0, 0.15, 3]


@pytest.mark.parametrize("case,match", [
    ("cpu", "unsupported device"),
    ("tsdf_float64", "tsdf must be torch.float32"),
    ("weight_strided", "weight must be contiguous"),
    ("pose_shape", r"T_wc must be \(4, 4\)"),
    ("weight_shape", r"weight must be \(8, 6, 40\)"),
    ("mixed_devices", "origin must lie on cpu"),
    ("one_step", "n_steps >= 2"),
    ("flat_volume", r"tsdf must be \(D, H, W\)"),
    ("negative_brackets", "n_brackets >= 0"),
])
def test_wrapper_refuses(case, match):
    """raycast_depth raises on what the kernel does not take, before any
    launch: tensors off a CUDA device, another dtype, shape or layout,
    tensors on two devices, fewer than two coarse steps."""
    vol = tsdf.make_volume((0.0, 0.0, 0.0), (8, 6, 40), 0.05, device="cpu")
    args = _wrapper_args(vol)
    if case == "tsdf_float64":
        args[0] = args[0].double()
    elif case == "weight_strided":
        args[1] = torch.zeros(40, 6, 8).transpose(0, 2)
    elif case == "pose_shape":
        args[3] = torch.eye(4)[:3].contiguous()
    elif case == "weight_shape":
        args[1] = torch.zeros(8, 6, 41)
    elif case == "mixed_devices":
        args[2] = args[2].to("meta")
    elif case == "one_step":
        args[4] = torch.zeros(1)
    elif case == "flat_volume":
        args[0] = args[0].reshape(-1)
    elif case == "negative_brackets":
        args[10] = -1
    before = raycast.launches
    with pytest.raises(ValueError, match=match):
        raycast.raycast_depth(*args)
    assert raycast.launches == before


# ---------------------------------------------------------------- the card

def _held(vol, intr, T_wc, shape, min_hits=0.0, **kw):
    """The kernel's depths against the plain version's on the card: equal
    bit for bit (NaN or not), one launch; returns the depths."""
    dev = vol.device
    before = raycast.launches
    got = tsdf.raycast_depth(vol, intr, torch.from_numpy(T_wc).to(dev),
                             shape, **kw)
    assert raycast.launches == before + 1
    want = _plain(vol, intr, torch.from_numpy(T_wc).to(dev), shape, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = got.view(torch.int32) != want.view(torch.int32)
    assert int(diff.sum()) == 0, (int(diff.sum()), float(
        (got - want)[diff].abs().max()))
    assert float((want > 0).float().mean()) >= min_hits
    return got


@pytest.fixture(scope="module")
def card_small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _small_scene(torch.device("cuda", 0))


@pytest.mark.card
@pytest.mark.parametrize("kw,min_hits", [
    (dict(), 0.3), (dict(t_near=0.4, t_far=4.0, n_steps=160), 0.3),
    (dict(n_brackets=1), 0.3), (dict(fine_steps=8), 0.3),
    (dict(t_near=0.0, t_far=2.0, n_steps=64), 0.0)],
    ids=["defaults", "deployment_march", "one_bracket", "eight_fine_steps",
         "t_near_zero"])
def test_small_view_bit_equal(card, card_small, kw, min_hits):
    """64 × 64 on the fused sphere: the default march, the deployment's,
    one bracket, short windows, and a march from t = 0 that ends before
    the surface."""
    vol, T_wc, _ = card_small
    _held(vol, SMALL_INTR, T_wc, SMALL_SHAPE, min_hits=min_hits, **kw)


@pytest.mark.card
@pytest.mark.parametrize("n_brackets", [1, 3])
def test_graze_bit_equal(card, n_brackets):
    """The phantom voxel takes the central ray's first window; with three
    brackets the march resumes onto the wall."""
    vol, T_wc = _graze_volume(card)
    got = _held(vol, GRAZE_INTR, T_wc, GRAZE_SHAPE, min_hits=0.9,
                t_near=0.1, t_far=3.0, n_brackets=n_brackets)
    c = float(got[60, 80])
    assert (c == 0.0) if n_brackets == 1 else abs(c - 1.8) < 0.05


@pytest.mark.card
def test_odd_width_bit_equal(card):
    """W = 45, not a multiple of 32: the wall's zero crossing at z = 1.6
    lies on the boundary of the mask's first and second (partial) word."""
    vol, T_wc = _graze_volume(card, width=45, wall=1.6)
    got = _held(vol, GRAZE_INTR, T_wc, GRAZE_SHAPE, min_hits=0.9,
                t_near=0.1, t_far=3.0)
    assert abs(float(got[60, 0]) - 1.4) < 0.05


@pytest.mark.card
def test_observed_nan_bit_equal(card):
    """An observed NaN voxel: the pooled field around it has no sign, and
    the trilinear samples leave it out."""
    vol, T_wc = _graze_volume(card, nan=True)
    clean = _plain(_graze_volume(card)[0], GRAZE_INTR,
                   torch.from_numpy(T_wc).to(card), GRAZE_SHAPE, 0.1, 3.0)
    got = _held(vol, GRAZE_INTR, T_wc, GRAZE_SHAPE, t_near=0.1, t_far=3.0)
    assert bool((got != clean).any())


@pytest.mark.card
def test_unobserved_volume_reads_zero(card):
    vol = tsdf.make_volume((0.0, 0.0, 0.0), (40, 48, 56), 0.05, device=card)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, 3] = [1.0, 1.2, 0.1]
    got = _held(vol, GRAZE_INTR, T_wc, GRAZE_SHAPE)
    assert not bool(got.any())


@pytest.fixture(scope="module")
def cell_volume():
    """The `kinfu-track-512` cell's set-up: its eight posed frames fused
    into the 512³ volume, and its segment's frames (the benchmark's own
    scene generator, on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.kinds import kinfu_track

    config = json.loads((ROOT / "benchmark" / "configs" /
                         "kinfu-512-vga.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" /
                          "track24.json").read_text())
    inputs = kinfu_track.Inputs(config, traffic, seed=4218000001)
    dev = torch.device("cuda", 0)
    vol = tsdf.make_volume(inputs.origin, inputs.dims, inputs.voxel_size,
                           inputs.truncation, device=dev)
    for fr in inputs.posed:
        vol = tsdf.integrate_depth(vol, fr.depth, inputs.K, fr.T_cw)
    return vol, inputs


@pytest.mark.card
@pytest.mark.parametrize("frame", [0, 12, 23])
def test_deployment_size_bit_equal(card, cell_volume, frame):
    """512³, 640 × 480, the cell's march, from the true pose of a frame
    of the segment (about half the pixels see the table and its objects;
    the room's wall lies beyond the volume)."""
    vol, inputs = cell_volume
    T_cw = inputs.frames[frame].T_cw.astype(np.float64)
    T_wc = np.linalg.inv(T_cw).astype(np.float32)
    t_near, t_far, n_steps = inputs.march
    _held(vol, inputs.K, T_wc, inputs.shape, min_hits=0.4, t_near=t_near,
          t_far=t_far, n_steps=n_steps)


@pytest.mark.card
def test_track_frame_equal_with_the_plain_raycast(card, cell_volume,
                                                  monkeypatch):
    """track_frame at the deployment's size from frame 1's start (frame
    0's true pose): the pose, inliers and overlap from the kernel's model
    view equal those from the plain raycast's."""
    vol, inputs = cell_volume
    t_near, t_far, n_steps = inputs.march
    fr = inputs.frames[1]
    T_init = inputs.frames[0].T_cw

    def track():
        return tsdf.track_frame(vol, fr.depth, inputs.K, T_init,
                                t_near=t_near, t_far=t_far, n_steps=n_steps)

    before = raycast.launches
    got = track()
    assert raycast.launches == before + 1
    with monkeypatch.context() as mp:
        mp.setattr(tsdf, "_raycast_kernel", tsdf._raycast_depth)
        want = track()
    assert raycast.launches == before + 1
    assert torch.equal(got.T_cw, want.T_cw)
    assert int(got.inliers) == int(want.inliers) > 0
    assert int(got.overlap) == int(want.overlap)


@pytest.mark.card
def test_three_kernels_a_raycast(card, card_small):
    """Under a profiler, each raycast on the card is three ordinary
    launches (what program_spans counts), raycast_flags_kernel,
    raycast_mask_kernel and raycast_march_kernel, inside one
    `tsdf.raycast_kernel` span. A
    profiler session late in a long process may drop device records, so
    each kernel is held to between one and three traced runs."""
    vol, T_wc, _ = card_small
    T = torch.from_numpy(T_wc).to(card)
    tsdf.raycast_depth(vol, SMALL_INTR, T, SMALL_SHAPE)       # warm-up
    torch.cuda.synchronize(card)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tsdf.raycast_depth(vol, SMALL_INTR, T, SMALL_SHAPE)
        torch.cuda.synchronize(card)
    names = [sp.name for sp in profiling.spans()]
    profiling.clear_spans()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for kernel in ("raycast_flags_kernel", "raycast_mask_kernel",
                   "raycast_march_kernel"):
        assert 1 <= sum(kernel in k for k in kernels) <= 3, kernels
    assert names.count("tsdf.raycast_kernel") == 3, names
    launches = [e.name for e in prof.events()
                if e.name.startswith("cudaLaunchKernel")]
    assert len(launches) == 9, launches
