"""KinFu Gauss-Newton in one launch (ops/gn_track.gauss_newton,
csrc/gn_track.cu) against the eager loop it replaces on the card
(models/tsdf._gauss_newton_plain).

On the CPU: _gauss_newton_plain equal bit for bit to the loop as
track_frame held it before the kernel, the path rule and the spans of
each path, and the wrapper's refusals. On the card (marked `card`,
skipped without one): the kernel against the plain loop on the same
device. This file imports no JAX, so the card's tests run where JAX is
absent: `python -m pytest --noconftest tests/test_torch_gn_kernel.py`.

The scene is test_torch_tsdf_tracking.py's corner (a sphere and two
walls) in a 64³ volume of 5 cm voxels, fused from three views and seen
from a fourth, here rendered exactly (every pixel's nearest hit) at
640 × 480 on the card and 48 × 64 on the CPU.

Tolerances. Every step is held alone: from the plain loop's pose after k
steps, the kernel's step k against the plain loop's. The kernel rounds
the transforms, the projection and the gates as torch's elementwise
kernels do on the card, so both see the same associations: the inlier
and overlap counts are equal. The 6 × 6 sums run in another order
(cuBLAS's against the kernel's tree), so rms agrees within 1e-5 of itself
and the step's pose within 1e-5 m and 1e-5 rad, measured in float64: a
step moves the pose by up to 0.08 rad and 0.1 m, and float32 sums of
about 180,000 terms in two orders part by about 1e-5 of the step (on an
H100 the first step reads 1.3e-6 m and 5.2e-7 rad, rms 7e-8 of itself,
the later ones less). The whole 10-step track is held to the class of
the plain loop's own last-bit differences: its start moved by one float32
ulp of each translation entry (about 5e-6 of a voxel) moves the plain
loop's result by up to 7e-7 m and 3e-7 rad on an H100, and the kernel's
result lies within four times the largest of those, or 1e-5 m and 1e-5
rad where that is less.
"""

import math

import numpy as np
import pytest
import torch

from objective_slam_tpu_torch.models import tsdf
from objective_slam_tpu_torch.ops import _build, gn_track
from objective_slam_tpu_torch.utils import profiling, synthetic

CENTER = np.float32([1.6, 1.6, 1.4])
CARD_SHAPE, CARD_INTR = (480, 640), (525.0, 525.0, 319.5, 239.5)
CPU_SHAPE, CPU_INTR = (48, 64), (64.0, 64.0, 31.5, 23.5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _view(ang, lift):
    eye = CENTER + np.float32([2.3 * math.cos(ang), 2.3 * math.sin(ang),
                               lift])
    return synthetic.look_at(eye, CENTER)


def _corner_depth(T_cw, intr, shape):
    """The corner scene's exact depth (float32, 0 where the ray misses): a
    sphere of radius 0.6 at (1.6, 1.6, 1.6), a floor z = 0.45 over
    [0.4, 2.8]² and a wall y = 0.45 over x in [0.4, 2.8], z in
    [0.78, 2.46] (test_torch_tsdf_tracking.py's _corner_scene)."""
    h, w = shape
    fx, fy, cx, cy = intr
    T = np.asarray(T_cw, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    eye = -R.T @ t
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    ray = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    d = ray @ R                     # world directions, camera z = 1
    best = np.full((h, w), np.inf)
    oc = eye - np.float64([1.6, 1.6, 1.6])
    a = np.sum(d * d, -1)
    b = 2.0 * (d @ oc)
    disc = b * b - 4.0 * a * (oc @ oc - 0.36)
    s = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
    best = np.where((disc >= 0) & (s > 0), s, best)
    for axis, level, box in ((2, 0.45, ((0, 0.4, 2.8), (1, 0.4, 2.8))),
                             (1, 0.45, ((0, 0.4, 2.8), (2, 0.78, 2.46)))):
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (level - eye[axis]) / d[..., axis]
        p = eye + s[..., None] * d
        ok = s > 0
        for ax, lo, hi in box:
            ok &= (p[..., ax] >= lo) & (p[..., ax] <= hi)
        best = np.where(ok & (s < best), s, best)
    return np.where(np.isfinite(best), best, 0.0).astype(np.float32)


def _scene(device, shape, intr):
    """The corner fused from three views into a 64³ volume of 5 cm
    voxels, the depth of an in-between view and its true T_cw."""
    vol = tsdf.make_volume((0.0, 0.0, 0.0), (64, 64, 64), 0.05,
                           device=device)
    for ang in (0.0, 0.5, 1.0):
        T_cw = _view(ang, 0.9)
        vol = tsdf.integrate_depth(vol, _corner_depth(T_cw, intr, shape),
                                   intr, T_cw)
    T_gt = _view(0.25, 0.95)
    return dict(vol=vol, T_gt=T_gt, depth=_corner_depth(T_gt, intr, shape),
                intr=intr, shape=shape)


def _perturbed(T_cw, rot_deg, trans, seed=1):
    """T_cw moved by rot_deg about a random axis and trans along a random
    direction (test_torch_tsdf_tracking.py's _perturb_pose)."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    th = math.radians(rot_deg)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    dT = np.eye(4)
    dT[:3, :3] = np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K
    d = rng.normal(size=3)
    dT[:3, 3] = d / np.linalg.norm(d) * trans
    return (np.asarray(T_cw, np.float64) @ dT).astype(np.float32)


def _gn_args(scene, T_init, iters, blank=False, **kw):
    """The arguments track_frame hands its Gauss-Newton loop for the
    scene's frame (all pixels invalid where `blank`) from T_init."""
    seen = []
    plain = tsdf._gauss_newton_plain

    def spy(*args):
        seen.append(args)
        return plain(*args)

    depth = scene["depth"] * np.float32(0.0 if blank else 1.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsdf, "_gauss_newton_plain", spy)
        mp.setattr(_build, "uses_kernel", lambda device: False)
        tsdf.track_frame(scene["vol"], depth, scene["intr"], T_init,
                         iters=iters, **kw)
    return seen[0]


def _with(args, T_wc=None, iters=None, wide_steps=None):
    """args with the start pose, the number of steps or of wide-gated
    steps replaced."""
    args = list(args)
    for i, v in ((7, T_wc), (11, iters), (12, wide_steps)):
        if v is not None:
            args[i] = v
    return tuple(args)


# ----------------------------------------------------------------- the CPU

@pytest.fixture(scope="module")
def cpu_scene():
    return _scene("cpu", CPU_SHAPE, CPU_INTR)


@pytest.fixture(scope="module")
def cpu_start(cpu_scene):
    """The CPU scene's start 4° and 12 cm off its true pose."""
    return _perturbed(cpu_scene["T_gt"], 4.0, 0.12)


@pytest.fixture(scope="module")
def cpu_args(cpu_scene, cpu_start):
    """The arguments track_frame hands its 10-step loop from cpu_start."""
    return _gn_args(cpu_scene, cpu_start, 10)


@pytest.fixture(scope="module")
def cpu_tracked(cpu_scene, cpu_start):
    """track_frame's result from cpu_start on the plain path."""
    return tsdf.track_frame(cpu_scene["vol"], cpu_scene["depth"], CPU_INTR,
                            cpu_start)


def _loop_as_it_was(v_cam, n_cam, frame_ok, v_model, n_model, model_ok,
                    T_cw_prev, T_wc, intrinsics, d2_max, normal_cos, iters,
                    wide_steps):
    """track_frame's Gauss-Newton loop as it stood inline before it moved
    into _gauss_newton_plain, statement for statement (the wide gate
    was i < iters // 2)."""
    assert wide_steps == iters // 2
    _rotate, _round_index, f32 = tsdf._rotate, tsdf._round_index, \
        tsdf.f32
    _OMEGA_MAX = tsdf._OMEGA_MAX
    dev = v_cam.device
    h, w = v_cam.shape[:2]
    fx, fy, cx, cy = tsdf._cam_scalars(intrinsics)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    damp = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)
    rms = torch.zeros((), dtype=torch.float32, device=dev)
    inl = ovl = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(iters):
        d2_i = 16.0 * d2_max if i < iters // 2 else d2_max
        pw = torch.stack(_rotate(T_wc[:3, :3], v_cam[..., 0],
                                 v_cam[..., 1], v_cam[..., 2],
                                 T_wc[:3, 3]), -1)
        nw = torch.stack(_rotate(T_wc[:3, :3], n_cam[..., 0],
                                 n_cam[..., 1], n_cam[..., 2]), -1)
        x, y, z = _rotate(T_cw_prev[:3, :3], pw[..., 0], pw[..., 1],
                          pw[..., 2], T_cw_prev[:3, 3])
        zc = torch.clamp(z, min=f32(1e-9))
        up = _round_index(fx * x / zc + cx)
        vp = _round_index(fy * y / zc + cy)
        in_img = (z > 0) & (up >= 0) & (up < w) & (vp >= 0) & (vp < h)
        flat = (torch.clamp(vp, 0, h - 1) * w
                + torch.clamp(up, 0, w - 1)).reshape(-1)
        pw = pw.reshape(-1, 3)
        nw = nw.reshape(-1, 3)
        vm = v_model[flat]
        nm = n_model[flat]
        diff = pw - vm
        cand = frame_ok & in_img.reshape(-1) & model_ok[flat]
        ok = (cand & (torch.sum(diff * diff, dim=-1) < d2_i)
              & (torch.sum(nw * nm, dim=-1) > normal_cos))
        wf = ok.to(torch.float32)
        rf = torch.sum(diff * nm, dim=-1)
        Jf = torch.cat([torch.linalg.cross(pw, nm, dim=-1), nm], dim=-1)
        Jw = Jf * wf[:, None]
        A = Jw.T @ Jf + damp
        b = -(Jw.T @ rf)
        delta = torch.linalg.solve_ex(A, b).result
        omega, t = delta[:3], delta[3:]
        th = torch.linalg.norm(omega) + 1e-12
        scale = torch.clamp(_OMEGA_MAX / th, max=1.0)
        omega, t, th = omega * scale, t * scale, th * scale
        k = omega / th
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                         torch.stack([k[2], zero, -k[0]]),
                         torch.stack([-k[1], k[0], zero])])
        R = eye3 + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
        dT = torch.eye(4, dtype=torch.float32, device=dev)
        dT[:3, :3] = R
        dT[:3, 3] = t
        wsum = torch.clamp(torch.sum(wf), min=1.0)
        rms = torch.sqrt(torch.sum(wf * rf * rf) / wsum)
        inl = torch.sum(wf).to(torch.int32)
        ovl = torch.sum(cand, dtype=torch.int32)
        T_wc = dT @ T_wc
    return T_wc, inl, rms, ovl


@pytest.mark.parametrize("rot_deg,trans,iters,dist", [
    (4.0, 0.12, 10, None), (5.0, 0.28, 12, 0.08), (4.0, 0.12, 1, None),
    (4.0, 0.12, 0, None)],
    ids=["perturbed", "annealed", "one_step", "no_step"])
def test_plain_equals_the_loop_it_was_moved_from(cpu_scene, rot_deg, trans,
                                                  iters, dist):
    """From the same maps and start, bit for bit, pose and counts."""
    T_init = _perturbed(cpu_scene["T_gt"], rot_deg, trans)
    args = _gn_args(cpu_scene, T_init, iters, dist_thresh=dist)
    got = tsdf._gauss_newton_plain(*args)
    want = _loop_as_it_was(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if iters:
        assert int(got[1]) > 0


def _spans_of(fn):
    profiling.clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            fn()
        return [s.name for s in profiling.spans()]
    finally:
        profiling.clear_spans()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_path_rule_and_spans(cpu_scene, cpu_start, cpu_tracked, monkeypatch,
                             device):
    """The kernel for maps on a CUDA device, inside `tsdf.gn_kernel`
    within `tsdf.gauss_newton`; the plain loop otherwise, with no
    `tsdf.gn_kernel` span. (The CUDA path runs here with the device rule
    forced, the launch replaced by the plain loop and the raycast's by
    the plain raycast.) Both paths give track_frame the same result."""
    calls = []
    plain = tsdf._gauss_newton_plain

    def kernel(*args):
        calls.append("kernel")
        return plain(*args)

    monkeypatch.setattr(gn_track, "gauss_newton", kernel)
    if device == "cuda":
        monkeypatch.setattr(_build, "uses_kernel", lambda d: True)
        monkeypatch.setattr(tsdf, "_raycast_kernel", tsdf._raycast_depth)
    assert _build.uses_kernel(torch.device("cpu")) == (device == "cuda")
    out = []
    names = _spans_of(lambda: out.append(tsdf.track_frame(
        cpu_scene["vol"], cpu_scene["depth"], CPU_INTR, cpu_start)))
    assert calls == (["kernel"] if device == "cuda" else [])
    assert "tsdf.gauss_newton" in names
    assert names.count("tsdf.gn_kernel") == (device == "cuda")
    if device == "cuda":
        i = names.index("tsdf.gauss_newton")
        assert names[i + 1] == "tsdf.gn_kernel"
    for a, b in zip(out[0], cpu_tracked):
        assert torch.equal(a, b)


def test_cuda_uses_the_kernel():
    assert _build.uses_kernel(torch.device("cuda", 0))
    assert not _build.uses_kernel(torch.device("cpu"))


def _bad(args, i, x):
    args = list(args)
    args[i] = x
    return tuple(args)


@pytest.mark.parametrize("case,match", [
    ("cpu", "unsupported device"),
    ("frame_ok_uint8", "frame_ok must be torch.bool"),
    ("v_model_float64", "v_model must be torch.float32"),
    ("v_model_shape", r"v_model must be \(3072, 3\)"),
    ("pose_shape", r"T_wc must be \(4, 4\)"),
    ("n_cam_strided", "n_cam must be contiguous"),
    ("mixed_devices", "model_ok must lie on cpu"),
    ("v_cam_flat", r"v_cam must be \(h, w, 3\)"),
    ("negative_iters", "iters >= 0"),
])
def test_wrapper_refuses(cpu_args, case, match):
    """gauss_newton raises on what the kernel does not take, before any
    launch: maps off a CUDA device, another dtype, shape or layout, maps
    on two devices, a negative step count."""
    args = cpu_args
    n = CPU_SHAPE[0] * CPU_SHAPE[1]
    bad = {
        "cpu": args,
        "frame_ok_uint8": _bad(args, 2, args[2].to(torch.uint8)),
        "v_model_float64": _bad(args, 3, args[3].double()),
        "v_model_shape": _bad(args, 3, torch.zeros(n, 4)),
        "pose_shape": _bad(args, 7, args[7][:3].contiguous()),
        "n_cam_strided": _bad(args, 1, args[1].transpose(0, 1)
                              .contiguous().transpose(0, 1)),
        "mixed_devices": _bad(args, 5, args[5].to("meta")),
        "v_cam_flat": _bad(args, 0, args[0].reshape(-1, 3)),
        "negative_iters": _with(args, iters=-1),
    }[case]
    before = gn_track.launches
    with pytest.raises(ValueError, match=match):
        gn_track.gauss_newton(*bad)
    assert gn_track.launches == before


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _scene(torch.device("cuda", 0), CARD_SHAPE, CARD_INTR)


CASES = {
    # 4° and 12 cm off, the default 10 steps.
    "perturbed": dict(rot_deg=4.0, trans=0.12, iters=10),
    # 5° and 28 cm off with a 8 cm final gate: the clamp and the wide
    # gate carry the first steps.
    "annealed": dict(rot_deg=5.0, trans=0.28, iters=12, dist_thresh=0.08),
    "one_step": dict(rot_deg=4.0, trans=0.12, iters=1),
    "no_step": dict(rot_deg=4.0, trans=0.12, iters=0),
    # No valid pixel in the frame: every step is the identity.
    "no_valid_pixel": dict(rot_deg=4.0, trans=0.12, iters=10, blank=True),
}


def _case_args(scene, case):
    kw = dict(CASES[case])
    T_init = _perturbed(scene["T_gt"], kw.pop("rot_deg"), kw.pop("trans"))
    return _gn_args(scene, T_init, **kw)


def _pose_gap(a, b):
    """(‖t_a − t_b‖, angle of R_aᵀ R_b) in float64, the angle from atan2
    of the skew and the symmetric part (test_torch_icp_kernel.py)."""
    a, b = (x.detach().cpu().double() for x in (a, b))
    R = a[:3, :3].T @ b[:3, :3]
    skew = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    ang = torch.atan2(0.5 * torch.linalg.vector_norm(skew),
                      0.5 * (torch.trace(R) - 1.0))
    return float(torch.linalg.vector_norm(a[:3, 3] - b[:3, 3])), float(ang)


def _steps(args):
    """(k, the kernel's step k, the plain loop's) for every step k: the
    kernel runs that step alone, with its gate, from the plain loop's pose
    after k steps."""
    T = args[7]
    for k in range(args[11]):
        step = _with(args, T_wc=T, iters=1,
                     wide_steps=int(k < args[12]))
        want = tsdf._gauss_newton_plain(*step)
        yield k, gn_track.gauss_newton(*step), want
        T = want[0]


def _nudged(args):
    """args with the start's translation entry j moved by one float32 ulp
    up or down, for j = 0, 1, 2."""
    for j in range(3):
        for toward in (np.inf, -np.inf):
            T = args[7].clone()
            x = np.float32(T[j, 3].item())
            T[j, 3] = float(np.nextafter(x, np.float32(toward)))
            yield _with(args, T_wc=T)


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(card, card_scene, case):
    """Each step alone: counts equal, rms and pose within the module's
    tolerances. Then the whole track in one launch, within the class of
    the plain loop's own last-bit differences."""
    args = _case_args(card_scene, case)
    for k, got, want in _steps(args):
        assert int(got[1]) == int(want[1]), (k, "inliers")
        assert int(got[3]) == int(want[3]), (k, "overlap")
        rms = float(want[2])
        assert abs(float(got[2]) - rms) <= 1e-5 * rms, (k, rms)
        td, rd = _pose_gap(got[0], want[0])
        assert td <= 1e-5 and rd <= 1e-5, (k, td, rd)
    before = gn_track.launches
    got = gn_track.gauss_newton(*args)
    assert gn_track.launches == before + 1
    want = tsdf._gauss_newton_plain(*args)
    if args[11] == 0 or CASES[case].get("blank"):
        assert torch.equal(got[0], args[7])
        assert int(got[1]) == int(got[3]) == 0 and float(got[2]) == 0.0
        return
    cls = np.max([_pose_gap(n[0], want[0])
                  for n in map(lambda a: tsdf._gauss_newton_plain(*a),
                               _nudged(args))], axis=0)
    td, rd = _pose_gap(got[0], want[0])
    assert td <= max(4 * cls[0], 1e-5) and rd <= max(4 * cls[1], 1e-5), \
        (td, rd, cls)


@pytest.mark.card
def test_same_bits_each_launch(card, card_scene):
    args = _case_args(card_scene, "perturbed")
    a, b = gn_track.gauss_newton(*args), gn_track.gauss_newton(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.card
def test_one_launch_per_frame(card, card_scene):
    """track_frame on the card, every case under one profiler session:
    one gn_track kernel a tracked frame, counted by the wrapper, inside
    one `tsdf.gn_kernel` span a frame."""
    s = card_scene
    frames = []
    for case, kw in CASES.items():
        kw = dict(kw)
        T_init = _perturbed(s["T_gt"], kw.pop("rot_deg"), kw.pop("trans"))
        depth = s["depth"] * np.float32(0.0 if kw.pop("blank", False)
                                        else 1.0)
        frames.append((depth, T_init, kw))
    for depth, T_init, kw in frames:           # warm-up
        tsdf.track_frame(s["vol"], depth, s["intr"], T_init, **kw)
    torch.cuda.synchronize(card)
    before = gn_track.launches
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for depth, T_init, kw in frames:
            tsdf.track_frame(s["vol"], depth, s["intr"], T_init, **kw)
        torch.cuda.synchronize(card)
    names = [sp.name for sp in profiling.spans()]
    profiling.clear_spans()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "gn_track" in e.name]
    assert gn_track.launches == before + len(frames)
    assert len(kernels) == len(frames), kernels
    assert names.count("tsdf.gn_kernel") == len(frames)
