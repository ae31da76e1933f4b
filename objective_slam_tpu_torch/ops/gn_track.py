"""KinFu Gauss-Newton tracking in one launch (csrc/gn_track.cu).

``gauss_newton`` runs every step of ``models/tsdf.track_frame``'s
fixed-iteration loop (transform, projective association, gates, the 6×6
point-to-plane normal equations, the pivoted solve, the clamped Rodrigues
lift, the pose update) in one cooperative launch on the current stream,
with the pose kept on chip. It takes exactly the arguments of
``models/tsdf._gauss_newton_plain``, the loop of small torch ops that is
the CPU path and the kernel's twin, and returns the same tuple. The module
integer ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from objective_slam_tpu_torch._common import f32
from objective_slam_tpu_torch.ops import _build

# Floats of the kernel's workspace: two buffers of partial sums, a row of
# 32 for each of at most 1,024 blocks (csrc/gn_track.cu, kMaxGrid).
_PARTIALS = 2 * 1024 * 32
# The launcher's arguments before the stream (csrc/gn_track.cu).
_ARGTYPES = (*[ctypes.c_void_p] * 8, ctypes.c_int, ctypes.c_int,
             *[ctypes.c_float] * 7, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p)

launches = 0


def _check(x, name, shape, dtype, dev):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on `dev`."""
    if not isinstance(x, torch.Tensor) or x.device != dev:
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"gn_track: {name} must lie on {dev}, got {where}")
    if x.dtype != dtype:
        raise ValueError(f"gn_track: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"gn_track: {name} must be {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"gn_track: {name} must be contiguous")


def gauss_newton(v_cam, n_cam, frame_ok, v_model, n_model, model_ok,
                 T_cw_prev, T_wc, intrinsics, d2_max: float,
                 normal_cos: float, iters: int, wide_steps: int):
    """``_gauss_newton_plain``'s (T_wc, inliers, rms, overlap) from one
    launch of csrc/gn_track.cu. v_cam and n_cam are (h, w, 3), v_model and
    n_model (h·w, 3), all float32; frame_ok and model_ok (h·w,) bool;
    T_cw_prev and T_wc (4, 4) float32; every one contiguous on one CUDA
    device. Raises on anything else, and on a failed launch."""
    global launches
    dev = v_cam.device
    if v_cam.dim() != 3:
        raise ValueError(f"gn_track: v_cam must be (h, w, 3), got "
                         f"{tuple(v_cam.shape)}")
    if iters < 0:
        raise ValueError(f"gn_track: needs iters >= 0, got {iters}")
    h, w = v_cam.shape[:2]
    n = h * w
    for name, x, shape, dtype in (
            ("v_cam", v_cam, (h, w, 3), torch.float32),
            ("n_cam", n_cam, (h, w, 3), torch.float32),
            ("frame_ok", frame_ok, (n,), torch.bool),
            ("v_model", v_model, (n, 3), torch.float32),
            ("n_model", n_model, (n, 3), torch.float32),
            ("model_ok", model_ok, (n,), torch.bool),
            ("T_cw_prev", T_cw_prev, (4, 4), torch.float32),
            ("T_wc", T_wc, (4, 4), torch.float32)):
        _check(x, name, shape, dtype, dev)
    if not _build.uses_kernel(dev):
        raise ValueError(f"gn_track: unsupported device {dev}")
    fx, fy, cx, cy = (f32(v) for v in intrinsics)
    out = torch.empty(32 + _PARTIALS, dtype=torch.float32, device=dev)
    _build.launch(
        "gn_track", _ARGTYPES, v_cam.data_ptr(), n_cam.data_ptr(),
        frame_ok.data_ptr(), v_model.data_ptr(), n_model.data_ptr(),
        model_ok.data_ptr(), T_wc.data_ptr(), T_cw_prev.data_ptr(), h, w, fx,
        fy, cx, cy, f32(16.0 * d2_max), f32(d2_max), f32(normal_cos), iters,
        wide_steps, out[32:].data_ptr(), out.data_ptr(), device=dev,
        no_fit="gn_track: no block fits an SM")
    launches += 1
    counts = out[17:19].view(torch.int32)
    return out[:16].view(4, 4), counts[0], out[16], counts[1]
