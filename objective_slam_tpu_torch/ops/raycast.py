"""KinFu raycast in three launches (csrc/raycast.cu).

``raycast_depth`` computes ``models/tsdf._raycast_depth``'s depth view on
the current stream: two passes write the sign of the 3³ min-pooled
observed field as two bit planes, then a march of one thread a pixel
steps through them and refines each bracket with trilinear samples of
the volume. It takes the march's small tables (the coarse parameters
`ts`, the window offsets `offs`, the pixel rays' camera-frame x and y)
as ``models/tsdf`` computes them, so that the depths equal the plain
version's bit for bit. The module integer ``launches`` counts calls of
the launcher, each the three kernels.
"""

from __future__ import annotations

import ctypes

import torch

from objective_slam_tpu_torch.ops import _build

# The launcher's arguments before the stream (csrc/raycast.cu).
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 3,
             *[ctypes.c_void_p] * 3, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             *[ctypes.c_int] * 3, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p)

launches = 0


def _check(x, name, shape, dev):
    """Raise unless x is a contiguous float32 tensor of `shape` on `dev`."""
    if not isinstance(x, torch.Tensor) or x.device != dev:
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"raycast: {name} must lie on {dev}, got {where}")
    if x.dtype != torch.float32:
        raise ValueError(f"raycast: {name} must be torch.float32, got "
                         f"{x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"raycast: {name} must be {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"raycast: {name} must be contiguous")


def raycast_depth(tsdf, weight, origin, T_wc, ts, offs, ray_u, ray_v,
                  vs_inv: float, truncation: float, n_brackets: int):
    """The (h, w) float32 depth view of the volume (tsdf, weight: (D, H, W)
    float32, voxel (0, 0, 0) at `origin` (3,), 1/voxel size `vs_inv`) from
    camera T_wc (4, 4) camera→world: for each pixel the first crossing of
    the first `n_brackets` brackets of the coarse march at parameters ts
    (n_steps,), refined over the window offsets offs (fine_steps,); rays
    (ray_u[u], ray_v[v], 1) in the camera frame, ray_u (w,) and ray_v (h,).
    Every tensor float32, contiguous, on one CUDA device. Raises on
    anything else, on n_steps < 2, and on a failed launch."""
    global launches
    dev = tsdf.device
    if tsdf.dim() != 3:
        raise ValueError(f"raycast: tsdf must be (D, H, W), got "
                         f"{tuple(tsdf.shape)}")
    D, H, W = tsdf.shape
    n_steps, fine_steps = ts.numel(), offs.numel()
    h, w = ray_v.numel(), ray_u.numel()
    if n_steps < 2:
        raise ValueError(f"raycast: needs n_steps >= 2, got {n_steps}")
    if fine_steps < 1 or n_brackets < 0:
        raise ValueError(f"raycast: needs fine_steps >= 1 and n_brackets "
                         f">= 0, got {fine_steps} and {n_brackets}")
    for name, x, shape in (
            ("tsdf", tsdf, (D, H, W)), ("weight", weight, (D, H, W)),
            ("origin", origin, (3,)), ("T_wc", T_wc, (4, 4)),
            ("ts", ts, (n_steps,)), ("offs", offs, (fine_steps,)),
            ("ray_u", ray_u, (w,)), ("ray_v", ray_v, (h,))):
        _check(x, name, shape, dev)
    if not _build.uses_kernel(dev):
        raise ValueError(f"raycast: unsupported device {dev}")
    work = torch.empty((2, D, H, (W + 31) // 32, 2), dtype=torch.int32,
                       device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    _build.launch(
        "raycast", _ARGTYPES, tsdf.data_ptr(), weight.data_ptr(), D, H, W,
        origin.data_ptr(), T_wc.data_ptr(), ts.data_ptr(), n_steps,
        offs.data_ptr(), fine_steps, ray_u.data_ptr(), ray_v.data_ptr(), h,
        w, n_brackets, float(vs_inv), float(truncation), work.data_ptr(),
        depth.data_ptr(), device=dev, no_fit="raycast: no block fits an SM")
    launches += 1
    return depth
