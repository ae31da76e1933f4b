"""Small helpers shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """A Python float holding exactly the float32 value of x.

    The JAX package writes scalar constants as ``jnp.float32(x)``. A Python
    float that is already float32-exact gives the same float32 arithmetic
    whether torch applies it as a float or as a double scalar, since one
    correctly rounded double operation on float32 inputs rounds to the
    same float32 result."""
    return float(np.float32(x))


def default_device() -> torch.device:
    """The current CUDA device, where an entry point gets numpy inputs and
    no device. Without a card it raises: the port never picks the CPU by
    itself; a caller that wants the CPU passes device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """x as a tensor of `dtype`; a tensor input keeps its device unless
    `device` is given, a numpy input goes to `device` (default_device())."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device,
                    dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=device if device is not None
                           else default_device())


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
