"""Checks shared by the kernels' wrappers: a launcher takes raw pointers, so
every tensor is checked for device, dtype, shape and contiguity before its
address is passed, and every launch's CUDA error is raised on."""

from __future__ import annotations

import torch


def check(name, x, shape, dtype, dev):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def stream(dev) -> int:
    """PyTorch's current CUDA stream on ``dev``, as the launchers take it."""
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def device_of(x) -> torch.device:
    """``x``'s device; only the CPU (plain version) and CUDA (kernel) are
    served."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def raise_on(err: int, what: str):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
