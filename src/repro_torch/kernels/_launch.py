"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def check_no_grad(what: str, **tensors: torch.Tensor) -> None:
    """Raise for a tensor that requires grad while grad mode is on: the
    kernels write through raw pointers, so their outputs carry no autograd
    graph, and a loss through them would get no gradient without an error."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t.requires_grad:
            raise ValueError(f"{what}: {name} requires grad; the kernel has no backward "
                             "(call it under torch.no_grad() or detach the operand)")


def check_operands(what: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on ``device``
    that needs no gradient (:func:`check_no_grad`)."""
    check_no_grad(what, **tensors)
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes float32 storage")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_shape(what: str, name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


# CUDA's grid limits: 2^31 - 1 blocks on x, 65,535 on y and on z.
GRID_LIMITS = {"x": 2**31 - 1, "y": 65_535, "z": 65_535}


def check_grid(what: str, axis: str, blocks: int) -> None:
    """Raise before a launch whose grid needs more blocks on ``axis`` than
    the card takes: a fleet folded into a kernel's chain axis can outgrow
    an axis that a single system never fills, and a wrong grid would not
    fail, it would leave blocks unlaunched."""
    limit = GRID_LIMITS[axis]
    if blocks > limit:
        raise ValueError(
            f"{what}: {blocks:,} blocks on the grid's {axis} axis exceed its limit of "
            f"{limit:,}; split the batch into fewer systems"
        )


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
