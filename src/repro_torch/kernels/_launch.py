"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def check_operands(what: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on ``device``."""
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


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
