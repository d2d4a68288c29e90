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


# The storage dtypes the kernels take, and the suffix of each one's C entry
# points (csrc/common.cuh: SAP_DTYPE_ENTRIES): the solver kernels (btf, bts,
# the fused pass, BCR) take all three, computing bfloat16 in float32 and
# float64 in float64; the scans take float32 and bfloat16 per-token
# tensors beside float32 states.
FLOAT32_ONLY = (torch.float32,)
SOLVER_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
SCAN_DTYPES = (torch.float32, torch.bfloat16)
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float64: "_f64"}


def entry(lib, name: str, dtype: torch.dtype):
    """The C entry point ``name`` of the library for ``dtype`` storage."""
    return getattr(lib, name + SUFFIX[dtype])


def _names(dtypes: tuple[torch.dtype, ...]) -> str:
    return " or ".join(str(d).removeprefix("torch.") for d in dtypes)


def check_operands(
    what: str, device: torch.device, dtypes: tuple[torch.dtype, ...] = FLOAT32_ONLY,
    **tensors: torch.Tensor,
) -> torch.dtype:
    """Raise unless the tensors are contiguous, on ``device``, need no
    gradient (:func:`check_no_grad`) and share one dtype of ``dtypes``;
    return that dtype.  Every check runs before any kernel is built."""
    check_no_grad(what, **tensors)
    first = None
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise TypeError(
                f"{what}: {name} is {t.dtype}; the kernel takes {_names(dtypes)} storage"
            )
        if first is None:
            first = (name, t.dtype)
        elif t.dtype != first[1]:
            raise TypeError(
                f"{what}: {name} is {t.dtype} but {first[0]} is {first[1]}; the kernel takes "
                "one storage dtype across its operands"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return first[1] if first else dtypes[0]


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
