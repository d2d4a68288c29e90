"""Causal / sliding-window GQA flash attention kernel (transformer prefill).

Replaces the TPU kernel ``repro/kernels/flash_attn.py:_flash_kernel``
(``flash_attention_pallas``).  The CUDA source is ``csrc/flash_attn.cu``:
one thread block per (batch, query head, 64-row query tile) walks the
64-key tiles its masks leave (the TPU kernel's block skip), with the key
and value tiles in shared memory and each row's running maximum, sum and
D-wide accumulator in registers; the (Tq, Tk) scores never reach device
memory.  The TPU kernel's interleaved fold of the G query heads of a KV
head (for its 128-row matrix unit) is not carried over: a block reads its
KV head ``h // G`` directly.

Two kernels, by dtype.  bfloat16 (the prefill) runs on the tensor cores:
``mma.sync`` m16n8k16 for q . k -- exact products of bfloat16 inputs with
float32 sums, the TPU kernel's arithmetic up to summation order -- and for
p . v with p split into two bfloat16 terms (hi + lo, ~16 bits of the
TPU kernel's float32 p) into one float32 accumulator; K and V tiles
stream through a two-stage ``cp.async`` ring in shared memory.  Bound on
the H100: the tensor cores, 4 D operations per visible (query, key) pair
and query head at 989 TFLOP/s, beside one exponential a pair and q, k, v
and o moved once.  float32 (the consistency check) keeps the CUDA-core
kernel: 4 x 4 register tiles of float32 FMA.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`, the same 64 x 64
tiles); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from ._launch import check_no_grad, stream_handle
from .ref import NEG_INF, flash_attention_ref  # noqa: F401  (the kernel's kNegInf)

DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128


def check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: Optional[int]) -> None:
    """Raise unless q (B, Hq, Tq, D), k and v (B, Hk, Tk, D) fit together,
    with Hq a multiple of Hk, and ``window`` is None or positive."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D (B, H, T, D)")
    b, hq, _, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit together")
    hk = k.shape[1]
    if hk == 0 or hq % hk:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hk={hk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be positive")


def check_card_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernel takes these operands: one device, one dtype
    (bfloat16 or float32), contiguous from a 16-byte-aligned start (the
    kernel loads 16 bytes at a time), D a multiple of 8 up to 128, and no
    gradient needed (:func:`._launch.check_no_grad`)."""
    check_no_grad("flash_attention", q=q, k=k, v=v)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: the kernel takes bfloat16 or float32, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary")
    d = q.shape[3]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is not a multiple of 8 "
                         f"in [8, {MAX_HEAD_DIM}]")


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hk, Tk, D)
    v: torch.Tensor,  # (B, Hk, Tk, D)
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention output (B, Hq, Tq, D) in q's dtype."""
    check_flash(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window)
    check_card_operands(q, k, v)
    b, hq, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = build.load("flash_attn")
    code = lib.flash_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hk, tq, tk, d,
        int(causal), window or 0, int(q.dtype == torch.bfloat16), stream_handle(q.device),
    )
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
