"""Chunked RWKV6 WKV kernel (the SaP-scan of the RWKV6 time mix).

Replaces the TPU kernel ``repro/kernels/wkv_chunk.py:_wkv_kernel``
(``wkv6_pallas``).  The CUDA source is ``csrc/wkv.cu``: one thread block
per (batch, head) row walks the chunks in order with the D x D state in
shared memory; the intra-chunk decay weights are accumulated over the
channels in registers instead of materializing the (C, C, D) decay.

Bound on the H100: bytes at decode (T = 1: the state is read and written
once per token), operations at prefill (C^2 D / 2 exponentials per chunk).

On a CPU tensor the wrapper runs the plain version (:func:`wkv6_plain`,
:func:`repro_torch.kernels.ref.wkv6_chunked_ref` on the flattened rows);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import check_operands, check_shape, stream_handle
from .ref import wkv6_chunked_ref


def check_chunk(what: str, t: int, chunk: int) -> None:
    """Raise unless ``chunk`` tiles ``t`` (the JAX wrappers assert it)."""
    if chunk <= 0 or t % chunk:
        raise ValueError(f"{what}: T={t} is not divisible by chunk={chunk}")


def wkv6_plain(r, k, v, logw, u, state, chunk: int = 64):
    """The plain version on flattened rows, on any device: (o, state_out).
    Computes in float32 and returns o in r's dtype and the state in its
    own, as the TPU kernel does."""
    f = lambda a: a.float()[None]  # noqa: E731
    o, s = wkv6_chunked_ref(f(r), f(k), f(v), f(logw), u.float(), f(state), chunk)
    return o[0].to(r.dtype), s[0].to(state.dtype)


def wkv6(
    r: torch.Tensor,  # (BH, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (BH, T, D), <= 0
    u: torch.Tensor,  # (BH, D)
    state: torch.Tensor,  # (BH, D, D)
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 over flattened (batch x head) rows: (o, state_out)."""
    bh, t, d = r.shape
    check_chunk("wkv6", t, chunk)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, state, chunk)
    check_operands("wkv6", r.device, r=r, k=k, v=v, logw=logw, u=u, state=state)
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        check_shape("wkv6", name, x, (bh, t, d))
    check_shape("wkv6", "u", u, (bh, d))
    check_shape("wkv6", "state", state, (bh, d, d))
    lib = build.load("wkv")
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    if bh == 0:
        return o, s_out
    code = lib.wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), o.data_ptr(), s_out.data_ptr(), bh, t, d, chunk,
        stream_handle(r.device),
    )
    build.check(lib, code, "wkv6")
    wkv6.launches += 1
    return o, s_out


wkv6.launches = 0
