"""Chunked RWKV6 WKV kernel (the SaP-scan of the RWKV6 time mix).

Replaces the TPU kernel ``repro/kernels/wkv_chunk.py:_wkv_kernel``
(``wkv6_pallas``).  The CUDA source is ``csrc/wkv.cu`` (with
``csrc/scan.cuh``).  :func:`scan_route` picks one of three routes from the
shape, and ``wkv6.by_route`` counts the calls each took:

- ``"step"`` (chunk 1: the decode step, and the chunk-1 forward): one pass
  over each row's state in registers per token;
- ``"split"`` (chunk up to 64): a CTA per (row, chunk) does the
  chunk-local work in parallel -- the intra term with its weights factored
  through sub-chunks of 16, the chunk's state contribution -- and a second
  launch carries the state along each row and adds the inter term;
- ``"block"`` (D above 64 or not a multiple of 4, a chunk above 64): the
  first port's kernel, one thread block per row walking its chunks.

r, k, v and log w may be float32 or bfloat16 (``scan_dtype``; one dtype
for the four, on the kernel's bfloat16 instantiation), u and the state
float32; the kernel computes in float32 and writes o in the inputs'
dtype.  ``wkv6.by_dtype`` counts the calls by that dtype.

Bound on the H100: bytes, at decode (T = 1: the state is read and written
once per token) and at prefill when counted in the token-by-token form.

On a CPU tensor the wrapper runs the plain version (:func:`wkv6_plain`,
:func:`repro_torch.kernels.ref.wkv6_chunked_ref` on the flattened rows);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import SCAN_DTYPES, check_operands, check_shape, entry, stream_handle
from .ref import accumulation_dtype, wkv6_chunked_ref


MAX_DIM = 64  # N, P, D of the step and split routes (csrc/scan.cuh: kMaxDim)
MAX_CHUNK = 64  # chunk of the split route (kMaxChunk)
ROUTES = ("block", "step", "split")  # the C entry points' route codes


def scan_route(chunk: int, *dims: int) -> str:
    """The route a scan of these state dimensions takes at this chunk."""
    if all(0 < d <= MAX_DIM and d % 4 == 0 for d in dims):
        if chunk == 1:
            return "step"
        if chunk <= MAX_CHUNK:
            return "split"
    return "block"


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it does not start on a 16-byte boundary
    (the step and split routes load 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_chunk(what: str, t: int, chunk: int) -> None:
    """Raise unless ``chunk`` tiles ``t`` (the JAX wrappers assert it)."""
    if chunk <= 0 or t % chunk:
        raise ValueError(f"{what}: T={t} is not divisible by chunk={chunk}")


def wkv6_plain(r, k, v, logw, u, state, chunk: int = 64):
    """The plain version on flattened rows, on any device: (o, state_out).
    Computes in float32 (float64 for float64 inputs) and returns o in r's
    dtype and the state in its own, as the TPU kernel does."""
    acc = accumulation_dtype(r)
    f = lambda a: a.to(acc)[None]  # noqa: E731
    o, s = wkv6_chunked_ref(f(r), f(k), f(v), f(logw), u.to(acc), f(state), chunk)
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
    dtype = check_operands("wkv6", r.device, SCAN_DTYPES, r=r, k=k, v=v, logw=logw)
    check_operands("wkv6", r.device, u=u, state=state)
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        check_shape("wkv6", name, x, (bh, t, d))
    check_shape("wkv6", "u", u, (bh, d))
    check_shape("wkv6", "state", state, (bh, d, d))
    lib = build.load("wkv")
    route = scan_route(chunk, d)
    if route != "block":
        r, k, v, logw, state = map(aligned, (r, k, v, logw, state))
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    if bh == 0:
        return o, s_out
    ws = (torch.empty(entry(lib, "wkv_workspace_floats", dtype)(bh, t, d, chunk),
                      dtype=torch.float32, device=r.device) if route == "split" else None)
    code = entry(lib, "wkv_launch", dtype)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        state.data_ptr(), o.data_ptr(), s_out.data_ptr(), None if ws is None else ws.data_ptr(),
        bh, t, d, chunk, ROUTES.index(route), stream_handle(r.device),
    )
    build.check(lib, code, f"wkv6 ({route} route, {dtype})")
    wkv6.launches += 1
    wkv6.by_dtype[dtype] = wkv6.by_dtype.get(dtype, 0) + 1
    wkv6.by_route[route] += 1
    return o, s_out


wkv6.launches = 0  # wrapper calls that launched (the split route's two kernels count once)
wkv6.by_route = dict.fromkeys(ROUTES, 0)  # those calls by route
wkv6.by_dtype = {}  # those calls by the dtype of r, k, v, log w
