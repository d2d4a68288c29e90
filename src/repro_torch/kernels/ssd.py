"""Chunked Mamba-2 SSD kernel (the SaP-scan of the Mamba-2 mixer).

Replaces the TPU kernel ``repro/kernels/ssd_chunk.py:_ssd_kernel``
(``ssd_pallas``).  The CUDA source is ``csrc/ssd.cu`` (with
``csrc/scan.cuh``), on the routes of :func:`.wkv.scan_route` (``"step"``
at chunk 1, ``"split"`` up to chunk 64, else ``"block"``), counted in
``ssd.by_route``.  On the split route a CTA forms C B^T once for a group
of heads that share B and C.  ``b`` and ``c`` may be shared by ``hshare``
consecutive rows (Mamba-2 broadcasts them over the heads of a token): the
kernel then reads row ``i // hshare`` and no per-head copy is made.

x, b and c may be float32 or bfloat16 (``scan_dtype``; one dtype for the
three, on the kernel's bfloat16 instantiation), log a and the state
float32; the kernel computes in float32 and writes y in x's dtype.
``ssd.by_dtype`` counts the calls by that dtype.

Bound on the H100: bytes at decode (T = 1: the state is read and written
once per token), operations at prefill (5 N P flops a token, counted in
the token-by-token form).

On a CPU tensor the wrapper runs the plain version (:func:`ssd_plain`,
:func:`repro_torch.kernels.ref.ssd_chunked_ref` on the flattened rows);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import SCAN_DTYPES, check_operands, check_shape, entry, stream_handle
from .ref import accumulation_dtype, ssd_chunked_ref
from .wkv import ROUTES, aligned, check_chunk, scan_route


def ssd_plain(x, b, c, loga, state, chunk: int = 64, hshare: int = 1):
    """The plain version on flattened rows, on any device (B and C repeated
    for the rows that share them): (y, state_out).  Computes in float32
    (float64 for float64 inputs) and returns y in x's dtype and the state
    in its own, as the TPU kernel does."""
    acc = accumulation_dtype(x)
    rep = lambda a: a.to(acc).repeat_interleave(hshare, dim=0)[None]  # noqa: E731
    y, s = ssd_chunked_ref(x.to(acc)[None], rep(b), rep(c), loga.to(acc)[None],
                           state.to(acc)[None], chunk)
    return y[0].to(x.dtype), s[0].to(state.dtype)


def ssd(
    x: torch.Tensor,  # (BH, T, P)
    b: torch.Tensor,  # (BH / hshare, T, N)
    c: torch.Tensor,  # (BH / hshare, T, N)
    loga: torch.Tensor,  # (BH, T), <= 0
    state: torch.Tensor,  # (BH, N, P)
    chunk: int = 64,
    hshare: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over flattened (batch x head) rows: (y, state_out)."""
    bh, t, p = x.shape
    n = b.shape[-1]
    check_chunk("ssd", t, chunk)
    if hshare <= 0 or bh % hshare:
        raise ValueError(f"ssd: {bh} rows are not a multiple of hshare={hshare}")
    if x.device.type == "cpu":
        return ssd_plain(x, b, c, loga, state, chunk, hshare)
    dtype = check_operands("ssd", x.device, SCAN_DTYPES, x=x, b=b, c=c)
    check_operands("ssd", x.device, loga=loga, state=state)
    check_shape("ssd", "b", b, (bh // hshare, t, n))
    check_shape("ssd", "c", c, (bh // hshare, t, n))
    check_shape("ssd", "loga", loga, (bh, t))
    check_shape("ssd", "state", state, (bh, n, p))
    lib = build.load("ssd")
    route = scan_route(chunk, n, p)
    if route != "block":
        x, b, c, state = map(aligned, (x, b, c, state))
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    if bh == 0:
        return y, s_out
    ws = (torch.empty(entry(lib, "ssd_workspace_floats", dtype)(bh, t, n, p, chunk),
                      dtype=torch.float32, device=x.device) if route == "split" else None)
    code = entry(lib, "ssd_launch", dtype)(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), loga.data_ptr(), state.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), None if ws is None else ws.data_ptr(), bh, t, n, p,
        chunk, hshare, ROUTES.index(route), stream_handle(x.device),
    )
    build.check(lib, code, f"ssd ({route} route, {dtype})")
    ssd.launches += 1
    ssd.by_dtype[dtype] = ssd.by_dtype.get(dtype, 0) + 1
    ssd.by_route[route] += 1
    return y, s_out


ssd.launches = 0  # wrapper calls that launched (the split route's two kernels count once)
ssd.by_route = dict.fromkeys(ROUTES, 0)  # those calls by route
ssd.by_dtype = {}  # those calls by the dtype of x, b, c
