"""Plain PyTorch versions of the two SaP-scan kernels (WKV6 and SSD) and
of the flash-attention kernel.

A copy of the sequence-mixing oracles of :mod:`repro.kernels.ref`: the
sequential recurrences (``wkv6_ref``, ``ssd_ref``, one step per token) and
the chunked SaP-scan forms (``wkv6_chunked_ref``, ``ssd_chunked_ref``)
that the CUDA kernels compute.  Each chunk is a local solve of the
block-bidiagonal system the recurrence defines (the intra-chunk term) plus
the carried state (the spike).  Every exponent is non-positive: the
masked upper triangle of the intra-chunk decay is masked before the
exponential, where the JAX package's ``wkv6_chunked_ref`` multiplies
``exp(diff)`` by the mask afterwards and so returns NaN (inf * 0) under
strong decay.  The chunked forms run every (batch, head) row at once and
loop over chunks.

:func:`flash_attention_ref` is the function of the TPU kernel
``repro/kernels/flash_attn.py:_flash_kernel``: the online softmax over
key tiles, with that kernel's masks, tile skip and finite ``NEG_INF``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite: -inf - -inf = NaN breaks the online softmax


def accumulation_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in: float32, or float64 for
    float64 inputs (gradient checks in float64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32

# ---------------------------------------------------------------------------
# RWKV6 WKV recurrence (matrix-valued state, per-channel data-dependent decay)
# ---------------------------------------------------------------------------


def wkv6_ref(r, k, v, logw, u, state):
    """Sequential WKV6 per head: ``o_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)``,
    ``S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T``.

    r/k/v/logw: (B, H, T, D); u: (H, D); state: (B, H, D, D) [k-dim x v-dim].
    Returns (o (B, H, T, D), state_out).
    """
    s = state
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, lwt = r[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t]
        o = torch.einsum("bhd,bhde->bhe", rt, s) + (rt * u * kt).sum(-1, keepdim=True) * vt
        s = torch.exp(lwt)[..., None] * s + kt[..., :, None] * vt[..., None, :]
        outs.append(o)
    return torch.stack(outs, dim=2), s


def wkv6_chunked_ref(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV6 (the algorithm of the kernel).  Per chunk, with
    ``Lcum = cumsum(logw)`` and ``Lprev`` its exclusive form:

        o_t   = (r_t * e^{Lprev_t}) @ S_in                                  [inter]
              + sum_{s<t} (sum_d r_td k_sd e^{Lprev_td - Lcum_sd}) v_s     [intra]
              + (r_t . u k_t) v_t                                         [bonus]
        S_out = diag(e^{Llast}) S_in + (k * e^{Llast - Lcum})^T v
    """
    bsz, h, t, d = r.shape
    nc = t // chunk
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    s = state
    outs = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        rj, kj, vj, lj = r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl]
        lcum = torch.cumsum(lj, dim=2)  # inclusive (B, H, C, D)
        lprev = torch.cat([torch.zeros_like(lcum[:, :, :1]), lcum[:, :, :-1]], dim=2)
        o_inter = (rj * torch.exp(lprev)) @ s
        diff = lprev[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B, H, C, C, D)
        # masked before the exponential: for s >= t the exponent is positive
        decay = torch.exp(torch.where(mask[:, :, None], diff, -torch.inf))
        g = torch.einsum("bhtd,bhsd,bhtsd->bhts", rj, kj, decay)
        diag = (rj * u[:, None, :] * kj).sum(-1)  # current-token bonus
        o_intra = g @ vj + diag[..., None] * vj
        llast = lcum[:, :, -1]  # (B, H, D)
        s = torch.exp(llast)[..., None] * s + (
            (kj * torch.exp(llast[:, :, None, :] - lcum)).transpose(-1, -2) @ vj
        )
        outs.append(o_inter + o_intra)
    return torch.cat(outs, dim=2), s


# ---------------------------------------------------------------------------
# Mamba-2 SSD recurrence (scalar per-head decay, outer-product state)
# ---------------------------------------------------------------------------


def ssd_ref(x, b, c, loga, state):
    """Sequential SSD per head: ``h_t = exp(a_t) h_{t-1} + b_t x_t^T``,
    ``y_t = c_t @ h_t``.

    x: (B, H, T, P) (dt-scaled); b/c: (B, H, T, N); loga: (B, H, T) (<= 0);
    state: (B, H, N, P).  Returns (y (B, H, T, P), state_out).
    """
    s = state
    ys = []
    for t in range(x.shape[2]):
        xt, bt, ct, lat = x[:, :, t], b[:, :, t], c[:, :, t], loga[:, :, t]
        s = torch.exp(lat)[..., None, None] * s + bt[..., :, None] * xt[..., None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, s))
    return torch.stack(ys, dim=2), s


def ssd_chunked_ref(x, b, c, loga, state, chunk: int):
    """Chunked SSD (the algorithm of the kernel).  Per chunk, with
    ``Lcum = cumsum(loga)``:

        G     = (C B^T) * e^{Lcum_t - Lcum_s}, masked to s <= t
        y     = e^{Lcum} * (C @ S_in) + G @ X
        S_out = e^{Llast} S_in + (B * e^{Llast - Lcum})^T X
    """
    t = x.shape[2]
    nc = t // chunk
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    s = state
    ys = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        xj, bj, cj, lj = x[:, :, sl], b[:, :, sl], c[:, :, sl], loga[:, :, sl]
        lcum = torch.cumsum(lj, dim=-1)  # inclusive (B, H, C)
        y_inter = torch.exp(lcum)[..., None] * (cj @ s)
        diff = lcum[..., :, None] - lcum[..., None, :]
        g = (cj @ bj.transpose(-1, -2)) * torch.exp(torch.where(mask, diff, -torch.inf))
        y_intra = g @ xj
        llast = lcum[..., -1:]  # (B, H, 1)
        s = torch.exp(llast)[..., None] * s + (
            (bj * torch.exp(llast - lcum)[..., None]).transpose(-1, -2) @ xj
        )
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=2), s


# ---------------------------------------------------------------------------
# Flash attention (online softmax over key tiles), GQA + causal / window
# ---------------------------------------------------------------------------


def _tile_rows(tq: int, k_start: int, block_q: int, block_k: int, causal: bool,
               window: Optional[int], q_offset: int) -> tuple[int, int]:
    """The rows [r0, r1) whose query tile visits the key tile at ``k_start``:
    causal, ``k_start <= q_end``; windowed, ``k_end >= q_start - (window -
    1)`` (the TPU kernel's block skip).  The visiting rows are contiguous."""
    r0, r1 = 0, tq
    if causal:  # first tile with q_offset + i*Bq + Bq - 1 >= k_start
        r0 = min(tq, max(0, -(-(k_start - q_offset - block_q + 1) // block_q)) * block_q)
    if window is not None:  # last tile with q_offset + i*Bq <= k_end + window - 1
        last = (k_start + block_k + window - 2 - q_offset) // block_q
        r1 = max(0, min(tq, (last + 1) * block_q))
    return r0, r1


def flash_attention_ref(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hk, Tk, D)
    v: torch.Tensor,  # (B, Hk, Tk, D)
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 64,
    block_k: int = 64,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention by the online softmax over key tiles of ``block_k``, never
    forming the (Tq, Tk) scores; the function of the CUDA kernel at its
    tiles (64 x 64).

    Key ``s`` is visible to query ``t`` (position ``q_offset + t``) iff
    ``s < Tk``, ``t >= s`` when causal and ``t - s < window`` when a window
    is given.  GQA: query head ``h`` reads key/value head ``h // (Hq //
    Hk)``.  A query tile of ``block_q`` rows skips the key tiles the masks
    leave empty for the whole tile; masked scores are the finite
    ``NEG_INF``, so a row's fully masked tiles before its first visible key
    are wiped by ``exp(NEG_INF - m) = 0``.  Computes in float32 (float64
    for float64 inputs: :func:`accumulation_dtype`) and returns ``acc /
    max(l, 1e-30)`` in q's dtype.  Differentiable: autograd of this
    function is the flash kernel's backward
    (:mod:`repro_torch.kernels.autograd`).
    """
    b, hq, tq, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    acc_dtype = accumulation_dtype(q)
    qg = q.reshape(b, hk, g, tq, d).to(acc_dtype)
    m_run = torch.full((b, hk, g, tq), NEG_INF, dtype=acc_dtype, device=q.device)
    l_run = torch.zeros((b, hk, g, tq), dtype=acc_dtype, device=q.device)
    acc = torch.zeros((b, hk, g, tq, d), dtype=acc_dtype, device=q.device)
    for k_start in range(0, tk, block_k):
        r0, r1 = _tile_rows(tq, k_start, block_q, block_k, causal, window, q_offset)
        if r0 >= r1:
            continue
        pad = max(0, k_start + block_k - tk)  # ragged last tile: zero keys and values
        kj = F.pad(k[:, :, k_start:k_start + block_k].to(acc_dtype), (0, 0, 0, pad))
        vj = F.pad(v[:, :, k_start:k_start + block_k].to(acc_dtype), (0, 0, 0, pad))
        q_pos = q_offset + torch.arange(r0, r1, device=q.device)[:, None]
        k_pos = k_start + torch.arange(block_k, device=q.device)[None, :]
        mask = k_pos < tk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        s = torch.einsum("bhgtd,bhcd->bhgtc", qg[:, :, :, r0:r1], kj) * scale
        s = torch.where(mask, s, NEG_INF)
        # the running rows are read as copies before they are overwritten in
        # place, so that autograd keeps the values it saved (the backward of
        # the flash kernel differentiates this function)
        m_prev = m_run[..., r0:r1].clone()
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l_run[..., r0:r1] = l_run[..., r0:r1].clone() * corr + p.sum(dim=-1)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :].clone() * corr[..., None]
                              + torch.einsum("bhgtc,bhcd->bhgtd", p, vj))
        m_run[..., r0:r1] = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(b, hq, tq, d).to(q.dtype)
