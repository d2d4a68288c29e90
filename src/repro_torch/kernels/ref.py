"""Plain PyTorch versions of the two SaP-scan kernels (WKV6 and SSD).

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
"""

from __future__ import annotations

import torch

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
