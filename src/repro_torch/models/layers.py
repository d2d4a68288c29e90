"""Shared layers of the port's LM zoo: norms, RoPE, MLP, attention, and
the parameter container.

A copy of :mod:`repro.models.layers` in PyTorch, with every float32 cast
point the JAX code has.  Attention is the JAX package's plain chunked
online-softmax ("flash") formulation, a loop over key blocks that never
materializes the (Tq, Tk) scores; the Pallas flash kernel is a separate
TPU kernel, not this function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Nested parameters addressed like the JAX package's dict pytree:
    ``tree["att"]["wr"]``.  Dict entries become child trees, modules stay
    modules (an ``nn.ModuleList`` of layers), tensors become parameters
    (inference only: no gradients)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` (on its device) times ``scale``."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dtype)


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis (RWKV6's per-head ln_x), in float32."""
    dtype = x.dtype
    *lead, c = x.shape
    x = x.float().reshape(*lead, groups, c // groups)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    return (y * w.float() + b.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Rotary frequencies (D/2,), float32."""
    i = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, D); positions: (..., T) or (T,).  Rotates in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., T, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp(params, x: torch.Tensor, act: str = "silu", gated: bool = True) -> torch.Tensor:
    """SwiGLU-style (gated: wi (D, 2F) fused gate|up) or plain 2-layer MLP."""
    wi = params["wi"].to(x.dtype)
    wo = params["wo"].to(x.dtype)
    h = x @ wi
    if gated:
        g, up = h.chunk(2, dim=-1)
        h = _act(act, g) * up
    else:
        h = _act(act, h)
    return h @ wo


# ---------------------------------------------------------------------------
# Attention (chunked online softmax), GQA + causal/SWA masks
# ---------------------------------------------------------------------------


NEG_INF = -1e30  # finite: -inf - -inf = NaN breaks the online softmax


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(m, 0.0, NEG_INF).float()


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Tq, Dh)
    k: torch.Tensor,  # (B, Hk, Tk, Dh)
    v: torch.Tensor,  # (B, Hk, Tk, Dh)
    causal: bool = True,
    window: Optional[int] = None,
    block_k: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Chunked online-softmax attention over key blocks of ``block_k``.

    GQA: Hq must be a multiple of Hk; query heads are grouped.
    ``q_offset``: absolute position of q[0].
    """
    b, hq, tq, dh = q.shape
    hk, tk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hk, g, tq, dh).float()
    nblk = -(-tk // block_k)
    pad = nblk * block_k - tk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m_run = torch.full((b, hk, g, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, hk, g, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, tq, dh), dtype=torch.float32, device=q.device)
    for j in range(nblk):
        kj = k[:, :, j * block_k:(j + 1) * block_k].float()
        vj = v[:, :, j * block_k:(j + 1) * block_k].float()
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        bias = _mask_bias(q_pos, k_pos, causal, window)
        bias = torch.where((k_pos < tk)[None, :], bias, NEG_INF)
        s = torch.einsum("bhgtd,bhcd->bhgtc", qg, kj) * scale + bias
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgtc,bhcd->bhgtd", p, vj)
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(b, hq, tq, dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, Dh)
    k_cache: torch.Tensor,  # (B, Hk, S, Dh)
    v_cache: torch.Tensor,  # (B, Hk, S, Dh)
    cur_len,  # scalar or (B,) number of valid cache entries
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache."""
    b, hq, _, dh = q.shape
    hk, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, dh).float()
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device).expand(b)
    valid = pos[None, :] < cur[:, None]
    if window is not None:
        valid &= pos[None, :] >= cur[:, None] - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, dh).to(q.dtype)
