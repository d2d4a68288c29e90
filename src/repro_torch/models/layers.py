"""Shared layers of the port's LM zoo: norms (RMS, layer, group), RoPE,
MLP, attention, the next-token loss, and the parameter container.  The
MLP, the attention's projections, the split RMS norm and the loss take an
optional rank ``mesh`` and split over its "model" axis
(:mod:`.tensor_parallel`); without one they are the single process's.

A copy of :mod:`repro.models.layers` in PyTorch, with every float32 cast
point the JAX code has.  Prompt attention is the flash kernel's plain
version, :func:`repro_torch.kernels.ref.flash_attention_ref` (the JAX
package's chunked online softmax); decoding attends to a KV cache here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ref import NEG_INF
from .tensor_parallel import (
    copy_to_model,
    model_size,
    reduce_from_model,
    row_parallel,
    split_count,
    vocab_parallel_nll,
)

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """Nested parameters addressed like the JAX package's dict pytree:
    ``tree["att"]["wr"]``.  Dict entries become child trees, modules stay
    modules (an ``nn.ModuleList`` of layers), tensors become parameters.

    Parameters are made with ``requires_grad=False``, so that serving runs
    no autograd bookkeeping.  To train a model, call
    ``model.requires_grad_(True)`` (as :class:`repro_torch.train.TrainLoop`
    does): every family's ``loss`` then back-propagates into all of them."""

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
# Rematerialization (the JAX package's jax.checkpoint of a layer)
# ---------------------------------------------------------------------------

_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    """The "dots" policy's contexts: save the outputs of the unbatched
    products (``aten.mm`` / ``aten.addmm``), recompute everything else --
    ``checkpoint_dots_with_no_batch_dims``.  A ``bmm`` (attention, the
    experts) has a batch dimension and is recomputed."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def _records(args) -> bool:
    """Whether autograd records a call on ``args``: grad mode on, and a
    tensor argument or a parameter of a module argument requires grad."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            return True
        if isinstance(a, nn.Module) and any(p.requires_grad for p in a.parameters()):
            return True
    return False


def remat(cfg, fn, *args):
    """``fn(*args)``, rematerialized as ``cfg.remat`` says when autograd
    records (:func:`_records`): "none" keeps every activation, "full" keeps
    ``fn``'s inputs and recomputes the rest in the backward, "dots" also
    keeps the unbatched products' outputs.  Where autograd does not record
    (serving: no grad, or frozen parameters) it is ``fn(*args)``.  Under a
    rank mesh the recompute replays ``fn``'s "model" collectives in the
    backward, every rank in the same order."""
    if cfg.remat == "none" or not _records(args):
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
    if cfg.remat != "full":
        raise ValueError(f"{cfg.name}: remat={cfg.remat!r}, not none | full | dots")
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dtype)


def split_rms_norm(x: torch.Tensor, w: torch.Tensor, mesh, eps: float = 1e-5) -> torch.Tensor:
    """:func:`rms_norm` over a last axis split over "model" (the rank holds
    ``x``'s and ``w``'s blocks), in float32; :func:`rms_norm` itself
    without a split."""
    if model_size(mesh) == 1:
        return rms_norm(x, w, eps)
    dtype = x.dtype
    xf = x.float()
    ss = copy_to_model(reduce_from_model((xf * xf).sum(dim=-1, keepdim=True), mesh), mesh)
    full_dim = x.shape[-1] * model_size(mesh)
    return (xf * torch.rsqrt(ss / full_dim + eps) * w.float()).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (whisper's pre-LN blocks), in float32."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


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


def mlp(params, x: torch.Tensor, act: str = "silu", gated: bool = True,
        mesh=None) -> torch.Tensor:
    """SwiGLU-style (gated: wi (D, 2F) fused gate|up) or plain 2-layer MLP.
    With ``mesh``, ``wi`` is column-split (a gated ``wi`` holds the rank's
    gate columns, then its up columns) and ``wo`` row-split over "model"."""
    h = copy_to_model(x, mesh) @ params["wi"].to(x.dtype)
    if gated:
        g, up = h.chunk(2, dim=-1)
        h = _act(act, g) * up
    else:
        h = _act(act, h)
    return row_parallel(h, params["wo"], mesh)


# ---------------------------------------------------------------------------
# Prompt attention's projections (GQA, RoPE)
# ---------------------------------------------------------------------------


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor, attend, mesh=None) -> torch.Tensor:
    """Pre-normed ``x`` (B, T, D) through ``wq`` / ``wk`` / ``wv``, RoPE,
    ``attend(q, k, v)`` on (B, H, T, Dh) heads and ``wo``.  With ``mesh``
    the projections are column-split and ``wo`` row-split over "model", so
    ``attend`` sees the rank's own query and KV heads."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    hkv = split_count(cfg.n_kv_heads, mesh, f"{cfg.name}: n_kv_heads")
    hq = cfg.n_heads // model_size(mesh)
    xc = copy_to_model(x, mesh)
    q = (xc @ p["wq"].to(x.dtype)).reshape(b, t, hq, hd)
    k = (xc @ p["wk"].to(x.dtype)).reshape(b, t, hkv, hd)
    v = (xc @ p["wv"].to(x.dtype)).reshape(b, t, hkv, hd)
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
    o = attend(q, k, v.transpose(1, 2))
    return row_parallel(o.transpose(1, 2).reshape(b, t, hq * hd), p["wo"], mesh)


# ---------------------------------------------------------------------------
# Decode attention over a KV cache, GQA
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor, vocab: int,
                   mesh=None) -> torch.Tensor:
    """Mean next-token negative log-likelihood, in float32: ``logsumexp -
    picked`` over ``logits[:, :-1, :vocab]`` against ``tokens[:, 1:]``, as
    every family's loss in the JAX package computes it.  With ``mesh`` the
    logits are the rank's vocabulary columns (``vocab_parallel_nll``)."""
    if model_size(mesh) > 1:
        return vocab_parallel_nll(logits, tokens, vocab, mesh)
    lg = logits[:, :-1, :vocab].float()
    picked = lg.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return (torch.logsumexp(lg, dim=-1) - picked).mean()
