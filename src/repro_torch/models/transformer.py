"""Decoder-only transformer LM (the dense and MoE families) on PyTorch.

A port of :mod:`repro.models.transformer` (stablelm-1.6b, phi3-mini-3.8b,
minitron-8b, starcoder2-15b, phi-3-vision-4.2b, deepseek-moe-16b,
mixtral-8x22b): pre-norm blocks of grouped-query attention with RoPE (and
a sliding window where the configuration has one) and a gated or plain
MLP, or a mixture of experts (:mod:`.moe`) where ``n_experts > 0``; the
VLM stub prepends precomputed patch embeddings to the token embeddings.
A prompt pass's attention runs on the hand-written CUDA flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`; its plain version on the
CPU) at every length: the kernel masks ragged tiles itself, so the JAX
package's T % 128 condition for its Pallas kernel has no counterpart here.
Decoding attends to a KV cache with the plain ``decode_attention``, as the
JAX package does, and routes the (B, 1) tokens of a step as one group of
B, as the JAX package's decode step does.

Parameters are float32 in the JAX package's layout (one
:class:`~repro_torch.models.layers.ParamTree` per layer), cast to the
compute dtype at each use, as the JAX code does.  The decode cache holds
``k`` and ``v`` (L, B, Hkv, S, Dh) in the compute dtype -- S is ``max_len``
or the window if smaller, a ring buffer that keeps position p in slot
p % S -- and the scalar ``len``, one length for every row, as in the JAX
package.  ``decode_step`` writes the new key and value into ``k`` / ``v``
in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import generator_on, resolve_device
from ..kernels import ops as kops
from ..launch.sharding import P
from . import moe as moe_mod
from .api import ModelConfig, ShapeSpec, dp_axes_for
from .layers import (
    ParamTree,
    apply_rope,
    attention,
    decode_attention,
    mlp,
    next_token_nll,
    normal,
    remat,
    rms_norm,
)
from .tensor_parallel import copy_to_model, vocab_parallel_embed


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def block_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One layer's parameters, with the JAX init's shapes and scales."""
    d, hd = cfg.d_model, cfg.head_dim
    dev = gen.device
    wi_cols = 2 * cfg.d_ff if cfg.gated_mlp else cfg.d_ff
    blk = {
        "ln1": torch.ones(d, device=dev),
        "ln2": torch.ones(d, device=dev),
        "attn": {
            "wq": normal(gen, (d, cfg.n_heads * hd), d**-0.5),
            "wk": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
            "wv": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
            "wo": normal(gen, (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
        },
    }
    if cfg.n_experts > 0:
        blk["moe"] = moe_mod.init_moe(cfg, gen)
    else:
        blk["mlp"] = {
            "wi": normal(gen, (d, wi_cols), d**-0.5),
            "wo": normal(gen, (cfg.d_ff, d), cfg.d_ff**-0.5),
        }
    return blk


class TransformerLM(ParamTree):
    """A dense or MoE transformer: ``embed``, ``blocks`` (one tree per layer),
    ``final_norm`` and, unless the embeddings are tied, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, embed, blocks: list[dict], final_norm,
                 lm_head=None):
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: lm_head must be given exactly when the "
                             "embeddings are not tied")
        tree = {
            "embed": embed,
            "blocks": nn.ModuleList(ParamTree(b) for b in blocks),
            "final_norm": final_norm,
        }
        if lm_head is not None:
            tree["lm_head"] = lm_head
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None):
        """Logits (B, T, vocab_padded) and the auxiliary loss (the routers'
        summed over layers; 0 for a dense model)."""
        return forward(self.cfg, self, tokens, patches)


def init(cfg: ModelConfig, generator: torch.Generator | None = None,
         device=None) -> TransformerLM:
    """Random float32 parameters drawn from ``generator`` (seed 0 when none
    is given), with the JAX init's shapes and scales; on the card unless
    ``device`` names another.  The generator must draw on that device."""
    gen = generator_on(device, generator)
    embed = normal(gen, (cfg.vocab_padded, cfg.d_model), 0.02)
    blocks = [block_tree(cfg, gen) for _ in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else normal(gen, (cfg.d_model, cfg.vocab_padded), 0.02)
    return TransformerLM(cfg, embed, blocks, torch.ones(cfg.d_model, device=gen.device), lm_head)


def _head(cfg: ModelConfig, params) -> torch.Tensor:
    """The output projection (D, vocab_padded): the transposed embedding
    when the embeddings are tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attend(cfg: ModelConfig):
    return lambda q, k, v: kops.flash_attention(q, k, v, causal=True, window=cfg.window)


def _ffn(cfg: ModelConfig, p, h: torch.Tensor, mesh=None):
    """The block's feed-forward: (y, aux) -- the experts' and their router's
    aux loss, or the MLP's and 0."""
    if cfg.n_experts > 0:
        return moe_mod.moe_mlp(cfg, p["moe"], h, mesh)
    return mlp(p["mlp"], h, cfg.act, cfg.gated_mlp, mesh), 0.0


def _block_fwd(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor, mesh=None):
    x = x + attention(cfg, p["attn"], rms_norm(x, p["ln1"]), positions, _attend(cfg), mesh)
    y, aux = _ffn(cfg, p, rms_norm(x, p["ln2"]), mesh)
    return x + y, aux


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None, mesh=None):
    """Prompt pass: tokens (B, T), and ``patches`` (B, Pn, D) prepended to
    their embeddings (the VLM stub) -> (logits (B, Pn + T, vocab_padded),
    aux loss as a float32 scalar: the routers' summed over layers, 0 for a
    dense model).  With a rank ``mesh``, ``params`` are the rank's blocks
    (``sharded.shard_model``), the inputs its rows, and the logits its
    vocabulary columns.  Under grad each block is rematerialized as
    ``cfg.remat`` says (:func:`~repro_torch.models.layers.remat`)."""
    cdt = cfg.cdtype
    x = vocab_parallel_embed(params["embed"], tokens, mesh).to(cdt)
    if patches is not None:
        x = torch.cat([patches.to(cdt), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params["blocks"]:
        x, aux_l = remat(cfg, _block_fwd, cfg, blk, x, positions, mesh)
        aux = aux + aux_l
    x = rms_norm(x, params["final_norm"])
    logits = copy_to_model(x, mesh) @ _head(cfg, params).to(cdt)
    return logits, aux


def loss(cfg: ModelConfig, params, batch: dict, mesh=None):
    """(total, {"nll", "aux"}): the next-token loss of ``batch["tokens"]``
    (B, T) plus the routers' aux loss (0 for a dense model, a scalar that
    carries gradient into every router for a MoE one).  With
    ``batch["patches"]`` (B, Pn, D) prepended, only the text region's
    logits count.  With a rank ``mesh``: the loss of the rank's rows from
    its parameter blocks, the same on every rank of a "model" line."""
    tokens = batch["tokens"]
    patches = batch.get("patches")
    logits, aux = forward(cfg, params, tokens, patches, mesh)
    if patches is not None:
        logits = logits[:, patches.shape[1]:]  # text region only
    nll = next_token_nll(logits, tokens, cfg.vocab, mesh)
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (KV cache; ring buffer under a sliding window)
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Cache slots: ``max_len``, or the window if it is smaller."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, prefilled: int = 0, device=None):
    """An empty KV cache of ``cache_len(cfg, max_len)`` slots, with length
    ``prefilled``; on the card unless ``device`` names another."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len(cfg, max_len), cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        "len": torch.tensor(prefilled, dtype=torch.int32, device=dev),
    }


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor):
    """One token per row (tokens (B, 1)): (logits (B, vocab), new cache).
    The key and value caches are updated in place at slot ``len % S``."""
    cdt = cfg.cdtype
    b = tokens.shape[0]
    hd = cfg.head_dim
    cur = cache["len"]
    s_cache = cache["k"].shape[3]
    slot = (cur % s_cache).long().reshape(1)  # == cur without a window
    n_valid = torch.clamp(cur + 1, max=s_cache)
    positions = cur[None]
    x = params["embed"][tokens[:, 0]].to(cdt)[:, None, :]
    for i, p in enumerate(params["blocks"]):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = rms_norm(x, p["ln1"])
        pa = p["attn"]
        q = (h @ pa["wq"].to(cdt)).reshape(b, 1, cfg.n_heads, hd)
        k = (h @ pa["wk"].to(cdt)).reshape(b, 1, cfg.n_kv_heads, hd)
        v = (h @ pa["wv"].to(cdt)).reshape(b, 1, cfg.n_kv_heads, hd)
        q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
        k_c.index_copy_(2, slot, k.to(k_c.dtype))
        v_c.index_copy_(2, slot, v.transpose(1, 2).to(v_c.dtype))
        o = decode_attention(q, k_c, v_c, n_valid)
        x = x + o.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd) @ pa["wo"].to(cdt)
        x = x + _ffn(cfg, p, rms_norm(x, p["ln2"]))[0]
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _head(cfg, params).to(cdt))[:, 0, : cfg.vocab]
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}


# ---------------------------------------------------------------------------
# Specs & shardings
# ---------------------------------------------------------------------------
#
# The JAX package's specs, on the port's layout: "blocks" is a list of
# per-layer trees, so each per-layer spec is the JAX one without its
# leading (layer) entry.  input_specs gives meta tensors (the
# ShapeDtypeStruct counterpart).


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step inputs of ``shape`` as ``device="meta"`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")  # noqa: E731
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((b, s), torch.int32)}
        if cfg.n_patches:
            specs["patches"] = meta((b, cfg.n_patches, cfg.d_model), cfg.cdtype)
        return specs
    kv = meta((cfg.n_layers, b, cfg.n_kv_heads, cache_len(cfg, s), cfg.head_dim), cfg.cdtype)
    return {"tokens": meta((b, 1), torch.int32),
            "cache": {"k": kv, "v": kv, "len": meta((), torch.int32)}}


def _kv_heads_spec(cfg: ModelConfig, mesh, batch: int):
    """Shard KV heads on 'model' when divisible, else shard head_dim."""
    dp = dp_axes_for(mesh, batch)
    model_size = mesh.shape.get("model", 1)
    if cfg.n_kv_heads % model_size == 0:
        return P(None, dp, "model", None, None)
    if cfg.head_dim % model_size == 0:
        return P(None, dp, None, None, "model")
    return P(None, dp, None, None, None)


def _block_pspecs(cfg: ModelConfig, mesh) -> dict:
    model_size = mesh.shape.get("model", 1)
    blk = {
        "ln1": P(None),
        "ln2": P(None),
        "attn": {"wq": P(None, "model"), "wk": P(None, "model"), "wv": P(None, "model"),
                 "wo": P("model", None)},
    }
    if cfg.n_experts > 0:
        if cfg.expert_sharding == "ep" and cfg.n_experts % model_size == 0:
            ex = {"wi": P("model", None, None), "wo": P("model", None, None)}
        else:
            ex = {"wi": P(None, None, "model"), "wo": P(None, "model", None)}
        blk["moe"] = {"router": P(None, None), "experts": ex}
        if cfg.n_shared_experts > 0:
            blk["moe"]["shared"] = {"wi": P(None, "model"), "wo": P("model", None)}
    else:
        blk["mlp"] = {"wi": P(None, "model"), "wo": P("model", None)}
    return blk


def param_pspecs(cfg: ModelConfig, mesh) -> dict:
    """Specs of every parameter: column-parallel ``wq`` / ``wk`` / ``wv`` /
    ``wi``, row-parallel ``wo``, the vocabulary split over "model"."""
    specs = {
        "embed": P("model", None),
        "blocks": [_block_pspecs(cfg, mesh) for _ in range(cfg.n_layers)],
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Specs of the step inputs: the batch split over the data axes."""
    dp = dp_axes_for(mesh, shape.global_batch)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": P(dp, None)}
        if cfg.n_patches:
            specs["patches"] = P(dp, None, None)
        return specs
    kv = _kv_heads_spec(cfg, mesh, shape.global_batch)
    return {"tokens": P(dp, None), "cache": {"k": kv, "v": kv, "len": P()}}
