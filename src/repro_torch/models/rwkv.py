"""RWKV6 ("Finch") family on PyTorch: attention-free LM with
data-dependent decay.

A port of :mod:`repro.models.rwkv`.  The WKV recurrence is a
block-bidiagonal system solved by the split-and-parallelize chunked scan,
on the card by the hand-written CUDA kernel
(:func:`repro_torch.kernels.ops.wkv6`).  Structure as in the JAX package:
data-dependent token shift (ddlerp with a small LoRA), decay
``w = exp(-exp(w0 + lora(x)))``, bonus ``u``, per-head GroupNorm, gated
output; ReLU^2 channel mixing.

Parameters are float32 in the JAX package's layout, one
:class:`~repro_torch.models.layers.ParamTree` per layer in an
``nn.ModuleList``; every matrix is cast to the compute dtype where it is
used, as in JAX.  States are dicts of tensors stacked over the layers:
``att_shift``, ``ffn_shift`` (L, B, D) and ``wkv`` (L, B, H, D, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import generator_on, resolve_device
from ..kernels import ops as kops
from ..launch.sharding import P
from .api import ModelConfig, ShapeSpec, dp_axes_for
from .layers import ParamTree, group_norm, next_token_nll, normal, remat, rms_norm
from .tensor_parallel import (
    copy_to_model,
    gather_from_model,
    model_size,
    row_parallel,
    scatter_to_model,
    split_count,
    vocab_parallel_embed,
)


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def block_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One layer's parameters, with the JAX init's shapes and scales."""
    d, f, lr = cfg.d_model, cfg.d_ff, cfg.rwkv_lora
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    dev = gen.device
    ones = lambda *s: torch.ones(s, device=dev)  # noqa: E731
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    return {
        "ln1": ones(d),
        "ln2": ones(d),
        "att": {
            "x_maa": zeros(d),
            "maa": zeros(5, d),
            "maa_w1": normal(gen, (d, 5 * lr), 0.01),
            "maa_w2": normal(gen, (5, lr, d), 0.01),
            "w0": torch.full((d,), -4.0, device=dev),
            "wd1": normal(gen, (d, lr), 0.01),
            "wd2": normal(gen, (lr, d), 0.01),
            "u": normal(gen, (h, hd), 0.1),
            "wr": normal(gen, (d, d), d**-0.5),
            "wk": normal(gen, (d, d), d**-0.5),
            "wv": normal(gen, (d, d), d**-0.5),
            "wg": normal(gen, (d, d), d**-0.5),
            "wo": normal(gen, (d, d), d**-0.5),
            "ln_x_w": ones(d),
            "ln_x_b": zeros(d),
        },
        "ffn": {
            "k_maa": zeros(d),
            "r_maa": zeros(d),
            "wk": normal(gen, (d, f), d**-0.5),
            "wv": normal(gen, (f, d), f**-0.5),
            "wr": normal(gen, (d, d), d**-0.5),
        },
    }


class RWKV6(ParamTree):
    """An RWKV6 model: ``embed``, ``blocks`` (one tree per layer),
    ``final_norm``, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, embed, blocks: list[dict], final_norm, lm_head):
        super().__init__({
            "embed": embed,
            "blocks": nn.ModuleList(ParamTree(b) for b in blocks),
            "final_norm": final_norm,
            "lm_head": lm_head,
        })
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, state: dict | None = None):
        """Logits (B, T, vocab_padded) and the carried state."""
        return forward(self.cfg, self, tokens, state)


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None) -> RWKV6:
    """Random float32 parameters drawn from ``generator`` (seed 0 when none
    is given), with the JAX init's shapes and scales; on the card unless
    ``device`` names another.  The generator must draw on that device."""
    gen = generator_on(device, generator)
    vp = cfg.vocab_padded
    embed = normal(gen, (vp, cfg.d_model), 0.02)
    blocks = [block_tree(cfg, gen) for _ in range(cfg.n_layers)]
    lm_head = normal(gen, (cfg.d_model, vp), 0.02)
    return RWKV6(cfg, embed, blocks, torch.ones(cfg.d_model, device=gen.device), lm_head)


# ---------------------------------------------------------------------------
# Block forward (sequence form)
# ---------------------------------------------------------------------------


def _ddlerp(p_att, x, xx):
    """RWKV6 data-dependent token shift: 5 mixed variants of x (w, k, v, r, g)."""
    sx = xx - x  # (B, T, D)
    xbase = x + sx * p_att["x_maa"].to(x.dtype)
    lo = torch.tanh(xbase @ p_att["maa_w1"].to(x.dtype))  # (B, T, 5*lr)
    b, t, _ = lo.shape
    lo = lo.reshape(b, t, 5, -1)
    delta = torch.einsum("btfl,fld->btfd", lo, p_att["maa_w2"].to(x.dtype))
    mix = p_att["maa"].to(x.dtype)[None, None] + delta  # (B, T, 5, D)
    return x[:, :, None, :] + sx[:, :, None, :] * mix


def _time_mix(cfg: ModelConfig, p_att, x, shift_in, wkv_in, mesh=None):
    """x: (B, T, D); shift_in: (B, D) last token of the previous call.
    Returns (out, shift_out, wkv_out).  With ``mesh`` the receptance, key,
    value and gate products are column-split and ``wo`` row-split over
    "model": the WKV6 kernel runs on the rank's heads, and the replicated
    decay and group-norm weights are sliced to its channels."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = split_count(_heads(cfg), mesh, "RWKV6 heads")
    xx = torch.cat([shift_in[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    mixed = _ddlerp(p_att, x, xx)
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)

    logw = -torch.exp(
        p_att["w0"].float()
        + (torch.tanh(xw @ p_att["wd1"].to(x.dtype)) @ p_att["wd2"].to(x.dtype)).float()
    )  # (B, T, D) <= 0
    heads = lambda y: y.reshape(b, t, h, hd).transpose(1, 2)  # noqa: E731
    col = lambda y, w: copy_to_model(y, mesh) @ p_att[w].to(x.dtype)  # noqa: E731
    r, k, v = heads(col(xr, "wr")), heads(col(xk, "wk")), heads(col(xv, "wv"))
    g = col(xg, "wg")
    lw = heads(scatter_to_model(logw, mesh))

    sdt = cfg.sdtype
    o, wkv_out = kops.wkv6(
        r.to(sdt), k.to(sdt), v.to(sdt), lw.to(sdt),
        p_att["u"].float(), wkv_in.float(), chunk=min(cfg.ssm_chunk, t),
    )
    o = o.transpose(1, 2).reshape(b, t, h * hd).to(x.dtype)
    o = group_norm(o, scatter_to_model(p_att["ln_x_w"], mesh),
                   scatter_to_model(p_att["ln_x_b"], mesh), groups=h)
    o = row_parallel(o * F.silu(g), p_att["wo"], mesh)
    return o, x[:, -1], wkv_out.to(wkv_in.dtype)


def _channel_mix(p_ffn, x, shift_in, mesh=None):
    """ReLU^2 channel mix.  With ``mesh``, ``wk`` is column-split and
    ``wv`` row-split, so ``kv`` comes whole out of the all-reduce, while
    ``sigmoid(xr @ wr)`` holds the rank's channels of ``wr``'s split and is
    gathered before the product."""
    xx = torch.cat([shift_in[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    sx = xx - x
    xk = x + sx * p_ffn["k_maa"].to(x.dtype)
    xr = x + sx * p_ffn["r_maa"].to(x.dtype)
    kk = F.relu(copy_to_model(xk, mesh) @ p_ffn["wk"].to(x.dtype)) ** 2
    kv = row_parallel(kk, p_ffn["wv"], mesh)
    gate = torch.sigmoid(copy_to_model(xr, mesh) @ p_ffn["wr"].to(x.dtype))
    return gather_from_model(gate, mesh) * kv, x[:, -1]


def _block_fwd(cfg, p_blk, x, att_shift, ffn_shift, wkv, mesh=None):
    h1 = rms_norm(x, p_blk["ln1"])
    att, s_att, wkv = _time_mix(cfg, p_blk["att"], h1, att_shift, wkv, mesh)
    x = x + att
    h2 = rms_norm(x, p_blk["ln2"])
    ffn, s_ffn = _channel_mix(p_blk["ffn"], h2, ffn_shift, mesh)
    return x + ffn, s_att, s_ffn, wkv


# ---------------------------------------------------------------------------
# Model-level API
# ---------------------------------------------------------------------------


def _zero_state(cfg: ModelConfig, batch: int, device, mesh=None) -> dict:
    h, hd = _heads(cfg) // model_size(mesh), cfg.rwkv_head_dim
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "att_shift": zeros(cfg.n_layers, batch, cfg.d_model),
        "ffn_shift": zeros(cfg.n_layers, batch, cfg.d_model),
        "wkv": zeros(cfg.n_layers, batch, h, hd, hd),
    }


def _layers(cfg: ModelConfig, params, x, state, mesh=None):
    outs = {"att_shift": [], "ffn_shift": [], "wkv": []}
    for i, p_blk in enumerate(params["blocks"]):
        x, s_att, s_ffn, wkv = remat(
            cfg, _block_fwd, cfg, p_blk, x, state["att_shift"][i], state["ffn_shift"][i],
            state["wkv"][i], mesh)
        # the shifts keep the compute dtype's values in the float32 state
        outs["att_shift"].append(s_att.to(state["att_shift"].dtype))
        outs["ffn_shift"].append(s_ffn.to(state["ffn_shift"].dtype))
        outs["wkv"].append(wkv)
    return x, {name: torch.stack(v) for name, v in outs.items()}


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, state: dict | None = None,
            mesh=None):
    """Prompt pass with a carried state: tokens (B, T) -> (logits
    (B, T, vocab_padded), state_out).  T must be at most ``ssm_chunk`` or
    a multiple of it.  With a rank ``mesh``, ``params`` are the rank's
    blocks (``sharded.shard_model``), the inputs its rows, the WKV state
    its heads', and the logits its vocabulary columns."""
    cdt = cfg.cdtype
    b, _ = tokens.shape
    x = vocab_parallel_embed(params["embed"], tokens, mesh).to(cdt)
    state = state if state is not None else _zero_state(cfg, b, tokens.device, mesh)
    x, state_out = _layers(cfg, params, x, state, mesh)
    x = rms_norm(x, params["final_norm"])
    logits = copy_to_model(x, mesh) @ params["lm_head"].to(cdt)
    return logits, state_out


def loss(cfg: ModelConfig, params, batch: dict, mesh=None):
    """(nll, {"nll", "aux": 0}): the next-token loss of ``batch["tokens"]``
    from a zero state (of the rank's rows, with a ``mesh``)."""
    logits = forward(cfg, params, batch["tokens"], mesh=mesh)[0]
    nll = next_token_nll(logits, batch["tokens"], cfg.vocab, mesh)
    return nll, {"nll": nll, "aux": torch.zeros((), device=nll.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, prefilled: int = 0, device=None):
    """A zero decode state for ``batch`` rows (RWKV6 needs no KV cache)."""
    return _zero_state(cfg, batch, resolve_device(device))


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor):
    """Single-token step (tokens (B, 1)): the T=1 sequence form with the
    state carried; returns (logits (B, vocab), new state)."""
    return forward_step(cfg, params, tokens, cache)


def forward_step(cfg: ModelConfig, params, tokens: torch.Tensor, state: dict):
    """One token per row through every layer: (logits (B, vocab), state)."""
    cdt = cfg.cdtype
    x = params["embed"][tokens[:, 0]].to(cdt)[:, None, :]
    x, state_out = _layers(cfg, params, x, state)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cdt))[:, 0, : cfg.vocab]
    return logits, state_out


# ---------------------------------------------------------------------------
# Specs & shardings (the JAX package's, per layer: see models/transformer.py)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step inputs of ``shape`` as ``device="meta"`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda *sh, dt=torch.float32: torch.empty(sh, dtype=dt, device="meta")  # noqa: E731
    if shape.kind in ("train", "prefill"):
        return {"tokens": meta(b, s, dt=torch.int32)}
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    return {"tokens": meta(b, 1, dt=torch.int32),
            "cache": {"att_shift": meta(cfg.n_layers, b, cfg.d_model),
                      "ffn_shift": meta(cfg.n_layers, b, cfg.d_model),
                      "wkv": meta(cfg.n_layers, b, h, hd, hd)}}


def _block_pspecs() -> dict:
    return {
        "ln1": P(None),
        "ln2": P(None),
        "att": {
            "x_maa": P(None),
            "maa": P(None, None),
            "maa_w1": P(None, None),
            "maa_w2": P(None, None, None),
            "w0": P(None),
            "wd1": P(None, None),
            "wd2": P(None, None),
            "u": P("model", None),
            "wr": P(None, "model"),
            "wk": P(None, "model"),
            "wv": P(None, "model"),
            "wg": P(None, "model"),
            "wo": P("model", None),
            "ln_x_w": P(None),
            "ln_x_b": P(None),
        },
        "ffn": {
            "k_maa": P(None),
            "r_maa": P(None),
            "wk": P(None, "model"),
            "wv": P("model", None),
            "wr": P(None, "model"),
        },
    }


def param_pspecs(cfg: ModelConfig, mesh) -> dict:
    """Specs of every parameter: heads split over "model"; the channel
    mix's ``wr`` column-split beside its row-split ``wv``."""
    return {
        "embed": P("model", None),
        "blocks": [_block_pspecs() for _ in range(cfg.n_layers)],
        "final_norm": P(None),
        "lm_head": P(None, "model"),
    }


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Specs of the step inputs: the batch split over the data axes."""
    dp = dp_axes_for(mesh, shape.global_batch)
    if shape.kind in ("train", "prefill"):
        return {"tokens": P(dp, None)}
    return {"tokens": P(dp, None),
            "cache": {"att_shift": P(None, dp, None), "ffn_shift": P(None, dp, None),
                      "wkv": P(None, dp, "model", None, None)}}
