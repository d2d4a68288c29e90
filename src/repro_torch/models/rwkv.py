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
from .api import ModelConfig
from .layers import ParamTree, group_norm, next_token_nll, normal, rms_norm


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


def _time_mix(cfg: ModelConfig, p_att, x, shift_in, wkv_in):
    """x: (B, T, D); shift_in: (B, D) last token of the previous call.
    Returns (out, shift_out, wkv_out)."""
    b, t, d = x.shape
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    xx = torch.cat([shift_in[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    mixed = _ddlerp(p_att, x, xx)
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)

    logw = -torch.exp(
        p_att["w0"].float()
        + (torch.tanh(xw @ p_att["wd1"].to(x.dtype)) @ p_att["wd2"].to(x.dtype)).float()
    )  # (B, T, D) <= 0
    heads = lambda y: y.reshape(b, t, h, hd).transpose(1, 2)  # noqa: E731
    r = heads(xr @ p_att["wr"].to(x.dtype))
    k = heads(xk @ p_att["wk"].to(x.dtype))
    v = heads(xv @ p_att["wv"].to(x.dtype))
    g = xg @ p_att["wg"].to(x.dtype)
    lw = heads(logw)

    sdt = cfg.sdtype
    o, wkv_out = kops.wkv6(
        r.to(sdt), k.to(sdt), v.to(sdt), lw.to(sdt),
        p_att["u"].float(), wkv_in.float(), chunk=min(cfg.ssm_chunk, t),
    )
    o = o.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    o = group_norm(o, p_att["ln_x_w"], p_att["ln_x_b"], groups=h)
    o = (o * F.silu(g)) @ p_att["wo"].to(x.dtype)
    return o, x[:, -1], wkv_out.to(wkv_in.dtype)


def _channel_mix(p_ffn, x, shift_in):
    xx = torch.cat([shift_in[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    sx = xx - x
    xk = x + sx * p_ffn["k_maa"].to(x.dtype)
    xr = x + sx * p_ffn["r_maa"].to(x.dtype)
    kk = F.relu(xk @ p_ffn["wk"].to(x.dtype)) ** 2
    kv = kk @ p_ffn["wv"].to(x.dtype)
    return torch.sigmoid(xr @ p_ffn["wr"].to(x.dtype)) * kv, x[:, -1]


def _block_fwd(cfg, p_blk, x, att_shift, ffn_shift, wkv):
    h1 = rms_norm(x, p_blk["ln1"])
    att, s_att, wkv = _time_mix(cfg, p_blk["att"], h1, att_shift, wkv)
    x = x + att
    h2 = rms_norm(x, p_blk["ln2"])
    ffn, s_ffn = _channel_mix(p_blk["ffn"], h2, ffn_shift)
    return x + ffn, s_att, s_ffn, wkv


# ---------------------------------------------------------------------------
# Model-level API
# ---------------------------------------------------------------------------


def _zero_state(cfg: ModelConfig, batch: int, device) -> dict:
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "att_shift": zeros(cfg.n_layers, batch, cfg.d_model),
        "ffn_shift": zeros(cfg.n_layers, batch, cfg.d_model),
        "wkv": zeros(cfg.n_layers, batch, h, hd, hd),
    }


def _layers(cfg: ModelConfig, params, x, state):
    outs = {"att_shift": [], "ffn_shift": [], "wkv": []}
    for i, p_blk in enumerate(params["blocks"]):
        x, s_att, s_ffn, wkv = _block_fwd(
            cfg, p_blk, x, state["att_shift"][i], state["ffn_shift"][i], state["wkv"][i]
        )
        # the shifts keep the compute dtype's values in the float32 state
        outs["att_shift"].append(s_att.to(state["att_shift"].dtype))
        outs["ffn_shift"].append(s_ffn.to(state["ffn_shift"].dtype))
        outs["wkv"].append(wkv)
    return x, {name: torch.stack(v) for name, v in outs.items()}


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, state: dict | None = None):
    """Prompt pass with a carried state: tokens (B, T) -> (logits
    (B, T, vocab_padded), state_out).  T must be at most ``ssm_chunk`` or
    a multiple of it."""
    cdt = cfg.cdtype
    b, _ = tokens.shape
    x = params["embed"][tokens].to(cdt)
    state = state if state is not None else _zero_state(cfg, b, tokens.device)
    x, state_out = _layers(cfg, params, x, state)
    x = rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"].to(cdt)
    return logits, state_out


def loss(cfg: ModelConfig, params, batch: dict):
    """(nll, {"nll", "aux": 0}): the next-token loss of ``batch["tokens"]``
    from a zero state."""
    nll = next_token_nll(forward(cfg, params, batch["tokens"])[0], batch["tokens"], cfg.vocab)
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
