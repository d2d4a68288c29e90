"""Whisper-style encoder-decoder family (audio backbone, conv-frontend stub).

A port of :mod:`repro.models.whisper`.  The modality frontend is a stub:
the caller supplies precomputed mel-frame embeddings (B, enc_seq, D).  The
backbone: sinusoidal positions on the encoder, learned positions on the
decoder (``pos_dec``, 32,768 rows), pre-LN blocks with GELU MLPs, decoder
cross-attention and a tied output head.

Every prompt-side attention -- the encoder's bidirectional self-attention
(Tq = Tk = enc_seq, a ragged tile at 1,500), the decoder's causal
self-attention and its cross-attention (Tq != Tk) -- runs on the
hand-written flash kernel (:func:`repro_torch.kernels.ops.flash_attention`;
its plain version on the CPU), where the JAX package calls the jnp
``layers.flash_attention``: the function is the same.  Decoding attends to
a self-attention KV cache and to precomputed cross-attention K/V with the
plain ``decode_attention``, as the JAX package does.

Parameters are float32 in the JAX package's layout (one
:class:`~repro_torch.models.layers.ParamTree` per layer), cast to the
compute dtype at each use.  The decode cache holds ``self_k`` /
``self_v`` (L, B, Hkv, max_len, Dh), ``cross_k`` / ``cross_v`` (L, B,
Hkv, enc_seq, Dh) and the scalar ``len``; ``init_cache`` zeros the cross
K/V and only :func:`precompute_cross_kv` fills them (the JAX package's
serving engine never does: ROADMAP R8).  ``decode_step`` writes the new
self key and value in place; like the JAX package's dynamic slices, the
write slot and the decoder position are clamped to the last row.

``forward`` / ``loss`` take a rank ``mesh`` (:mod:`.sharded`): the heads
and the MLP split over "model" as the dense family's
(:mod:`.tensor_parallel`), the tied head over the vocabulary, the frames
over the data axes.  A training forward rematerializes each encoder and
decoder block as ``cfg.remat`` says.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import generator_on, resolve_device
from ..kernels import ops as kops
from ..launch.sharding import P
from .api import ModelConfig, ShapeSpec, dp_axes_for
from .layers import (
    ParamTree,
    decode_attention,
    layer_norm,
    mlp,
    next_token_nll,
    normal,
    remat,
)
from .tensor_parallel import (
    copy_to_model,
    model_size,
    row_parallel,
    split_count,
    vocab_parallel_embed,
)

POS_DEC_ROWS = 32_768


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Sinusoidal positions (length, channels), float32: sines then cosines."""
    log_timescale = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, device=device,
                                                  dtype=torch.float32))
    t = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": normal(gen, (d, cfg.n_heads * hd), d**-0.5),
        "wk": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
        "wv": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
        "wo": normal(gen, (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
    }


def _ln(d: int, dev) -> dict:
    return {"w": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}


def _mlp_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    return {"wi": normal(gen, (cfg.d_model, cfg.d_ff), cfg.d_model**-0.5),
            "wo": normal(gen, (cfg.d_ff, cfg.d_model), cfg.d_ff**-0.5)}


def enc_block_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One encoder layer's parameters, with the JAX init's shapes and scales."""
    d, dev = cfg.d_model, gen.device
    return {"ln1": _ln(d, dev), "attn": _attn_params(cfg, gen), "ln2": _ln(d, dev),
            "mlp": _mlp_params(cfg, gen)}


def dec_block_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One decoder layer's parameters, with the JAX init's shapes and scales."""
    d, dev = cfg.d_model, gen.device
    return {"ln1": _ln(d, dev), "self_attn": _attn_params(cfg, gen), "ln_x": _ln(d, dev),
            "cross_attn": _attn_params(cfg, gen), "ln2": _ln(d, dev),
            "mlp": _mlp_params(cfg, gen)}


class Whisper(ParamTree):
    """The encoder-decoder: ``embed`` (tied head), ``pos_dec``,
    ``enc_blocks`` and ``dec_blocks`` (one tree per layer), ``enc_ln`` and
    ``dec_ln``."""

    def __init__(self, cfg: ModelConfig, embed, pos_dec, enc_blocks: list[dict],
                 dec_blocks: list[dict], enc_ln: dict, dec_ln: dict):
        super().__init__({
            "embed": embed,
            "pos_dec": pos_dec,
            "enc_blocks": nn.ModuleList(ParamTree(b) for b in enc_blocks),
            "dec_blocks": nn.ModuleList(ParamTree(b) for b in dec_blocks),
            "enc_ln": enc_ln,
            "dec_ln": dec_ln,
        })
        self.cfg = cfg

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor):
        """Logits (B, T, vocab_padded) and the auxiliary loss (0)."""
        return forward(self.cfg, self, {"frames": frames, "tokens": tokens})


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None) -> Whisper:
    """Random float32 parameters drawn from ``generator`` (seed 0 when none
    is given), with the JAX init's shapes and scales; on the card unless
    ``device`` names another.  The generator must draw on that device."""
    gen = generator_on(device, generator)
    d, dev = cfg.d_model, gen.device
    embed = normal(gen, (cfg.vocab_padded, d), 0.02)
    enc = [enc_block_tree(cfg, gen) for _ in range(cfg.n_enc_layers)]
    dec = [dec_block_tree(cfg, gen) for _ in range(cfg.n_layers)]
    pos_dec = normal(gen, (POS_DEC_ROWS, d), 0.01)
    return Whisper(cfg, embed, pos_dec, enc, dec, _ln(d, dev), _ln(d, dev))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mha(cfg: ModelConfig, p, xq: torch.Tensor, xkv: torch.Tensor, causal: bool,
         mesh=None) -> torch.Tensor:
    """Attention of ``xq`` to ``xkv`` (the same tensor in self-attention).
    With ``mesh`` the projections are column-split and ``wo`` row-split
    over "model" (the rank's heads); a cross-attention's ``xkv`` comes in
    through ``copy_to_model`` already (:func:`decode_train`)."""
    b, tq, _ = xq.shape
    hd = cfg.head_dim
    hkv = split_count(cfg.n_kv_heads, mesh, f"{cfg.name}: n_kv_heads")
    hq = cfg.n_heads // model_size(mesh)
    xc = copy_to_model(xq, mesh)
    xkv = xc if xkv is xq else xkv
    q = (xc @ p["wq"].to(xq.dtype)).reshape(b, tq, hq, hd)
    k = (xkv @ p["wk"].to(xq.dtype)).reshape(b, -1, hkv, hd)
    v = (xkv @ p["wv"].to(xq.dtype)).reshape(b, -1, hkv, hd)
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal)
    return row_parallel(o.transpose(1, 2).reshape(b, tq, hq * hd), p["wo"], mesh)


def _enc_block(cfg: ModelConfig, p, x: torch.Tensor, mesh=None) -> torch.Tensor:
    h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
    x = x + _mha(cfg, p["attn"], h, h, False, mesh)
    h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"])
    return x + mlp(p["mlp"], h, "gelu", False, mesh)


def _dec_block(cfg: ModelConfig, p, x: torch.Tensor, enc: torch.Tensor,
               mesh=None) -> torch.Tensor:
    h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
    x = x + _mha(cfg, p["self_attn"], h, h, True, mesh)
    h = layer_norm(x, p["ln_x"]["w"], p["ln_x"]["b"])
    x = x + _mha(cfg, p["cross_attn"], h, enc, False, mesh)
    h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"])
    return x + mlp(p["mlp"], h, "gelu", False, mesh)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, mesh=None) -> torch.Tensor:
    """frames: (B, enc_seq, D) precomputed embeddings (the conv stub) ->
    the encoder's output (B, enc_seq, D) in the compute dtype.  Under grad
    each block is rematerialized as ``cfg.remat`` says."""
    cdt = cfg.cdtype
    x = frames.to(cdt) + _sinusoids(frames.shape[1], cfg.d_model, frames.device).to(cdt)
    for p in params["enc_blocks"]:
        x = remat(cfg, _enc_block, cfg, p, x, mesh)
    return layer_norm(x, params["enc_ln"]["w"], params["enc_ln"]["b"])


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor, enc: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """The decoder over whole token sequences (B, T) attending to ``enc``:
    logits (B, T, vocab_padded) -- with ``mesh`` the rank's vocabulary
    columns of them (the tied head's split embedding, transposed).  Under
    grad each block is rematerialized as ``cfg.remat`` says."""
    cdt = cfg.cdtype
    t = tokens.shape[1]
    x = vocab_parallel_embed(params["embed"], tokens, mesh).to(cdt)
    x = x + params["pos_dec"][:t].to(cdt)
    enc = copy_to_model(enc, mesh)  # every layer's cross K / V read it
    for p in params["dec_blocks"]:
        x = remat(cfg, _dec_block, cfg, p, x, enc, mesh)
    x = layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])
    return copy_to_model(x, mesh) @ params["embed"].T.to(cdt)  # tied head


def forward(cfg: ModelConfig, params, batch: dict, mesh=None):
    """batch {"frames": (B, enc_seq, D), "tokens": (B, T)} -> (logits (B, T,
    vocab_padded), aux loss 0 as a float32 scalar).  With a rank ``mesh``,
    ``params`` are the rank's blocks (``sharded.shard_model``), the batch
    its rows, and the logits its vocabulary columns."""
    enc = encode(cfg, params, batch["frames"], mesh)
    logits = decode_train(cfg, params, batch["tokens"], enc, mesh)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss(cfg: ModelConfig, params, batch: dict, mesh=None):
    """(nll, {"nll", "aux": 0}): the next-token loss of the decoder over
    ``batch["tokens"]`` attending to the encoded ``batch["frames"]`` (of
    the rank's rows, the same on every rank of a "model" line, with a
    ``mesh``)."""
    logits, aux = forward(cfg, params, batch, mesh)
    nll = next_token_nll(logits, batch["tokens"], cfg.vocab, mesh)
    return nll, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (cached)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, prefilled: int = 0, device=None):
    """A zero cache: self K/V of ``max_len`` slots, cross K/V of
    ``enc_seq``, length ``prefilled``; on the card unless ``device`` names
    another."""
    dev = resolve_device(device)

    def kv(s):
        return torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim),
                           dtype=cfg.cdtype, device=dev)

    return {"self_k": kv(max_len), "self_v": kv(max_len), "cross_k": kv(cfg.enc_seq),
            "cross_v": kv(cfg.enc_seq), "len": torch.tensor(prefilled, dtype=torch.int32,
                                                             device=dev)}


def precompute_cross_kv(cfg: ModelConfig, params, enc: torch.Tensor):
    """The cross-attention K/V of every decoder layer, once a request batch:
    (cross_k, cross_v), each (L, B, Hkv, T_enc, Dh) in enc's dtype."""
    b, hd = enc.shape[0], cfg.head_dim
    ks, vs = [], []
    for p in params["dec_blocks"]:
        pc = p["cross_attn"]
        ks.append((enc @ pc["wk"].to(enc.dtype)).reshape(b, -1, cfg.n_kv_heads, hd)
                  .transpose(1, 2))
        vs.append((enc @ pc["wv"].to(enc.dtype)).reshape(b, -1, cfg.n_kv_heads, hd)
                  .transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor):
    """One token per row (tokens (B, 1)): (logits (B, vocab), new cache).
    The self K/V caches are updated in place at slot ``len``."""
    cdt = cfg.cdtype
    b, hd = tokens.shape[0], cfg.head_dim
    cur = cache["len"]
    s_cache = cache["self_k"].shape[3]
    slot = torch.clamp(cur, max=s_cache - 1).long().reshape(1)
    row = torch.clamp(cur, max=params["pos_dec"].shape[0] - 1).long().reshape(1)
    x = params["embed"][tokens[:, 0]].to(cdt)[:, None, :]
    x = x + params["pos_dec"].index_select(0, row).to(cdt)
    enc_len = torch.tensor(cfg.enc_seq, dtype=torch.int32, device=x.device)
    for i, p in enumerate(params["dec_blocks"]):
        k_c, v_c = cache["self_k"][i], cache["self_v"][i]
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
        pa = p["self_attn"]
        q = (h @ pa["wq"].to(cdt)).reshape(b, 1, cfg.n_heads, hd).transpose(1, 2)
        k = (h @ pa["wk"].to(cdt)).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
        v = (h @ pa["wv"].to(cdt)).reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
        k_c.index_copy_(2, slot, k.to(k_c.dtype))
        v_c.index_copy_(2, slot, v.to(v_c.dtype))
        o = decode_attention(q, k_c, v_c, cur + 1)
        x = x + o.transpose(1, 2).reshape(b, 1, -1) @ pa["wo"].to(cdt)
        h = layer_norm(x, p["ln_x"]["w"], p["ln_x"]["b"])
        px = p["cross_attn"]
        q2 = (h @ px["wq"].to(cdt)).reshape(b, 1, cfg.n_heads, hd).transpose(1, 2)
        o2 = decode_attention(q2, cache["cross_k"][i], cache["cross_v"][i], enc_len)
        x = x + o2.transpose(1, 2).reshape(b, 1, -1) @ px["wo"].to(cdt)
        h = layer_norm(x, p["ln2"]["w"], p["ln2"]["b"])
        x = x + mlp(p["mlp"], h, "gelu", gated=False)
    x = layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])
    logits = (x @ params["embed"].T.to(cdt))[:, 0, : cfg.vocab]
    return logits, {**cache, "len": cur + 1}


# ---------------------------------------------------------------------------
# Specs & shardings (the JAX package's, per layer: see models/transformer.py)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step inputs of ``shape`` as ``device="meta"`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")  # noqa: E731
    if shape.kind in ("train", "prefill"):
        return {"frames": meta((b, cfg.enc_seq, cfg.d_model), cfg.cdtype),
                "tokens": meta((b, s), torch.int32)}
    kv = lambda sl: meta((cfg.n_layers, b, cfg.n_kv_heads, sl, cfg.head_dim), cfg.cdtype)  # noqa: E731
    return {"tokens": meta((b, 1), torch.int32),
            "cache": {"self_k": kv(s), "self_v": kv(s), "cross_k": kv(cfg.enc_seq),
                      "cross_v": kv(cfg.enc_seq), "len": meta((), torch.int32)}}


def _attn_pspecs() -> dict:
    return {"wq": P(None, "model"), "wk": P(None, "model"), "wv": P(None, "model"),
            "wo": P("model", None)}


def _ln_pspecs() -> dict:
    return {"w": P(None), "b": P(None)}


def param_pspecs(cfg: ModelConfig, mesh) -> dict:
    """Specs of every parameter: the attention and the MLP split as the
    dense family's, the tied embedding over the vocabulary, ``pos_dec``
    and the layer norms replicated."""
    mlp_specs = lambda: {"wi": P(None, "model"), "wo": P("model", None)}  # noqa: E731
    enc = lambda: {"ln1": _ln_pspecs(), "attn": _attn_pspecs(), "ln2": _ln_pspecs(),  # noqa: E731
                   "mlp": mlp_specs()}
    dec = lambda: {"ln1": _ln_pspecs(), "self_attn": _attn_pspecs(), "ln_x": _ln_pspecs(),  # noqa: E731
                   "cross_attn": _attn_pspecs(), "ln2": _ln_pspecs(), "mlp": mlp_specs()}
    return {
        "embed": P("model", None),
        "pos_dec": P(None, None),
        "enc_blocks": [enc() for _ in range(cfg.n_enc_layers)],
        "dec_blocks": [dec() for _ in range(cfg.n_layers)],
        "enc_ln": _ln_pspecs(),
        "dec_ln": _ln_pspecs(),
    }


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Specs of the step inputs: the batch split over the data axes."""
    dp = dp_axes_for(mesh, shape.global_batch)
    if shape.kind in ("train", "prefill"):
        return {"frames": P(dp, None, None), "tokens": P(dp, None)}
    model_size = mesh.shape.get("model", 1)
    kv = (P(None, dp, "model", None, None) if cfg.n_kv_heads % model_size == 0
          else P(None, dp, None, None, None))
    return {"tokens": P(dp, None),
            "cache": {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv, "len": P()}}
