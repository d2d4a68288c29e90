"""Mamba-2 / Zamba2 hybrid family on PyTorch.

A port of :mod:`repro.models.mamba`: a backbone of Mamba-2 (SSD) blocks
with one *shared* transformer block (attention + MLP, one set of weights)
applied after every ``cfg.attn_every`` layers.  The SSD recurrence is the
split-and-parallelize chunked scan, on the card by the hand-written CUDA
kernel (:func:`repro_torch.kernels.ops.ssd`); its B and C are shared by
the heads and reach the kernel once per token.

Parameters are float32 in the JAX package's layout (one
:class:`~repro_torch.models.layers.ParamTree` per Mamba layer, one for the
shared block), cast to the compute dtype where they are used.  The decode
cache holds ``conv`` (L, B, W-1, conv_dim), ``ssm`` (L, B, H, N, P), and
for the shared attention ``attn_k`` / ``attn_v`` (segments, B, Hkv, S, Dh)
and the scalar ``len`` -- one length for every row, as in the JAX package.
``decode_step`` writes the new key and value into ``attn_k`` / ``attn_v``
in place (the cache is not copied per token); the other entries are new
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import generator_on, resolve_device
from ..kernels import ops as kops
from ..kernels.ref import flash_attention_ref
from ..launch.sharding import P
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
    split_rms_norm,
)
from .tensor_parallel import (
    copy_to_model,
    gather_from_model,
    model_size,
    row_parallel,
    scatter_to_model,
    split_count,
    vocab_parallel_embed,
)


def _dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    h = din // cfg.ssm_head_dim
    return din, h, cfg.ssm_state, cfg.ssm_head_dim


def _n_segments(cfg: ModelConfig) -> tuple[int, int]:
    """(segments, layers per segment): the shared block follows each segment."""
    if cfg.attn_every and cfg.attn_every > 0:
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                             f"attn_every={cfg.attn_every}")
        return cfg.n_layers // cfg.attn_every, cfg.attn_every
    return 1, cfg.n_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def mamba_block_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One Mamba-2 layer's parameters, with the JAX init's shapes and scales."""
    d = cfg.d_model
    din, h, n, _ = _dims(cfg)
    conv_dim = din + 2 * n
    dev = gen.device
    return {
        "ln": torch.ones(d, device=dev),
        "in_proj": normal(gen, (d, 2 * din + 2 * n + h), d**-0.5),
        "conv_w": normal(gen, (cfg.conv_width, conv_dim), 0.1),
        "conv_b": torch.zeros(conv_dim, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros(h, device=dev),
        "d_skip": torch.ones(h, device=dev),
        "out_norm": torch.ones(din, device=dev),
        "out_proj": normal(gen, (din, d), din**-0.5),
    }


def shared_attn_tree(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The shared attention + MLP block's parameters."""
    d, hd = cfg.d_model, cfg.head_dim
    dev = gen.device
    return {
        "ln1": torch.ones(d, device=dev),
        "ln2": torch.ones(d, device=dev),
        "wq": normal(gen, (d, cfg.n_heads * hd), d**-0.5),
        "wk": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
        "wv": normal(gen, (d, cfg.n_kv_heads * hd), d**-0.5),
        "wo": normal(gen, (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
        "mlp": {
            "wi": normal(gen, (d, 2 * cfg.d_ff), d**-0.5),
            "wo": normal(gen, (cfg.d_ff, d), cfg.d_ff**-0.5),
        },
    }


class Zamba2(ParamTree):
    """A Zamba2 hybrid: ``embed``, ``blocks`` (one tree per Mamba layer),
    ``shared_attn``, ``final_norm``, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, embed, blocks: list[dict], shared_attn: dict,
                 final_norm, lm_head):
        super().__init__({
            "embed": embed,
            "blocks": nn.ModuleList(ParamTree(b) for b in blocks),
            "shared_attn": shared_attn,
            "final_norm": final_norm,
            "lm_head": lm_head,
        })
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, state: dict | None = None):
        """Logits (B, T, vocab_padded) and the carried Mamba state."""
        return forward(self.cfg, self, tokens, state)


def init(cfg: ModelConfig, generator: torch.Generator | None = None, device=None) -> Zamba2:
    """Random float32 parameters drawn from ``generator`` (seed 0 when none
    is given), with the JAX init's shapes and scales; on the card unless
    ``device`` names another.  The generator must draw on that device."""
    gen = generator_on(device, generator)
    vp = cfg.vocab_padded
    embed = normal(gen, (vp, cfg.d_model), 0.02)
    blocks = [mamba_block_tree(cfg, gen) for _ in range(cfg.n_layers)]
    shared = shared_attn_tree(cfg, gen)
    lm_head = normal(gen, (cfg.d_model, vp), 0.02)
    return Zamba2(cfg, embed, blocks, shared, torch.ones(cfg.d_model, device=gen.device),
                  lm_head)


# ---------------------------------------------------------------------------
# Mamba2 block (sequence form)
# ---------------------------------------------------------------------------


def _mamba_fwd(cfg: ModelConfig, p, x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor, mesh=None):
    """x: (B, T, D); conv_state (B, W-1, conv_dim), ssm_state (B, H, N, P).
    Returns (x + mixer(x), conv_state_out, ssm_state_out).

    With ``mesh``, ``in_proj`` is column-split and ``out_proj`` row-split
    over "model": the rank holds its share of each of ``in_proj``'s
    segments ``[z | x | B | C | dt]`` and of the conv's ``[x | B | C]``
    (``sharded.param_segments``), so its product yields its heads' z, x
    and dt beside a share of B and C, which the conv treats channel by
    channel before B and C are gathered; the SSD kernel runs on its heads,
    and the states hold its heads and channels."""
    bsz, t, _ = x.shape
    din, h, n, hd = _dims(cfg)
    h = split_count(h, mesh, "Zamba2 heads")
    n_l = split_count(n, mesh, "ssm_state")
    din_l = h * hd
    res = x
    x = rms_norm(x, p["ln"])
    proj = copy_to_model(x, mesh) @ p["in_proj"].to(x.dtype)  # (B, T, 2din+2n+h)
    z, xs, bmat, cmat, dt = torch.split(proj, [din_l, din_l, n_l, n_l, h], dim=-1)

    # depthwise causal conv over [xs|B|C] with the carried state
    xbc = torch.cat([xs, bmat, cmat], dim=-1)  # (B, T, conv_dim)
    w = cfg.conv_width
    hist = torch.cat([conv_state.to(x.dtype), xbc], dim=1)
    conv = sum(hist[:, i:i + t] * p["conv_w"][i].to(x.dtype) for i in range(w))
    conv = F.silu(conv + p["conv_b"].to(x.dtype))
    if t >= w - 1:
        conv_out = hist[:, t:t + w - 1]
    else:  # fewer new tokens than the window: keep the tail of the old state
        conv_out = torch.cat([conv_state[:, t:], xbc.to(conv_state.dtype)], dim=1)
    xs, bmat, cmat = torch.split(conv, [din_l, n_l, n_l], dim=-1)
    if model_size(mesh) > 1:
        # B and C are shared by every head: gather the rank's shares, and
        # sum their gradient over the ranks' heads on the way back
        bc = gather_from_model(torch.cat([bmat, cmat], dim=-1), mesh, segments=(n, n))
        bmat, cmat = torch.split(copy_to_model(bc, mesh), [n, n], dim=-1)

    dt = F.softplus(dt.float() + scatter_to_model(p["dt_bias"], mesh))  # (B, T, H)
    loga = -torch.exp(scatter_to_model(p["a_log"], mesh))[None, None, :] * dt  # (B, T, H) <= 0
    sdt = cfg.sdtype
    xh = xs.reshape(bsz, t, h, hd).transpose(1, 2).float()
    xh = (xh * dt.transpose(1, 2)[..., None]).to(sdt)  # fold dt in
    bh = bmat[:, None].to(sdt).expand(bsz, h, t, n)  # shared by the heads
    ch = cmat[:, None].to(sdt).expand(bsz, h, t, n)
    la = loga.transpose(1, 2).float()  # (B, H, T)

    y, ssm_out = kops.ssd(xh, bh, ch, la, ssm_state.float(), chunk=min(cfg.ssm_chunk, t))
    d_skip = scatter_to_model(p["d_skip"], mesh)
    y = y.float() + d_skip[None, :, None, None] * xh.float()  # skip connection
    y = y.transpose(1, 2).reshape(bsz, t, din_l).to(x.dtype)
    y = split_rms_norm(y * F.silu(z), p["out_norm"], mesh)
    out = row_parallel(y, p["out_proj"], mesh)
    return res + out, conv_out.to(conv_state.dtype), ssm_out.to(ssm_state.dtype)


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------


def _shared_attn_fwd(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor, mesh=None):
    """The shared attention + MLP block (split over "model" as the dense
    block is, with ``mesh``).  Its attention is the plain chunked
    formulation: the JAX package's shared block runs the jnp
    ``layers.flash_attention``, not its Pallas kernel."""
    attend = lambda q, k, v: flash_attention_ref(q, k, v, causal=True,  # noqa: E731
                                                 block_k=cfg.attn_block_k)
    x = x + attention(cfg, p, rms_norm(x, p["ln1"]), positions, attend, mesh)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"]), cfg.act, True, mesh)


def _shared_attn_decode(cfg: ModelConfig, p, x, k_c, v_c, cur):
    """One token of the shared block against segment caches k_c / v_c
    (B, Hkv, S, Dh), written in place at slot ``cur % S``."""
    bsz = x.shape[0]
    hd, cdt = cfg.head_dim, cfg.cdtype
    s_cache = k_c.shape[2]
    positions = cur[None]
    h1 = rms_norm(x, p["ln1"])
    q = (h1 @ p["wq"].to(cdt)).reshape(bsz, 1, cfg.n_heads, hd)
    k = (h1 @ p["wk"].to(cdt)).reshape(bsz, 1, cfg.n_kv_heads, hd)
    v = (h1 @ p["wv"].to(cdt)).reshape(bsz, 1, cfg.n_kv_heads, hd)
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
    slot = (cur % s_cache).long().reshape(1)
    k_c.index_copy_(2, slot, k.to(k_c.dtype))
    v_c.index_copy_(2, slot, v.transpose(1, 2).to(v_c.dtype))
    o = decode_attention(q, k_c, v_c, torch.clamp(cur + 1, max=s_cache))
    o = o.transpose(1, 2).reshape(bsz, 1, cfg.n_heads * hd)
    x = x + o @ p["wo"].to(cdt)
    h2 = rms_norm(x, p["ln2"])
    return x + mlp(p["mlp"], h2, cfg.act, True)


# ---------------------------------------------------------------------------
# Model-level API
# ---------------------------------------------------------------------------


def _zero_state(cfg: ModelConfig, batch: int, device, mesh=None) -> dict:
    """Zero states; with ``mesh`` the rank's heads and conv channels (its
    share of ``[x | B | C]``), B and C being gathered before the scan."""
    din, h, n, hd = _dims(cfg)
    m = model_size(mesh)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "conv": zeros(cfg.n_layers, batch, cfg.conv_width - 1, (din + 2 * n) // m),
        "ssm": zeros(cfg.n_layers, batch, h // m, n, hd),
    }


def _segments(cfg: ModelConfig, params, x, state, shared, mesh=None):
    """Every Mamba layer in segment order, ``shared(x, segment)`` after each
    segment; returns (x, stacked conv and ssm states)."""
    ns, sl = _n_segments(cfg)
    conv, ssm = [], []
    for s in range(ns):
        for i in range(s * sl, (s + 1) * sl):
            x, c, m = remat(cfg, _mamba_fwd, cfg, params["blocks"][i], x, state["conv"][i],
                            state["ssm"][i], mesh)
            conv.append(c)
            ssm.append(m)
        if cfg.attn_every:
            x = shared(x, s)
    return x, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, state: dict | None = None,
            mesh=None):
    """Prompt pass with a carried Mamba state: tokens (B, T) -> (logits
    (B, T, vocab_padded), state_out).  The shared attention sees positions
    0..T-1 of this call only, as in the JAX package.  With a rank
    ``mesh``, ``params`` are the rank's blocks (``sharded.shard_model``),
    the inputs its rows, the states its heads' and channels', and the
    logits its vocabulary columns."""
    cdt = cfg.cdtype
    bsz, t = tokens.shape
    x = vocab_parallel_embed(params["embed"], tokens, mesh).to(cdt)
    state = state if state is not None else _zero_state(cfg, bsz, tokens.device, mesh)
    positions = torch.arange(t, device=tokens.device)
    shared = lambda y, s: _shared_attn_fwd(  # noqa: E731
        cfg, params["shared_attn"], y, positions, mesh)
    x, state_out = _segments(cfg, params, x, state, shared, mesh)
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
    """Zero Mamba states and, with shared attention, an empty KV cache of
    ``max_len`` slots (the window's, if smaller)."""
    dev = resolve_device(device)
    cache = _zero_state(cfg, batch, dev)
    if cfg.attn_every:
        ns, _ = _n_segments(cfg)
        s = min(max_len, cfg.window) if cfg.window else max_len
        shape = (ns, batch, cfg.n_kv_heads, s, cfg.head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        cache["attn_v"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        cache["len"] = torch.tensor(prefilled, dtype=torch.int32, device=dev)
    return cache


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor):
    """One token per row (tokens (B, 1)): (logits (B, vocab), new cache).
    The key/value caches are updated in place."""
    cdt = cfg.cdtype
    x = params["embed"][tokens[:, 0]].to(cdt)[:, None, :]
    cur = cache.get("len")  # the shared attention's length (None without it)
    shared = lambda y, s: _shared_attn_decode(  # noqa: E731
        cfg, params["shared_attn"], y, cache["attn_k"][s], cache["attn_v"][s], cur)
    x, mstate = _segments(cfg, params, x, cache, shared)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cdt))[:, 0, : cfg.vocab]
    new_cache = dict(mstate)
    if cfg.attn_every:
        new_cache["attn_k"] = cache["attn_k"]
        new_cache["attn_v"] = cache["attn_v"]
        new_cache["len"] = cur + 1
    return logits, new_cache


# ---------------------------------------------------------------------------
# Specs & shardings (the JAX package's, per layer: see models/transformer.py)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step inputs of ``shape`` as ``device="meta"`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda sh, dt=torch.float32: torch.empty(sh, dtype=dt, device="meta")  # noqa: E731
    if shape.kind in ("train", "prefill"):
        return {"tokens": meta((b, s), torch.int32)}
    din, h, n, hd_s = _dims(cfg)
    cache = {"conv": meta((cfg.n_layers, b, cfg.conv_width - 1, din + 2 * n)),
             "ssm": meta((cfg.n_layers, b, h, n, hd_s))}
    if cfg.attn_every:
        ns, _ = _n_segments(cfg)
        sc = min(s, cfg.window) if cfg.window else s
        kv = meta((ns, b, cfg.n_kv_heads, sc, cfg.head_dim), cfg.cdtype)
        cache.update(attn_k=kv, attn_v=kv, len=meta((), torch.int32))
    return {"tokens": meta((b, 1), torch.int32), "cache": cache}


def _block_pspecs() -> dict:
    return {
        "ln": P(None),
        "in_proj": P(None, "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "a_log": P(None),
        "dt_bias": P(None),
        "d_skip": P(None),
        "out_norm": P("model"),
        "out_proj": P("model", None),
    }


def param_pspecs(cfg: ModelConfig, mesh) -> dict:
    """Specs of every parameter.  ``in_proj``'s fused ``[z | x | B | C |
    dt]`` columns and the conv's ``[x | B | C]`` channels are split over
    "model" as one axis; :mod:`repro_torch.models.sharded` places a rank's
    share of each segment there (``segments``)."""
    shared = {
        "ln1": P(None),
        "ln2": P(None),
        "wq": P(None, "model"),
        "wk": P(None, "model"),
        "wv": P(None, "model"),
        "wo": P("model", None),
        "mlp": {"wi": P(None, "model"), "wo": P("model", None)},
    }
    return {
        "embed": P("model", None),
        "blocks": [_block_pspecs() for _ in range(cfg.n_layers)],
        "shared_attn": shared,
        "final_norm": P(None),
        "lm_head": P(None, "model"),
    }


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Specs of the step inputs: the batch split over the data axes."""
    dp = dp_axes_for(mesh, shape.global_batch)
    if shape.kind in ("train", "prefill"):
        return {"tokens": P(dp, None)}
    cache = {"conv": P(None, dp, None, "model"), "ssm": P(None, dp, "model", None, None)}
    if cfg.attn_every:
        model_size = mesh.shape.get("model", 1)
        kv = (P(None, dp, "model", None, None) if cfg.n_kv_heads % model_size == 0
              else P(None, dp, None, None, None))
        cache.update(attn_k=kv, attn_v=kv, len=P())
    return {"tokens": P(dp, None), "cache": cache}
