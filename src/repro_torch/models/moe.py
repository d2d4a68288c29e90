"""Mixture-of-Experts FFN: top-k routing, capacity, shared experts.

A port of :mod:`repro.models.moe`: GShard-style dense dispatch *within
token groups*.  Tokens are split into groups of ``cfg.moe_group``; inside
each group every routed slot is scattered into its expert's capacity
buffer, the experts run as one batched product over the expert axis, and
the combine weights gather the results back.  ``moe.py`` has no Pallas
kernel in the JAX package, so PyTorch products stand in for its einsums:
the dispatch and combine tensors (NG, G, E, C) are the einsums' own (each
token's k experts are distinct, so a scatter writes them exactly), and
``matmul`` / ``bmm`` take the products the einsums take.

What the port copies exactly, since any other choice routes or drops
other slots: routing in float32 (softmax, then the top k -- ties to the
lower expert index, as ``jax.lax.top_k`` breaks them -- then the gates
renormalized by ``max(sum, 1e-9)``); the slot order (each group's (G, k)
choices flattened token-major, a token's k choices in descending
probability) ranked by a cumulative sum; the capacity ``int(max(1,
round(G k capacity_factor / E)))`` with Python's half-to-even ``round``;
and the cast of the weights, the dispatch and the combine tensors to the
compute dtype at each use.  Aux loss: ``router_aux_coef`` times the
Switch-style load balance plus 1e-3 times the router z-loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .layers import _act, normal


def _positions_in_expert(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each routed slot within its expert, order-preserving, along
    the last axis: expert_idx (..., N) -> (..., N) ranks."""
    ranks = F.one_hot(expert_idx, n_experts).cumsum(dim=-2) - 1
    return ranks.gather(-1, expert_idx.unsqueeze(-1)).squeeze(-1)


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots an expert takes in a group of ``group`` tokens."""
    return int(max(1, round(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)))


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """Routing of grouped tokens xg (NG, G, D), in float32: (logits, probs
    (NG, G, E), gates (NG, G, k) renormalized, expert indices (NG, G, k) in
    descending probability, ties to the lower index)."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., : cfg.top_k], idx[..., : cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, gate_idx


def slot_counts(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """(dropped, routed): the routed slots of x (B, S, D) that land beyond
    their expert's capacity in :func:`moe_mlp`'s grouping (a tensor), and
    all routed slots (an int)."""
    d = x.shape[-1]
    group = min(cfg.moe_group, x.numel() // d)
    gate_idx = route(cfg, router, x.reshape(-1, group, d))[3]
    pos = _positions_in_expert(gate_idx.reshape(gate_idx.shape[0], -1), cfg.n_experts)
    return (pos >= capacity(cfg, group)).sum(), pos.numel()


def moe_mlp(cfg: ModelConfig, params, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), aux loss, a float32 scalar).

    params:
      router   : (D, E)
      experts  : {wi: (E, D, 2F or F), wo: (E, F, D)}
      shared   : {wi: (D, s*2F), wo: (s*F, D)}        (optional)
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    group = min(cfg.moe_group, tokens)
    ng = tokens // group
    if ng * group != tokens:
        raise ValueError(f"tokens={tokens} not divisible by group={group}")
    xg = x.reshape(ng, group, d)

    # ---- routing (float32) and aux losses ------------------------------------
    logits, probs, gate_vals, gate_idx = route(cfg, params["router"], xg)
    # a one-hot sum, not bincount: bincount reads its input's maximum back
    # to the host, a sync a layer on the card
    frac = F.one_hot(gate_idx, e).sum(dim=(0, 1, 2)).float() / (tokens * k)
    lb_loss = e * torch.sum(frac * probs.mean(dim=(0, 1)))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.router_aux_coef * lb_loss + 1e-3 * z_loss

    # ---- capacity, positions, dispatch and combine (per group) --------------
    cap = capacity(cfg, group)
    pos = _positions_in_expert(gate_idx.reshape(ng, group * k), e).reshape(ng, group, k)
    keep = pos < cap
    flat = gate_idx * cap + torch.where(keep, pos, 0)  # (NG, G, k): expert-major slot
    cdt = cfg.cdtype
    disp = torch.zeros(ng, group, e * cap, device=x.device)
    disp.scatter_(2, flat, keep.float())
    combine = torch.zeros(ng, group, e * cap, device=x.device)
    combine.scatter_(2, flat, keep.float() * gate_vals)
    disp, combine = disp.to(cdt), combine.to(cdt)

    # ---- expert compute --------------------------------------------------------
    wi = params["experts"]["wi"].to(cdt)  # (E, D, 2F|F)
    wo = params["experts"]["wo"].to(cdt)  # (E, F, D)
    xc = xg.to(cdt)
    xe = torch.matmul(disp.transpose(1, 2), xc)  # (NG, E*C, D)
    xe = xe.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    h = torch.bmm(xe, wi)
    if cfg.gated_mlp:
        gte, up = h.chunk(2, dim=-1)
        h = _act(cfg.act, gte) * up
    ye = torch.bmm(h, wo)  # (E, NG*C, D)
    ye = ye.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    y = torch.matmul(combine, ye)  # (NG, G, D)

    # ---- shared (always-on) experts ----------------------------------------------
    if cfg.n_shared_experts > 0:
        hs = xc @ params["shared"]["wi"].to(cdt)
        if cfg.gated_mlp:
            g2, up2 = hs.chunk(2, dim=-1)
            hs = _act(cfg.act, g2) * up2
        y = y + hs @ params["shared"]["wo"].to(cdt)

    return y.reshape(b, s, d).to(x.dtype), aux


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """One layer's router, experts and shared experts, with the JAX init's
    shapes and scales (float32, drawn from ``gen`` on its device)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    wi_cols = 2 * f if cfg.gated_mlp else f
    params = {
        "router": normal(gen, (d, e), 0.02),
        "experts": {
            "wi": normal(gen, (e, d, wi_cols), d**-0.5),
            "wo": normal(gen, (e, f, d), f**-0.5),
        },
    }
    if cfg.n_shared_experts > 0:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "wi": normal(gen, (d, 2 * fs if cfg.gated_mlp else fs), d**-0.5),
            "wo": normal(gen, (fs, d), fs**-0.5),
        }
    return params
