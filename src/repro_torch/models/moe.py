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

On a rank mesh (the JAX package's GSPMD placement of
``transformer.param_pspecs``: experts over "model" for "ep", each
expert's F for "tp") every rank routes its rows over all experts, as the
single process does, keeps its own experts' slots (or its slice of F),
and one all-reduce over "model" sums the partial outputs; the gates'
gradient is summed over "model" (:func:`combine_gates`) and the load
balance reads the global batch's statistics (:func:`balance_mean`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .layers import _act, normal
from .tensor_parallel import (
    copy_to_model,
    data_axes,
    data_mean,
    model_index,
    model_size,
    reduce_from_model,
)


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


def _groups(cfg: ModelConfig, tokens: int, mesh) -> int:
    """The group size: ``moe_group``, or the global batch's token count
    if smaller (a rank's ``tokens`` times the data axes' size), as the
    single process takes it over the whole batch.  A rank whose tokens are
    not a whole number of groups raises: regrouping would change the
    capacity and the dropped slots."""
    axes = data_axes(mesh)
    data = mesh.axis_size(axes) if axes else 1
    group = min(cfg.moe_group, tokens * data)
    if tokens % group:
        where = f" on a rank ({tokens} of {tokens * data} tokens)" if data > 1 else ""
        raise ValueError(f"{cfg.name}: tokens={tokens}{where} not divisible by group={group}")
    return group


def combine_gates(gate_vals: torch.Tensor, mesh) -> torch.Tensor:
    """The gates entering the combine.  Each rank's combine multiplies only
    its own experts' outputs (or its slice of F), so the gradient into the
    gates is a partial sum over "model", summed here on the backward pass."""
    return copy_to_model(gate_vals, mesh)


def balance_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """A routing statistic of the rank's tokens (``frac``, ``mean_prob``)
    averaged over the data axes: the global batch's, as the load balance
    reads it."""
    return data_mean(t, mesh)


def moe_mlp(cfg: ModelConfig, params, x: torch.Tensor, mesh=None):
    """x: (B, S, D) -> (y (B, S, D), aux loss, a float32 scalar).

    params:
      router   : (D, E)
      experts  : {wi: (E, D, 2F or F), wo: (E, F, D)}
      shared   : {wi: (D, s*2F), wo: (s*F, D)}        (optional)

    With a rank ``mesh``, ``x`` is the rank's rows (replicated over
    "model") and ``params`` its blocks (``transformer._block_pspecs``):
    under "ep" experts ``[r E/m, (r+1) E/m)``, under "tp" every expert's
    slice of F (the gate and up columns of ``wi`` each split), the router
    replicated, the shared experts split as a dense MLP.  Routing, top k,
    positions and capacity are the single process's over all E experts; the
    rank keeps its experts' dispatch and combine columns, and one all-reduce
    over "model" sums the partial outputs.  The load balance takes ``frac``
    and ``mean_prob`` over the global batch (:func:`balance_mean`).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    group = _groups(cfg, tokens, mesh)
    ng = tokens // group
    xg = x.reshape(ng, group, d)

    # ---- routing (float32) and aux losses ------------------------------------
    # from the layer input itself: its cotangent from the router is whole on
    # every rank and must not be summed over "model"
    logits, probs, gate_vals, gate_idx = route(cfg, params["router"], xg)
    # a one-hot sum, not bincount: bincount reads its input's maximum back
    # to the host, a sync a layer on the card
    frac = F.one_hot(gate_idx, e).sum(dim=(0, 1, 2)).float() / (tokens * k)
    mean_prob = probs.mean(dim=(0, 1))
    lb_loss = e * torch.sum(balance_mean(frac, mesh) * balance_mean(mean_prob, mesh))
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
    combine.scatter_(2, flat, keep.float() * combine_gates(gate_vals, mesh))
    wi = params["experts"]["wi"].to(cdt)  # (E or E/m, D, 2F|F or its split)
    wo = params["experts"]["wo"].to(cdt)  # (E or E/m, F or F/m, D)
    e_loc = wi.shape[0]
    if e_loc != e:  # "ep": this rank's experts' columns
        lo = model_index(mesh) * e_loc * cap
        disp, combine = disp[..., lo:lo + e_loc * cap], combine[..., lo:lo + e_loc * cap]
    disp, combine = disp.to(cdt), combine.to(cdt)

    # ---- expert compute --------------------------------------------------------
    xc = copy_to_model(xg, mesh).to(cdt)
    xe = torch.matmul(disp.transpose(1, 2), xc)  # (NG, E*C, D)
    xe = xe.reshape(ng, e_loc, cap, d).transpose(0, 1).reshape(e_loc, ng * cap, d)
    h = torch.bmm(xe, wi)
    if cfg.gated_mlp:
        gte, up = h.chunk(2, dim=-1)
        h = _act(cfg.act, gte) * up
    ye = torch.bmm(h, wo)  # (E, NG*C, D)
    ye = ye.reshape(e_loc, ng, cap, d).transpose(0, 1).reshape(ng, e_loc * cap, d)
    sharded = model_size(mesh) > 1
    # partial sums over "model" in float32, rounded once after the reduce
    y = torch.matmul(combine.float(), ye.float()) if sharded else torch.matmul(combine, ye)

    # ---- shared (always-on) experts ----------------------------------------------
    if cfg.n_shared_experts > 0:
        hs = xc @ params["shared"]["wi"].to(cdt)
        if cfg.gated_mlp:
            g2, up2 = hs.chunk(2, dim=-1)
            hs = _act(cfg.act, g2) * up2
        wo_s = params["shared"]["wo"].to(cdt)
        y = y + (hs.float() @ wo_s.float() if sharded else hs @ wo_s)
    if sharded:
        y = reduce_from_model(y, mesh).to(cdt)

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
