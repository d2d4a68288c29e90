"""AdamW with a cosine schedule, global-norm clipping and optional float32
master weights.

A port of :mod:`repro.optim.adamw` with its formula exactly: the step
counted from 1; the clip scale ``min(1, clip_norm / max(gnorm, 1e-9))``
on every gradient; ``m``, ``v`` in float32; the bias-corrected ``mh /
(sqrt(vh) + eps)`` plus ``weight_decay * p`` as one delta, scaled by the
scheduled ``lr``.  Not ``torch.optim.AdamW`` (which keeps no master copy)
nor ``clip_grad_norm_`` (which divides by ``norm + 1e-6``).

Parameters are named tensors (``dict(model.named_parameters())``) and are
updated in place under ``torch.no_grad()`` with ``torch._foreach_*`` ops,
a group of tensors at a time (:data:`GROUP_ELEMENTS`), so the temporaries
of the update stay near one group's size.  The schedule is a function of
the step, which the host knows: it is computed there, and nothing in an
update reads a value back from the card.

``zero1_pspecs`` / ``opt_state_pspecs`` are the JAX package's specs of
the optimizer state over a rank mesh (:mod:`repro_torch.launch.sharding`);
``repro_torch.train.make_train_step(..., mesh=...)`` keeps each rank's
block of them and updates it with :func:`apply_updates`, given the global
norm it computed over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..launch.sharding import P, entry_axes, tree_map

# Tensors of one foreach group: their sizes summed stay at or under this
# (or it is a single larger tensor).
GROUP_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """The JAX package's optimizer settings, with its defaults."""

    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # master weights: the parameters may be bfloat16; a float32 copy of
    # them lives in the state, takes the update and is cast back
    master_weights: bool = False


@dataclasses.dataclass
class AdamWState:
    """Steps taken, and float32 ``m``, ``v`` (and ``master``) keyed by the
    parameters' names."""

    step: int
    m: dict
    v: dict
    master: Optional[dict] = None


def init(params: dict, master_weights: bool = False) -> AdamWState:
    """Zero moments (float32, on each parameter's device), step 0, and a
    float32 copy of the parameters with ``master_weights``."""
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}  # noqa: E731
    master = ({n: p.detach().float().clone() for n, p in params.items()}
              if master_weights else None)
    return AdamWState(step=0, m=zeros(), v=zeros(), master=master)


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step``: linear warmup over ``warmup_steps``,
    then a cosine from ``lr`` down to ``min_lr_frac * lr`` at
    ``total_steps``."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                   0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _float32(tensors: list) -> list:
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (a 0-d
    tensor on the tensors' device)."""
    tensors = _float32(list(tensors.values()) if isinstance(tensors, dict) else list(tensors))
    norms = torch.stack(torch._foreach_norm(tensors))
    return torch.sqrt(torch.sum(norms * norms))


def _groups(tensors: list) -> list[list[int]]:
    """Indices of ``tensors`` in groups of at most GROUP_ELEMENTS elements."""
    groups, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and size + t.numel() > GROUP_ELEMENTS:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    return groups + ([cur] if cur else [])


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: AdamWState,
                  gnorm: Optional[torch.Tensor] = None) -> dict:
    """One AdamW step in place: ``params`` (and ``state.master``), ``m``,
    ``v`` and ``state.step`` change; ``grads`` (keyed as ``params``) are
    read.  ``gnorm``: the global norm to clip by, where the tensors given
    are blocks of a sharded model's (default: theirs).  Returns
    {"grad_norm": the unclipped global norm (a 0-d tensor), "lr": the
    step's learning rate}."""
    state.step += 1
    step = state.step
    lr = schedule(cfg, step)
    names = list(params)
    g_all = _float32([grads[n] for n in names])
    if gnorm is None:
        gnorm = global_norm(g_all)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.betas
    bc1, bc2 = 1.0 - b1**step, 1.0 - b2**step
    use_master = cfg.master_weights and state.master is not None
    src_all = [state.master[n] if use_master else params[n] for n in names]
    for idx in _groups(g_all):
        g = torch._foreach_mul([g_all[i] for i in idx], scale)
        m = [state.m[names[i]] for i in idx]
        v = [state.v[names[i]] for i in idx]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        src = [src_all[i] for i in idx]
        p32 = _float32(src)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, denom)  # mh / (sqrt(vh) + eps)
        del denom
        if cfg.weight_decay:
            torch._foreach_add_(delta, p32, alpha=cfg.weight_decay)
        torch._foreach_add_(p32, delta, alpha=-lr)
        del delta
        for s, new in zip(src, p32):
            if new is not s:
                s.copy_(new)
        if use_master:
            for i, new in zip(idx, p32):
                params[names[i]].copy_(new)
    return {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1: shard optimizer moments over the data axis where possible
# ---------------------------------------------------------------------------


def zero1_pspecs(param_pspecs, params, mesh):
    """Moment specs: the parameter's spec plus "data" on the first
    dimension it leaves unsharded whose size the data axis divides (the
    spec itself when none does, when the leaf is already split over
    "data", or on a mesh without a data axis of size > 1).  ``params``
    has ``param_pspecs``'s structure (nested dicts and lists) and holds
    tensors (``device="meta"`` ones do) or shapes."""
    data = mesh.shape.get("data", 1)

    def one(spec, p):
        if data <= 1:
            return spec
        if "data" in {a for e in spec for a in entry_axes(e)}:
            return spec
        shape = tuple(p.shape) if hasattr(p, "shape") else tuple(p)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % data == 0:
                entries[i] = "data"
                return P(*entries)
        return spec

    return tree_map(one, param_pspecs, params)


def opt_state_pspecs(param_pspecs, params, mesh, zero1: bool = False,
                     master_weights: bool = False) -> AdamWState:
    """The specs of an :class:`AdamWState` of parameters placed by
    ``param_pspecs``: the step replicated, ``m`` / ``v`` (and ``master``)
    as the parameters, or by :func:`zero1_pspecs` with ``zero1``."""
    mspec = zero1_pspecs(param_pspecs, params, mesh) if zero1 else param_pspecs
    return AdamWState(step=P(), m=mspec, v=mspec, master=mspec if master_weights else None)
