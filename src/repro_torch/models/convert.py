"""Carry the JAX package's model parameters across to the port.

``params_from_jax(cfg, tree)`` maps a parameter pytree of
:mod:`repro.models.rwkv`, :mod:`repro.models.mamba`,
:mod:`repro.models.transformer` (dense and MoE: a layer's ``moe`` subtree
of router, experts and shared experts comes across whole) or
:mod:`repro.models.whisper` -- nested dicts with numpy leaves, per-layer
leaves stacked along a leading layer axis (``n_layers``; whisper's
encoder along ``n_enc_layers``) -- onto the port's modules, so that both
packages compute the same model.  Every leaf is copied as float32.  A
model with tied embeddings has no ``lm_head``; its forward uses the
transposed embedding, as the JAX package's does.

``params_to_jax(model)`` is the inverse map: the model's parameters --
or any tensors keyed by the parameters' names, such as their ``.grad``s
or AdamW's moments -- as the JAX package's nested numpy tree, each
``nn.ModuleList`` of layers stacked along a leading layer axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .api import ModelConfig


def _tensors(tree, device) -> dict:
    if isinstance(tree, dict):
        return {name: _tensors(v, device) for name, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def _layer(tree: dict, i: int) -> dict:
    return {name: _layer(v, i) if isinstance(v, dict) else v[i].clone()
            for name, v in tree.items()}


def params_from_jax(cfg: ModelConfig, tree: dict, device=None):
    """The port's model (an ``nn.Module``) holding the parameters of
    ``tree``; on the card unless ``device`` names another."""
    t = _tensors(tree, resolve_device(device))
    if cfg.family == "encdec":
        t["enc_blocks"] = [_layer(t["enc_blocks"], i) for i in range(cfg.n_enc_layers)]
        t["dec_blocks"] = [_layer(t["dec_blocks"], i) for i in range(cfg.n_layers)]
    else:
        t["blocks"] = [_layer(t["blocks"], i) for i in range(cfg.n_layers)]
    return model_from_tree(cfg, t)


def model_from_tree(cfg: ModelConfig, t: dict):
    """The port's model holding the tensors of ``t``: the JAX package's
    tree with every stacked layer leaf given as a list of per-layer trees
    (``blocks``, or whisper's ``enc_blocks`` / ``dec_blocks``)."""
    if cfg.family == "encdec":
        from .whisper import Whisper

        return Whisper(cfg, t["embed"], t["pos_dec"], t["enc_blocks"], t["dec_blocks"],
                       t["enc_ln"], t["dec_ln"])
    blocks = t["blocks"]
    if cfg.family == "rwkv":
        from .rwkv import RWKV6

        return RWKV6(cfg, t["embed"], blocks, t["final_norm"], t["lm_head"])
    if cfg.family == "hybrid":
        from .mamba import Zamba2

        return Zamba2(cfg, t["embed"], blocks, t["shared_attn"], t["final_norm"], t["lm_head"])
    if cfg.family in ("dense", "moe"):
        from .transformer import TransformerLM

        return TransformerLM(cfg, t["embed"], blocks, t["final_norm"], t.get("lm_head"))
    raise ValueError(f"unknown family {cfg.family!r}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _stack(trees: list[dict]) -> dict:
    return {name: _stack([t[name] for t in trees]) if isinstance(v, dict)
            else np.stack([t[name] for t in trees]) for name, v in trees[0].items()}


def _tree(module: nn.Module, prefix: str, leaf) -> dict:
    out = {name: leaf(prefix + name, p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            out[name] = _stack([_tree(m, f"{prefix}{name}.{i}.", leaf)
                                for i, m in enumerate(child)])
        else:
            out[name] = _tree(child, f"{prefix}{name}.", leaf)
    return out


def params_to_jax(model: nn.Module, values: Optional[dict] = None) -> dict:
    """The JAX package's nested float32 numpy tree (per-layer leaves
    stacked on a leading layer axis) of ``model``'s parameters, or of
    ``values[name]`` for each parameter's name in ``named_parameters()``
    (``{n: p.grad for n, p in model.named_parameters()}``, AdamW's ``m``)."""
    return _tree(model, "", lambda name, p: _numpy(p if values is None else values[name]))
