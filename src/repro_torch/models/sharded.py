"""The LM families' loss and gradient on a rank mesh: tensor parallel over
"model", data parallel over the data axes.

The JAX package jits ``fam.loss`` on parameters placed by
``param_pspecs`` and a batch placed by ``batch_pspecs``, and GSPMD inserts
the collectives.  Here every mesh position is a process that holds its
block of every parameter (:func:`shard_model`) and of the batch, and
:func:`loss` is the family's own ``loss`` given the mesh: its forward
states the "model" collectives itself (:mod:`.tensor_parallel`), so the
attention and the scans run on the rank's heads -- the flash, WKV6 and SSD
kernels (:mod:`repro_torch.kernels.ops`) on local heads.
:func:`value_and_grad` averages the loss and every gradient over the data
axes.

Some parameter layouts differ from a contiguous split of the spec's
dimension, because a contiguous split would cut a fused axis at the wrong
place: the gated MLP's ``wi`` (``[gate | up]``), and so a MoE layer's
gated ``experts.wi`` under "tp" (split along F) and its shared experts'
``wi``, and Zamba2's ``in_proj`` (``[z | x | B | C | dt]``) and
``conv_w`` / ``conv_b`` (``[x | B | C]``).  A rank holds its share of
every segment (:func:`param_segments`, placed by :func:`shard_model` and
undone by :func:`gather_model`): the block has the spec's shape, and the
local product yields the rank's gate and up columns, or its heads' z, x
and dt beside a share of B and C.

Families: dense (MHA, GQA, the sliding window, the VLM stub's patches),
MoE (``expert_sharding`` "ep": the rank's experts; "tp": every expert's
slice of F; routing over all experts on every rank, the load balance over
the global batch: :func:`repro_torch.models.moe.moe_mlp`), RWKV6, the
Zamba2 hybrid and the whisper encoder-decoder (the attention and MLP split
as the dense family's, the tied head over the vocabulary).

Messages: a layer's "model" all-reduces run in the forward (the
row-parallel sums, the split norms and gathers) and in the backward (the
column-parallel inputs' gradients), in the layers' order on every rank.
Under ``cfg.remat`` "full" or "dots" the backward first replays each
layer's forward (:func:`repro_torch.models.layers.remat`), and with it the
layer's forward all-reduces: every rank replays them in the same order, so
the collectives still pair up.  The replay stops at the last tensor the
backward reads (the checkpoint's early stop), so a dense layer sends its
attention's row-parallel sum twice and its MLP's, which ends the layer,
once.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from ..core.distributed import all_reduce_axis
from ..launch.sharding import flatten, gather_shards, local_shard
from .api import ModelConfig, get_family
from .tensor_parallel import data_axes

# A gradient bucket's elements (128 MB of float32): few all-reduces over
# the data axes, and a bounded host copy each on gloo.
GRAD_BUCKET_ELEMENTS = 1 << 25


def loss(cfg: ModelConfig, params, batch: dict, mesh) -> torch.Tensor:
    """The next-token loss of this rank's rows (its ``batch_pspecs``
    block), from its parameter blocks (``shard_model``): the family's
    ``loss`` given the mesh, the same value on every rank of a "model"
    line.  The global loss is its mean over the data axes."""
    return get_family(cfg).loss(cfg, params, batch, mesh=mesh)[0]


def reduce_grads(grads: dict, mesh, axes) -> None:
    """Average every gradient over ``axes`` in place, in buckets of at most
    GRAD_BUCKET_ELEMENTS float32 elements (one all-reduce a bucket and
    axis): whole gradients concatenated, and a gradient larger than a
    bucket cut into bucket-sized pieces, so no message (and no host copy on
    gloo) exceeds a bucket."""
    axes = [ax for ax in axes if mesh.shape[ax] > 1]
    if not axes:
        return
    scale = 1.0 / mesh.axis_size(axes)
    pieces = [flat[off:off + GRAD_BUCKET_ELEMENTS]
              for flat in (g.view(-1) for g in grads.values())
              for off in range(0, flat.numel(), GRAD_BUCKET_ELEMENTS)]
    start = 0
    while start < len(pieces):
        end, size = start, 0
        while end < len(pieces) and size + pieces[end].numel() <= GRAD_BUCKET_ELEMENTS:
            size += pieces[end].numel()
            end += 1
        group = pieces[start:end]
        flat = torch.cat([g.float() for g in group])
        for ax in axes:
            flat = all_reduce_axis(flat, mesh, ax)
        flat.mul_(scale)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()])
            off += g.numel()
        start = end


def value_and_grad(cfg: ModelConfig, model, batch: dict, mesh):
    """(global loss, {name: gradient block}): the loss averaged over the
    data axes, and every parameter's gradient (``model`` must require
    grad) of it, averaged over the data axes -- the rank's block of the
    single process's ``jax.value_and_grad``.  ``batch`` is the rank's
    block of a global batch split over the data axes (``batch_pspecs``)."""
    params = dict(model.named_parameters())
    for prm in params.values():
        prm.grad = None
    local = loss(cfg, model, batch, mesh)
    local.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in params.items()}
    for prm in params.values():
        prm.grad = None
    axes = data_axes(mesh)
    reduce_grads(grads, mesh, axes)
    value = local.detach()
    for ax in axes:
        value = all_reduce_axis(value, mesh, ax) / mesh.shape[ax]
    return value, grads


# ---------------------------------------------------------------------------
# Placing a model's parameters on the ranks, and back
# ---------------------------------------------------------------------------


def param_segments(cfg: ModelConfig, name: str) -> Optional[dict]:
    """``{dim: segment sizes}`` of a parameter whose split dimension is a
    concatenation of segments (each split on its own), else None."""
    key = re.sub(r"\.\d+\.", ".*.", name)
    if cfg.gated_mlp and key in ("blocks.*.mlp.wi", "shared_attn.mlp.wi"):
        return {1: [cfg.d_ff, cfg.d_ff]}
    if cfg.gated_mlp and key == "blocks.*.moe.experts.wi":  # (E, D, [gate | up])
        return {2: [cfg.d_ff, cfg.d_ff]}
    if cfg.gated_mlp and key == "blocks.*.moe.shared.wi":
        fs = cfg.d_ff * cfg.n_shared_experts
        return {1: [fs, fs]}
    if cfg.family == "hybrid":
        from .mamba import _dims

        din, h, n, _ = _dims(cfg)
        if key == "shared_attn.mlp.wi":
            return {1: [cfg.d_ff, cfg.d_ff]}
        if key == "blocks.*.in_proj":
            return {1: [din, din, n, n, h]}
        if key == "blocks.*.conv_w":
            return {1: [din, n, n]}
        if key == "blocks.*.conv_b":
            return {0: [din, n, n]}
    return None


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """``{parameter name: spec}`` of ``fam.param_pspecs``."""
    return flatten(get_family(cfg).param_pspecs(cfg, mesh))


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _build(cfg: ModelConfig, flat: dict):
    from .convert import model_from_tree

    return model_from_tree(cfg, _unflatten(flat))


def shard_model(cfg: ModelConfig, model, mesh, requires_grad: bool = True):
    """This rank's model: a model of the same family whose parameters are
    the rank's blocks of ``model``'s (by ``param_pspecs``; the fused axes
    by :func:`param_segments`), on ``model``'s device."""
    specs = param_specs(cfg, mesh)
    flat = {n: local_shard(p.detach(), specs[n], mesh, param_segments(cfg, n)).clone()
            for n, p in model.named_parameters()}
    return _build(cfg, flat).requires_grad_(requires_grad)


def gather_model(cfg: ModelConfig, model, mesh):
    """The whole model from every rank's :func:`shard_model` (every rank
    gets it): the inverse of :func:`shard_model`."""
    specs = param_specs(cfg, mesh)
    flat = {n: gather_shards(p.detach(), specs[n], mesh, param_segments(cfg, n))
            for n, p in model.named_parameters()}
    return _build(cfg, flat)


def gather_tree(cfg: ModelConfig, values: dict, mesh) -> dict:
    """``{name: whole tensor}`` of per-rank blocks keyed by parameter name
    (the gradients of :func:`value_and_grad`)."""
    specs = param_specs(cfg, mesh)
    return {n: gather_shards(v, specs[n], mesh, param_segments(cfg, n)) for n, v in values.items()}
