"""Int8 gradient compression with error feedback.

A port of :mod:`repro.optim.compress`: ``compress(g, err)`` quantizes
``g + err`` to int8 with a per-tensor scale (``max |g + err| / 127``,
at least 1e-30 / 127), rounding half to even (``torch.round`` rounds as
``jnp.round`` does), and returns the residual as the next error.  On a
data-parallel mesh the int8 tensor is what would cross the slow links;
on one card the round trip is the same arithmetic.  The train step
applies it to every gradient when ``TrainConfig.grad_compress`` is set.

``compress_tree`` scales by the JAX package's leaves: there a layer
stack's parameter is one array (the layers stacked on a leading axis), so
the per-layer tensors of one parameter -- names that differ only in the
layer index, ``blocks.0.attn.wq`` and ``blocks.1.attn.wq`` -- share one
scale, the largest magnitude over all of them.
"""

from __future__ import annotations

import torch


def _quantize(g32: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, g32 - q.float() * scale


def compress(g: torch.Tensor, err: torch.Tensor):
    """(q int8, scale float32 0-d, new error float32) of ``g + err``."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q, new_err = _quantize(g32, scale)
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32."""
    return q.float() * scale


def leaf_key(name: str) -> str:
    """The JAX package's leaf of a parameter name: the name without its
    layer index (``blocks.3.attn.wq`` -> ``blocks.attn.wq``)."""
    return ".".join(part for part in name.split(".") if not part.isdigit())


def compress_tree(grads: dict, err: dict, leaf_max=None):
    """The int8 round trip of every gradient: (decompressed gradients, new
    errors), both keyed as ``grads``; one scale for the tensors of one
    JAX leaf (:func:`leaf_key`).  ``leaf_max(names, top)``, where given,
    turns the largest ``|g + err|`` of a leaf's local tensors into the
    whole leaf's (a rank's block of a split leaf: the max over the ranks
    that hold the rest)."""
    groups: dict[str, list[str]] = {}
    for name in grads:
        groups.setdefault(leaf_key(name), []).append(name)
    out, new_err = {}, {}
    for names in groups.values():
        g32 = [grads[n].float() + err[n] for n in names]
        top = torch.stack([g.abs().max() for g in g32]).max()
        if leaf_max is not None:
            top = leaf_max(names, top)
        scale = torch.clamp(top, min=1e-30) / 127.0
        for n, g in zip(names, g32):
            q, new_err[n] = _quantize(g, scale)
            out[n] = decompress(q, scale)
    return out, new_err


def init_error_state(params: dict) -> dict:
    """Zero float32 errors keyed as ``params``."""
    return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
