"""Partition specs over a rank mesh, and the blocks they give each rank.

A spec is the port's counterpart of ``jax.sharding.PartitionSpec``: one
entry per leading tensor dimension, each ``None`` (replicated), a mesh
axis name, or a tuple of axis names (the dimension split over their
flattened product, the first axis outermost); dimensions past the spec's
length are replicated.  :class:`PartitionSpec` is a tuple, so a spec
compares equal to the tuple of its entries.

A rank holds the block of a full tensor at its coordinates
(:func:`local_shard`), and :func:`gather_shards` puts the blocks back
together.  Where a sharded dimension is the concatenation of segments
that must be split one by one -- the gated MLP's fused ``[gate | up]``
columns, Zamba2's ``[z | x | B | C | dt]`` projection -- ``segments``
names their sizes, and a rank's block is its share of each segment in
turn (a fixed permutation of the dimension; the block's shape is the
spec's).

Gathers go through :func:`repro_torch.core.distributed.all_reduce_axis`
(a zero-padded buffer summed over the axis): gloo, the backend of every
multi-rank run on the one-card machine, has no ``all_gather`` for CUDA
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


class PartitionSpec(tuple):
    """``P(None, "model")``: a tuple of per-dimension entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set[str]:
    """Every mesh axis a spec uses."""
    return {a for e in spec for a in entry_axes(e)}


def _dims(spec, ndim: int) -> list[tuple[int, tuple[str, ...]]]:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than the tensor's {ndim} dimensions")
    return [(d, entry_axes(e)) for d, e in enumerate(spec) if entry_axes(e)]




def take_block(t: torch.Tensor, dim: int, n: int, i: int, segments=None) -> torch.Tensor:
    """Block ``i`` of ``n`` along ``dim``: a slice, or the i-th share of
    every segment in turn."""
    size = t.shape[dim]
    segs = list(segments) if segments else [size]
    if sum(segs) != size:
        raise ValueError(f"segments {segs} do not add up to dimension {dim}'s {size}")
    for s in segs:
        if s % n:
            raise ValueError(f"a segment of {s} along dimension {dim} does not split {n} ways")
    out, start = [], 0
    for s in segs:
        out.append(t.narrow(dim, start + i * (s // n), s // n))
        start += s
    return out[0] if len(out) == 1 else torch.cat(out, dim=dim)


def local_shard(t: torch.Tensor, spec, mesh, segments: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``;
    ``segments`` maps a dimension to its segment sizes.  A new contiguous
    tensor (``t`` itself when nothing is split)."""
    segments = segments or {}
    out = t
    for d, axes in _dims(spec, t.dim()):
        if len(axes) > 1 and segments.get(d):
            raise ValueError(f"dimension {d} has segments and is split over {axes}")
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        out = take_block(out, d, n, i, segments.get(d))
    return out if out is t else out.contiguous()


def place_block(full: torch.Tensor, block: torch.Tensor, dim: int, n: int, i: int,
                segments=None) -> None:
    """Write ``block`` where :func:`take_block` took block ``i`` of ``n``."""
    segs = list(segments) if segments else [full.shape[dim]]
    start = off = 0
    for s in segs:
        w = s // n
        full.narrow(dim, start + i * w, w).copy_(block.narrow(dim, off, w))
        start += s
        off += w


def gather_shards(t_local: torch.Tensor, spec, mesh,
                  segments: Optional[dict] = None) -> torch.Tensor:
    """The full tensor from every rank's block (the inverse of
    :func:`local_shard`): one zero-padded all-reduce over the axes of each
    split dimension, innermost axis first."""
    from ..core.distributed import all_reduce_axis

    segments = segments or {}
    out = t_local
    for d, axes in reversed(_dims(spec, t_local.dim())):
        for ax in reversed(axes):
            n, i = mesh.shape[ax], mesh.axis_index((ax,))
            if n == 1:
                continue
            full_shape = list(out.shape)
            full_shape[d] *= n
            buf = out.new_zeros(full_shape)
            # an outer axis's blocks are contiguous runs of the inner ones'
            place_block(buf, out, d, n, i, segments.get(d) if len(axes) == 1 else None)
            out = all_reduce_axis(buf, mesh, ax, kind="all_gather")
    return out


# ---------------------------------------------------------------------------
# Spec trees: nested dicts (and lists of per-layer dicts) of specs
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / list tree (and of trees of
    the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def flatten(tree, prefix: str = "") -> dict:
    """``{"blocks.0.attn.wq": leaf, ...}``: a tree's leaves under the names
    ``nn.Module.named_parameters`` gives the port's models."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out
