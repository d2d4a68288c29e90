"""Tensor parallelism over a rank mesh's "model" axis: the collectives the
families' forwards call where a parameter is split.

The JAX package jits ``fam.loss`` on parameters placed by
``param_pspecs`` and GSPMD inserts the collectives.  Here every mesh
position is a process that holds its block of every parameter
(:func:`repro_torch.models.sharded.shard_model`), and the families'
forwards state the collectives themselves (Megatron-LM's layout, Shoeybi
et al. 2019) through the functions below.  Every one takes a ``mesh``
that may be None: without a mesh, or with a "model" axis of size 1, each
is the identity (or the plain product), so a single-process forward runs
exactly the code and the arithmetic it ran before.

* column-parallel products (``wq`` / ``wk`` / ``wv``, the MLP's ``wi``,
  RWKV6's ``wr`` / ``wk`` / ``wv`` / ``wg``, Zamba2's ``in_proj``, the
  head) enter through :func:`copy_to_model` (identity forward, all-reduce
  of the gradient backward), so the attention and the scans run on the
  rank's own heads;
* row-parallel products (``wo``, ``out_proj``, the channel mix's ``wv``)
  are :func:`row_parallel`: the partial sums are taken in float32 and
  rounded to the compute dtype once, after :func:`reduce_from_model`
  (all-reduce forward, identity backward), where the single process
  rounds its one product;
* the embedding and the head are split over the vocabulary: the lookup
  masks the ids of other ranks' rows and all-reduces
  (:func:`vocab_parallel_embed`); the next-token loss takes an
  all-reduced max, an all-reduced sum of exponentials and the target's
  logit from the rank that owns it, with ``next_token_nll``'s mask of the
  padded vocabulary (:func:`vocab_parallel_nll`); tied embeddings
  transpose the split embedding;
* a replicated tensor that a rank uses only in part (RWKV6's decay, the
  group norm's weights, Zamba2's per-head vectors) is sliced by
  :func:`scatter_to_model`, whose backward gathers the gradient, and a
  split tensor that replicated code reads whole (RWKV6's receptance gate,
  Zamba2's B and C) is gathered by :func:`gather_from_model`, whose
  backward slices; so every replicated parameter's gradient is whole and
  equal on every rank, and every split one's is the rank's block.

Gathers are zero-padded all-reduces (gloo, the backend of the one-card
machine's multi-rank runs, carries only all-reduce and broadcast for CUDA
tensors); :func:`repro_torch.core.distributed.comm_stats` counts every
collective by kind and axis.
"""

from __future__ import annotations

import torch

from ..launch.sharding import place_block, take_block

MODEL = "model"


def model_size(mesh) -> int:
    """The "model" axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get(MODEL, 1)


def model_index(mesh) -> int:
    """This rank's place along "model" (0 without a mesh)."""
    return mesh.axis_index((MODEL,)) if model_size(mesh) > 1 else 0


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's data axes ("pod", "data") of size above 1, over which
    the batch is split (none without a mesh)."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)


def split_count(total: int, mesh, what: str) -> int:
    """The rank's share of ``total`` heads or channels split over "model"."""
    n = model_size(mesh)
    if total % n:
        raise ValueError(f"{what} = {total} does not split over model = {n}")
    return total // n


def _all_reduce(x: torch.Tensor, mesh, kind: str = "all_reduce", op: str = "sum") -> torch.Tensor:
    from ..core.distributed import all_reduce_axis

    return all_reduce_axis(x, mesh, MODEL, op=op, kind=kind)


def _slice(x: torch.Tensor, mesh, dim: int, segments) -> torch.Tensor:
    return take_block(x, dim, model_size(mesh), model_index(mesh), segments).contiguous()


def _gather(x: torch.Tensor, mesh, dim: int, segments) -> torch.Tensor:
    n = model_size(mesh)
    shape = list(x.shape)
    shape[dim] *= n
    buf = x.new_zeros(shape)
    place_block(buf, x, dim, n, model_index(mesh), segments)
    return _all_reduce(buf, mesh, kind="all_gather")


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        from ..core.distributed import all_reduce_axis

        axes = data_axes(mesh)
        for ax in axes:
            x = all_reduce_axis(x.contiguous(), mesh, ax)
        return x / mesh.axis_size(axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, segments):
        ctx.args = (mesh, dim, segments)
        return _slice(x, mesh, dim, segments).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, segments):
        ctx.args = (mesh, dim, segments)
        return _gather(x.contiguous(), mesh, dim, segments)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward, gradient all-reduced over "model" backward: a
    replicated tensor entering column-parallel products."""
    return _Copy.apply(x, mesh) if model_size(mesh) > 1 else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Partial sums all-reduced over "model" forward, identity backward:
    after a row-parallel product, read whole by replicated code."""
    return _Reduce.apply(x, mesh) if model_size(mesh) > 1 else x


def data_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the data axes of a statistic of the rank's rows,
    forward; identity backward.  Every data rank's loss reads the same
    mean, and ``sharded.value_and_grad`` averages the ranks' gradients over
    the data axes, so each rank passes its cotangent back unscaled: the
    average then carries the mean's own 1 / n.  Without data axes, ``x``."""
    return _DataMean.apply(x, mesh) if data_axes(mesh) else x


def max_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max over "model" of a tensor that carries no
    gradient."""
    return _all_reduce(x, mesh, op="max") if model_size(mesh) > 1 else x


def scatter_to_model(x: torch.Tensor, mesh, dim: int = -1, segments=None) -> torch.Tensor:
    """The rank's block of a replicated tensor along ``dim``; backward
    gathers the gradient (every rank's block) over "model"."""
    if model_size(mesh) == 1:
        return x
    return _Scatter.apply(x, mesh, dim % x.dim(), segments)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1, segments=None) -> torch.Tensor:
    """Every rank's block along ``dim`` put together; backward slices out
    the rank's block of the gradient (the whole tensor is read by
    replicated code)."""
    if model_size(mesh) == 1:
        return x
    return _Gather.apply(x, mesh, dim % x.dim(), segments)


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype; with ``w`` split by rows over "model",
    each rank's partial product in float32 (of the compute-dtype
    operands), summed over "model", rounded to ``x``'s dtype once."""
    if model_size(mesh) == 1:
        return x @ w.to(x.dtype)
    part = x.float() @ w.to(x.dtype).float()
    return reduce_from_model(part, mesh).to(x.dtype)


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """Rows of the embedding for ``tokens``.  Split over "model" ((V /
    model, D) on each rank), other ranks' ids give zeros, and the
    all-reduce fills them (float32)."""
    if model_size(mesh) == 1:
        return embed[tokens]
    v_loc = embed.shape[0]
    ids = tokens.long() - model_index(mesh) * v_loc
    own = (ids >= 0) & (ids < v_loc)
    x = embed[ids.clamp(0, v_loc - 1)] * own[..., None].to(embed.dtype)
    return reduce_from_model(x, mesh)


def vocab_parallel_nll(logits: torch.Tensor, tokens: torch.Tensor, vocab: int,
                       mesh) -> torch.Tensor:
    """``layers.next_token_nll`` of logits split over the vocabulary
    ((B, T, V / model) on each rank): the mean over this rank's rows."""
    lg = logits[:, :-1].float()
    v_loc = lg.shape[-1]
    lo = model_index(mesh) * v_loc
    cols = lo + torch.arange(v_loc, device=lg.device)
    lg = lg.masked_fill(cols >= vocab, float("-inf"))
    mx = max_over_model(lg.detach().amax(dim=-1, keepdim=True), mesh)
    se = reduce_from_model(torch.exp(lg - mx).sum(dim=-1), mesh)
    lse = torch.log(se) + mx[..., 0]
    tgt = tokens[:, 1:].long() - lo
    own = (tgt >= 0) & (tgt < v_loc)
    picked = lg.gather(-1, tgt.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = reduce_from_model(torch.where(own, picked, torch.zeros_like(picked)), mesh)
    return (lse - picked).mean()
