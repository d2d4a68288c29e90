"""Batched many-systems solves: one factorization / solve over a fleet axis.

The lifecycle API (:mod:`repro_torch.core.sap`) amortizes the expensive
stages across right-hand sides of a *single* matrix.  The paper's target
workload, though, is sequences of moderately sized banded systems -- one
per time step, one per scenario, one per user -- and serving such fleets
wants a *system* batch axis: factor S independent systems in one pass and
solve them in one Krylov iteration, instead of S Python round trips.

Two layers live here:

1. **Batched lifecycle** -- :func:`batch_plan` / :func:`batch_factor`
   produce a :class:`BatchedSaPFactorization`: a stacked
   :class:`~repro_torch.core.sap.SaPFactorization` whose tensors carry a
   leading system axis, with ``solve_batch`` (one RHS per system,
   ``(S, N)``) and ``solve_batch_many`` (``(S, N, R)``).  On the card the
   system axis folds into each kernel's chain axis (S*P partitions for
   btf, bts and the fused pass; S reduced chains for the chain sweep and
   for block cyclic reduction), so a batch launches each kernel as often
   as one system does.

2. **Bucketing** -- heterogeneous fleets cannot share one stacked shape.
   :func:`bucket_shape` / :func:`bucket_by_shape` round each system's
   ``(N, K)`` up to a shared bucket (power-of-two rounding by default) and
   :func:`pad_band_to` embeds a system *exactly* into the bucket shape.

   The N axis pads with decoupled identity rows.  The K axis is the
   subtle one: zero side columns are *algebraically* exact but
   *structurally* singular -- a K' > K band whose outer diagonals are
   exactly zero has strictly-triangular coupling blocks, so the K'-blocked
   pivots of the block LU become ill-conditioned and the "exact" variant E
   preconditioner silently loses digits (a converged-but-wrong solve).
   When K widens, :func:`pad_band_to` therefore *interleaves* identity
   rows instead: every K original rows are followed by K' - K identity
   slots, which makes the padded matrix a symmetric permutation of
   ``blkdiag(A, I)`` whose K'-blocked pivots are exactly
   ``(original KxK pivot) (+) I``.  The row permutation
   (:func:`pad_permutation`) rides the factorization's ``b_perm`` /
   ``x_perm`` slots, so callers keep the contiguous contract: RHS in as
   ``[b; 0]``, solution out as ``[x; 0]``.

The per-system factorizations inside a batch are slicable
(:func:`index_factorization`) and re-stackable
(:func:`stack_factorizations`), which is what the serving engine
(:mod:`repro_torch.serve.solver_engine`) uses to mix cached and freshly
factored systems inside one batched solve.

Nothing is traced or compiled per shape here: the JAX package's jitted,
vmapped, ahead-of-time compiled factor stages (``_factor_stages_fn``,
``factor_stages_compiled``) have no counterpart beyond the plain function
:func:`_factor_stages`.  The single-system stage spans (``factor.lu``,
``factor.spike``, ...) stay quiet inside a batch factor, as they do under
the JAX package's ``vmap``: ``factor.batch`` has no lifecycle children.
The JAX package's first ``factor.batch`` of a bucket also holds a
``compile`` span (its ahead-of-time compile); the port's never does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..obs.trace import count, quiet, span
from .banded import band_to_block_tridiag, diag_dominance_factor
from .operators import BandedOperator
from .sap import (
    SaPFactorization,
    SaPOptions,
    SaPSolveResult,
    _annotate_solve,
    _dtype,
    _solve_impl,
    _tensor,
    resolve_solver,
    resolve_variant,
)
from .spike import SaPPreconditioner, build_preconditioner

# ---------------------------------------------------------------------------
# Bucketing: shared stacked shapes for heterogeneous fleets
# ---------------------------------------------------------------------------


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def interleaved_rows(n: int, k: int, k_pad: int) -> int:
    """Rows the structurally exact K-widened embedding needs.

    Widening K to K' > K interleaves K' - K identity rows after every K
    original rows (see :func:`pad_band_to`), so N grows to
    ``ceil(N / K) * K'``.  No widening (or K = 0, where there are no
    couplings to keep well-conditioned) needs no extra rows.
    """
    if k <= 0 or k_pad <= k:
        return n
    return -(-n // k) * k_pad


def bucket_shape(n: int, k: int, p: int, rounding: str = "pow2") -> Tuple[int, int, int]:
    """Round a system's ``(N, K)`` up to its bucket ``(N', K', P)``.

    ``rounding="pow2"`` keeps the number of distinct shapes logarithmic in
    the size spread (at most ~2x padding waste); ``"exact"`` buckets only
    identical shapes together.  ``K'`` is never rounded below 2 so
    degenerate K=0/1 systems still form K x K blocks.  When ``K' > K`` the
    bucket's ``N'`` also covers the interleaved identity-row embedding
    (:func:`interleaved_rows`) so the K-widening stays structurally exact.
    """
    if rounding == "pow2":
        kb = max(_next_pow2(k), 2)
    elif rounding == "exact":
        kb = max(k, 2)
    else:
        raise ValueError(f"unknown bucket rounding {rounding!r}")
    n_eff = interleaved_rows(n, k, kb)
    if rounding == "pow2":
        nb = max(_next_pow2(n_eff), p * kb)
    else:
        nb = max(n_eff, p * kb)
    # block-tridiag partitioning pads to P * M * K' anyway; absorb that
    # padding into the bucket so the bucket key IS the factored shape.
    nb = _round_up(nb, p * kb)
    return nb, kb, p


def bucket_by_shape(shapes: Sequence[Tuple[int, int]], p: int, rounding: str = "pow2") -> dict:
    """Group systems by shared bucket shape.

    ``shapes`` is a sequence of per-system ``(N, K)``; returns an ordered
    ``{(N', K', P): [indices...]}`` mapping (insertion order = first
    occurrence, so callers can drain buckets deterministically).
    """
    buckets: dict = {}
    for i, (n, k) in enumerate(shapes):
        buckets.setdefault(bucket_shape(n, k, p, rounding), []).append(i)
    return buckets


def _pad_positions(n: int, k: int, k_pad: int) -> np.ndarray:
    """Interleaved position of original row t: chunk ``t // k`` of K rows
    starts at ``(t // k) * K'`` in the padded frame."""
    t = np.arange(n)
    return (t // k) * k_pad + (t % k)


def pad_permutation(n: int, k: int, n_pad: int, k_pad: int) -> Optional[np.ndarray]:
    """Contiguous -> padded row map of the bucket embedding, or None.

    Returns ``perm`` (int32, length N') such that for a padded-frame
    vector ``v``, ``v[perm]`` is the contiguous-frame vector: original
    row ``t < N`` lives at padded row ``perm[t]``, identity pad slots
    occupy ``perm[N:]``.  None when the embedding is contiguous (no
    K-widening, K = 0, or not enough rows to interleave), i.e. original
    rows simply occupy the first N slots.
    """
    if k <= 0 or k_pad <= k or interleaved_rows(n, k, k_pad) > n_pad:
        return None
    pos = _pad_positions(n, k, k_pad)
    pad_slots = np.setdiff1d(np.arange(n_pad), pos)
    return np.concatenate([pos, pad_slots]).astype(np.int32)


def _pad_band_interleaved(band: torch.Tensor, n_pad: int, k_pad: int) -> torch.Tensor:
    """K-widening embedding that preserves block conditioning exactly.

    Insert ``K' - K`` identity rows after every K original rows.  The
    resulting (N', 2K'+1) band is a symmetric permutation of
    ``blkdiag(A, I)``: every K'xK' partition block of the block-tridiag
    factorization is (an original KxK block) (+) (an identity slot), so
    pivots, spikes, and the reduced interface system have *identical*
    conditioning to the unpadded factorization -- unlike zero side
    columns, which make the widened coupling blocks strictly triangular
    (structurally singular) and poison the f32 block-pivot inverses.
    """
    n, w = band.shape
    k = (w - 1) // 2
    pos = _pad_positions(n, k, k_pad)
    t = np.arange(n)
    rows, cols, src_t, src_j = [], [], [], []
    for j in range(w):
        c = t + (j - k)
        valid = (c >= 0) & (c < n)
        tv = t[valid]
        # |pos[c] - pos[t]| <= K' for |c - t| <= K: same or adjacent chunk
        off = pos[c[valid]] - pos[tv]
        rows.append(pos[tv])
        cols.append(k_pad + off)
        src_t.append(tv)
        src_j.append(np.full(tv.shape, j))

    def idx(parts):
        return torch.as_tensor(np.concatenate(parts), device=band.device)

    out = band.new_zeros((n_pad, 2 * k_pad + 1))
    out[:, k_pad] = 1.0  # identity everywhere ...
    # ... original entries overwrite their slots (targets are unique)
    out[idx(rows), idx(cols)] = band[idx(src_t), idx(src_j)]
    return out


def pad_band_to(band, n_pad: int, k_pad: int) -> torch.Tensor:
    """Embed an (N, 2K+1) band exactly into bucket shape (N', 2K'+1).

    ``band`` is a tensor (padded where it lies) or a numpy array (padded
    on the CPU).  When K widens (``K' > K > 0``) and the bucket has room
    (``interleaved_rows(N, K, K') <= N'``, guaranteed for buckets from
    :func:`bucket_shape`), the embedding interleaves identity rows so the
    padded matrix is a symmetric permutation of ``blkdiag(A, I)`` --
    structurally exact, same conditioning as unpadded (see
    :func:`_pad_band_interleaved`); recover the row order with
    :func:`pad_permutation` (``batch_factor`` wires it into the
    factorization's ``b_perm`` / ``x_perm`` automatically).

    Otherwise the embedding is contiguous: zero side columns for the
    added diagonals, identity rows appended below.  That form is
    algebraically exact too, but a widened K leaves structurally singular
    coupling blocks whose boosted pivots degrade the preconditioner --
    only acceptable when K does not widen.
    """
    band = _tensor(band)
    n, w = band.shape
    k = (w - 1) // 2
    if k_pad < k or n_pad < n:
        raise ValueError(
            f"bucket shape (N'={n_pad}, K'={k_pad}) smaller than system (N={n}, K={k})"
        )
    if pad_permutation(n, k, n_pad, k_pad) is not None:
        return _pad_band_interleaved(band, n_pad, k_pad)
    if k_pad != k:
        side = band.new_zeros((n, k_pad - k))
        band = torch.cat([side, band, side], dim=1)
    if n_pad != n:
        rows = band.new_zeros((n_pad - n, 2 * k_pad + 1))
        rows[:, k_pad] = 1.0
        band = torch.cat([band, rows], dim=0)
    return band


def _host(band) -> np.ndarray:
    """A band as a host numpy array (a tensor is copied off its device)."""
    if isinstance(band, torch.Tensor):
        return band.detach().cpu().numpy()
    return np.asarray(band)


def band_effective_k(band) -> int:
    """True half-bandwidth: stored K minus exactly-zero outer diagonals.

    A band *stored* wider than its couplings (e.g. a K=3 matrix in K=4
    storage) reproduces the structurally-singular zero-diagonal problem
    no matter how it is bucketed; trimming to the effective K first
    (:func:`trim_band_to_effective`) restores the exact embedding.  Host-
    side (numpy) -- used on the serving escalation path.
    """
    a = _host(band)
    k = (a.shape[1] - 1) // 2
    ke = k
    while ke > 0 and not (np.any(a[:, k - ke]) or np.any(a[:, k + ke])):
        ke -= 1
    return ke


def trim_band_to_effective(band) -> np.ndarray:
    """Drop exactly-zero outer diagonal pairs from band storage."""
    a = _host(band)
    k = (a.shape[1] - 1) // 2
    ke = band_effective_k(a)
    return a if ke == k else a[:, k - ke : k + ke + 1]


def pad_rhs_to(b, n_pad: int) -> torch.Tensor:
    """Zero-pad a (N,) or (N, R) right-hand side to the bucket length."""
    b = _tensor(b)
    if b.shape[0] == n_pad:
        return b
    return torch.cat([b, b.new_zeros((n_pad - b.shape[0],) + tuple(b.shape[1:]))], dim=0)


# ---------------------------------------------------------------------------
# Stage 1: batch_plan (stack a fleet into one bucket shape)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchedSaPPlan:
    """Plan for a fleet of banded systems sharing one bucket.

    bands   : (S, N', 2K'+1) stacked (padded) band storage, on the device
    k, n    : bucket half-bandwidth K' and size N'
    orig_ns : per-system original sizes (for un-padding results)
    orig_ks : per-system original half-bandwidths (for the interleaved
              K-widening permutations; empty = assume no widening)
    opts    : solver options shared by the whole batch
    """

    bands: torch.Tensor
    k: int
    n: int
    orig_ns: Tuple[int, ...]
    opts: SaPOptions
    orig_ks: Tuple[int, ...] = ()

    @property
    def s(self) -> int:
        """Number of systems in the batch."""
        return self.bands.shape[0]


def batch_plan(
    bands,
    opts: Optional[SaPOptions] = None,
    rounding: str = "pow2",
    device=None,
) -> BatchedSaPPlan:
    """Plan a fleet of banded systems as ONE stacked, bucket-padded batch.

    ``bands`` is either an already-stacked (S, N, 2K+1) tensor or array
    (uniform fleet) or a sequence of per-system (N_i, 2K_i+1) bands
    (heterogeneous fleet).  All systems are padded to the single bucket
    covering the largest ``(N, K)`` in the fleet -- callers that want
    *multiple* shapes split the fleet with :func:`bucket_by_shape` first
    (the serving engine does exactly that).  The stack goes to ``device``
    (default: the card).
    """
    opts = opts or SaPOptions()
    dev = resolve_device(device)
    if isinstance(bands, (torch.Tensor, np.ndarray)) and bands.ndim == 3:
        stacked = _tensor(bands)
        s, n, w = stacked.shape
        k = (w - 1) // 2
        nb, kb, _ = bucket_shape(n, k, opts.p, rounding)
        if (nb, kb) != (n, k):
            stacked = torch.stack([pad_band_to(bd, nb, kb) for bd in stacked])
        return BatchedSaPPlan(bands=stacked.to(dev), k=kb, n=nb, orig_ns=(n,) * s, opts=opts,
                              orig_ks=(k,) * s)

    bands = [_tensor(bd) for bd in bands]
    if not bands:
        raise ValueError("batch_plan needs at least one system")
    shapes = [(bd.shape[0], (bd.shape[1] - 1) // 2) for bd in bands]
    nb = max(bucket_shape(n, k, opts.p, rounding)[0] for n, k in shapes)
    kb = max(bucket_shape(n, k, opts.p, rounding)[1] for n, k in shapes)
    # the fleet bucket's K' may exceed a member's own bucket K', widening
    # its interleaved embedding beyond its own N' -- grow N' to cover the
    # worst member so every embedding stays structurally exact.
    need = max(interleaved_rows(n, k, kb) for n, k in shapes)
    nb = max(nb, _next_pow2(need) if rounding == "pow2" else need)
    nb = _round_up(nb, opts.p * kb)  # one bucket for the whole fleet
    stacked = torch.stack([pad_band_to(bd, nb, kb) for bd in bands])
    return BatchedSaPPlan(
        bands=stacked.to(dev),
        k=kb,
        n=nb,
        orig_ns=tuple(n for n, _ in shapes),
        opts=opts,
        orig_ks=tuple(k for _, k in shapes),
    )


# ---------------------------------------------------------------------------
# Stage 2: batch_factor (every system in one pass of each kernel)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class BatchedSaPFactorization:
    """S independent SaP factorizations stacked over a leading system axis.

    ``fac`` is a :class:`~repro_torch.core.sap.SaPFactorization` whose
    tensors (band, preconditioner factors, d_factor, permutations) carry a
    leading ``(S, ...)`` axis while the meta fields (bucket shape,
    tolerances) are shared.
    """

    fac: SaPFactorization
    s: int
    orig_ns: Tuple[int, ...]

    @property
    def n(self) -> int:
        """Padded per-system size shared by the whole batch."""
        return self.fac.n

    @property
    def k(self) -> int:
        """Padded half-bandwidth shared by the whole batch."""
        return self.fac.k

    @property
    def variant(self) -> str:
        """Resolved SaP variant shared by the whole batch."""
        return self.fac.variant

    def _rhs(self, b) -> torch.Tensor:
        return _tensor(b).to(self.fac.pc.lu.sinv.device)

    def solve_batch(self, b, record_history: bool = False) -> SaPSolveResult:
        """Solve system i against RHS i: b (S, N') -> x (S, N'); the
        per-system diagnostics are (S,)."""
        b = self._rhs(b)
        if b.ndim != 2 or tuple(b.shape) != (self.s, self.n):
            raise ValueError(
                f"solve_batch expects one RHS per system, shape ({self.s}, {self.n}); "
                f"got {tuple(b.shape)}"
            )
        with span("krylov", s=self.s, n=self.n, k=self.k, variant=self.variant) as sp:
            launched = kops.launch_counts() if sp else None
            res = _solve_impl(self.fac, b[..., None], record_history)
            res = sp.sync(SaPSolveResult(
                x=res.x[..., 0],
                iterations=res.iterations[:, 0],
                resnorm=res.resnorm[:, 0],
                converged=res.converged[:, 0],
                true_resnorm=res.true_resnorm[:, 0],
                d_factor=res.d_factor,
                history=None if res.history is None else res.history[:, 0],
            ))
        if sp:
            _annotate_solve(sp, res, launched)
        return res

    def solve_batch_many(self, b, record_history: bool = False) -> SaPSolveResult:
        """Solve R RHS per system: b (S, N', R) -> x (S, N', R); the
        per-system, per-column diagnostics are (S, R)."""
        b = self._rhs(b)
        if b.ndim != 3 or tuple(b.shape[:2]) != (self.s, self.n):
            raise ValueError(
                f"solve_batch_many expects shape ({self.s}, {self.n}, R); got {tuple(b.shape)}"
            )
        with span("krylov", s=self.s, n=self.n, k=self.k, variant=self.variant,
                  nrhs=int(b.shape[2])) as sp:
            launched = kops.launch_counts() if sp else None
            res = sp.sync(_solve_impl(self.fac, b, record_history))
        if sp:
            _annotate_solve(sp, res, launched)
        return res


def _factor_stages(
    bands: torch.Tensor, k: int, p: int, variant: str, opts: SaPOptions
) -> tuple[SaPPreconditioner, torch.Tensor]:
    """The device stages of ``sap.factor`` on a stack of bands: the split of
    every system in one strided copy, then the preconditioner with each
    kernel launched once for the whole stack.  Returns the stacked
    preconditioner and the per-system dominance ``d`` (S,)."""
    d_factor = diag_dominance_factor(bands)
    bt = band_to_block_tridiag(bands, max(k, 1), p)
    with quiet():  # the single-system stage spans, as under the JAX package's vmap
        pc = build_preconditioner(
            bt,
            variant=variant,
            boost_eps=opts.boost_eps,
            precond_dtype=_dtype(opts.precond_dtype),
            reduced_solver=opts.reduced_solver,
            fused=opts.fused_factor,
        )
    return pc, d_factor


def _stacked_permutations(bpl: BatchedSaPPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-system contiguous<->padded row maps as stacked (S, N') tensors.

    ``x_perm[i]`` gathers system i's padded-frame solution back to the
    contiguous frame; ``b_perm[i]`` (its inverse) scatters the contiguous
    ``[b; 0]`` RHS into the interleaved frame.  Always materialized --
    identity rows for members that need no interleaving -- so every
    factorization of a bucket has the same structure and the serving cache
    can stack factorizations coming from different plans.
    """
    orig_ks = bpl.orig_ks or (bpl.k,) * bpl.s
    ident = np.arange(bpl.n, dtype=np.int64)
    xs, bs = [], []
    for n, k in zip(bpl.orig_ns, orig_ks):
        perm = pad_permutation(n, k, bpl.n, bpl.k)
        if perm is None:
            xs.append(ident)
            bs.append(ident)
        else:
            xs.append(perm.astype(np.int64))
            bs.append(np.argsort(perm).astype(np.int64))
    dev = bpl.bands.device
    return torch.as_tensor(np.stack(xs), device=dev), torch.as_tensor(np.stack(bs), device=dev)


def batch_factor(bpl: BatchedSaPPlan) -> BatchedSaPFactorization:
    """Factor every system in the batch in one pass of each kernel.

    ``variant="auto"`` resolves once for the whole batch from the *worst*
    (minimum) degree of diagonal dominance, so one stacked shape covers
    the batch: conservative -- any non-dominant member makes the batch use
    the exact reduced system "E".  (Identity padding rows are infinitely
    dominant and do not perturb the estimate.)
    """
    opts = bpl.opts
    variant = opts.variant
    if variant == "auto":
        count("host_syncs")
        variant = resolve_variant("auto", float(diag_dominance_factor(bpl.bands).min()))
    with span("factor.batch", s=bpl.s, n=bpl.n, k=bpl.k, p=opts.p, variant=variant) as sp:
        pc, d_factors = _factor_stages(bpl.bands, bpl.k, opts.p, variant, opts)
        sp.sync(pc)
    x_perm, b_perm = _stacked_permutations(bpl)
    fac = SaPFactorization(
        op=BandedOperator(band=bpl.bands, n=bpl.n, k=bpl.k),
        pc=pc,
        n=bpl.n,
        k=bpl.k,
        tol=opts.tol,
        maxiter=opts.maxiter,
        iter_dtype=opts.iter_dtype,
        solver=resolve_solver(opts.solver, opts.use_cg),
        d_factor=d_factors,
        b_perm=b_perm,
        x_perm=x_perm,
    )
    return BatchedSaPFactorization(fac=fac, s=bpl.s, orig_ns=bpl.orig_ns)


# ---------------------------------------------------------------------------
# Slicing / restacking (the serving engine's cache currency)
# ---------------------------------------------------------------------------


def _is_meta(x) -> bool:
    return x is None or isinstance(x, (bool, int, float, str))


def _tree_index(obj, i: int):
    """``obj`` with every tensor replaced by a copy of its i-th slice."""
    if isinstance(obj, torch.Tensor):
        return obj[i].clone()
    if _is_meta(obj):
        return obj
    if isinstance(obj, tuple):
        items = [_tree_index(v, i) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: _tree_index(getattr(obj, f.name), i) for f in dataclasses.fields(obj)}
        )
    raise TypeError(f"cannot index a {type(obj).__name__}")


def _tree_stack(objs: list, path: str):
    """Stack same-structure objects tensor by tensor; every meta field
    (shape, variant, tolerance ...) must agree.  Raises ValueError naming
    the first field that differs."""
    first = objs[0]

    def mixed():
        return ValueError(
            f"cannot stack factorizations from different buckets/variants: {path} differs"
        )

    if isinstance(first, torch.Tensor):
        if not all(isinstance(o, torch.Tensor) and o.shape == first.shape
                   and o.dtype == first.dtype and o.device == first.device for o in objs):
            raise mixed()
        return torch.stack(objs)
    if any(type(o) is not type(first) for o in objs):
        raise mixed()
    if _is_meta(first):
        if any(o != first for o in objs):
            raise mixed()
        return first
    if isinstance(first, tuple):
        if any(len(o) != len(first) for o in objs):
            raise mixed()
        items = [_tree_stack([o[j] for o in objs], f"{path}[{j}]") for j in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _tree_stack([getattr(o, f.name) for o in objs], f"{path}.{f.name}")
            for f in dataclasses.fields(first)})
    raise TypeError(f"cannot stack a {type(first).__name__}")


def index_factorization(bfac: BatchedSaPFactorization, i: int) -> SaPFactorization:
    """Extract system ``i`` as a standalone single-system factorization
    (its tensors copied out of the batch)."""
    return _tree_index(bfac.fac, i)


def stack_factorizations(
    facs: Sequence[SaPFactorization], orig_ns: Optional[Sequence[int]] = None
) -> BatchedSaPFactorization:
    """Stack single-system factorizations (same bucket shape) into a batch.

    The inverse of :func:`index_factorization`; all handles must share
    their meta (bucket shape, variant, tolerances) -- i.e. come from the
    same bucket -- or the stack is ill-formed and this raises.
    """
    facs = list(facs)
    if not facs:
        raise ValueError("stack_factorizations needs at least one handle")
    stacked = _tree_stack(facs, "fac")
    ns = tuple(orig_ns) if orig_ns is not None else (facs[0].n,) * len(facs)
    return BatchedSaPFactorization(fac=stacked, s=len(facs), orig_ns=ns)


def unpad_solution(x: torch.Tensor, orig_ns: Sequence[int]) -> List[np.ndarray]:
    """Slice a padded (S, N') batch solution back to per-system lengths,
    as host numpy arrays."""
    xs = x.detach().cpu().numpy()
    return [xs[i, :n] for i, n in enumerate(orig_ns)]
