"""SaP solver API: plan / plan_banded / factor / solve.

The paper's economics (Fig. 3.1): pay once for the expensive stages -- DB
reordering (T_DB), CM reordering (T_CM), drop-off (T_Drop), banded
assembly (T_Asmbl) and the split block-LU + SPIKE factorization (T_LU) --
then amortize them over a cheap preconditioned Krylov iteration per
right-hand side (T_Kry).  The lifecycle mirrors that:

1. ``plan(a, opts, device)`` / ``plan_banded(band, opts, device) ->
   SaPPlan``: ``plan`` runs the host-side DB/CM/drop-off analysis of a
   CSR, scipy or dense square matrix once and keeps the permutations;
   ``plan_banded`` takes (N, 2K+1) band storage as it is.  The operator
   and preconditioner band go to the device (the card unless
   ``device="cpu"`` is asked for).
2. ``factor(plan) -> SaPFactorization``: block-LU + SPIKE coupling
   (paper Sec. 2.1), through the CUDA kernels when the band is on the card.
3. ``factorization.solve(b)`` / ``factorization.solve_many(B)``: one RHS of
   shape (N,), or (N, R) with an independent Krylov iteration per column;
   permutations are applied and undone inside.

The Krylov matvec always uses the original (reordered) matrix; drop-off
and the banded approximation only affect the preconditioner.

Mixed precision (Sec. 3.1): the preconditioner is factored and applied in
``opts.precond_dtype`` while the outer iteration runs in the dtype of the
RHS (or ``opts.iter_dtype``).  On the card each of "float32", "bfloat16"
and "float64" runs its own instantiation of every block kernel
(bfloat16 computing in float32, float64 in float64).  The apply rounds
the Krylov vector to ``precond_dtype``, so BiCGStab(2) with a bfloat16
preconditioner reports convergence at a true residual of about 2^-8, as
the JAX package does (R11); ``solver="refine"`` recomputes the true
residual in the iteration's dtype every sweep and reaches ``tol``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..obs.trace import count, device_span, span
from . import reorder as reorder_mod
from .banded import band_to_block_tridiag, diag_dominance_factor
from .block_lu import DEFAULT_BOOST
from .krylov import KrylovResult, _bicgstab2_block, _cg_block, _refine_block
from .operators import BandedOperator, CsrOperator, LinearOperator, require_square_dense
from .spike import SaPPreconditioner, build_preconditioner


@dataclasses.dataclass
class SaPOptions:
    """Solver configuration: partitioning, variant, tolerances, dtypes."""

    p: int = 8  # number of partitions
    # "C" coupled (truncated SPIKE) | "D" decoupled | "E" exact reduced
    # system | "auto" (C when the band is diagonally dominant, d >= 1, else
    # E -- paper Sec. 2.1.1 guidance), resolved at factor() time.
    variant: str = "C"
    tol: float = 1e-10
    maxiter: int = 500
    # Tolerance on the *true* relative residual ||b - A x|| / ||b|| a
    # served result must meet before its ``converged`` claim is trusted
    # (None: 10 * tol).  Read by SolverEngine / AsyncSolverService, which
    # escalate or demote ``converged`` when it fails; every solve path
    # reports ``true_resnorm`` either way.
    check_true_residual: Optional[float] = None
    boost_eps: float = DEFAULT_BOOST
    precond_dtype: str = "float32"
    iter_dtype: Optional[str] = None  # Krylov dtype; None = follow the RHS
    use_cg: bool = False  # legacy spelling of solver="cg" (SPD systems)
    # Outer solver: "bicgstab2" | "cg" | "refine" | "auto" (= "cg" when
    # use_cg else "bicgstab2"); resolved once, at factor() time.
    solver: str = "auto"
    # Fused factor+spike kernel: "on" | "off" | "auto" (fused on the card).
    fused_factor: str = "auto"
    # reduced-system solver for variant "E": "chain" = sequential btf/bts
    # sweep over the (P-1)-interface chain, "bcr" = block cyclic reduction,
    # "auto" = bcr from 8 interfaces on.
    reduced_solver: str = "auto"
    # sparse front end (Sec. 2.2), used by plan()
    use_db: bool = True  # diagonal-boosting reordering
    use_cm: bool = True  # bandwidth-reducing reordering
    drop_tol: float = 0.0  # element drop-off fraction (0 = keep all)
    # Record the per-sweep Krylov residual in the serving engine's solves; a
    # solve-time knob, never part of a factorization or a cache key.
    record_history: bool = False


@dataclasses.dataclass
class SaPSolution:
    """Legacy one-shot result (``solve_banded`` / ``solve_sparse``)."""

    x: torch.Tensor
    iterations: float
    resnorm: float
    converged: bool
    k: int  # half bandwidth used by the preconditioner
    info: dict
    true_resnorm: float = float("nan")  # ||b - A x|| / ||b||, unpreconditioned


class SaPSolveResult(NamedTuple):
    """Result of a lifecycle solve.

    For ``solve_many``, ``x`` is (N, R) and the per-RHS diagnostics
    (``iterations`` / ``resnorm`` / ``converged`` / ``true_resnorm``) are
    (R,).  ``converged`` / ``resnorm`` describe the *preconditioned*
    residual the Krylov iteration drives below ``tol``; ``true_resnorm``
    (``||b - A x|| / ||b||`` recomputed at exit) measures answer quality.
    ``d_factor`` is the band's degree of diagonal dominance (Eq. 2.11).
    """

    x: torch.Tensor
    iterations: torch.Tensor
    resnorm: torch.Tensor
    converged: torch.Tensor
    true_resnorm: Optional[torch.Tensor] = None
    d_factor: Optional[torch.Tensor] = None
    history: Optional[torch.Tensor] = None


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}[name]


def _resolve_iter_dtype(b_dtype: torch.dtype, iter_dtype: Optional[str]) -> torch.dtype:
    """Krylov iteration dtype: explicit option > RHS dtype > default float."""
    if iter_dtype is not None:
        return _dtype(iter_dtype)
    if b_dtype.is_floating_point:
        return b_dtype
    return torch.get_default_dtype()


def _tensor(x) -> torch.Tensor:
    """A tensor as is; anything else (numpy, lists) copied into one."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# Stage 1: plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SaPPlan:
    """Analysis result: operator + permutations + preconditioner band.

    op      : (reordered) operator the Krylov matvec uses
    band_pc : (N, 2K+1) preconditioner band (post drop-off), on the device
    k       : preconditioner half bandwidth
    b_perm  : RHS permutation (None = identity), ``b_r = b[b_perm]``
    x_perm  : unknown un-permutation (None = identity), ``x = x_r[x_perm]``
    opts    : solver options the factorization will inherit
    info    : stage diagnostics (db/cm flags, k_after_reorder, ...)
    """

    op: LinearOperator
    band_pc: torch.Tensor
    k: int
    n: int
    b_perm: Optional[np.ndarray]
    x_perm: Optional[np.ndarray]
    opts: SaPOptions
    info: dict


def plan_banded(band, opts: Optional[SaPOptions] = None, device=None) -> SaPPlan:
    """Plan for a dense banded system in (N, 2K+1) band storage.

    ``band`` is a tensor, a numpy array or a :class:`BandedOperator`; it
    keeps its dtype and moves to ``device`` (default: the card).  No
    reordering: the band itself is the preconditioner matrix.
    """
    opts = opts or SaPOptions()
    dev = resolve_device(device)
    with span("plan", banded=True) as sp:
        if isinstance(band, BandedOperator):
            band = band.band
        band = _tensor(band).to(dev)
        op = BandedOperator.from_band(band)
        sp.annotate(n=op.n, k=op.k)
    return SaPPlan(
        op=op,
        band_pc=band,
        k=op.k,
        n=op.n,
        b_perm=None,
        x_perm=None,
        opts=opts,
        info={"variant": opts.variant, "p": opts.p},
    )


def plan(a, opts: Optional[SaPOptions] = None, device=None) -> SaPPlan:
    """Plan for a general operator / sparse matrix (paper Sec. 2.2 / 4.3).

    Runs DB + CM reordering and drop-off once (per ``opts``) on the host;
    the returned plan carries the permutations, the reordered operator and
    the preconditioner band, both on ``device`` (default: the card) in the
    default float dtype.  Banded operators skip the reordering front end.
    """
    opts = opts or SaPOptions()
    if isinstance(a, BandedOperator):
        return plan_banded(a, opts, device)
    dev = resolve_device(device)
    if isinstance(a, CsrOperator):
        a = a.to_csr()
    elif isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(a, np.ndarray):
        require_square_dense(a)
    with span("plan", use_db=opts.use_db, use_cm=opts.use_cm) as sp:
        rp = reorder_mod.analyze(a, use_db=opts.use_db, use_cm=opts.use_cm, drop_tol=opts.drop_tol)
        sp.annotate(n=rp.csr.n, k=rp.k)
    return SaPPlan(
        op=CsrOperator.from_csr(rp.csr, device=dev),
        band_pc=torch.tensor(rp.band_pc, dtype=torch.get_default_dtype(), device=dev),
        k=rp.k,
        n=rp.csr.n,
        b_perm=rp.b_perm,
        x_perm=rp.x_perm,
        opts=opts,
        info={**rp.info, "variant": opts.variant, "p": opts.p},
    )


# ---------------------------------------------------------------------------
# Stage 2: factor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class SaPFactorization:
    """Reusable SaP factorization handle.

    Holds the (reordered) operator, the factored preconditioner and the
    permutations; ``solve`` / ``solve_many`` pay only the Krylov
    iteration.  ``d_factor`` is the preconditioner band's degree of
    diagonal dominance (Eq. 2.11), echoed into every
    :class:`SaPSolveResult`.

    The stacked layout of a fleet (:mod:`repro_torch.core.batched`) is the
    same class with a leading system axis on every tensor -- the operator's
    band (S, N, 2K+1), the preconditioner's factors, ``d_factor`` (S,) and
    the permutations (S, N) -- and shared meta fields; :func:`_solve_impl`
    takes it with an (S, N, R) right-hand side.
    """

    op: LinearOperator
    pc: SaPPreconditioner
    n: int
    k: int
    tol: float
    maxiter: int
    iter_dtype: Optional[str]
    # resolved outer solver ("bicgstab2" | "cg" | "refine"); never "auto"
    solver: str = "bicgstab2"
    d_factor: Optional[torch.Tensor] = None
    b_perm: Optional[torch.Tensor] = None  # int64 (N,) on the device, or None
    x_perm: Optional[torch.Tensor] = None  # int64 (N,) on the device, or None

    @property
    def variant(self) -> str:
        """Variant actually factored ("auto" resolved): "C", "D", or "E"."""
        return self.pc.variant

    @property
    def p(self) -> int:
        return self.pc.p

    @property
    def n_pad(self) -> int:
        """Internal (padded) problem size P*M*K; >= the user's N."""
        return self.pc.p * self.pc.m * self.pc.k

    def _rhs(self, b, ndim: int) -> torch.Tensor:
        b = _tensor(b).to(self.pc.lu.sinv.device)
        if b.ndim != ndim:
            want = f"({self.n},)" if ndim == 1 else f"({self.n}, R)"
            raise ValueError(f"expected an RHS of shape {want}, got {tuple(b.shape)}")
        if b.shape[0] != self.n:
            raise ValueError(f"RHS length {b.shape[0]} != operator size {self.n}")
        return b

    def solve(self, b, record_history: bool = False) -> SaPSolveResult:
        """Solve A x = b for a single RHS of shape (N,)."""
        b = self._rhs(b, 1)
        with span("krylov", n=self.n, k=self.k, p=self.p, variant=self.variant, nrhs=1) as sp:
            launched = kops.launch_counts() if sp else None
            res = _solve_impl(self, b[:, None], record_history)
            res = sp.sync(SaPSolveResult(
                x=res.x[:, 0],
                iterations=res.iterations[0],
                resnorm=res.resnorm[0],
                converged=res.converged[0],
                true_resnorm=res.true_resnorm[0],
                d_factor=res.d_factor,
                history=None if res.history is None else res.history[0],
            ))
        if sp:
            _annotate_solve(sp, res, launched)
        return res

    def solve_many(self, b, record_history: bool = False) -> SaPSolveResult:
        """Solve A X = B for B of shape (N, R): one Krylov run per column."""
        b = self._rhs(b, 2)
        with span("krylov", n=self.n, k=self.k, p=self.p, variant=self.variant,
                  nrhs=int(b.shape[1])) as sp:
            launched = kops.launch_counts() if sp else None
            res = sp.sync(_solve_impl(self, b, record_history))
        if sp:
            _annotate_solve(sp, res, launched)
        return res


def resolve_solver(solver: str, use_cg: bool) -> str:
    """Resolve ``SaPOptions.solver`` to a concrete outer solver name:
    ``"auto"`` honours the legacy ``use_cg`` flag, an explicit name wins."""
    if solver == "auto":
        return "cg" if use_cg else "bicgstab2"
    if solver not in ("bicgstab2", "cg", "refine"):
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def resolve_variant(variant: str, d_factor: float) -> str:
    """The ``"auto"`` policy: truncated SPIKE needs spike decay, which the
    paper ties to diagonal dominance (Sec. 2.1.1) -- C for d >= 1, else E."""
    if variant != "auto":
        return variant
    return "C" if d_factor >= 1.0 else "E"


def factor(pl: SaPPlan) -> SaPFactorization:
    """Factor the SaP preconditioner from a plan (T_LU .. T_SPIKE).

    The ``factor`` span waits for the card at its close; its sub-spans
    are timed on the card by CUDA-event pairs and wait for nothing."""
    opts = pl.opts
    with span("factor", n=pl.n, k=pl.k, p=opts.p) as sp:
        launched = kops.launch_counts() if sp else None
        d_factor = diag_dominance_factor(pl.band_pc)
        count("host_syncs")
        d_host = float(d_factor)
        variant = resolve_variant(opts.variant, d_host)
        sp.annotate(variant=variant, d_factor=d_host)
        with device_span("factor.split", pl.band_pc.device):
            bt = band_to_block_tridiag(pl.band_pc, max(pl.k, 1), opts.p)
        pc = build_preconditioner(
            bt,
            variant=variant,
            boost_eps=opts.boost_eps,
            precond_dtype=_dtype(opts.precond_dtype),
            reduced_solver=opts.reduced_solver,
            fused=opts.fused_factor,
        )
        sp.sync(pc)
        if sp:
            sp.annotate(launches=_launches_since(launched))
    dev = pl.band_pc.device

    def to_idx(perm):
        return None if perm is None else torch.as_tensor(perm, dtype=torch.int64).to(dev)

    return SaPFactorization(
        op=pl.op,
        pc=pc,
        n=pl.n,
        k=pl.k,
        tol=opts.tol,
        maxiter=opts.maxiter,
        iter_dtype=opts.iter_dtype,
        solver=resolve_solver(opts.solver, opts.use_cg),
        d_factor=d_factor,
        b_perm=to_idx(pl.b_perm),
        x_perm=to_idx(pl.x_perm),
    )


# ---------------------------------------------------------------------------
# Stage 3: solve
# ---------------------------------------------------------------------------


def _solve_impl(
    fac: SaPFactorization, bmat: torch.Tensor, record_history: bool = False
) -> SaPSolveResult:
    """Solve body on an (N, R) block: permute, pad, Krylov, unpad,
    un-permute.

    A stacked factorization of S systems takes an (S, N, R) block and runs
    ONE Krylov iteration over its S * R columns: the matvec applies system
    s's band to system s's columns, the preconditioner folds the systems
    into its kernels' chain axis, and the loop syncs with the host once a
    sweep for the whole batch.  Every column keeps its own scalars and
    freezes on its own exit -- the semantics of the JAX package's vmapped
    solve -- so the per-system results (S, R) are what S separate solves
    report.

    Inside the caller's ``krylov`` span each preconditioner apply (with
    its pad and unpad) is a ``krylov.precond`` span and each band matvec a
    ``krylov.matvec`` span; the call counts one of ``solves``."""
    count("solves")
    b = bmat.to(_resolve_iter_dtype(bmat.dtype, fac.iter_dtype))
    n, n_pad = fac.n, fac.n_pad
    if b.ndim == 2:
        s, r = None, b.shape[1]
        if fac.b_perm is not None:
            b = b[fac.b_perm]

        def cols(v):
            return v

        def systems(v):
            return v
    else:
        s, r = b.shape[0], b.shape[2]
        if fac.b_perm is not None:
            b = torch.gather(b, 1, fac.b_perm[:, :, None].expand(-1, -1, r))

        def cols(v):  # (S, N, R) -> (N, S * R)
            return v.transpose(0, 1).reshape(v.shape[1], s * r)

        def systems(v):  # (N, S * R) -> (S, N, R)
            return v.reshape(v.shape[0], s, r).transpose(0, 1)

    def precond(v):
        with span("krylov.precond"):
            z = systems(v)
            if n_pad != n:
                z = torch.cat([z, z.new_zeros(z.shape[:-2] + (n_pad - n, r))], dim=-2)
            return cols(fac.pc.apply(z)[..., :n, :])

    def matvec(v):
        with span("krylov.matvec"):
            return cols(fac.op.matvec(systems(v)))

    if fac.solver == "refine":
        block = _refine_block
    elif fac.solver == "cg":
        block = _cg_block
    else:
        block = _bicgstab2_block
    res: KrylovResult = block(matvec, cols(b), precond, None, fac.tol, fac.maxiter, record_history)
    x = systems(res.x)
    if fac.x_perm is not None and s is None:
        x = x[fac.x_perm]
    elif fac.x_perm is not None:
        x = torch.gather(x, 1, fac.x_perm[:, :, None].expand(-1, -1, r))

    def per_system(t):  # (S * R, ...) -> (S, R, ...)
        return t if t is None or s is None else t.reshape((s, r) + tuple(t.shape[1:]))

    # true_resnorm is computed in the solver frame (permuted, unpadded:
    # identity-padding rows never enter the Krylov vectors); permutations
    # preserve norms, so it equals the original frame's ||b - A x|| / ||b||
    return SaPSolveResult(
        x=x,
        iterations=per_system(res.iterations),
        resnorm=per_system(res.resnorm),
        converged=per_system(res.converged),
        true_resnorm=per_system(res.true_resnorm),
        d_factor=fac.d_factor,
        history=per_system(res.history),
    )


def _launches_since(before: dict) -> dict:
    """Kernel launches by wrapper since ``before`` (a ``launch_counts()``
    snapshot), the wrappers that launched."""
    return {name: n - before[name] for name, n in kops.launch_counts().items()
            if n != before[name]}


def _annotate_solve(sp, res: SaPSolveResult, launched: dict) -> None:
    """A ``krylov`` span's attributes: the kernel launches since
    ``launched``, and the convergence digest deferred to the span's first
    read (the traced solve makes no host read for it).  The digest holds
    the per-column scalars, never x."""
    its, conv, rnorm, hist = res.iterations, res.converged, res.resnorm, res.history
    sp.annotate(launches=_launches_since(launched))
    sp.defer("convergence", lambda: _convergence_summary(its, conv, rnorm, hist))


def _convergence_summary(iterations: torch.Tensor, converged: torch.Tensor,
                         resnorm: torch.Tensor, history: Optional[torch.Tensor]) -> dict:
    """Host-side convergence digest for the ``krylov`` span attribute."""
    out = {
        "iterations": float(iterations.max()),
        "converged": bool(converged.all()),
        "resnorm": float(resnorm.max()),
    }
    if history is not None:
        hist = history.cpu().numpy()
        hist = hist.reshape(-1, hist.shape[-1])
        firsts, lasts, recorded, stalled = [], [], 0, False
        for row in hist:
            rec = row[~np.isnan(row)]
            recorded = max(recorded, rec.size)
            if rec.size == 0:
                continue
            firsts.append(float(rec[0]))
            lasts.append(float(rec[-1]))
            # Stall heuristic: <10% progress over the last 5 recorded sweeps.
            if rec.size >= 5 and rec[-1] > 0.9 * rec[-5]:
                stalled = True
        out["recorded"] = recorded
        if firsts:
            out["first_resnorm"] = max(firsts)
            out["last_resnorm"] = max(lasts)
        out["stalled"] = bool(stalled and not out["converged"])
    return out


# ---------------------------------------------------------------------------
# Legacy one-shot wrappers (deprecated for repeated solves)
# ---------------------------------------------------------------------------


def solve_banded(band, b, opts: Optional[SaPOptions] = None, device=None) -> SaPSolution:
    """One-shot solve of a dense banded system in (N, 2K+1) band storage.

    Deprecated for repeated solves: this re-plans and re-factors on every
    call.  Use ``factor(plan_banded(band, opts))`` and reuse the handle.
    """
    warnings.warn(
        "solve_banded re-runs the whole plan/factor pipeline on every call and "
        "is deprecated; use factor(plan_banded(band, opts)).solve(b) and reuse "
        "the handle across right-hand sides",
        DeprecationWarning,
        stacklevel=2,
    )
    pl = plan_banded(band, opts, device)
    fac = factor(pl)
    res = fac.solve(b)
    return SaPSolution(
        x=res.x,
        iterations=float(res.iterations),
        resnorm=float(res.resnorm),
        converged=bool(res.converged),
        true_resnorm=float(res.true_resnorm),
        k=fac.k,
        info={
            "variant": fac.variant,
            "variant_requested": pl.opts.variant,
            "reduced_solver": fac.pc.reduced_solver,
            "d_factor": float(fac.d_factor),
            "p": pl.opts.p,
        },
    )


def solve_sparse(a, b, opts: Optional[SaPOptions] = None, device=None) -> SaPSolution:
    """One-shot solve of a sparse system via the reorder + banded pipeline.

    Deprecated for repeated solves: this re-runs DB/CM reordering and the
    block-LU factorization on every call.  Use ``factor(plan(a, opts))``
    and reuse the handle across right-hand sides.
    """
    warnings.warn(
        "solve_sparse re-runs the whole plan/factor pipeline on every call and "
        "is deprecated; use factor(plan(a, opts)).solve(b) and reuse the handle "
        "across right-hand sides",
        DeprecationWarning,
        stacklevel=2,
    )
    pl = plan(a, opts, device)
    fac = factor(pl)
    res = fac.solve(b)
    return SaPSolution(
        x=res.x,
        iterations=float(res.iterations),
        resnorm=float(res.resnorm),
        converged=bool(res.converged),
        true_resnorm=float(res.true_resnorm),
        k=fac.k,
        info={
            **pl.info,
            "variant": fac.variant,
            "variant_requested": pl.opts.variant,
            "reduced_solver": fac.pc.reduced_solver,
            "d_factor": float(fac.d_factor),
            "p": pl.opts.p,
        },
    )
