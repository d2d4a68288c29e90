"""Krylov-subspace solvers: BiCGStab(2), CG and iterative refinement.

Paper Sec. 2.1.1: the SaP preconditioner is wrapped in BiCGStab(l)
[Sleijpen & Fokkema 1993] with l = 2, or CG when the matrix is symmetric
positive definite.  BiCGStab iterations are counted in *quarters* (the
algorithm has intermediate exit points), as in the paper's Tables 4.1/4.2.

Mixed precision (paper Sec. 3.1): the preconditioner apply runs in its own
(lower) storage dtype; the outer iteration runs in the dtype of ``b``.

Every solver runs on a block of R right-hand-side columns with per-column
scalars of shape (R,): the ``_many`` forms take ``b`` of shape (N, R) and
hand ``matvec`` / ``precond`` the whole (N, R) block, and a column that has
converged (or run out of sweeps) keeps its state while the others iterate
-- the semantics of the JAX package's vmapped ``while_loop``.  The
single-RHS forms are the R = 1 case with ``matvec`` / ``precond`` called on
(N,) vectors.  The loop checks once per sweep, on the host, whether any
column is still active.

Inside the ``krylov`` span the loop opens host-only sub-spans:
``krylov.start`` (the initial residual and ``||b||``), ``krylov.sweep``
(one sweep), ``krylov.check`` (the selects after a sweep and the host
read of whether any column is active) and ``krylov.finish`` (the exit
norms and the true residual); each host read adds to the ``host_syncs``
counter of :mod:`repro_torch.obs.trace`.

BiCGStab(2)'s block solver takes an optional ``allreduce``: with it, each process
holds its own rows of the vectors (:mod:`repro_torch.core.distributed`),
and every dot product and norm is summed over the processes before use.
Without it the arithmetic is exactly the single-process one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from ..obs.trace import count, span
from .operators import LinearOperator, as_matvec

MatVec = Union[Callable[[torch.Tensor], torch.Tensor], LinearOperator]


class KrylovResult(NamedTuple):
    """Solver exit state.

    ``converged``/``resnorm`` report the *preconditioned* residual the
    iteration actually controls; ``true_resnorm`` is the unpreconditioned
    ``||b - A x|| / ||b||``, recomputed from scratch at exit (one extra
    matvec) -- the quantity callers should trust.  With ``record_history``
    ``history`` holds the preconditioned relative residual after each outer
    sweep, NaN-padded past the exit sweep: (maxiter,), or (R, maxiter) for
    the ``_many`` forms.
    """

    x: torch.Tensor
    iterations: torch.Tensor  # fractional iterations (quarters for BiCGStab)
    resnorm: torch.Tensor  # preconditioned residual norm at exit
    converged: torch.Tensor
    true_resnorm: Optional[torch.Tensor] = None  # ||b - A x|| / ||b||
    history: Optional[torch.Tensor] = None


def _identity(x):
    return x


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=0)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=0)


def _reducers(allreduce):
    """(dot, norm) over the rows this process holds, or, with
    ``allreduce``, over every process's rows: the partial sums are summed
    across processes, so each process gets the same scalars."""
    if allreduce is None:
        return _dot, _norm

    def dot(a, b):
        return allreduce(_dot(a, b))

    def norm(a):
        return allreduce(_dot(a, a)).sqrt()

    return dot, norm


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.ones_like(x))


def _true_resnorm(matvec, b: torch.Tensor, x: torch.Tensor, norm=_norm) -> torch.Tensor:
    """Unpreconditioned relative residual, recomputed (not the recurrence)."""
    return norm(b - matvec(x).to(b.dtype)) / _nonzero(norm(b))


def _iterate(state: dict, step, maxiter: int, record_history: bool, bnorm: torch.Tensor,
             norm=_norm):
    """Run ``step`` until every column is done or has used ``maxiter``
    sweeps.  ``state`` maps names to (N, R) blocks or (R,) per-column
    scalars and holds ``it`` and ``done``; inactive columns keep their state.

    Across processes (an ``allreduce`` in the solver) every process takes
    the same branch at the host check: ``done`` and ``it`` come from
    reduced scalars, which the collective gives every process alike.
    """
    hist = None
    if record_history:
        hist = torch.full(
            (bnorm.shape[0], maxiter), float("nan"), dtype=bnorm.dtype, device=bnorm.device
        )
    sweep = 0  # every active column has run exactly `sweep` whole sweeps
    new = None
    while True:
        with span("krylov.check"):
            if new is not None:
                state = {
                    name: torch.where(active if old.ndim == 1 else active[None, :], new[name], old)
                    for name, old in state.items()
                }
                if hist is not None:
                    hist[:, sweep] = torch.where(active, norm(state["r"]) / bnorm, hist[:, sweep])
                sweep += 1
            active = (~state["done"]) & (state["it"] < maxiter)
            count("host_syncs")
            go = bool(active.any())
        if not go:
            return state, hist
        with span("krylov.sweep"):
            new = step(state)


def _select(c: torch.Tensor, a: dict, b: dict) -> dict:
    return {
        name: torch.where(c if v.ndim == 1 else c[None, :], v, b[name]) for name, v in a.items()
    }


# ---------------------------------------------------------------------------
# BiCGStab(2)  (Sleijpen & Fokkema), left preconditioning: M^-1 A x = M^-1 b
# ---------------------------------------------------------------------------


def _bicgstab2_block(mv, b, pc, x0, tol, maxiter, record_history, allreduce=None) -> KrylovResult:
    """BiCGStab(2) on an (N, R) block; one outer "iteration" = two
    matvec+precond in the BiCG part plus two in the MR part, counted as 4
    quarter-exits to mirror the paper's tables."""
    dtype = b.dtype
    nr = b.shape[1]
    dot, norm = _reducers(allreduce)

    def op(v):
        return pc(mv(v)).to(dtype)

    with span("krylov.start"):
        x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
        r0 = pc(b - mv(x)).to(dtype)
        bnorm = _nonzero(norm(pc(b).to(dtype)))
        done = norm(r0) <= tol * bnorm
    rtilde = r0
    eps = 1e-300 if dtype == torch.float64 else 1e-30
    ratio_eps = (50 * torch.finfo(dtype).eps) ** 2
    zero = torch.zeros((), dtype=dtype, device=b.device)

    def step(s):
        """One BiCGStab(2) sweep (Sleijpen & Fokkema Alg. 3.1, l = 2).

        If an intermediate exit triggers, the snapshot at that point is
        kept -- continuing with a (near-)zero residual would divide by
        degenerate inner products.
        """
        x, r0, u0, it = s["x"], s["r"], s["u"], s["it"]
        rho0 = -s["omega"] * s["rho"]
        alpha = s["alpha"]

        # ---- BiCG part, j = 0 -------------------------------------------
        rho1 = dot(r0, rtilde)
        beta = torch.where(rho0.abs() > eps, alpha * rho1 / rho0, zero)
        rho0 = rho1
        u0 = r0 - beta * u0
        u1 = op(u0)
        gamma = dot(u1, rtilde)
        alpha = torch.where(gamma.abs() > eps, rho0 / gamma, zero)
        r0 = r0 - alpha * u1
        r1 = op(r0)
        x = x + alpha * u0
        q1 = norm(r0) <= tol * bnorm  # quarter-exit 1
        snap1 = dict(x=x, r=r0, u=u0, rho=rho0, omega=s["omega"], alpha=alpha,
                     it=it + 0.25, done=q1)

        # ---- BiCG part, j = 1 -------------------------------------------
        rho1 = dot(r1, rtilde)
        beta = torch.where(rho0.abs() > eps, alpha * rho1 / rho0, zero)
        rho0 = rho1
        u0 = r0 - beta * u0
        u1 = r1 - beta * u1
        u2 = op(u1)
        gamma = dot(u2, rtilde)
        alpha = torch.where(gamma.abs() > eps, rho0 / gamma, zero)
        r0 = r0 - alpha * u1
        r1 = r1 - alpha * u2
        r2 = op(r1)
        x = x + alpha * u0
        q2 = norm(r0) <= tol * bnorm  # quarter-exit 2
        snap2 = dict(x=x, r=r0, u=u0, rho=rho0, omega=s["omega"], alpha=alpha,
                     it=it + 0.5, done=q2)

        # ---- MR part (modified Gram-Schmidt on r1, r2) -------------------
        # Degeneracy guard: when the preconditioner is (near-)exact,
        # r2 - tau12 r1 is rounding noise; using it poisons x while the
        # recurrence residual stays small.  Detect via the relative norm of
        # the orthogonalized direction and fall back to the l=1 step.
        sigma1 = dot(r1, r1).clamp_min(eps)
        gp1 = dot(r0, r1) / sigma1
        tau12 = dot(r2, r1) / sigma1
        r2o = r2 - tau12 * r1
        sigma2 = dot(r2o, r2o)
        degenerate = sigma2 <= ratio_eps * sigma1
        gp2 = torch.where(degenerate, zero, dot(r0, r2o) / sigma2.clamp_min(eps))
        g2 = gp2
        omega_new = torch.where(degenerate, gp1, g2)
        g1 = gp1 - tau12 * g2
        gpp1 = g2  # gamma''_1 = gamma_2 (l = 2)

        x = x + g1 * r0 + gpp1 * r1
        r0 = r0 - gp1 * r1 - gp2 * r2o
        u0 = u0 - g1 * u1 - g2 * u2
        q4 = norm(r0) <= tol * bnorm
        full = dict(x=x, r=r0, u=u0, rho=rho0, omega=omega_new, alpha=alpha,
                    it=it + 1.0, done=q4)
        return _select(q1, snap1, _select(q2, snap2, full))

    ones = torch.ones((nr,), dtype=dtype, device=b.device)
    state = dict(
        x=x, r=r0, u=torch.zeros_like(b), rho=ones, omega=ones.clone(),
        alpha=torch.zeros_like(ones), it=torch.zeros_like(ones), done=done,
    )
    state, hist = _iterate(state, step, maxiter, record_history, bnorm, norm)
    with span("krylov.finish"):
        return KrylovResult(
            x=state["x"],
            iterations=state["it"],
            resnorm=norm(state["r"]) / bnorm,
            converged=state["done"],
            true_resnorm=_true_resnorm(mv, b, state["x"], norm),
            history=hist,
        )


# ---------------------------------------------------------------------------
# Preconditioned CG (paper: used when A is SPD)
# ---------------------------------------------------------------------------


def _cg_block(mv, b, pc, x0, tol, maxiter, record_history) -> KrylovResult:
    dtype = b.dtype
    with span("krylov.start"):
        x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
        r = b - mv(x)
        z = pc(r).to(dtype)
        bnorm = _nonzero(_norm(b))
    zero = torch.zeros((), dtype=dtype, device=b.device)

    def step(s):
        x, r, p, rz = s["x"], s["r"], s["p"], s["rz"]
        ap = mv(p)
        denom = _dot(p, ap)
        alpha = torch.where(denom.abs() > 0, rz / denom, zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = pc(r).to(dtype)
        rz_new = _dot(r, z)
        beta = torch.where(rz.abs() > 0, rz_new / rz, zero)
        p = z + beta * p
        done = _norm(r) <= tol * bnorm
        return dict(x=x, r=r, z=z, p=p, rz=rz_new, it=s["it"] + 1.0, done=done)

    state = dict(
        x=x, r=r, z=z, p=z, rz=_dot(r, z),
        it=torch.zeros((b.shape[1],), dtype=dtype, device=b.device),
        done=_norm(r) <= tol * bnorm,
    )
    state, hist = _iterate(state, step, maxiter, record_history, bnorm)
    with span("krylov.finish"):
        return KrylovResult(
            x=state["x"],
            iterations=state["it"],
            resnorm=_norm(state["r"]) / bnorm,
            converged=state["done"],
            true_resnorm=_true_resnorm(mv, b, state["x"]),
            history=hist,
        )


# ---------------------------------------------------------------------------
# Iterative refinement (mixed precision: low-dtype factor, high-dtype loop)
# ---------------------------------------------------------------------------


def _refine_block(mv, b, pc, x0, tol, maxiter, record_history) -> KrylovResult:
    """Preconditioned iterative refinement (Richardson iteration):
    ``x_{k+1} = x_k + M^-1 (b - A x_k)``, the correction computed in the
    preconditioner's dtype and applied in the dtype of ``b``.  The
    controlled residual IS the true residual."""
    dtype = b.dtype
    with span("krylov.start"):
        x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
        r = b - mv(x).to(dtype)
        bnorm = _nonzero(_norm(b))

    def step(s):
        x = s["x"] + pc(s["r"]).to(dtype)
        r = b - mv(x).to(dtype)
        return dict(x=x, r=r, it=s["it"] + 1.0, done=_norm(r) <= tol * bnorm)

    state = dict(
        x=x, r=r, it=torch.zeros((b.shape[1],), dtype=dtype, device=b.device),
        done=_norm(r) <= tol * bnorm,
    )
    state, hist = _iterate(state, step, maxiter, record_history, bnorm)
    with span("krylov.finish"):
        return KrylovResult(
            x=state["x"],
            iterations=state["it"],
            resnorm=_norm(state["r"]) / bnorm,
            converged=state["done"],
            true_resnorm=_true_resnorm(mv, b, state["x"]),
            history=hist,
        )


# ---------------------------------------------------------------------------
# Public single- and multi-RHS entry points
# ---------------------------------------------------------------------------


def _single(block, default_maxiter):
    def solve(
        matvec: MatVec,
        b: torch.Tensor,
        precond: MatVec = _identity,
        x0: torch.Tensor | None = None,
        tol: float = 1e-10,
        maxiter: int = default_maxiter,
        record_history: bool = False,
    ) -> KrylovResult:
        mv, pc = as_matvec(matvec), as_matvec(precond)
        res = block(
            lambda v: mv(v[:, 0])[:, None],
            b[:, None],
            lambda v: pc(v[:, 0])[:, None],
            None if x0 is None else x0[:, None],
            tol,
            maxiter,
            record_history,
        )
        return KrylovResult(
            x=res.x[:, 0],
            iterations=res.iterations[0],
            resnorm=res.resnorm[0],
            converged=res.converged[0],
            true_resnorm=res.true_resnorm[0],
            history=None if res.history is None else res.history[0],
        )

    return solve


def _many(block, default_maxiter):
    def solve_many(
        matvec: MatVec,
        b: torch.Tensor,
        precond: MatVec = _identity,
        x0: torch.Tensor | None = None,
        tol: float = 1e-10,
        maxiter: int = default_maxiter,
        record_history: bool = False,
    ) -> KrylovResult:
        """Solve A X = B for B of shape (N, R): one Krylov run per column.

        ``matvec`` and ``precond`` take the whole (N, R) block.  Returns x
        (N, R) and per-column iterations / resnorm / converged of shape
        (R,); ``history`` is (R, maxiter).
        """
        return block(as_matvec(matvec), b, as_matvec(precond), x0, tol, maxiter, record_history)

    return solve_many


bicgstab2 = _single(_bicgstab2_block, 500)
cg = _single(_cg_block, 1000)
refine = _single(_refine_block, 500)
bicgstab2_many = _many(_bicgstab2_block, 500)
cg_many = _many(_cg_block, 1000)
refine_many = _many(_refine_block, 500)
