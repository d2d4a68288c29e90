"""Block cyclic reduction (BCR) for block-tridiagonal chains.

The SaP-E exact coupling (:mod:`repro_torch.core.spike`, paper Sec. 2.1.1)
ends in a (P-1)-interface block-tridiagonal *chain* of (2K x 2K) blocks.
The ``btf_chain`` / ``bts_chain`` factorization sweeps that chain
sequentially: O(M) dependent steps.  Cyclic reduction replaces the sweep
with even/odd elimination:

  level 0:   eliminate the odd-indexed unknowns from the even equations
             (every elimination is independent), leaving a
             block-tridiagonal chain of half the length;
  level l:   recurse on the survivors;
  root:      a single block remains -- invert it;
  back-substitution mirrors the levels in reverse, recovering the odd
             unknowns from their (already solved) even neighbours.

Eliminating odd unknown x_j (j odd) via its own equation

    x_j = inv(D_j) (b_j - E_j x_{j-1} - F_j x_{j+1})

and substituting into the even equations j = 2i gives the level-(l+1)
chain over the even unknowns:

    lo_i  = E_{2i} inv(D_{2i-1})          hi_i = F_{2i} inv(D_{2i+1})
    D'_i  = D_{2i} - lo_i F_{2i-1} - hi_i E_{2i+1}
    E'_i  = -lo_i E_{2i-1}                F'_i = -hi_i F_{2i+1}
    b'_i  = b_{2i} - lo_i b_{2i-1} - hi_i b_{2i+1}

Chains are padded to a power of two with decoupled identity blocks
(D = I, E = F = 0, b = 0), so non-power-of-two lengths work unchanged.

The functions here are the plain PyTorch versions, split the way the four
CUDA kernels of :mod:`repro_torch.kernels.bcr` split the work
(:func:`bcr_inv_odd_ref`, :func:`bcr_reduce_ref`,
:func:`bcr_rhs_reduce_ref`, :func:`bcr_backsub_ref`), and the whole
:func:`bcr_factor` / :func:`bcr_solve` built from them.  The kernel path
is :func:`repro_torch.kernels.ops.bcr_factor` / ``bcr_solve``.

:func:`pcr_factor` / :func:`pcr_solve` are the all-active *parallel*
cyclic reduction (PCR) form, in which every equation eliminates both
neighbours at distance s = 2^l each level and no unknown goes idle.  PCR
does O(M log M) work, but each level touches only neighbours at a fixed
stride, which maps onto neighbour-exchange rounds between ranks:
:mod:`repro_torch.core.distributed` uses it for the SaP-E reduced sweep
across ranks (the chain never gathers onto one rank).  The shift
primitive is injected, so the same code runs on one device (tensor
shifts) and across ranks (permutations over a process group).  Each
level's block inverses go through the port's boosted Gauss-Jordan
inverse kernel (``kernels/bcr.py:inv_odd``) for tensors on the card; the
products stay ``torch.matmul``, as the JAX package computes them outside
any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .block_lu import DEFAULT_BOOST, compute_dtype, gj_inverse


def _next_pow2(m: int) -> int:
    return 1 if m <= 1 else 1 << (m - 1).bit_length()


def _shift_dn(x: torch.Tensor, s: int = 1) -> torch.Tensor:
    """x[i] <- x[i-s] along axis 0; the first s rows get zeros."""
    return torch.cat([torch.zeros_like(x[:s]), x[:-s]], dim=0)


def _shift_up(x: torch.Tensor, s: int = 1) -> torch.Tensor:
    """x[i] <- x[i+s] along axis 0; the last s rows get zeros."""
    return torch.cat([x[s:], torch.zeros_like(x[:s])], dim=0)


def pad_chain(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero the unused end blocks and pad with identity blocks to 2^L.

    The padding blocks are decoupled (D = I, E = F = 0): they carry the
    zero solution and never touch the real chain.  ``e`` and ``f`` are
    cloned before ``e[0]`` / ``f[m-1]`` are zeroed: the caller's tensors
    are never written.
    """
    m, k, _ = d.shape
    e = e.clone()
    f = f.clone()
    e[0] = 0.0
    f[m - 1] = 0.0
    m_pad = _next_pow2(m)
    if m_pad == m:
        return d, e, f
    extra = m_pad - m
    eye = torch.eye(k, dtype=d.dtype, device=d.device).expand(extra, k, k)
    zero = d.new_zeros((extra, k, k))
    return torch.cat([d, eye]), torch.cat([e, zero]), torch.cat([f, zero])


class BCRLevel(NamedTuple):
    """One elimination level; all tensors are (m_l / 2, K, K).

    lo/hi multiply the odd RHS neighbours in the forward reduction;
    a_odd (= inv(D_odd)), e_odd, f_odd drive the back-substitution.
    """

    lo: torch.Tensor
    hi: torch.Tensor
    a_odd: torch.Tensor
    e_odd: torch.Tensor
    f_odd: torch.Tensor


@dataclasses.dataclass
class BCRFactors:
    """Log-depth factorization of one block-tridiagonal chain.

    levels[l] holds the level-l elimination blocks (chain length
    2^(L-l)); root_inv is the inverse of the final surviving (K, K) block;
    ``m`` is the true (un-padded) chain length.
    """

    levels: tuple[BCRLevel, ...]
    root_inv: torch.Tensor
    m: int

    @property
    def n_levels(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Plain versions of the four kernels
# ---------------------------------------------------------------------------


def _widen(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands in the dtype the plain versions compute in: the wider
    of float32 and the first operand's storage."""
    cdt = compute_dtype(ts[0].dtype)
    return tuple(t.to(cdt) for t in ts)


def bcr_inv_odd_ref(
    d: torch.Tensor, boost_eps: float = DEFAULT_BOOST, first: int = 1
) -> torch.Tensor:
    """Boosted Gauss-Jordan inverses of d[first::2]: the odd diagonal
    blocks of a level (``first=1``) or the root block (``first=0`` on a
    one-block chain)."""
    return gj_inverse(d[first::2], boost_eps).contiguous()


def bcr_reduce_ref(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, a_odd: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Eliminate the odd rows of an (m, K, K) chain, m even.

    Returns ``(lo, hi, d', e', f')``, each (m/2, K, K).  E_0 = 0 kills the
    i = 0 down-neighbour terms, which the shift fills with zeros.
    Computed in :func:`~repro_torch.core.block_lu.compute_dtype` of the
    storage, stored in it.
    """
    dt = d.dtype
    d, e, f, a_odd = _widen(d, e, f, a_odd)
    e_odd, f_odd = e[1::2], f[1::2]
    lo = e[0::2] @ _shift_dn(a_odd)  # E_{2i} inv(D_{2i-1})
    hi = f[0::2] @ a_odd  # F_{2i} inv(D_{2i+1})
    d_next = d[0::2] - lo @ _shift_dn(f_odd) - hi @ e_odd
    e_next = -(lo @ _shift_dn(e_odd))
    f_next = -(hi @ f_odd)
    return tuple(t.to(dt) for t in (lo, hi, d_next, e_next, f_next))


def bcr_reduce_level_ref(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> tuple[BCRLevel, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One even/odd elimination level: (m, K, K) chain, m even ->
    (BCRLevel, (d', e', f')) of length m/2."""
    a_odd = bcr_inv_odd_ref(d, boost_eps)
    lo, hi, d_next, e_next, f_next = bcr_reduce_ref(d, e, f, a_odd)
    level = BCRLevel(lo=lo, hi=hi, a_odd=a_odd, e_odd=e[1::2], f_odd=f[1::2])
    return level, (d_next, e_next, f_next)


def bcr_rhs_reduce_ref(lo: torch.Tensor, hi: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fold the odd right-hand sides of an (m, K, R) level into its even
    equations: b'_i = b_{2i} - lo_i b_{2i-1} - hi_i b_{2i+1}."""
    dt = b.dtype
    lo, hi, b = _widen(lo, hi, b)
    b_odd = b[1::2]
    return (b[0::2] - lo @ _shift_dn(b_odd) - hi @ b_odd).to(dt)


def bcr_backsub_ref(
    a_odd: torch.Tensor,
    e_odd: torch.Tensor,
    f_odd: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """Recover the odd unknowns of a level and interleave them.

    ``b`` is the level's (m, K, R) right-hand side, ``x`` the (m/2, K, R)
    solved even unknowns; returns the level's (m, K, R) solution.  F_odd
    of the chain tail is zero, killing the shifted-in zero neighbour.
    """
    dt = x.dtype
    a_odd, e_odd, f_odd, b, x = _widen(a_odd, e_odd, f_odd, b, x)
    x_odd = a_odd @ (b[1::2] - e_odd @ x - f_odd @ _shift_up(x))
    m2, k, r = x.shape
    return torch.stack([x, x_odd], dim=1).reshape(2 * m2, k, r).to(dt)


# ---------------------------------------------------------------------------
# Whole factor / solve (plain)
# ---------------------------------------------------------------------------


def bcr_factor(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BCRFactors:
    """Factor a block-tridiagonal chain (M, K, K) in log2(M) levels.

    Drop-in alternative to :func:`repro_torch.core.block_lu.btf_chain`
    (pair with :func:`bcr_solve`); ``e[0]`` / ``f[M-1]`` are ignored.
    """
    m = d.shape[0]
    d, e, f = pad_chain(d, e, f)
    levels = []
    while d.shape[0] > 1:
        level, (d, e, f) = bcr_reduce_level_ref(d, e, f, boost_eps)
        levels.append(level)
    root_inv = bcr_inv_odd_ref(d, boost_eps, first=0)[0]
    return BCRFactors(levels=tuple(levels), root_inv=root_inv, m=m)


def pad_rhs(b: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Zero-pad an (M, K, R) right-hand side to the factored 2^L blocks."""
    m, k, r = b.shape
    m_pad = 1 << n_levels
    if m_pad == m:
        return b
    return torch.cat([b, b.new_zeros((m_pad - m, k, r))])


def bcr_solve(factors: BCRFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one factored chain: b (M, K, R) -> x (M, K, R).

    Forward: log2(M) RHS reductions; root: one (K, K) apply; backward:
    log2(M) interleaving back-substitutions.
    """
    b = pad_rhs(b, factors.n_levels)
    rhs = []
    for lv in factors.levels:
        rhs.append(b)
        b = bcr_rhs_reduce_ref(lv.lo, lv.hi, b)
    x = (factors.root_inv @ b[0])[None]
    for lv, bl in zip(reversed(factors.levels), reversed(rhs)):
        x = bcr_backsub_ref(lv.a_odd, lv.e_odd, lv.f_odd, bl, x)
    return x[: factors.m]


# ---------------------------------------------------------------------------
# All-active parallel cyclic reduction (the sweep across ranks)
# ---------------------------------------------------------------------------


def _vinv(a: torch.Tensor, boost_eps: float) -> torch.Tensor:
    """Boosted Gauss-Jordan inverses of (rows, K, K) blocks in one
    ``inv_odd`` call: the blocks sit at the odd places of a chain that
    interleaves them with identity blocks (the kernel inverts every other
    block), as ``kernels/ops.py:bcr_factor`` inverts its roots.  The
    wrapper launches the kernel for a tensor on the card and runs
    :func:`gj_inverse` otherwise."""
    from ..kernels import bcr

    rows, k = a.shape[0], a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device).expand(rows, k, k)
    return bcr.inv_odd(torch.stack([eye, a], dim=1).reshape(2 * rows, k, k), boost_eps)


def pcr_n_levels(m: int) -> int:
    """Levels needed to decouple a chain of length m: smallest L with
    2^L >= m (after which every coupling block has been driven to zero)."""
    return max(m - 1, 0).bit_length()


@dataclasses.dataclass
class PCRFactors:
    """All-active PCR factorization of a chain, or of this rank's rows of it.

    alphas/betas: (rows, L, K, K) per-level neighbour-elimination blocks
    (row-major, so the leading axis splits over ranks like every other
    partition tensor); dinv: (rows, K, K) inverses of the fully decoupled
    diagonal.
    """

    alphas: torch.Tensor
    betas: torch.Tensor
    dinv: torch.Tensor

    @property
    def n_levels(self) -> int:
        return self.alphas.shape[1]


def pcr_factor(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    n_levels: int,
    shift_dn=None,
    shift_up=None,
    boost_eps: float = DEFAULT_BOOST,
) -> PCRFactors:
    """PCR matrix reduction: every equation eliminates both neighbours at
    stride s = 2^l per level; after ``n_levels`` levels the chain is block
    diagonal.

    ``shift_dn(x, s)`` / ``shift_up(x, s)`` fetch the row s positions away
    (zero fill past the ends).  The defaults shift a local tensor;
    :mod:`repro_torch.core.distributed` injects shifts across ranks, making
    each level one neighbour-exchange round -- O(log2 P) rounds in all.
    The three blocks a level takes from below (the inverse, F and E) travel
    as one stacked shift, and the three from above as another.

    Rows past the chain end must be decoupled identity padding (see
    :func:`pad_chain`).  Each level inverts the diagonal once and shifts
    the *inverse* both ways; couplings to out-of-range rows are exactly
    zero by induction, so the zero-filled shifted inverse is benign.
    """
    if shift_dn is None:
        shift_dn = _shift_dn
    if shift_up is None:
        shift_up = _shift_up
    rows, k, _ = d.shape
    alphas = d.new_empty((rows, n_levels, k, k))
    betas = torch.empty_like(alphas)
    for lev in range(n_levels):
        s = 1 << lev
        dinv = _vinv(d, boost_eps)
        dinv_dn, f_dn, e_dn = shift_dn(torch.stack([dinv, f, e], dim=1), s).unbind(1)
        dinv_up, e_up, f_up = shift_up(torch.stack([dinv, e, f], dim=1), s).unbind(1)
        alpha = torch.matmul(e, dinv_dn, out=alphas[:, lev])
        beta = torch.matmul(f, dinv_up, out=betas[:, lev])
        d = d - alpha @ f_dn - beta @ e_up
        e, f = -(alpha @ e_dn), -(beta @ f_up)
    return PCRFactors(alphas=alphas, betas=betas, dinv=_vinv(d, boost_eps))


def pcr_solve(
    factors: PCRFactors, b: torch.Tensor, shift_dn=None, shift_up=None
) -> torch.Tensor:
    """Apply a PCR factorization to a right-hand side b (rows, K, R).

    One shift pair and two batched products per level, then the decoupled
    diagonal apply -- the log-depth replacement for the forward / backward
    chain sweeps.
    """
    if shift_dn is None:
        shift_dn = _shift_dn
    if shift_up is None:
        shift_up = _shift_up
    for lev in range(factors.n_levels):
        s = 1 << lev
        b = b - factors.alphas[:, lev] @ shift_dn(b, s) - factors.betas[:, lev] @ shift_up(b, s)
    return factors.dinv @ b


def resolve_reduced_solver(reduced_solver: str, m: int) -> str:
    """The ``"auto"`` policy for the SaP-E reduced chain solver.

    Cyclic reduction wins once the chain is long enough for its log-depth
    to beat the sequential sweep's lower constant; short chains (few
    partitions) stay on the ``btf_chain`` sweep.
    """
    if reduced_solver not in ("chain", "bcr", "auto"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}")
    if reduced_solver != "auto":
        return reduced_solver
    return "bcr" if m >= 8 else "chain"
