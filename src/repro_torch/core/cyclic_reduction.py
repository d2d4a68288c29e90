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
is :func:`repro_torch.kernels.ops.bcr_factor` / ``bcr_solve``.  The
all-active PCR form of the JAX package waits for the distributed path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .block_lu import DEFAULT_BOOST, gj_inverse


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
    """
    e_odd, f_odd = e[1::2], f[1::2]
    lo = e[0::2] @ _shift_dn(a_odd)  # E_{2i} inv(D_{2i-1})
    hi = f[0::2] @ a_odd  # F_{2i} inv(D_{2i+1})
    d_next = d[0::2] - lo @ _shift_dn(f_odd) - hi @ e_odd
    e_next = -(lo @ _shift_dn(e_odd))
    f_next = -(hi @ f_odd)
    return lo, hi, d_next, e_next, f_next


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
    b_odd = b[1::2]
    return b[0::2] - lo @ _shift_dn(b_odd) - hi @ b_odd


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
    x_odd = a_odd @ (b[1::2] - e_odd @ x - f_odd @ _shift_up(x))
    m2, k, r = x.shape
    return torch.stack([x, x_odd], dim=1).reshape(2 * m2, k, r)


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
