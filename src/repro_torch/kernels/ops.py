"""Public entry points of the port's kernels.

Dispatch goes by tensor device alone: the wrappers in :mod:`.btf`,
:mod:`.bts`, :mod:`.fused_spike`, :mod:`.bcr`, :mod:`.wkv`, :mod:`.ssd`
and :mod:`.flash_attn` run the plain PyTorch version for a CPU tensor and
launch the CUDA kernel for a CUDA tensor.  This module adds the factor
containers, the single-chain forms (the SaP-E reduced interface system),
the per-partition coupling layout of the fused pass, the level loops of
block cyclic reduction, the (batch, head) layout of the two SaP-scan
recurrences, and the contiguous operands of flash attention.  The three
model kernels' entry points (``wkv6``, ``ssd``, ``flash_attention``) are
differentiable: on the card a call whose operands require grad goes
through its :mod:`.autograd` Function.

With ``REPRO_TORCH_REPORT_LAUNCHES`` set in its environment, a process
prints every wrapper's launch count at exit (:func:`launch_counts`, one
line ``repro_torch launches {json}``), so that a parent can read the
launches of an entry point it ran as a child; the counters are read, not
changed.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Optional

import torch

from ..core.block_lu import DEFAULT_BOOST, BTFactors, FusedSpikeFactors, pad_couplings
from ..core.cyclic_reduction import BCRFactors, BCRLevel, pad_chain, pad_rhs
from ..obs.trace import span
from . import autograd as kgrad
from . import bcr
from .btf import btf
from .bts import bts
from .flash_attn import flash_attention as _flash
from .fused_spike import fused_factor_spike as _fused
from .ssd import ssd as _ssd
from .wkv import wkv6 as _wkv6


REPORT_LAUNCHES_ENV = "REPRO_TORCH_REPORT_LAUNCHES"
LAUNCH_REPORT_PREFIX = "repro_torch launches "


def launch_counts() -> dict[str, int]:
    """This process's launches by kernel wrapper (the wrappers' counters)."""
    wrappers = {"btf": btf, "bts": bts, "fused_factor_spike": _fused,
                "bcr_inv_odd": bcr.inv_odd, "bcr_reduce": bcr.reduce,
                "bcr_rhs_reduce": bcr.rhs_reduce, "bcr_backsub": bcr.backsub,
                "wkv": _wkv6, "ssd": _ssd, "flash": _flash}
    return {name: w.launches for name, w in wrappers.items()}


def _report_launches() -> None:
    # one write of the whole line: ranks that share the parent's stdout
    # end together, and a pipe keeps a write of under 4 KiB in one piece
    line = LAUNCH_REPORT_PREFIX + json.dumps({"pid": os.getpid(), "launches": launch_counts()})
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (line + "\n").encode())


if os.environ.get(REPORT_LAUNCHES_ENV):
    atexit.register(_report_launches)


# A 5-D input carries a leading *system* axis (S, P, M, K, ...): a fleet of
# independent block-tridiagonal systems (:mod:`repro_torch.core.batched`).
# Partitions are already independent chains, so the system axis folds into
# the partition axis: one launch over S*P chains, not S launches.


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(S, P, ...) -> (S*P, ...): the systems' partitions become chains."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(x: torch.Tensor, s: int) -> torch.Tensor:
    return x.reshape((s, x.shape[0] // s) + tuple(x.shape[1:]))


def block_tridiag_factor(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Block-tridiagonal LU factor of (P, M, K, K) chains, or of a fleet's
    (S, P, M, K, K) in one launch over S*P chains."""
    if d.ndim == 5:
        s = d.shape[0]
        sinv, l = btf(_fold(d), _fold(e), _fold(f), boost_eps)
        return BTFactors(sinv=_unfold(sinv, s), l=_unfold(l, s), f=f)
    sinv, l = btf(d, e, f, boost_eps)
    return BTFactors(sinv=sinv, l=l, f=f)


def block_tridiag_solve(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve the factored chains for (P, M, K, R) right-hand sides, or a
    fleet's (S, P, M, K, R) in one launch over S*P chains."""
    if b.ndim == 5:
        x = bts(_fold(factors.sinv), _fold(factors.l), _fold(factors.f), _fold(b))
        return _unfold(x, b.shape[0])
    return bts(factors.sinv, factors.l, factors.f, b)


def block_tridiag_factor_chain(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Factor a single block-tridiagonal chain (M, K, K), or S chains
    (S, M, K, K) as S partitions of one launch.  The factors keep a
    singleton partition axis before M."""
    return block_tridiag_factor(d[..., None, :, :, :], e[..., None, :, :, :],
                                f[..., None, :, :, :], boost_eps)


def block_tridiag_solve_chain(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one factored chain: b (M, K, R) -> x (M, K, R); or S chains,
    (S, M, K, R)."""
    return block_tridiag_solve(factors, b[..., None, :, :, :])[..., 0, :, :, :]


def fused_factor_spike(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    b_cpl: torch.Tensor,
    c_cpl: torch.Tensor,
    boost_eps: float = DEFAULT_BOOST,
) -> FusedSpikeFactors:
    """Fused block-LU factor + spike-corner extraction in one pass.

    d/e/f: (P, M, K, K) partition blocks; b_cpl/c_cpl: (P-1, K, K)
    interface couplings.  ``lu`` and ``v_bot`` / ``w_top`` equal the
    btf -> UL-btf sequence; ``v_top`` / ``w_bot`` are algebraically equal to
    the whole-spike solves (forward carries instead of back-substitution).

    A fleet's (S, P, M, K, K) and (S, P-1, K, K) go through one launch over
    S*P chains: each system's couplings are padded to P first, so the last
    partition of every system has zero coupling and the fold is exact.
    """
    p = d.shape[-4]
    bq, cq = pad_couplings(b_cpl.to(d.dtype), c_cpl.to(d.dtype), p)
    if d.ndim == 5:
        s = d.shape[0]
        out = _fused(_fold(d), _fold(e), _fold(f), _fold(bq), _fold(cq), boost_eps)
        sinv, l, vb, vt, wt, wb = (_unfold(t, s) for t in out)
    else:
        sinv, l, vb, vt, wt, wb = _fused(d, e, f, bq, cq, boost_eps)
    return FusedSpikeFactors(
        lu=BTFactors(sinv=sinv, l=l, f=f),
        v_bot=vb[..., :-1, :, :],
        v_top=vt[..., :-1, :, :],
        w_top=wt[..., 1:, :, :],
        w_bot=wb[..., 1:, :, :],
    )


def bcr_factor(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BCRFactors:
    """Block cyclic reduction factor of one chain (M, K, K) in log2(M)
    levels (pair with :func:`bcr_solve`); ``e[0]`` / ``f[M-1]`` are ignored.
    Per level, ``inv_odd`` inverts the odd diagonal blocks and ``reduce``
    builds ``lo``/``hi`` and the half-length chain; the root block goes
    through ``inv_odd``'s kernel as well.

    S chains (S, M, K, K) go through the same launches: each is padded to
    2^L with its end couplings zeroed (:func:`pad_chain`), and the S padded
    chains, laid end to end, are one block-diagonal chain whose levels
    reduce each system's blocks within the system.  After L levels every
    system has its root block; the S roots are inverted in one ``inv_odd``
    launch, at the odd places of a chain that interleaves them with
    identity blocks.  Every level of the factors carries the system axis,
    (S, m_l / 2, K, K), and the roots are (S, K, K).  Each level is a
    host span ``factor.reduced.level`` (attribute ``level``, from 0).
    """
    if d.ndim == 3:
        fac = bcr_factor(d[None], e[None], f[None], boost_eps)
        return BCRFactors(levels=tuple(BCRLevel(*(t[0] for t in lv)) for lv in fac.levels),
                          root_inv=fac.root_inv[0], m=fac.m)
    s, m, k = d.shape[0], d.shape[1], d.shape[2]
    padded = [pad_chain(*c) for c in zip(d, e, f)]
    d, e, f = (torch.cat(t).contiguous() for t in zip(*padded))  # (S * 2^L, K, K)
    levels = []
    while d.shape[0] > s:
        with span("factor.reduced.level", level=len(levels)):
            a_odd = bcr.inv_odd(d, boost_eps)
            lo, hi, d_next, e_next, f_next = bcr.reduce(d, e, f, a_odd)
            lv = (lo, hi, a_odd, e[1::2].contiguous(), f[1::2].contiguous())
            levels.append(BCRLevel(*(t.reshape(s, -1, k, k) for t in lv)))
            d, e, f = d_next, e_next, f_next
    eye = torch.eye(k, dtype=d.dtype, device=d.device).expand(s, k, k)
    root_inv = bcr.inv_odd(torch.stack([eye, d], dim=1).reshape(2 * s, k, k), boost_eps)
    return BCRFactors(levels=tuple(levels), root_inv=root_inv, m=m)


def bcr_solve(factors: BCRFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one BCR-factored chain: b (M, K, R) -> x (M, K, R); or S
    chains factored together, b (S, M, K, R), through the same launches as
    one.  The root apply ``root_inv @ b_0`` is one plain product, as in the
    JAX package."""
    batched = factors.root_inv.ndim == 3
    k, r = b.shape[-2], b.shape[-1]
    if batched:
        b = torch.stack([pad_rhs(bs, factors.n_levels) for bs in b]).reshape(-1, k, r)
    else:
        b = pad_rhs(b.contiguous(), factors.n_levels)

    def flat(t):
        return t.reshape(-1, k, k)

    rhs = []
    for lv in factors.levels:
        rhs.append(b)
        b = bcr.rhs_reduce(flat(lv.lo), flat(lv.hi), b)
    x = factors.root_inv @ b if batched else (factors.root_inv @ b[0])[None]
    for lv, bl in zip(reversed(factors.levels), reversed(rhs)):
        x = bcr.backsub(flat(lv.a_odd), flat(lv.e_odd), flat(lv.f_odd), bl, x)
    if batched:
        return x.reshape(factors.root_inv.shape[0], -1, k, r)[:, : factors.m]
    return x[: factors.m]


# ---------------------------------------------------------------------------
# Analytic work counts (the cost model's and the smoke's bounds)
# ---------------------------------------------------------------------------
#
# Two kinds of count.  The ``*_flops`` are the JAX package's leading-order
# algebraic flop counts (``repro/kernels/ops.py``), copied unchanged: its
# cost tests hold its HLO-derived counters to them.  The ``*_work`` return
# (flops, bytes) that a function must do -- each input read once, each
# output written once, ``itemsize`` bytes an element (4, float32, unless
# given: 2 for bfloat16, 8 for float64 storage) -- counted row by row as
# the kernels here run it; ``chip_smoke.py`` divides them by the card's peaks for each
# kernel's bound, and :mod:`repro_torch.obs.cost` sums them into stage costs.


def gj_inverse_flops(k: int) -> float:
    """Gauss-Jordan inverse of one KxK block: ~2 K^3 multiply-adds."""
    return 2.0 * k**3


def btf_flops(p: int, m: int, k: int) -> float:
    """Block-tridiag factor of P chains of M KxK blocks.

    Per interior block: one Schur-pivot inverse (2 K^3), the elimination
    product ``l = e @ sinv`` (2 K^3), and the Schur update ``d - l @ f``
    (2 K^3 + K^2).
    """
    return float(p) * m * (gj_inverse_flops(k) + 4.0 * k**3 + k * k)


def bts_flops(p: int, m: int, k: int, r: int = 1) -> float:
    """Block-tridiag solve: forward + backward sweeps, three K x K block
    mat-vecs (2 K^2 R each) per block per sweep pair."""
    return float(p) * m * 6.0 * k * k * r


def fused_factor_spike_flops(p: int, m: int, k: int) -> float:
    """Fused factor+spike megakernel: the LU recurrence twice (forward and
    reversed chains, ~6 K^3 + K^2 per block each), two K x K RHS carries
    (2 K^3 per block each), plus four corner products (2 K^3 each) per
    partition.  Compare ~2x the flops of :func:`btf_flops` alone -- but
    the kernel *sequence* it replaces pays the UL factor writeback and two
    whole-spike bts solves in HBM traffic, which is what the fused pass
    eliminates (see ``solver_stage_costs``)."""
    return 2.0 * btf_flops(p, m, k) + float(p) * m * 4.0 * k**3 + float(p) * 8.0 * k**3


def bcr_flops(m: int, k: int) -> float:
    """Cyclic reduction over a chain of M KxK blocks: ~M eliminated nodes
    across the log2(M) levels, each paying one inverse (2 K^3) and four
    update products (2 K^3 each)."""
    return float(m) * 10.0 * k**3


def btf_work(p: int, m: int, k: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) a block-tridiagonal LU of P chains of M K x K blocks
    must do.  Row 0 only inverts (2K^3); rows 1..M-1 each form L_j (2K^3),
    S_j = D_j - L_j F_{j-1} (2K^3 + K^2) and invert S_j (2K^3).  Reads every
    D, E_1..E_{M-1} and F_0..F_{M-2}; writes sinv and l."""
    flops = p * ((6 * m - 4) * k**3 + (m - 1) * k**2)
    return float(flops), float(itemsize) * p * k * k * ((3 * m - 2) + 2 * m)


def bts_work(p: int, m: int, k: int, r: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) of both sweeps for R right-hand sides: M-1 forward
    products, sinv_{M-1} y, then F_j x_{j+1} and sinv_j (...) for j < M-1,
    each 2K^2 R flops.  Reads sinv, l_1..l_{M-1}, f_0..f_{M-2} and b;
    writes x."""
    flops = p * ((6 * m - 4) * k * k * r + 2 * (m - 1) * k * r)
    return float(flops), float(itemsize) * p * ((3 * m - 2) * k * k + 2 * m * k * r)


def fused_work(p: int, m: int, k: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) of the fused pass: the LU and the UL recurrence (btf's
    work each), the two spike carries (M-1 products each) and the four
    corner products.  Reads the chain blocks btf reads plus bq and cq;
    writes sinv, l and the four K x K corners."""
    flops = p * ((16 * m - 4) * k**3 + 2 * (m - 1) * k**2)
    return float(flops), float(itemsize) * p * k * k * ((3 * m - 2) + 2 * m + 2 + 4)


def bcr_work(m: int, k: int, r: int, itemsize: int = 4) -> dict[str, tuple[float, float]]:
    """(flops, bytes) of each BCR kernel over all levels of one factor
    (inv_odd, reduce) or one solve with R right-hand sides (rhs_reduce,
    backsub), for a chain of m blocks of K x K padded to 2^L blocks.  Each
    level of length m_l eliminates m_l/2 odd rows, so the levels eliminate
    2^L - 1 rows in all; the identity padding rows are counted, since the
    kernels eliminate them like any other (at m = 63: 1 of 64 rows).
    inv_odd inverts every odd block and the root (2K^3 each; reads and
    writes one block each); reduce does six K x K products per even row
    plus two block subtractions, reading D_2i, E, F, a (3 blocks per row
    pair) and writing lo, hi, D', E', F'; rhs_reduce reads lo, hi and the
    level's RHS, writes the half-length RHS (4K^2 R + 2KR flops a row);
    backsub reads a, e, f, the odd RHS and x, writes the level's solution
    (6K^2 R + 2KR flops a row)."""
    rows = (1 << max(m - 1, 0).bit_length()) - 1
    blk, vec = float(itemsize) * k * k, float(itemsize) * k * r
    return {
        "inv_odd": (2.0 * k**3 * (rows + 1), 2 * blk * (rows + 1)),
        "reduce": (rows * (12.0 * k**3 + 2 * k * k), rows * 11 * blk),
        "rhs_reduce": (rows * (4.0 * k * k * r + 2 * k * r), rows * (2 * blk + 3 * vec)),
        "backsub": (rows * (6.0 * k * k * r + 2 * k * r), rows * (3 * blk + 4 * vec)),
    }


def reduce_level_work(m2: int, k: int, itemsize: int = 4) -> tuple[float, float]:
    """(flops, bytes) of one reduce level of m2 even rows, as bcr_work
    counts a row: six K x K products and two block subtractions, reading
    D_2i, E, F, a and writing lo, hi, D', E', F' (11 blocks)."""
    return m2 * (12.0 * k**3 + 2 * k * k), m2 * 11 * float(itemsize) * k * k


def solve_level_work(
    m2: int, k: int, r: int, itemsize: int = 4
) -> dict[str, tuple[float, float]]:
    """(flops, bytes) of one rhs_reduce and one backsub level of m2 even
    rows, as bcr_work counts a row."""
    blk, vec = float(itemsize) * k * k, float(itemsize) * k * r
    return {"rhs_reduce": (m2 * (4.0 * k * k * r + 2 * k * r), m2 * (2 * blk + 3 * vec)),
            "backsub": (m2 * (6.0 * k * k * r + 2 * k * r), m2 * (3 * blk + 4 * vec))}


# ---------------------------------------------------------------------------
# Sequence-mixing recurrences (flattened over batch x heads)
# ---------------------------------------------------------------------------


def wkv6(
    r: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,  # (H, D)
    state: torch.Tensor,  # (B, H, D, D)
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 recurrence; returns (output (B, H, T, D), final state).
    Differentiable: on the card through :class:`.autograd.WKV6`."""
    bsz, h, t, d = r.shape
    flat = lambda x: x.reshape(bsz * h, *x.shape[2:]).contiguous()  # noqa: E731
    u_full = u.expand(bsz, h, d).reshape(bsz * h, d).contiguous()
    args = (flat(r), flat(k), flat(v), flat(logw), u_full, flat(state))
    if kgrad.on_card_with_grad(*args):
        o, s_out = kgrad.WKV6.apply(_wkv6, *args, chunk)
    else:
        o, s_out = _wkv6(*args, chunk)
    return o.reshape(bsz, h, t, d), s_out.reshape(bsz, h, d, d)


def ssd(
    x: torch.Tensor,  # (B, H, T, P)
    b: torch.Tensor,  # (B, H, T, N)
    c: torch.Tensor,  # (B, H, T, N)
    loga: torch.Tensor,  # (B, H, T)
    state: torch.Tensor,  # (B, H, N, P)
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (state-space dual) scan; returns (output, final state).

    ``b`` and ``c`` broadcast over the heads (stride 0 on the head axis, as
    ``expand`` makes them) are handed to the kernel once per batch row.
    Differentiable: on the card through :class:`.autograd.SSD`, whose
    gradient for that row is summed over the heads.
    """
    bsz, h, t, p = x.shape
    n = b.shape[-1]
    flat = lambda a: a.reshape(bsz * h, *a.shape[2:]).contiguous()  # noqa: E731
    if h > 1 and b.stride(1) == 0 and c.stride(1) == 0:
        bq, cq, hshare = b[:, 0].contiguous(), c[:, 0].contiguous(), h
    else:
        bq, cq, hshare = flat(b), flat(c), 1
    args = (flat(x), bq, cq, flat(loga), flat(state))
    if kgrad.on_card_with_grad(*args):
        y, s_out = kgrad.SSD.apply(_ssd, *args, chunk, hshare)
    else:
        y, s_out = _ssd(*args, chunk, hshare)
    return y.reshape(bsz, h, t, p), s_out.reshape(bsz, h, n, p)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hk, Tk, D)
    v: torch.Tensor,  # (B, Hk, Tk, D)
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal / sliding-window GQA attention in the JAX layout; the
    operands are made contiguous first (RoPE and the head transpose leave
    them strided)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kgrad.on_card_with_grad(q, k, v):
        return kgrad.FlashAttention.apply(_flash, q, k, v, causal, window)
    return _flash(q, k, v, causal, window)
