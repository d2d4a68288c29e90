"""Block-tridiagonal LU / UL factorization -- the plain PyTorch versions.

The paper's dense-banded LU (Sec. 3.1) cast as a block-tridiagonal
factorization with (K x K) blocks:

    A_i = L_i @ U_i,     L_i unit block-lower-bidiagonal (blocks L_j),
                         U_i block-upper-bidiagonal (diag S_j, super F_j)

    S_0 = D_0
    L_j = E_j @ inv(S_{j-1})          j = 1..M-1
    S_j = D_j - L_j @ F_{j-1}

Pivoting is replaced by *pivot boosting* (paper Sec. 2.2): inside the
Gauss-Jordan inversion of each S_j, any pivot smaller than
``boost_eps * max|S_j|`` is boosted to that threshold.  *Structurally* zero
rows (identity padding, a band stored wider than its true bandwidth) take
pivot 1 instead, so padded embeddings stay exactly blkdiag(A, I).

Every function here is batched over the partition axis P with a Python loop
over the M block rows, and computes in the wider of float32 and the storage
dtype (:func:`compute_dtype`): float64 storage in float64, float32 and
bfloat16 storage in float32, as the CUDA kernels in ``repro_torch.kernels``
do for each of the three storage dtypes; results are stored back in the
input dtype.  These are the kernels' plain versions: the CPU path of
every kernel wrapper and the yardstick the kernels are held against on the
card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_BOOST = 1e-10


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain block kernels compute in for ``dtype`` storage:
    the wider of it and float32."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Gauss-Jordan inverse with pivot boosting (K x K), batched over leading axes
# ---------------------------------------------------------------------------


def gj_inverse(a: torch.Tensor, boost_eps: float = DEFAULT_BOOST) -> torch.Tensor:
    """Inverse of (..., K, K) blocks via Gauss-Jordan with pivot boosting.

    Rows of a block that are *exactly* zero take pivot 1 (never boosted), so
    the inverse acts as the identity on those slots.  Elimination never
    fills a zero row (its multiplier column entry is zero), so the test at
    step ``t`` sees the original structure of row ``t``.
    """
    k = a.shape[-1]
    cdt = compute_dtype(a.dtype)
    x = a.to(cdt)
    scale = x.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
    thr = boost_eps * scale
    eye = torch.eye(k, dtype=cdt, device=a.device)
    aug = torch.cat([x, eye.expand(x.shape)], dim=-1)  # (..., K, 2K)
    one = torch.ones((), dtype=cdt, device=a.device)
    for t in range(k):
        piv = aug[..., t, t]
        struct_zero = (aug[..., t, :k] == 0).all(dim=-1)
        piv = torch.where(piv.abs() < thr, torch.where(piv >= 0, thr, -thr), piv)
        piv = torch.where(struct_zero, one, piv)
        row = aug[..., t, :] / piv[..., None]
        row[..., t] = 1.0
        col = aug[..., :, t]
        aug = aug - col[..., :, None] * row[..., None, :]
        aug[..., t, :] = row
    return aug[..., k:].to(a.dtype)


def gj_solve(a: torch.Tensor, b: torch.Tensor, boost_eps: float = DEFAULT_BOOST) -> torch.Tensor:
    """Solve (..., K, K) @ x = (..., K, R) through the boosted inverse (small
    systems), in the compute dtype of the wider of ``a`` and ``b``."""
    cdt = compute_dtype(torch.promote_types(a.dtype, b.dtype))
    return gj_inverse(a.to(cdt), boost_eps) @ b.to(cdt)


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------


class BTFactors(NamedTuple):
    """Factors of the block-diagonal matrix D = diag(A_1..A_P).

    sinv: (P, M, K, K)  inverses of the block pivots S_j
    l:    (P, M, K, K)  unit-lower block multipliers (l[:, 0] zero)
    f:    (P, M, K, K)  super-diagonal blocks (copied from input)
    """

    sinv: torch.Tensor
    l: torch.Tensor
    f: torch.Tensor


def btf_ref(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Block-tridiagonal factorization of every partition: (P, M, K, K)."""
    p, m, k, _ = d.shape
    cdt = compute_dtype(d.dtype)
    dc, ec, fc = (x.to(cdt) for x in (d, e, f))
    sinv = torch.empty_like(dc)
    l = torch.zeros_like(dc)
    sinv[:, 0] = gj_inverse(dc[:, 0], boost_eps)
    for j in range(1, m):
        lj = ec[:, j] @ sinv[:, j - 1]
        sinv[:, j] = gj_inverse(dc[:, j] - lj @ fc[:, j - 1], boost_eps)
        l[:, j] = lj
    return BTFactors(sinv=sinv.to(d.dtype), l=l.to(d.dtype), f=f)


# ---------------------------------------------------------------------------
# Solve  D @ x = b  (independent per partition)
# ---------------------------------------------------------------------------


def bts_ref(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve with the factors.  b: (P, M, K, R) -> x: (P, M, K, R)."""
    cdt = compute_dtype(factors.sinv.dtype)
    sinv, l, f = (x.to(cdt) for x in factors)
    bc = b.to(cdt)
    m = b.shape[1]
    y = torch.empty_like(bc)
    # forward:  y_j = b_j - L_j y_{j-1}
    y[:, 0] = bc[:, 0]
    for j in range(1, m):
        y[:, j] = bc[:, j] - l[:, j] @ y[:, j - 1]
    # backward: x_{M-1} = Sinv y_{M-1};  x_j = Sinv_j (y_j - F_j x_{j+1})
    x = torch.empty_like(bc)
    x[:, m - 1] = sinv[:, m - 1] @ y[:, m - 1]
    for j in range(m - 2, -1, -1):
        x[:, j] = sinv[:, j] @ (y[:, j] - f[:, j] @ x[:, j + 1])
    return x.to(b.dtype)


# ---------------------------------------------------------------------------
# Single-chain convenience (the SaP-E reduced interface system, Sec. 2.1)
# ---------------------------------------------------------------------------


def btf_chain(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """Factor a single block-tridiagonal chain (M, K, K).

    The returned factors keep a leading singleton partition axis (pair with
    :func:`bts_chain`).
    """
    return btf_ref(d[None], e[None], f[None], boost_eps)


def bts_chain(factors: BTFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve one factored chain: b (M, K, R) -> x (M, K, R)."""
    return bts_ref(factors, b[None])[0]


# ---------------------------------------------------------------------------
# UL factorization via reversal (for the left-spike top blocks, Sec. 2.1)
# ---------------------------------------------------------------------------


def _flip2(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2, -1)


def _fliprows(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2)


def flip_block_tridiag(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocks of J A J^T (row+col reversal) per partition.

    Reversal maps block (r, c) -> (M-1-r, M-1-c) and flips each block on
    both axes.  An LU factorization of the reversed matrix is a UL
    factorization of the original (paper Sec. 2.1).  Leading axes (P, or
    S and P) are kept.
    """
    d_r = _flip2(d.flip(-3))
    # sub-diag of reversed row j is the flipped super-diag of row M-1-j
    e_r = _flip2(f.flip(-3))
    f_r = _flip2(e.flip(-3))
    e_r[..., 0, :, :] = 0.0
    f_r[..., -1, :, :] = 0.0
    return d_r, e_r, f_r


def btf_ul_ref(
    d: torch.Tensor, e: torch.Tensor, f: torch.Tensor, boost_eps: float = DEFAULT_BOOST
) -> BTFactors:
    """UL factors == LU factors of the reversed partition."""
    return btf_ref(*flip_block_tridiag(d, e, f), boost_eps)


# ---------------------------------------------------------------------------
# Fused factor + spike extraction (single ascending pass, Sec. 2.1 + 3.1)
# ---------------------------------------------------------------------------
#
# One ascending sweep j = 0..M-1 carries four K x K blocks: the LU
# recurrence; the UL recurrence (the LU recurrence on the reversed chain,
# only its carry kept); the left-spike RHS swept forward through LU
# (y_0 = C_i, y_j = -l_j y_{j-1}, so w_bot = sinv_{M-1} y_{M-1}); and the
# right-spike RHS swept forward through UL (yr_0 = flip(B_i),
# yr_j = -l^{UL}_j yr_{j-1}, so v_top = flip(sinv^{UL}_{M-1} yr_{M-1})).


class FusedSpikeFactors(NamedTuple):
    """LU factors plus the four spike corner blocks, from one fused pass.

    lu:     factors of diag(A_1..A_P) (identical to :func:`btf_ref`)
    v_bot:  (P-1, K, K)  bottom blocks of the right spikes V_i,  i=0..P-2
    v_top:  (P-1, K, K)  top blocks of the same right spikes
    w_top:  (P-1, K, K)  top blocks of the left spikes W_{i+1}
    w_bot:  (P-1, K, K)  bottom blocks of the same left spikes
    """

    lu: BTFactors
    v_bot: torch.Tensor
    v_top: torch.Tensor
    w_top: torch.Tensor
    w_bot: torch.Tensor


def fused_factor_spike_padded_ref(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    bq: torch.Tensor,
    cq: torch.Tensor,
    boost_eps: float = DEFAULT_BOOST,
) -> tuple[torch.Tensor, ...]:
    """Fused factor+spike pass on per-partition padded couplings.

    d/e/f: (P, M, K, K); bq/cq: (P, K, K) -- the coupling block *of each
    partition* (see :func:`pad_couplings`), so every partition is an
    independent chain.  Returns ``(sinv, l, vb, vt, wt, wb)`` with sinv/l
    of shape (P, M, K, K) and the corners (P, K, K).
    """
    p, m, k, _ = d.shape
    cdt = compute_dtype(d.dtype)
    dc, ec, fc, bqc, cqc = (x.to(cdt) for x in (d, e, f, bq, cq))
    sinv = torch.empty_like(dc)
    l = torch.zeros_like(dc)
    sinv[:, 0] = gj_inverse(dc[:, 0], boost_eps)
    c_ul = gj_inverse(_flip2(dc[:, m - 1]), boost_eps)
    c_w = cqc
    c_v = _fliprows(bqc)
    for j in range(1, m):
        lj = ec[:, j] @ sinv[:, j - 1]
        sinv[:, j] = gj_inverse(dc[:, j] - lj @ fc[:, j - 1], boost_eps)
        l[:, j] = lj
        c_w = -(lj @ c_w)
        # reversed chain: d_r[j] = flip2(d[M-1-j]), e_r[j] = flip2(f[M-1-j]),
        # f_r[j-1] = flip2(e[M-j])
        l_ul = _flip2(fc[:, m - 1 - j]) @ c_ul
        s_ul = _flip2(dc[:, m - 1 - j]) - l_ul @ _flip2(ec[:, m - j])
        c_ul = gj_inverse(s_ul, boost_eps)
        c_v = -(l_ul @ c_v)
    s_last = sinv[:, m - 1]
    vb = s_last @ bqc
    wb = s_last @ c_w
    wt = _fliprows(c_ul @ _fliprows(cqc))
    vt = _fliprows(c_ul @ c_v)
    dt = d.dtype
    return sinv.to(dt), l.to(dt), vb.to(dt), vt.to(dt), wt.to(dt), wb.to(dt)


def pad_couplings(
    b_cpl: torch.Tensor, c_cpl: torch.Tensor, p: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P-1, K, K) interface couplings -> per-partition (P, K, K) layout.

    ``bq[p] = B_p`` (zero for the last partition, which has no right
    neighbor); ``cq[p] = C_p`` (zero for the first).  Zero couplings make
    the corresponding corner blocks exactly zero.
    """
    pad = b_cpl.new_zeros(b_cpl.shape[:-3] + (1,) + b_cpl.shape[-2:])
    bq = torch.cat([b_cpl, pad], dim=-3)
    cq = torch.cat([pad, c_cpl], dim=-3)
    return bq, cq


def fused_factor_spike_ref(
    d: torch.Tensor,
    e: torch.Tensor,
    f: torch.Tensor,
    b_cpl: torch.Tensor,
    c_cpl: torch.Tensor,
    boost_eps: float = DEFAULT_BOOST,
) -> FusedSpikeFactors:
    """Fused factor + spike-corner extraction (plain version).

    d/e/f: (P, M, K, K) partition blocks; b_cpl/c_cpl: (P-1, K, K)
    interface couplings as in :class:`~repro_torch.core.banded.BlockTridiag`.
    """
    p = d.shape[0]
    bq, cq = pad_couplings(b_cpl.to(d.dtype), c_cpl.to(d.dtype), p)
    sinv, l, vb, vt, wt, wb = fused_factor_spike_padded_ref(d, e, f, bq, cq, boost_eps)
    return FusedSpikeFactors(
        lu=BTFactors(sinv=sinv, l=l, f=f),
        v_bot=vb[:-1],
        v_top=vt[:-1],
        w_top=wt[1:],
        w_bot=wb[1:],
    )
