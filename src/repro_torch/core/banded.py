"""Banded-matrix storage utilities (PyTorch).

Three representations are used throughout the solver:

1. ``dense``        : plain (N, N) tensor (tests / tiny problems only).
2. ``band``         : the paper's "tall and thin" storage, shape (N, 2K+1)
                      with ``band[r, j] == A[r, r - K + j]``.  The diagonal
                      lives in column K (paper Sec. 3.1).
3. ``block-tridiag``: each of the P partitions is a block-tridiagonal
                      matrix with (K x K) blocks.
                      Shapes: D (P, M, K, K) diagonal blocks,
                              E (P, M, K, K) sub-diagonal  (E[:, 0] unused),
                              F (P, M, K, K) super-diagonal (F[:, M-1] unused).

The partition coupling blocks of the paper (B_i super- / C_i sub-coupling,
each K x K) are extracted separately; they drive the spike computation.

Everything here is host-orchestrated tensor code on whatever device the
inputs live on; the numpy generators at the bottom produce the same
matrices as the JAX package's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# dense <-> band conversions
# ---------------------------------------------------------------------------


def dense_to_band(a: torch.Tensor, k: int) -> torch.Tensor:
    """Convert a dense (N, N) banded matrix into (N, 2K+1) band storage."""
    n = a.shape[0]
    cols = torch.arange(n, device=a.device)[:, None] + torch.arange(
        -k, k + 1, device=a.device
    )
    valid = (cols >= 0) & (cols < n)
    vals = torch.gather(a, 1, cols.clamp(0, n - 1))
    return torch.where(valid, vals, torch.zeros((), dtype=a.dtype, device=a.device))


def band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dense_to_band`."""
    n, w = band.shape
    k = (w - 1) // 2
    rows = torch.arange(n, device=band.device)[:, None].expand(n, w)
    cols = rows - k + torch.arange(w, device=band.device)
    valid = (cols >= 0) & (cols < n)
    out = torch.zeros((n, n), dtype=band.dtype, device=band.device)
    out[rows[valid], cols[valid]] = band[valid]
    return out


def band_matvec(band: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in band storage.

    ``band`` is (N, 2K+1) against ``x`` of (N,) or (N, R), or a stack of
    S bands (S, N, 2K+1) against (S, N) or (S, N, R): system s's band
    multiplies system s's vector.  One windowed product: ``x`` padded by K
    zeros on each side of its row axis is viewed as its (..., N, R, 2K+1)
    sliding windows (no copy), so ``y[r] = sum_j band[r, j] * x[r - K + j]``.
    Computes in the promoted dtype of ``band`` and ``x``.
    """
    w = band.shape[-1]
    k = (w - 1) // 2
    squeeze = x.ndim == band.ndim - 1
    if squeeze:
        x = x[..., None]
    dt = torch.promote_types(band.dtype, x.dtype)
    xp = torch.nn.functional.pad(x.to(dt).transpose(-1, -2), (k, k)).transpose(-1, -2)
    win = xp.unfold(-2, w, 1)  # (..., N, R, 2K+1) view
    y = torch.einsum("...nw,...nrw->...nr", band.to(dt), win)
    return y[..., 0] if squeeze else y


def diag_dominance_factor(band: torch.Tensor) -> torch.Tensor:
    """Degree of diagonal dominance ``d`` of a band-storage matrix.

    Paper Eq. 2.11: ``min_i |a_ii| / sum_{j!=i} |a_ij|``.  Rows with no
    off-diagonal mass are infinitely dominant and drop out of the minimum
    (a pure diagonal matrix returns ``inf``).  Drives ``variant="auto"``.
    A stack of bands (S, N, 2K+1) gives one ``d`` a system, (S,).
    """
    k = (band.shape[-1] - 1) // 2
    diag = band[..., k].abs()
    off = band.abs().sum(dim=-1) - diag
    safe = torch.where(off > 0, off, torch.ones_like(off))
    ratio = torch.where(off > 0, diag / safe, torch.full_like(off, float("inf")))
    return ratio.amin(dim=-1)


# ---------------------------------------------------------------------------
# Partitioning (paper Sec. 3.1: first P_r partitions get floor(N/P)+1 rows)
# ---------------------------------------------------------------------------


def partition_sizes(n: int, p: int) -> np.ndarray:
    base = n // p
    rem = n - p * base
    return np.asarray([base + 1 if i < rem else base for i in range(p)])


def padded_partition_size(n: int, p: int, k: int) -> int:
    """Uniform per-partition row count, padded so K | Ni (identity padding)."""
    ni = -(-n // p)  # ceil
    m = -(-ni // k)
    return m * k


def pad_banded(
    band: torch.Tensor, b: torch.Tensor, n_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad system with identity rows so the total size becomes ``n_pad``."""
    n, w = band.shape
    k = (w - 1) // 2
    if n_pad == n:
        return band, b
    extra = n_pad - n
    pad_rows = band.new_zeros((extra, w))
    pad_rows[:, k] = 1.0
    band_p = torch.cat([band, pad_rows], dim=0)
    b_p = torch.cat([b, b.new_zeros((extra,) + tuple(b.shape[1:]))], dim=0)
    return band_p, b_p


# ---------------------------------------------------------------------------
# band -> block tridiagonal (per partition)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockTridiag:
    """Block-tridiagonal form of the P partitions + coupling blocks.

    d: (P, M, K, K)   diagonal blocks
    e: (P, M, K, K)   sub-diagonal blocks   (e[:, 0] is zero / unused)
    f: (P, M, K, K)   super-diagonal blocks (f[:, M-1] is zero / unused)
    b_cpl: (P-1, K, K) super coupling block B_i  (rows: bottom of part i,
                        cols: top of part i+1)
    c_cpl: (P-1, K, K) sub coupling block C_{i+1} (rows: top of part i+1,
                        cols: bottom of part i)
    n: original (unpadded) system size

    A fleet of S systems split alike (:mod:`repro_torch.core.batched`)
    carries a leading system axis on every tensor: d (S, P, M, K, K), ...
    """

    d: torch.Tensor
    e: torch.Tensor
    f: torch.Tensor
    b_cpl: torch.Tensor
    c_cpl: torch.Tensor
    n: int

    @property
    def p(self) -> int:
        return self.d.shape[-4]

    @property
    def m(self) -> int:
        return self.d.shape[-3]

    @property
    def k(self) -> int:
        return self.d.shape[-1]

    @property
    def n_pad(self) -> int:
        return self.p * self.m * self.k


def block_row_windows(band: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N, 2K+1) band storage, K | N -> (..., N/K, K, 3K) windows.

    Window i holds block row i's columns from K before its first row to K
    past its last: the sub-diagonal, diagonal and super-diagonal blocks
    side by side.  Row r (global) belongs to block row ``r // K`` with
    offset ``o = r % K``; its band entry j lands at column ``o + j``.  For a
    fixed block row those targets sit at flat offsets ``o * (3K + 1) + j``,
    so the whole scatter is ONE strided copy of the band into the windows.
    """
    lead, n = band.shape[:-2], band.shape[-2]
    nb, w = n // k, 2 * k + 1
    win = band.new_zeros(lead + (nb, k, 3 * k))
    flat = win.view(-1, nb, k, 3 * k)
    strides = (nb * k * 3 * k, 3 * k * k, 3 * k + 1, 1)
    torch.as_strided(flat, (flat.shape[0], nb, k, w), strides).copy_(band.reshape(-1, nb, k, w))
    return win


def band_to_block_tridiag(band: torch.Tensor, k: int, p: int) -> BlockTridiag:
    """Split a banded system into P partitions of block-tridiagonal (K x K).

    The block rows are :func:`block_row_windows` of the band, padded with
    identity rows to P equal partitions.  Band entries outside the matrix
    only ever land in ``e[0, 0]`` / ``f[P-1, M-1]``, which are zeroed
    anyway.  A stack of bands (S, N, 2K+1) splits every system alike in the
    same one copy.
    """
    lead, n = band.shape[:-2], band.shape[-2]
    ni = padded_partition_size(n, p, k)
    n_pad = ni * p
    m = ni // k
    if n_pad > n:  # identity rows below the system
        rows = band.new_zeros(lead + (n_pad - n, 2 * k + 1))
        rows[..., k] = 1.0
        band = torch.cat([band, rows], dim=-2)

    win = block_row_windows(band, k).reshape(lead + (p, m, k, 3 * k))
    e = win[..., 0:k].contiguous()
    d = win[..., k : 2 * k].contiguous()
    f = win[..., 2 * k : 3 * k].contiguous()
    # Coupling blocks B_i = A[part i bottom K rows, part i+1 top K cols] and
    # C_{i+1}, taken before the cross-partition pieces are zeroed.
    b_cpl = f[..., :-1, m - 1, :, :].clone()
    c_cpl = e[..., 1:, 0, :, :].clone()
    e[..., 0, :, :] = 0.0
    f[..., m - 1, :, :] = 0.0
    return BlockTridiag(d=d, e=e, f=f, b_cpl=b_cpl, c_cpl=c_cpl, n=n)


def block_tridiag_to_dense(bt: BlockTridiag) -> torch.Tensor:
    """Reassemble the full (padded) dense matrix (tests only)."""
    p, m, k = bt.p, bt.m, bt.k
    out = bt.d.new_zeros((bt.n_pad, bt.n_pad))
    for i in range(p):
        off = i * m * k
        for j in range(m):
            r0 = off + j * k
            out[r0 : r0 + k, r0 : r0 + k] = bt.d[i, j]
            if j > 0:
                out[r0 : r0 + k, r0 - k : r0] = bt.e[i, j]
            if j < m - 1:
                out[r0 : r0 + k, r0 + k : r0 + 2 * k] = bt.f[i, j]
    for i in range(p - 1):
        rb = (i + 1) * m * k  # first row of partition i+1
        out[rb - k : rb, rb : rb + k] = bt.b_cpl[i]
        out[rb : rb + k, rb - k : rb] = bt.c_cpl[i]
    return out


# ---------------------------------------------------------------------------
# Test-matrix generators (numpy; mirror the paper's experiments Sec. 4.1)
# ---------------------------------------------------------------------------


def random_banded(
    n: int,
    k: int,
    d: float,
    seed: int = 0,
    dtype=np.float64,
) -> np.ndarray:
    """Random band-storage matrix with degree of diagonal dominance ``d``.

    Off-diagonal entries are U(-1, 1); the diagonal is set so that
    |a_ii| = d * sum_{j != i} |a_ij|  (paper Eq. 2.11, with equality).
    Returns band storage (N, 2K+1).
    """
    rng = np.random.default_rng(seed)
    band = rng.uniform(-1.0, 1.0, size=(n, 2 * k + 1)).astype(dtype)
    # zero out-of-matrix corners
    for j in range(2 * k + 1):
        c = np.arange(n) - k + j
        band[(c < 0) | (c >= n), j] = 0.0
    off = np.abs(band).sum(axis=1) - np.abs(band[:, k])
    sign = np.where(band[:, k] >= 0, 1.0, -1.0)
    band[:, k] = sign * np.maximum(d * off, 1e-3)
    return band


def oscillatory_banded(
    n: int,
    k: int,
    d: float,
    jitter: float = 0.02,
    seed: int = 0,
    dtype=np.float64,
) -> np.ndarray:
    """Band-storage matrix with dominance ``d`` and *non-decaying* spikes.

    Every off-diagonal is coherently negative (-1 with a small positive
    jitter), which puts the symbol of the matrix near zero: the spikes
    oscillate without decaying.  For d < 1 truncation (variants C/D) breaks
    down and the exact reduced system (variant "E") is required -- the hard
    scenario of paper Sec. 2.1/4.1.  Returns band storage (N, 2K+1).
    """
    rng = np.random.default_rng(seed)
    band = -(1.0 + jitter * rng.uniform(0.0, 1.0, size=(n, 2 * k + 1)))
    band = band.astype(dtype)
    for j in range(2 * k + 1):
        c = np.arange(n) - k + j
        band[(c < 0) | (c >= n), j] = 0.0
    off = np.abs(band).sum(axis=1) - np.abs(band[:, k])
    band[:, k] = np.maximum(d * off, 1e-3)
    return band


def random_rhs(n: int, seed: int = 1, dtype=np.float64) -> np.ndarray:
    """Paper Sec 4.3.3: entries on a parabola from 1.0 to ~400 back to 1.0."""
    t = np.linspace(-1.0, 1.0, n)
    return (400.0 * (1.0 - t * t) + 1.0).astype(dtype)
