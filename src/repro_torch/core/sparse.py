"""Minimal CSR sparse-matrix container (numpy, host-side).

The paper's reordering stages (DB, CM) are host-side preprocessing in
SaP::GPU as well (hybrid CPU/GPU, Sec. 3.2-3.3); here they are numpy.
The device-side story starts after banded assembly.  This module is the
JAX package's ``repro.core.sparse`` copied for the port (numpy only).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int64 column indices
    data: np.ndarray  # (nnz,) float64
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int):
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n))
        rows = np.repeat(np.arange(self.n), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.n), np.diff(self.indptr))

    def transpose(self) -> "CSR":
        rows = self.row_ids()
        order = np.lexsort((rows, self.indices))
        new_rows = self.indices[order]
        new_cols = rows[order]
        new_data = self.data[order]
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(indptr, new_rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(indptr=indptr, indices=new_cols, data=new_data, n=self.n)


def csr_from_dense(a: np.ndarray, tol: float = 0.0) -> CSR:
    n = a.shape[0]
    mask = np.abs(a) > tol
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols.astype(np.int64), data=a[rows, cols].astype(np.float64), n=n)


def csr_from_coo(n: int, rows, cols, data) -> CSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    data = np.asarray(data, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    # combine duplicates
    if len(rows) > 0:
        key = rows * n + cols
        uniq, first = np.unique(key, return_index=True)
        summed = np.add.reduceat(data, first)
        rows = uniq // n
        cols = uniq % n
        data = summed
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(indptr=indptr, indices=cols, data=data, n=n)


# ---------------------------------------------------------------------------
# Sparse test-matrix generators (for the paper's Sec. 4.2/4.3 style suites)
# ---------------------------------------------------------------------------


def random_sparse(
    n: int,
    avg_nnz_per_row: float = 6.0,
    d: float = 1.0,
    shuffle: bool = True,
    seed: int = 0,
    structured_band: int | None = None,
) -> CSR:
    """Random sparse matrix with a hidden banded structure.

    Mirrors the provenance of the paper's FE/multibody matrices: a narrow-
    band matrix (e.g. from a 1D/2D stencil) scrambled by a random symmetric
    permutation, so DB/CM reorderings have something to recover.
    ``d`` is the diagonal-dominance degree in the *unscrambled* ordering.
    """
    rng = np.random.default_rng(seed)
    k = structured_band or max(2, int(avg_nnz_per_row) // 2)
    rows, cols, data = [], [], []
    for off in range(1, k + 1):
        keep = rng.random(n - off) < (avg_nnz_per_row / (2.0 * k))
        idx = np.nonzero(keep)[0]
        vals = rng.uniform(-1.0, 1.0, size=idx.shape[0])
        rows.append(idx)
        cols.append(idx + off)
        data.append(vals)
        vals2 = rng.uniform(-1.0, 1.0, size=idx.shape[0])
        rows.append(idx + off)
        cols.append(idx)
        data.append(vals2)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data)
    # diagonal with dominance d
    off_abs = np.zeros(n)
    np.add.at(off_abs, rows, np.abs(data))
    diag = d * np.maximum(off_abs, 1e-3) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    data = np.concatenate([data, diag])
    if shuffle:
        perm = rng.permutation(n)
        rows, cols = perm[rows], perm[cols]
    return csr_from_coo(n, rows, cols, data)
