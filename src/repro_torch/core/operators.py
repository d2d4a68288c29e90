"""Linear operators: the one matvec interface the solver stack speaks.

``plan`` / ``plan_banded`` / ``factor`` / ``solve`` (see
:mod:`repro_torch.core.sap`) exchange matrices through these operator
objects:

* :class:`BandedOperator` -- (N, 2K+1) band storage; matvec is the
  shifted-diagonal product.
* :class:`CsrOperator`   -- general sparse matrices in expanded-COO form
  on the device; matvec is a gather and an ``index_add_`` scatter.

``matvec`` accepts a single vector ``(N,)`` or a trailing-batch matrix
``(N, R)`` of right-hand-side columns and preserves that shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .banded import band_matvec


class LinearOperator:
    """Marker base class: anything with ``.n``, ``.dtype`` and ``.matvec``."""

    n: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)


@dataclasses.dataclass(eq=False)
class BandedOperator(LinearOperator):
    """Dense banded matrix in (N, 2K+1) band storage, or a stack of S of
    them (S, N, 2K+1) whose matvec takes (S, N) or (S, N, R)."""

    band: torch.Tensor
    n: int
    k: int

    @classmethod
    def from_band(cls, band: torch.Tensor) -> "BandedOperator":
        n, w = band.shape[-2:]
        return cls(band=band, n=n, k=(w - 1) // 2)

    @property
    def dtype(self) -> torch.dtype:
        return self.band.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return band_matvec(self.band, x)


@dataclasses.dataclass(eq=False)
class CsrOperator(LinearOperator):
    """Sparse matrix as device-resident expanded COO (rows, cols, data)."""

    data: torch.Tensor  # (nnz,)
    rows: torch.Tensor  # (nnz,) int64 row id per entry
    cols: torch.Tensor  # (nnz,) int64 column index per entry
    n: int

    @classmethod
    def from_csr(cls, csr, dtype=None, device=None) -> "CsrOperator":
        """Build from a host-side :class:`repro_torch.core.sparse.CSR`.

        ``dtype`` defaults to the default float dtype (float32 unless the
        caller changed it), as the JAX package stores the canonical float;
        ``device`` is where the three tensors go.
        """
        dtype = dtype or torch.get_default_dtype()
        return cls(
            data=torch.tensor(csr.data, dtype=dtype, device=device),
            rows=torch.tensor(csr.row_ids(), dtype=torch.int64, device=device),
            cols=torch.tensor(csr.indices, dtype=torch.int64, device=device),
            n=csr.n,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        data = self.data.to(x.dtype)
        prod = data[:, None] * x[self.cols] if x.ndim == 2 else data * x[self.cols]
        return x.new_zeros((self.n,) + tuple(x.shape[1:])).index_add_(0, self.rows, prod)

    def to_csr(self):
        """Reconstruct a host-side CSR (sorts and merges the COO entries,
        so operators built from unsorted triplets round-trip correctly)."""
        from .sparse import csr_from_coo

        return csr_from_coo(
            self.n,
            self.rows.cpu().numpy(),
            self.cols.cpu().numpy(),
            self.data.cpu().double().numpy(),
        )


def require_square_dense(a) -> None:
    """Reject raw arrays that are not dense square matrices.

    Band-storage (N, 2K+1) arrays are ambiguous with dense matrices, so
    raw arrays are only accepted when square; band storage must be wrapped
    explicitly.
    """
    if np.ndim(a) != 2 or a.shape[0] != a.shape[1]:
        raise TypeError(
            f"raw arrays must be dense square matrices, got shape "
            f"{tuple(np.shape(a))}; use BandedOperator.from_band / plan_banded "
            f"for (N, 2K+1) band storage"
        )


def as_matvec(op):
    """Normalize an operator-or-callable into a matvec callable."""
    if isinstance(op, LinearOperator):
        return op.matvec
    mv = getattr(op, "matvec", None)
    return mv if mv is not None else op


def as_operator(a, device=None) -> LinearOperator:
    """Coerce ``a`` into a :class:`LinearOperator`.

    Accepts an operator (returned as-is), a host CSR / scipy sparse matrix,
    or a dense (N, N) array or tensor, put on ``device`` (default: the
    card).  Band-storage arrays are ambiguous with dense matrices -- wrap
    those explicitly with :meth:`BandedOperator.from_band`.
    """
    if isinstance(a, LinearOperator):
        return a
    from . import reorder as reorder_mod  # local imports: no cycles
    from .sap import resolve_device

    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    if isinstance(a, np.ndarray):
        require_square_dense(a)
    return CsrOperator.from_csr(reorder_mod.to_csr(a), device=dev)
