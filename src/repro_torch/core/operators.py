"""Linear operators: the one matvec interface the solver stack speaks.

``plan_banded`` / ``factor`` / ``solve`` (see :mod:`repro_torch.core.sap`)
exchange matrices through these operator objects.  ``matvec`` accepts a
single vector ``(N,)`` or a trailing-batch matrix ``(N, R)`` of
right-hand-side columns and preserves that shape.
"""

from __future__ import annotations

import dataclasses

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
    """Dense banded matrix in (N, 2K+1) band storage."""

    band: torch.Tensor
    n: int
    k: int

    @classmethod
    def from_band(cls, band: torch.Tensor) -> "BandedOperator":
        n, w = band.shape
        return cls(band=band, n=n, k=(w - 1) // 2)

    @property
    def dtype(self) -> torch.dtype:
        return self.band.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return band_matvec(self.band, x)


def as_matvec(op):
    """Normalize an operator-or-callable into a matvec callable."""
    if isinstance(op, LinearOperator):
        return op.matvec
    mv = getattr(op, "matvec", None)
    return mv if mv is not None else op
