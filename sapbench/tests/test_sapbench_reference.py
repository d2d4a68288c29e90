"""The plain reference against dense torch on tiny systems."""

import pytest
import torch

from sapbench.harness import make_bands
from sapbench.reference import banded


def _dense(band: torch.Tensor) -> torch.Tensor:
    n, w = band.shape
    k = (w - 1) // 2
    a = torch.zeros((n, n), dtype=torch.float64)
    for r in range(n):
        for j in range(w):
            c = r - k + j
            if 0 <= c < n:
                a[r, c] = band[r, j]
    return a


@pytest.mark.parametrize("n, k, d", [(48, 4, 1.0), (50, 4, 0.5), (37, 3, 0.5)])
def test_solve_and_matvec_match_dense(n, k, d):
    bands = make_bands(2, n, k, d, seed=7, device="cpu")
    rhs = torch.randn((2, n, 3), generator=torch.Generator().manual_seed(1))
    x = banded.solve(bands, rhs)
    for s in range(2):
        a = _dense(bands[s])
        assert torch.allclose(x[s], torch.linalg.solve(a, rhs[s].double()), rtol=1e-10, atol=1e-12)
        assert torch.allclose(banded.matvec(bands[s:s + 1], x[s:s + 1])[0], a @ x[s], atol=1e-12)


def test_tf32_control_is_worse_than_float32_and_float64():
    bands = make_bands(1, 64, 4, 1.0, seed=3, device="cpu")
    rhs = torch.randn((1, 64, 2), generator=torch.Generator().manual_seed(2))
    exact = banded.solve(bands, rhs)

    def err(x):
        return float(torch.linalg.vector_norm(x.double() - exact) / torch.linalg.vector_norm(exact))

    f32 = err(banded.solve(bands, rhs, dtype=torch.float32))
    tf32 = err(banded.solve(bands, rhs, dtype=torch.float32, tf32=True))
    assert f32 < 1e-5 < 1e-4 < tf32 < 1e-2


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0000002])
    y = banded._tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]
