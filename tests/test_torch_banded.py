"""The port's band-storage utilities against the JAX package.

Generators must be bit-equal (same numpy code, same seed).  The
block-tridiagonal split only moves values, so it is compared exactly;
``band_matvec`` sums in another order than the JAX shifted-diagonal loop,
so it is compared at rtol=1e-5 (float32) / 1e-12 (float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jb
from repro_torch.core import banded as tb


@pytest.mark.parametrize("n,k,d,seed", [(50, 3, 1.0, 0), (37, 5, 0.5, 3), (8, 2, 2.0, 9)])
def test_generators_bit_equal(n, k, d, seed):
    np.testing.assert_array_equal(tb.random_banded(n, k, d, seed), jb.random_banded(n, k, d, seed))
    np.testing.assert_array_equal(
        tb.oscillatory_banded(n, k, d, seed=seed), jb.oscillatory_banded(n, k, d, seed=seed)
    )
    np.testing.assert_array_equal(tb.random_rhs(n, seed), jb.random_rhs(n, seed))
    np.testing.assert_array_equal(
        tb.random_banded(n, k, d, seed, dtype=np.float32),
        jb.random_banded(n, k, d, seed, dtype=np.float32),
    )


@pytest.mark.parametrize("n,k,p", [(48, 3, 4), (50, 3, 4), (37, 5, 3), (16, 2, 1), (41, 4, 8)])
def test_band_to_block_tridiag_equal(n, k, p):
    """Including identity padding (n not a multiple of P*K) and a last
    partition made entirely of padding rows (n=41, k=4, p=8)."""
    band = tb.random_banded(n, k, 1.0, seed=n).astype(np.float32)
    port = tb.band_to_block_tridiag(torch.tensor(band), k, p)
    ref = jb.band_to_block_tridiag(jnp.asarray(band), k, p)
    for name in ("d", "e", "f", "b_cpl", "c_cpl"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert (port.p, port.m, port.k, port.n_pad, port.n) == (ref.p, ref.m, ref.k, ref.n_pad, ref.n)
    np.testing.assert_array_equal(
        tb.block_tridiag_to_dense(port).numpy(), np.asarray(jb.block_tridiag_to_dense(ref))
    )


def test_band_to_block_tridiag_ignores_out_of_matrix_band_entries():
    """Band entries pointing outside the (padded) matrix are dropped, as the
    JAX package's masked scatter drops them."""
    band = np.ones((12, 5), np.float32)
    port = tb.band_to_block_tridiag(torch.tensor(band), 2, 2)
    ref = jb.band_to_block_tridiag(jnp.asarray(band), 2, 2)
    for name in ("d", "e", "f", "b_cpl", "c_cpl"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("r", [None, 3])
def test_band_matvec_matches(dtype, rtol, r):
    n, k = 40, 4
    band = tb.random_banded(n, k, 1.0, seed=2).astype(dtype)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n,) if r is None else (n, r)).astype(dtype)
    port = tb.band_matvec(torch.tensor(band), torch.tensor(x)).numpy()
    dense = tb.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(port, dense @ x.astype(np.float64), rtol=rtol, atol=rtol)
    if dtype == np.float32:
        ref = np.asarray(jb.band_matvec(jnp.asarray(band), jnp.asarray(x)))
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol)


def test_band_matvec_promotes_mixed_precision():
    """float32 band storage times a float64 vector runs in float64."""
    band = tb.random_banded(20, 2, 1.0, seed=1).astype(np.float32)
    x = np.random.default_rng(0).normal(size=20)
    y = tb.band_matvec(torch.tensor(band), torch.tensor(x))
    assert y.dtype == torch.float64
    dense = tb.band_to_dense(torch.tensor(band, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-12)


@pytest.mark.parametrize("d", [1.0, 0.5, 2.0])
def test_diag_dominance_factor_equal(d):
    band = tb.random_banded(30, 3, d, seed=4).astype(np.float32)
    port = float(tb.diag_dominance_factor(torch.tensor(band)))
    ref = float(jb.diag_dominance_factor(jnp.asarray(band)))
    assert port == pytest.approx(ref, rel=1e-6)
    diag = np.zeros((6, 3), np.float32)
    diag[:, 1] = 2.0
    assert float(tb.diag_dominance_factor(torch.tensor(diag))) == float("inf")


def test_dense_band_roundtrip_and_partitioning():
    band = tb.random_banded(9, 2, 1.0, seed=6)
    dense = tb.band_to_dense(torch.tensor(band))
    np.testing.assert_array_equal(
        dense.numpy().astype(np.float32), np.asarray(jb.band_to_dense(jnp.asarray(band, jnp.float32)))
    )
    np.testing.assert_array_equal(tb.dense_to_band(dense, 2).numpy(), band)
    np.testing.assert_array_equal(tb.partition_sizes(10, 3), jb.partition_sizes(10, 3))
    assert tb.padded_partition_size(10, 3, 2) == jb.padded_partition_size(10, 3, 2)
    bp, rp = tb.pad_banded(torch.tensor(band), torch.ones(9, dtype=torch.float64), 12)
    jbp, jrp = jb.pad_banded(jnp.asarray(band, jnp.float32), jnp.ones(9), 12)
    np.testing.assert_array_equal(bp.numpy().astype(np.float32), np.asarray(jbp))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(jrp))
