"""The port's SaP preconditioner against the JAX package.

``build_preconditioner`` then ``apply`` on the same block-tridiagonal
split, for D, C (fused off and on, each against the JAX package with the
same ``fused_factor``), E with the chain and with the block cyclic
reduction reduced solver, and whole spikes (``spike_mode="full"``).

Tolerance: the largest difference at most 1e-4 of the largest magnitude
(normwise, float32) -- a factor and two block solves in float32 on each
side, the sums of every block product taken in another order, so a few
ulps per stage compound; the oscillatory d = 0.5 systems of variant E are
ill-conditioned enough that single small entries drift further relative
to themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import banded as jb
from repro.core import spike as js
from repro_torch.core import banded as tb
from repro_torch.core import spike as ts


def _systems(n, k, p, d, seed, osc=False):
    gen = jb.oscillatory_banded if osc else jb.random_banded
    band = gen(n, k, d, seed=seed).astype(np.float32)
    return (
        tb.band_to_block_tridiag(torch.tensor(band), k, p),
        jb.band_to_block_tridiag(jnp.asarray(band), k, p),
    )


def _close(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= 1e-4 * np.abs(ref).max()


CASES = [
    # variant, spike_mode, fused, (n, k, p, d, oscillatory)
    ("D", "ul", "off", (64, 4, 4, 1.0, False)),
    ("C", "ul", "off", (64, 4, 4, 1.0, False)),
    ("C", "ul", "on", (64, 4, 4, 1.0, False)),
    ("C", "full", "off", (60, 3, 4, 1.0, False)),
    ("E", "ul", "off", (72, 3, 6, 0.5, True)),
    ("E", "ul", "on", (72, 3, 6, 0.5, True)),
    ("C", "ul", "on", (41, 4, 8, 2.0, False)),  # last partition all padding
]


@pytest.mark.parametrize("variant,spike_mode,fused,system", CASES)
def test_preconditioner_apply_matches_jax(variant, spike_mode, fused, system):
    n, k, p, d, osc = system
    tbt, jbt = _systems(n, k, p, d, seed=n + p, osc=osc)
    kw = dict(variant=variant, spike_mode=spike_mode, reduced_solver="chain", fused=fused)
    tpc = ts.build_preconditioner(tbt, **kw)
    jpc = js.build_preconditioner(jbt, impl="jnp", **kw)
    assert (tpc.variant, tpc.fused, tpc.reduced_solver) == (jpc.variant, jpc.fused, jpc.reduced_solver)
    for name in ("v_bot", "w_top", "rbar_inv"):
        if getattr(jpc, name) is not None:
            _close(getattr(tpc, name), getattr(jpc, name))
    if jpc.red_lu is not None:
        _close(tpc.red_lu.sinv, jpc.red_lu.sinv)
    rng = np.random.default_rng(p)
    for shape in [(tbt.n_pad,), (tbt.n_pad, 3)]:
        r = rng.normal(size=shape).astype(np.float32)
        _close(tpc.apply(torch.tensor(r)), jpc.apply(jnp.asarray(r)))


def test_apply_keeps_the_residual_dtype():
    """float64 residual in, float32 factors applied, float64 out."""
    tbt, jbt = _systems(64, 4, 4, 1.0, seed=1)
    tpc = ts.build_preconditioner(tbt, variant="C")
    jpc = js.build_preconditioner(jbt, variant="C", impl="jnp")
    r = np.random.default_rng(0).normal(size=tbt.n_pad)
    z = tpc.apply(torch.tensor(r))
    assert z.dtype == torch.float64 and tpc.lu.sinv.dtype == torch.float32
    _close(z.float(), jpc.apply(jnp.asarray(r, jnp.float32)))


def test_exact_variant_solves_the_banded_system():
    """SaP-E applies the exact inverse of the banded preconditioner matrix."""
    n, k, p = 48, 3, 4
    band = tb.oscillatory_banded(n, k, 0.5, seed=2)
    bt = tb.band_to_block_tridiag(torch.tensor(band), k, p)
    pc = ts.build_preconditioner(bt, variant="E", precond_dtype=torch.float64)
    x = torch.tensor(np.random.default_rng(1).normal(size=n))
    z = pc.apply(tb.band_matvec(torch.tensor(band), x))
    torch.testing.assert_close(z, x, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("reduced_solver", ["bcr", "auto"])
def test_exact_preconditioner_with_bcr_matches_jax(reduced_solver):
    """9 partitions: 8 interfaces, so "auto" resolves to BCR in both
    packages, and the apply is the exact inverse either way."""
    tbt, jbt = _systems(90, 2, 9, 0.5, seed=3)
    kw = dict(variant="E", reduced_solver=reduced_solver)
    tpc = ts.build_preconditioner(tbt, **kw)
    jpc = js.build_preconditioner(jbt, impl="jnp", **kw)
    assert tpc.reduced_solver == jpc.reduced_solver == "bcr"
    assert tpc.red_lu is None and tpc.red_bcr.m == 8 and tpc.red_bcr.n_levels == 3
    r = np.random.default_rng(5).normal(size=(tbt.n_pad, 2)).astype(np.float32)
    _close(tpc.apply(torch.tensor(r)), jpc.apply(jnp.asarray(r)))
    chain = ts.build_preconditioner(tbt, variant="E", reduced_solver="chain")
    assert chain.reduced_solver == "chain" and chain.red_bcr is None
    _close(tpc.apply(torch.tensor(r)), chain.apply(torch.tensor(r)).numpy())


def test_resolve_fused_follows_the_device():
    assert ts.resolve_fused("auto", torch.device("cpu")) is False
    assert ts.resolve_fused("auto", torch.device("cuda")) is True
    assert ts.resolve_fused("on", "cpu") is True
    assert ts.resolve_fused(False, "cuda") is False
    with pytest.raises(ValueError):
        ts.resolve_fused("sometimes", "cpu")


def test_single_partition_collapses_to_decoupled():
    tbt, _ = _systems(32, 4, 1, 1.0, seed=4)
    assert ts.build_preconditioner(tbt, variant="C").variant == "D"
    assert ts.build_preconditioner(tbt, variant="E").variant == "D"
    with pytest.raises(ValueError):
        ts.build_preconditioner(tbt, variant="Q")
