"""The preconditioner's storage dtypes against the JAX package.

bfloat16 and float64 storage through the port's solver kernels' plain
versions (the CPU path of every wrapper, and the yardstick the card's
bfloat16 and float64 instantiations are held against) and through the
lifecycle, on the same numpy inputs as the JAX package:

* bfloat16 btf, the fused pass and BCR (factor and solve, level by level)
  equal the Pallas kernels run in interpret mode bit for bit: both compute
  in float32 from the same bfloat16 inputs and round each output once, and
  measured at these shapes every sum lands on the same bits.
* bfloat16 bts is within one bfloat16 step of the largest value: the
  Pallas bts stores the forward sweep's y in bfloat16 between its two
  ``pallas_call``s (``repro/kernels/bts.py``), the port keeps y in float32
  (as its CUDA kernel does), so x moves by up to a step of y's scale.
* float64 BCR equals the JAX jnp path under ``jax.enable_x64`` within
  1e-12 (btf, bts and the fused pass in float64:
  ``test_torch_block_lu.py``).
* The lifecycle at N = 600, K = 5, P = 4, d = 1.0: a float64
  preconditioner under BiCGStab(2) at tol 1e-10 reaches a true residual
  below 1e-9 in both packages, x within 1e-8; a bfloat16 preconditioner
  under ``solver="refine"`` reaches tol in both, sweeps within one; under
  BiCGStab(2) both stop with ``converged`` at a true residual of about
  2^-8 (R11: the apply rounds the Krylov vector to bfloat16), which the
  test pins to [1e-4, 1e-2] and never reads the flag.
* ``check_operands`` takes bfloat16 and float64 and refuses float16,
  integers and mixed block dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import cyclic_reduction as jcr
from repro.kernels import ops as jops
from repro.kernels.bcr import bcr_factor_pallas, bcr_solve_pallas
import repro_torch as RT
import repro_torch.core as T
from repro_torch.core import block_lu as tbl
from repro_torch.kernels import _launch
from repro_torch.kernels import ops as tops

BF16_STEP = 2.0**-7  # a bfloat16 step is at most 2^-7 of the value


def _chain(rng, p, m, k):
    d = rng.normal(size=(p, m, k, k)) + 4 * np.eye(k)
    e = rng.normal(size=(p, m, k, k)) * 0.3
    f = rng.normal(size=(p, m, k, k)) * 0.3
    e[:, 0] = 0.0
    f[:, m - 1] = 0.0
    b_cpl = rng.normal(size=(p - 1, k, k)) * 0.3
    c_cpl = rng.normal(size=(p - 1, k, k)) * 0.3
    return tuple(x.astype(np.float32) for x in (d, e, f, b_cpl, c_cpl))


def _jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tbf(x):
    return torch.tensor(x).bfloat16()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bit_equal(port, ref, what):
    assert port.dtype == torch.bfloat16, what
    np.testing.assert_array_equal(_f32(port), _f32(ref), err_msg=what)


def test_bfloat16_btf_and_fused_equal_the_interpret_kernels():
    rng = np.random.default_rng(0)
    d, e, f, b_cpl, c_cpl = _chain(rng, 2, 3, 8)
    jf = jops.block_tridiag_factor(_jbf(d), _jbf(e), _jbf(f), impl="interpret")
    tf = tops.block_tridiag_factor(_tbf(d), _tbf(e), _tbf(f))
    _bit_equal(tf.sinv, jf.sinv, "sinv")
    _bit_equal(tf.l, jf.l, "l")
    jfs = jops.fused_factor_spike(*map(_jbf, (d, e, f, b_cpl, c_cpl)), impl="interpret")
    tfs = tops.fused_factor_spike(*map(_tbf, (d, e, f, b_cpl, c_cpl)))
    _bit_equal(tfs.lu.sinv, jfs.lu.sinv, "fused sinv")
    _bit_equal(tfs.lu.l, jfs.lu.l, "fused l")
    for name in ("v_bot", "v_top", "w_top", "w_bot"):
        _bit_equal(getattr(tfs, name), getattr(jfs, name), name)


@pytest.mark.parametrize("r", [1, 2])
def test_bfloat16_bts_within_one_step_of_the_interpret_kernel(r):
    """The same bfloat16 factors (the interpret kernel's) through both
    sweeps: x within one bfloat16 step of its largest value (the Pallas
    kernel's y is rounded to bfloat16, the port's is not)."""
    rng = np.random.default_rng(1)
    d, e, f, _, _ = _chain(rng, 2, 3, 8)
    b = rng.normal(size=(2, 3, 8, r)).astype(np.float32)
    jf = jops.block_tridiag_factor(_jbf(d), _jbf(e), _jbf(f), impl="interpret")
    jx = jops.block_tridiag_solve(jf, _jbf(b), impl="interpret")
    tf = tbl.BTFactors(*(_tbf(_f32(x)) for x in (jf.sinv, jf.l, jf.f)))
    tx = tops.block_tridiag_solve(tf, _tbf(b))
    assert tx.dtype == torch.bfloat16
    want = _f32(jx)
    assert np.abs(_f32(tx) - want).max() <= BF16_STEP * np.abs(want).max()


def _bcr_chain(m, k, r, seed):
    rng = np.random.default_rng(seed)
    sc = min(1.0, 8 / k)  # keeps the 4 I shift dominant at K = 37 (B3)
    d = sc * rng.normal(size=(m, k, k)) + 4 * np.eye(k)
    e = sc * rng.normal(size=(m, k, k)) * 0.3
    f = sc * rng.normal(size=(m, k, k)) * 0.3
    b = rng.normal(size=(m, k, r))
    return d, e, f, b


@pytest.mark.parametrize("m,k,r", [(3, 37, 2)])
def test_bfloat16_bcr_equals_the_interpret_kernels(m, k, r):
    """Every level leaf, the root inverse and x: bit for bit (measured; the
    tolerance is zero)."""
    d, e, f, b = (x.astype(np.float32) for x in _bcr_chain(m, k, r, seed=m + k))
    jf = bcr_factor_pallas(_jbf(d), _jbf(e), _jbf(f), interpret=True, lane_pad=False)
    jx = bcr_solve_pallas(jf, _jbf(b), interpret=True, lane_pad=False)
    tf = tops.bcr_factor(_tbf(d), _tbf(e), _tbf(f))
    for tl, jl in zip(tf.levels, jf.levels):
        for name in tl._fields:
            _bit_equal(getattr(tl, name), getattr(jl, name), name)
    _bit_equal(tf.root_inv, jf.root_inv, "root_inv")
    _bit_equal(tops.bcr_solve(tf, _tbf(b)), jx, "x")


@pytest.mark.parametrize("m,k,r", [(3, 8, 2)])
def test_float64_bcr_matches_jax_in_float64(m, k, r):
    d, e, f, b = _bcr_chain(m, k, r, seed=10 * m + k)
    tf = tops.bcr_factor(*(torch.tensor(x) for x in (d, e, f)))
    tx = tops.bcr_solve(tf, torch.tensor(b))
    assert tx.dtype == torch.float64 and tf.root_inv.dtype == torch.float64
    with jax.enable_x64(True):
        jf = jcr.bcr_factor(*(jnp.asarray(x) for x in (d, e, f)))
        jx = jcr.bcr_solve(jf, jnp.asarray(b))
        assert jf.root_inv.dtype == jnp.float64
        for tl, jl in zip(tf.levels, jf.levels):
            for name in tl._fields:
                np.testing.assert_allclose(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                           rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-12)


# ---- the lifecycle ----------------------------------------------------------


def _system():
    n, k = 600, 5
    band = J.random_banded(n, k, 1.0, seed=3).astype(np.float64)
    dense = T.band_to_dense(torch.tensor(band)).numpy()
    b = dense @ np.random.default_rng(4).normal(size=n)
    return band, b


def _both(precond_dtype, solver, tol):
    band, b = _system()
    kw = dict(p=4, variant="C", tol=tol, maxiter=200, precond_dtype=precond_dtype, solver=solver)
    with jax.enable_x64(True):
        jres = J.factor(J.plan_banded(jnp.asarray(band), J.SaPOptions(**kw))).solve(jnp.asarray(b))
        jout = (float(jres.true_resnorm), float(jres.iterations), np.asarray(jres.x))
    tfac = RT.factor(RT.plan_banded(band, T.SaPOptions(**kw), device="cpu"))
    assert tfac.pc.lu.sinv.dtype == getattr(torch, precond_dtype)
    tres = tfac.solve(b)
    assert tres.x.dtype == torch.float64
    return (float(tres.true_resnorm), float(tres.iterations), tres.x.numpy()), jout


def test_float64_preconditioner_reaches_float64_accuracy_in_both():
    (t_res, _, tx), (j_res, _, jx) = _both("float64", "bicgstab2", 1e-10)
    assert t_res <= 1e-9 and j_res <= 1e-9
    assert np.abs(tx - jx).max() <= 1e-8


def test_bfloat16_preconditioner_with_refinement_reaches_tol_in_both():
    (t_res, t_it, _), (j_res, j_it, _) = _both("bfloat16", "refine", 1e-8)
    assert t_res <= 1e-8 and j_res <= 1e-8
    assert abs(t_it - j_it) <= 1.0


def test_bfloat16_preconditioner_under_bicgstab2_stops_near_2_to_the_minus_8():
    """R11: the reference reports convergence at a true residual of about
    2^-8 (its apply rounds the Krylov vector to the preconditioner's
    dtype); the port reproduces it.  The flag is not compared."""
    (t_res, _, _), (j_res, _, _) = _both("bfloat16", "bicgstab2", 1e-10)
    assert 1e-4 <= t_res <= 1e-2 and 1e-4 <= j_res <= 1e-2


# ---- the operand checks -------------------------------------------------------


def test_check_operands_takes_the_solver_dtypes_and_refuses_the_rest():
    d = torch.randn(2, 3, 4, 4)
    for dt in _launch.SOLVER_DTYPES:
        x = d.to(dt)
        assert _launch.check_operands("btf", d.device, _launch.SOLVER_DTYPES, d=x, e=x, f=x) == dt
    with pytest.raises(TypeError, match="float32 or bfloat16 or float64"):
        _launch.check_operands("btf", d.device, _launch.SOLVER_DTYPES, d=d.half(), e=d.half())
    with pytest.raises(TypeError, match="storage"):
        _launch.check_operands("btf", d.device, _launch.SOLVER_DTYPES, d=d.int())
    with pytest.raises(TypeError, match="one storage dtype"):
        _launch.check_operands("btf", d.device, _launch.SOLVER_DTYPES, d=d.double(), e=d)
    r = torch.randn(2, 8, 4)
    assert _launch.check_operands("wkv6", r.device, _launch.SCAN_DTYPES, r=r.bfloat16()) == (
        torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _launch.check_operands("wkv6", r.device, _launch.SCAN_DTYPES, r=r.double())
