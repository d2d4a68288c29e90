"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; run them on a machine with a card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.  Each
test skips inside the ``cuda`` fixture when there is no card, so every
pytest worker collects the same tests.

Tolerance: the largest difference at most 1e-4 of the largest plain value
-- the same float32 recurrences with the K x K product sums taken in
another order, compounding over the M block rows.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SaPOptions, band_to_block_tridiag, factor, plan_banded, random_banded
from repro_torch.core import block_lu as bl
from repro_torch.kernels import ops
from repro_torch.kernels.btf import btf
from repro_torch.kernels.bts import bts
from repro_torch.kernels.fused_spike import fused_factor_spike

pytestmark = pytest.mark.gpu

# (n, k, p).  At K = 256 the K x K elimination block does not fit in one
# block's shared memory, so btf and the fused pass eliminate in device
# memory (and the fused pass keeps its fourth workspace slot there).
SHAPES = [(15, 5, 4), (259, 37, 3), (3200, 20, 8), (12800, 200, 4), (1400, 256, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(kernel, plain):
    assert bool(torch.isfinite(kernel).all())
    diff = (kernel.double() - plain.double()).abs().max()
    assert float(diff) <= 1e-4 * max(float(plain.double().abs().max()), 1e-30)


def _split(cuda, n, k, p):
    band = torch.tensor(random_banded(n, k, 1.0, seed=n).astype(np.float32), device=cuda)
    return band_to_block_tridiag(band, k, p)


@pytest.mark.parametrize("n,k,p", SHAPES)
def test_btf_kernel_matches_plain(cuda, n, k, p):
    bt = _split(cuda, n, k, p)
    before = btf.launches
    sinv, l = btf(bt.d, bt.e, bt.f)
    assert btf.launches == before + 1
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    _close(sinv, ref.sinv)
    _close(l, ref.l)


@pytest.mark.parametrize("n,k,p", SHAPES)
@pytest.mark.parametrize("r", [1, 4, "k"])
def test_bts_kernel_matches_plain(cuda, n, k, p, r):
    bt = _split(cuda, n, k, p)
    ref = bl.btf_ref(bt.d, bt.e, bt.f)
    rhs = torch.randn(bt.d.shape[:3] + (k if r == "k" else r,), device=cuda)
    _close(bts(ref.sinv, ref.l, bt.f, rhs), bl.bts_ref(ref, rhs))


@pytest.mark.parametrize("n,k,p", SHAPES)
def test_fused_kernel_matches_plain(cuda, n, k, p):
    bt = _split(cuda, n, k, p)
    bq, cq = bl.pad_couplings(bt.b_cpl, bt.c_cpl, p)
    for got, want in zip(fused_factor_spike(bt.d, bt.e, bt.f, bq, cq),
                         bl.fused_factor_spike_padded_ref(bt.d, bt.e, bt.f, bq, cq)):
        _close(got, want)


def test_chain_kernels_at_block_size_400(cuda):
    """The SaP-E reduced chain factors 2K x 2K = 400 x 400 blocks, whose
    elimination works out of device memory."""
    bt = _split(cuda, 8 * 7 * 200, 200, 8)
    fs = ops.fused_factor_spike(bt.d, bt.e, bt.f, bt.b_cpl, bt.c_cpl)
    from repro_torch.core.spike import _reduced_interface_system

    rd, re, rf = _reduced_interface_system(fs.v_bot, fs.v_top, fs.w_top, fs.w_bot)
    got = ops.block_tridiag_factor_chain(rd, re, rf)
    want = bl.btf_chain(rd, re, rf)
    _close(got.sinv, want.sinv)
    h = torch.randn(rd.shape[0], 400, 1, device=cuda)
    _close(ops.block_tridiag_solve_chain(got, h), bl.bts_chain(want, h))


def test_k256_elimination_block_lives_in_device_memory(cuda):
    """The K = 256 shapes above take the device-memory layout: btf needs a
    K x K workspace per partition, the fused pass four slots per side."""
    from repro_torch.kernels import build

    assert build.load("btf").btf_workspace_floats(256) == 256 * 256
    assert build.load("fused_spike").fused_workspace_floats(256) == 2 * 4 * 256 * 256
    assert build.load("btf").btf_workspace_floats(200) == 0


def test_wrappers_reject_non_float32(cuda):
    bt = _split(cuda, 64, 4, 2)
    with pytest.raises(TypeError):
        btf(bt.d.double(), bt.e.double(), bt.f.double())


@pytest.mark.parametrize("variant", ["C", "D", "E"])
def test_lifecycle_on_the_card_matches_the_cpu(cuda, variant):
    band = random_banded(4000, 10, 1.0 if variant != "E" else 0.5, seed=1).astype(np.float32)
    b = np.random.default_rng(2).normal(size=4000)
    opts = SaPOptions(p=8, variant=variant, tol=1e-8)
    gpu = factor(plan_banded(band, opts)).solve(b)
    cpu = factor(plan_banded(band, opts, device="cpu")).solve(b)
    assert float(gpu.true_resnorm) <= 1e-6
    x_gpu, x_cpu = gpu.x.cpu(), cpu.x
    assert float((x_gpu - x_cpu).norm() / x_cpu.norm()) <= 1e-5
