"""The port's flash attention against the JAX package's, on the CPU.

``flash_attention_ref`` (the plain version of the CUDA kernel) and
``ops.flash_attention`` on CPU tensors against the TPU kernel
``repro.kernels.flash_attn.flash_attention_pallas`` run in interpret mode
at the kernel's 64 x 64 tiles: the cases of ``tests/test_kernels.py``
(causal, GQA, GQA + window, bidirectional), a head dim of 24, a window
smaller than a tile, and rows with no visible key (Tq > Tk under a
window), where the result is set by the tile skip and the finite
``NEG_INF``.  Then against ``repro.models.layers.flash_attention`` at a
ragged Tk, and the wrapper's launch counter and operand checks.

Tolerance: rtol 2e-4, atol 2e-5, as ``tests/test_kernels.py`` holds the
TPU kernel to dense attention -- the same float32 online softmax with the
sums taken in another order.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_pallas
from repro.models import layers as jl
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attn import check_card_operands, flash_attention
from repro_torch.kernels.ref import flash_attention_ref

TOL = dict(rtol=2e-4, atol=2e-5)

# (b, hq, hk, tq, tk, d, causal, window)
PALLAS_CASES = [
    (1, 2, 2, 128, 128, 16, True, None),
    (2, 4, 2, 128, 128, 32, True, None),  # GQA
    (1, 4, 1, 256, 256, 16, True, 64),  # GQA + sliding window
    (1, 2, 2, 128, 128, 16, False, None),  # bidirectional (encoder)
    (1, 2, 1, 128, 128, 24, True, None),  # head dim not a power of two
    (1, 6, 2, 256, 256, 16, True, 16),  # GQA + a window smaller than a tile
    (1, 2, 1, 256, 128, 16, True, 40),  # rows past Tk + window - 1 see no key
]


def _qkv(b, hq, hk, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, tq, d)).astype(np.float32),
            rng.normal(size=(b, hk, tk, d)).astype(np.float32),
            rng.normal(size=(b, hk, tk, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", PALLAS_CASES)
def test_plain_version_and_cpu_wrapper_match_the_tpu_kernel(b, hq, hk, tq, tk, d, causal, window):
    q, k, v = _qkv(b, hq, hk, tq, tk, d, seed=7)
    want = np.asarray(flash_attention_pallas(q, k, v, causal=causal, window=window,
                                             block_q=64, block_k=64, interpret=True))
    t = torch.tensor
    got = flash_attention_ref(t(q), t(k), t(v), causal, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the entry point takes the strided layout RoPE and the head transpose leave
    qs = t(q).transpose(2, 3).contiguous().transpose(2, 3)
    assert not qs.is_contiguous()
    got = ops.flash_attention(qs, t(k), t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("tq,tk,window,block_k", [(40, 40, None, 16), (37, 101, 8, 32),
                                                  (100, 100, 30, 64)])
def test_plain_version_matches_the_jax_chunked_attention(tq, tk, window, block_k):
    """Ragged Tk (not a multiple of the tile): keys past Tk are masked."""
    q, k, v = _qkv(2, 4, 2, tq, tk, 16, seed=3)
    want = np.asarray(jl.flash_attention(q, k, v, causal=True, window=window, block_k=block_k))
    t = torch.tensor
    for got in (flash_attention_ref(t(q), t(k), t(v), True, window),
                flash_attention(t(q), t(k), t(v), True, window)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    non_causal = np.asarray(jl.flash_attention(q, k, v, causal=False, window=window,
                                               block_k=block_k))
    np.testing.assert_allclose(flash_attention_ref(t(q), t(k), t(v), False, window).numpy(),
                               non_causal, **TOL)


def test_bfloat16_inputs_give_bfloat16_rounded_like_torch():
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(1, 2, 1, 128, 128, 16, seed=5))
    got = flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    f32 = flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(got, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_calls_use_the_plain_version_and_do_not_count(monkeypatch):
    def no_build(name):
        raise AssertionError(f"kernel {name} must not be built for a CPU tensor")

    monkeypatch.setattr(build, "load", no_build)
    before = flash_attention.launches
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 64, 64, 8, seed=1))
    torch.testing.assert_close(flash_attention(q, k, v, True, 16),
                               flash_attention_ref(q, k, v, True, 16), rtol=0, atol=0)
    ops.flash_attention(q, k, v)
    assert flash_attention.launches == before


def test_operands_the_kernel_does_not_take_are_refused():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 64, 64, 16, seed=2))
    with pytest.raises(ValueError, match="multiple of Hk"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="fit together"):
        flash_attention(q, k, v[..., :8])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    # the card's checks, run before any launch
    check_card_operands(q, k, v)
    check_card_operands(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        check_card_operands(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="q is"):
        check_card_operands(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        check_card_operands(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    for d in (12, 136):
        qd, kd, vd = (torch.zeros(1, 2, 8, d) for _ in range(3))
        with pytest.raises(ValueError, match="head dim"):
            check_card_operands(qd, kd, vd)


def test_hi_lo_bfloat16_split_of_p_keeps_about_16_bits():
    """The tensor-core kernel's p . v: p in two bfloat16 terms, hi = bf16(p)
    and lo = bf16(p - hi), each product exact and summed in float32,
    against float32 p . v: within 2^-16 of sum |p| |v| for every output.
    One bfloat16 p, as SDPA rounds it, is off by up to 2^-9 of a term."""
    rng = np.random.default_rng(11)
    p = np.exp(-rng.exponential(3.0, size=(64, 64))).astype(np.float32)  # (0, 1]
    p[:, 0] = 1.0  # a row's maximum
    p[:4] *= 1e-20  # rows far below their maximum
    v = torch.tensor(rng.normal(size=(64, 128)).astype(np.float32)).bfloat16().float()
    pt = torch.tensor(p)
    hi = pt.bfloat16().float()
    lo = (pt - hi).bfloat16().float()
    got = hi @ v + lo @ v
    exact = pt.double() @ v.double()
    scale = pt.double().abs() @ v.double().abs()
    assert float(((got.double() - exact) / scale).abs().max()) <= 2.0**-16
    one = hi.double() @ v.double()
    assert float(((one - exact) / scale).abs().max()) > 2.0**-16


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch only when run)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b,hq,hk,tq,tk,d,causal,window", [
    (1, 4, 2, 100, 100, 16, True, None),  # causal
    (2, 3, 3, 90, 90, 8, True, 16),  # causal with a window
    (1, 2, 1, 37, 70, 24, False, None),  # Tq != Tk, bidirectional
    (1, 2, 2, 70, 37, 8, True, 5),  # Tq > Tk, causal, windowed
])
def test_flash_work_counts_the_pairs_the_masks_leave(b, hq, hk, tq, tk, d, causal, window):
    """flash_work's exponentials are the visible (query, key) pairs of an
    explicit mask, times B Hq; its tensor-core operations 4 D a pair; its
    bytes q, k, v and o once."""
    smoke = _chip_smoke()
    t, s = np.arange(tq)[:, None], np.arange(tk)[None, :]
    mask = np.ones((tq, tk), dtype=bool)
    if causal:
        mask &= t >= s
    if window:
        mask &= t - s < window
    tc_ops, exps, nbytes = smoke.flash_work(b, hq, hk, tq, tk, d, causal, window, 2)
    assert exps == b * hq * int(mask.sum())
    assert tc_ops == 4 * d * exps
    assert nbytes == 2 * (2 * b * hq * tq * d + 2 * b * hk * tk * d)
    # the data sheet's rates, as the smoke's bound_ms takes them (its
    # bound_ms_calibrated passes the measured ones the same way)
    from repro_torch.launch.roofline import H100_DATASHEET as sheet
    from repro_torch.launch.roofline import H100_DATASHEET_SFU_S as sfu

    ms, by = smoke.flash_bound(tc_ops, exps, nbytes, sheet.hbm_bw, sheet.peak_bf16_flops, sfu)
    assert (sheet.hbm_bw, sheet.peak_bf16_flops, sfu) == (3.35e12, 989e12, 3.9e12)
    assert ms == max(nbytes / sheet.hbm_bw, tc_ops / sheet.peak_bf16_flops,
                     exps / sfu) * 1e3 and by in ("bytes", "operations")
