"""The calibration's measuring functions on the CPU, at tiny sizes.

The JAX package has no test of its calibrate module; these hold the
port's to its units (FLOP/s from 2 n^3 flops a GEMM, bytes/s from read +
write bytes a stream pass), its types and its TF32 handling.  The card's
numbers are checked on the card (``tests/test_torch_gpu.py``).
"""

import pytest
import torch

from repro_torch.launch import calibrate as cal
from repro_torch.launch.roofline import BACKEND_SPECS, HardwareSpec, backend_spec


def _one_second(monkeypatch, seen=None):
    def fake(fn, device, repeats, warmup=2):
        fn()
        if seen is not None:
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        return 1.0

    monkeypatch.setattr(cal, "_median_seconds", fake)


@pytest.mark.parametrize("measure", [cal.measure_gemm_flops, cal.measure_bf16_flops])
def test_gemm_rate_counts_two_n_cubed_flops_a_call(monkeypatch, measure):
    _one_second(monkeypatch)
    assert measure(n=16, repeats=1, device="cpu") == 2.0 * 16**3


def test_stream_rate_counts_read_plus_write_bytes(monkeypatch):
    _one_second(monkeypatch)
    assert cal.measure_stream_bw(nbytes=4096, repeats=1, device="cpu") == 2.0 * 4096


def test_gemm_turns_tf32_off_and_restores_it(monkeypatch):
    seen = []
    _one_second(monkeypatch, seen)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        cal.measure_gemm_flops(n=8, repeats=1, device="cpu")
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_median_of_the_host_clock_on_the_cpu():
    calls = []
    sec = cal._median_seconds(lambda: calls.append(1), torch.device("cpu"), repeats=5, warmup=2)
    assert len(calls) == 7 and isinstance(sec, float) and sec >= 0.0


def test_calibrate_on_the_cpu_returns_a_spec():
    spec = cal.calibrate(gemm_n=32, stream_bytes=1 << 16, repeats=3, device="cpu")
    assert isinstance(spec, HardwareSpec) and spec.name == "cpu-calibrated"
    for rate in (spec.peak_flops, spec.hbm_bw, spec.peak_bf16_flops):
        assert isinstance(rate, float) and rate > 0.0


def test_cli_prints_the_env_overrides(capsys):
    assert cal.main(["--device", "cpu", "--gemm-n", "16", "--stream-mib", "1",
                     "--repeats", "2"]) == 0
    out = capsys.readouterr().out
    assert "device         : cpu" in out
    assert "export REPRO_PEAK_FLOPS=" in out and "export REPRO_HBM_BW=" in out


def test_calibration_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cal.calibrate()


def test_spec_table_keys_by_device_type():
    assert set(BACKEND_SPECS) == {"cuda", "cpu"}
    h100 = backend_spec("cuda")
    # measured on the card, below the data sheet's 67 TFLOP/s, 3.35 TB/s
    # and 989 TFLOP/s
    assert h100.peak_flops <= 67e12 and h100.hbm_bw <= 3.35e12 and h100.peak_bf16_flops <= 989e12
    assert backend_spec("mps") is BACKEND_SPECS["cpu"]
