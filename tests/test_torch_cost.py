"""The port's cost model against the JAX package's, on the CPU.

``repro_torch.obs.cost`` counts stage costs analytically (the port has no
HLO): the leading-order ``*_flops`` equal ``repro.kernels.ops``' exactly,
and the JAX package's HLO-derived btf, bts and bcr flops at its test
bucket lie 1x-20x above the port's counts -- the band
``tests/test_cost.py`` holds the HLO walk to against the same algebra.
Then the roofline arithmetic, the stage dict and its cache, and
``cost_accounting`` on the engine and the service.
"""

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.banded import random_banded
from repro.kernels import ops as jops
from repro.obs import cost as jcost
from repro_torch.kernels import ops as tops
from repro_torch.launch import calibrate as tcal
from repro_torch.obs import Tracer, use_tracer
from repro_torch.obs import cost
from repro_torch.serve import AsyncSolverService, SolverEngine

OPTS = T.SaPOptions(p=4, variant="C", tol=1e-6, maxiter=50)
BUCKET = (256, 4, 4)


# ---------------------------------------------------------------------------
# hardware model
# ---------------------------------------------------------------------------


def test_hardware_spec_defaults(monkeypatch):
    assert cost.hardware_spec("cuda").name == "cuda-h100-calibrated"
    assert cost.hardware_spec("cpu").name == "cpu-calibrated"
    assert cost.hardware_spec("cuda").peak_flops > cost.hardware_spec("cpu").peak_flops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cost.hardware_spec() == cost.hardware_spec("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cost.hardware_spec() == cost.hardware_spec(torch.device("cuda"))


def test_hardware_spec_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("REPRO_HBM_BW", "2e12")
    hw = cost.hardware_spec("cpu")
    assert hw.peak_flops == 1e15
    assert hw.hbm_bw == 2e12
    assert hw.name.endswith("+env")


def test_hardware_spec_calibrates_once_and_env_wins(monkeypatch):
    calls = []

    def fake(device=None, **sizes):
        calls.append((device, sizes))
        return cost.HardwareSpec("cpu-calibrated", 3.0e9, 7.0e9, 5.0e9)

    monkeypatch.setattr(tcal, "calibrate", fake)
    monkeypatch.setattr(cost, "_CALIBRATED", {})
    monkeypatch.setenv("REPRO_CALIBRATE", "1")
    assert cost.hardware_spec("cpu").peak_flops == 3.0e9
    assert cost.hardware_spec("cpu").hbm_bw == 7.0e9
    assert calls == [("cpu", {"gemm_n": 1024, "stream_bytes": 1 << 28})]
    monkeypatch.setenv("REPRO_HBM_BW", "1e10")
    assert cost.hardware_spec("cpu").hbm_bw == 1e10 and len(calls) == 1


def test_device_memory_bytes_is_zero_on_the_cpu():
    x = torch.ones(128, 128)
    assert cost.device_memory_bytes("cpu") == 0
    del x


# ---------------------------------------------------------------------------
# StageCost arithmetic
# ---------------------------------------------------------------------------


def test_stage_cost_roofline_identity():
    hw = cost.hardware_spec("cpu")
    c = cost.stage_cost("add", flops=32 * 32, hbm_bytes=2 * 32 * 32 * 4, hw=hw)
    assert c.roofline_s == max(c.compute_s, c.memory_s)
    assert c.compute_s == 32 * 32 / hw.peak_flops and c.memory_s == 8192 / hw.hbm_bw
    assert c.bottleneck == "memory" and c.intensity == pytest.approx(1 / 8)
    g = cost.stage_cost("gemm", flops=2.0 * 512**3, hbm_bytes=3 * 512 * 512 * 4, hw=hw)
    assert g.bottleneck == "compute"


def test_stage_cost_scale_and_per_iteration():
    c = cost.stage_cost("mul", flops=2560.0, hbm_bytes=20480.0, loop_iters=10)
    one = c.per_iteration()
    assert one.flops == pytest.approx(c.flops / 10)
    assert one.loop_iters is None
    tripled = one.scale(3)
    assert tripled.flops == pytest.approx(3 * one.flops)
    assert tripled.roofline_s == pytest.approx(3 * one.roofline_s)
    d = tripled.to_dict(measured_s=2 * tripled.roofline_s)
    assert d["roofline_frac"] == pytest.approx(0.5, rel=1e-3)
    assert "xla_flops" not in d and "loop_iters" not in d
    assert c.to_dict()["loop_iters"] == 10


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,m,k", [(4, 16, 4), (64, 16, 200), (16, 64, 16), (3, 1, 37)])
def test_flop_counts_equal_the_jax_package(p, m, k):
    assert tops.gj_inverse_flops(k) == jops.gj_inverse_flops(k)
    assert tops.btf_flops(p, m, k) == jops.btf_flops(p, m, k)
    for r in (1, 4):
        assert tops.bts_flops(p, m, k, r) == jops.bts_flops(p, m, k, r)
    assert tops.fused_factor_spike_flops(p, m, k) == jops.fused_factor_spike_flops(p, m, k)
    assert tops.bcr_flops(p * m, 2 * k) == jops.bcr_flops(p * m, 2 * k)


def test_work_counts_give_the_recorded_datasheet_bounds():
    """The smoke's bounds at the main path's shape (P=64, M=16, K=200)
    against the data sheet's 67 TFLOP/s and 3.35 TB/s, as recorded before
    the counts moved into ``kernels/ops.py``."""
    flops, _ = tops.btf_work(64, 16, 200)
    assert round(flops / 67e12 * 1e3, 4) == 0.7036
    _, nbytes = tops.bts_work(64, 16, 200, 1)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.1411
    flops, _ = tops.fused_work(64, 16, 200)
    assert round(flops / 67e12 * 1e3, 3) == 1.927
    work = tops.bcr_work(63, 400, 1)
    assert round(work["inv_odd"][0] / 67e12 * 1e3, 4) == 0.1223
    assert round(work["reduce"][0] / 67e12 * 1e3, 4) == 0.7225
    level = tops.reduce_level_work(32, 400)
    assert level == tuple(x * 32 / 63 for x in work["reduce"])
    solve = tops.solve_level_work(32, 400, 1)
    assert solve["backsub"] == tuple(x * 32 / 63 for x in work["backsub"])


@pytest.mark.parametrize("stage,jax_opts", [
    ("btf", J.SaPOptions(p=4, variant="C", tol=1e-6, maxiter=50)),
    ("bts", J.SaPOptions(p=4, variant="C", tol=1e-6, maxiter=50)),
    ("bcr", J.SaPOptions(p=4, variant="E", reduced_solver="bcr", tol=1e-6, maxiter=50)),
])
def test_jax_hlo_flops_within_the_analytic_band_of_the_port(stage, jax_opts):
    """The HLO walk counts every lowered op, so it sits above the port's
    analytic count -- by a bounded factor."""
    variant = jax_opts.variant
    jc = jcost.solver_stage_costs(BUCKET, s=1, opts=jax_opts, variant=variant)
    topts = T.SaPOptions(p=4, variant=variant, reduced_solver="bcr", tol=1e-6, maxiter=50)
    tc = cost.solver_stage_costs(BUCKET, s=1, opts=topts, variant=variant, device="cpu")
    ratio = jc[stage].flops / tc[stage].flops
    assert 1.0 <= ratio <= 20.0, (stage, ratio)


# ---------------------------------------------------------------------------
# solver stage costs
# ---------------------------------------------------------------------------


def test_solver_stage_costs_stages_present():
    costs = cost.solver_stage_costs(BUCKET, s=1, opts=OPTS, device="cpu")
    assert set(costs) == {"factor", "krylov", "btf", "bts"}
    for c in costs.values():
        assert c.flops > 0 and c.hbm_bytes > 0
    assert costs["krylov"].loop_iters == OPTS.maxiter
    e = cost.solver_stage_costs(BUCKET, opts=OPTS, variant="E", device="cpu")
    assert set(e) == {"factor", "krylov", "btf", "bts", "bcr"}
    d = cost.solver_stage_costs(BUCKET, opts=OPTS, variant="D", device="cpu")
    assert d["factor"].flops < costs["factor"].flops  # no spikes, no reduced system


def test_solver_stage_costs_cached():
    first = cost.solver_stage_costs(BUCKET, s=1, opts=OPTS, device="cpu")
    again = cost.solver_stage_costs(BUCKET, s=1, opts=OPTS, device="cpu")
    assert first is again  # same dict object: served from the cache


def test_solver_stage_costs_count_what_each_device_launches():
    """"auto" is fused on the card: one pass in place of btf, the UL btf and
    the spike products on the CPU -- the same flops as the pair of
    recurrences and carries, less the UL factor's write-back."""
    cpu = cost.solver_stage_costs(BUCKET, opts=OPTS, device="cpu")
    card = cost.solver_stage_costs(BUCKET, opts=OPTS, device="cuda")
    assert card is not cpu and card["factor"].hbm_bytes < cpu["factor"].hbm_bytes
    assert card["factor"].hw == "cuda-h100-calibrated" and cpu["factor"].hw == "cpu-calibrated"
    assert card["krylov"].flops == cpu["krylov"].flops  # the same applies and matvecs


def test_solver_stage_costs_scale_with_systems_and_sweeps():
    one = cost.solver_stage_costs(BUCKET, s=1, opts=OPTS, device="cpu")
    four = cost.solver_stage_costs(BUCKET, s=4, opts=OPTS, device="cpu")
    for stage in one:
        assert four[stage].flops == pytest.approx(4 * one[stage].flops)
    # linear in maxiter: the same sweep each, plus the work outside the loop
    k25, k50, k100 = (cost.solver_stage_costs(BUCKET, opts=T.SaPOptions(p=4, tol=1e-6, maxiter=i),
                                              device="cpu")["krylov"] for i in (25, 50, 100))
    assert k100.flops - k50.flops == pytest.approx(2 * (k50.flops - k25.flops))
    assert k100.loop_iters == 100
    wide = cost.solver_stage_costs(BUCKET, opts=OPTS, dtype=torch.float64, device="cpu")
    assert wide["krylov"].hbm_bytes > one["krylov"].hbm_bytes
    assert wide["factor"] == one["factor"]  # the preconditioner stays float32


# ---------------------------------------------------------------------------
# engine + service surfacing
# ---------------------------------------------------------------------------


def _one_system(n=96, k=2, seed=0):
    band = np.float32(random_banded(n, k, d=1.2, seed=seed))
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    b = T.band_matvec(torch.tensor(band), torch.tensor(x)).numpy()
    return band, b


def test_engine_cost_accounting():
    opts = T.SaPOptions(p=2, variant="C", tol=1e-6, maxiter=30)
    eng = SolverEngine(opts, max_batch=8, cache_size=8, cost_accounting=True, device="cpu")
    tracer = Tracer()
    with use_tracer(tracer):
        for seed in (1, 1, 2):
            band, b = _one_system(seed=seed)
            eng.submit_system(band, b)
        done = eng.run_until_drained()
    assert done and all(r.result.converged for r in done)

    snap = eng.stats_snapshot()
    assert snap["peak_device_bytes"] == 0  # nothing lives on a card
    assert "recompiles_total" not in snap

    totals = eng.cost_snapshot()
    assert set(totals) == {"factor", "krylov"}
    assert totals["factor"]["flops"] > 0 and totals["krylov"]["roofline_s"] > 0
    # two distinct matrices were factored; sweeps x batch of one solve each
    bucket = done[0].result.bucket
    costs = eng.stage_costs(bucket, variant="C")
    assert totals["factor"]["flops"] == pytest.approx(2 * costs["factor"].flops)
    sweeps = max(r.result.iterations for r in done)
    assert totals["krylov"]["flops"] == pytest.approx(
        3 * sweeps * costs["krylov"].per_iteration().flops)

    # the solve span carries the per-stage cost records
    (sp,) = tracer.find("engine.solve_prepared")
    c = sp.attrs.get("cost")
    assert c and c["factor"]["flops"] > 0 and "roofline_s" in c["krylov"]


def test_engine_cost_model_never_fails_a_solve(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no cost model")

    monkeypatch.setattr(cost, "solver_stage_costs", broken)
    eng = SolverEngine(T.SaPOptions(p=2, variant="C", tol=1e-6, maxiter=30), cost_accounting=True,
                       device="cpu")
    band, b = _one_system(seed=3)
    eng.submit_system(band, b)
    tracer = Tracer()
    with use_tracer(tracer):
        (out,) = eng.run_until_drained()
    assert out.result.converged and eng.cost_snapshot() == {}
    assert "cost" not in tracer.find("engine.solve_prepared")[0].attrs


def test_service_exposition_with_cost_accounting():
    opts = T.SaPOptions(p=2, variant="C", tol=1e-6, maxiter=30)
    svc = AsyncSolverService(opts, start=False, cost_accounting=True, device="cpu")
    try:
        band, b = _one_system(seed=2)
        fut = svc.submit(band, b)
        while svc.pending:
            svc.drain_once()
        assert fut.result(5).converged
        prom = svc.render()
        assert "peak_device_bytes" in prom
        assert "recompiles" not in prom and "compile_seconds" not in prom
        snap = svc.snapshot()
        assert snap["gauges"]["peak_device_bytes"] == 0
        assert svc.engine.cost_accounting and svc.engine.cost_snapshot()["krylov"]["flops"] > 0
    finally:
        svc.close()
