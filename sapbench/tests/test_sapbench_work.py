"""The frozen work counts: PERF.md's sheet bounds, and stage counts that do
not depend on which implementation of the stage ran."""

import inspect

import pytest

from sapbench import work

PEAK_FLOPS, PEAK_BW = 67e12, 3.35e12


@pytest.mark.parametrize("name, count, by, ms", [
    ("btf", work.btf_work(64, 16, 200), "flops", 0.7036),
    ("fused", work.fused_work(64, 16, 200), "flops", 1.927),
    ("bts", work.bts_work(64, 16, 200, 1), "bytes", 0.1411),
])
def test_sheet_bounds(name, count, by, ms):
    flops_s, bytes_s = count[0] / PEAK_FLOPS, count[1] / PEAK_BW
    assert (flops_s > bytes_s) == (by == "flops")
    assert work.bound_s(count, PEAK_FLOPS, PEAK_BW) * 1e3 == pytest.approx(ms, rel=5e-4)


def test_partition_blocks_match_the_cells():
    assert work.partition_blocks(200_000, 64, 200) == 16
    assert work.partition_blocks(512, 4, 8) == 16


def test_stage_counts_take_no_implementation_knob():
    for fn in (work.factor_work, work.apply_work, work.solve_work):
        params = set(inspect.signature(fn).parameters)
        assert not params & {"fused", "fused_factor", "reduced", "reduced_solver"}


@pytest.mark.parametrize("variant", ["C", "E"])
def test_factor_count_is_at_most_either_implementation(variant):
    n, k, p = 200_000, 200, 64
    m = work.partition_blocks(n, p, k)
    split = (0.0, 4.0 * n * (2 * k + 1) + 12.0 * p * m * k * k)
    if variant == "C":
        unfused = work._add(work._times(2, work.btf_work(p, m, k)),
                            work.products(2 * (p - 1), k, k))
        reduced = [work._add(work.products(p - 1, k, k), work.btf_work(p - 1, 1, k))]
    else:
        unfused = work._add(work.btf_work(p, m, k), work._times(2, work.bts_work(p, m, k, k)))
        bw = work.bcr_work(p - 1, 2 * k, 1)
        assemble = (0.0, 4.0 * (p - 1) * (12 * k * k + 4 * k * k))
        reduced = [work._add(assemble, work.btf_work(1, p - 1, 2 * k)),
                   work._add(assemble, bw["inv_odd"], bw["reduce"])]
    count = work.factor_work(n, k, p, variant)
    for lu in (work.fused_work(p, m, k), unfused):
        for red in reduced:
            whole = work._add(split, lu, red)
            assert count[0] <= whole[0] and count[1] <= whole[1]


def _roofline_factor(config):
    from types import SimpleNamespace

    from sapbench.harness import load_module

    read = load_module(work.__file__.replace("work.py", "metrics/factor_roofline.py"),
                       "factor_roofline").read
    ctx = SimpleNamespace(
        spans={"factor": [0.012] * 10}, peaks={"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
        trace=SimpleNamespace(stage_device_s={"factor": 0.12}), work=work,
        cell=SimpleNamespace(config=config))
    return read(ctx)


def test_factor_roofline_is_the_same_whatever_implementation_ran():
    base = {"n": 200_000, "k": 200, "p": 64, "variant": "E"}
    values = {_roofline_factor({**base, "fused_factor": f, "reduced_solver": r})
              for f in ("on", "off", "auto") for r in ("chain", "bcr", "auto")}
    assert len(values) == 1
    assert 0 < values.pop() < 100


def test_solve_counts_whole_sweeps():
    one = work.solve_work(200_000, 200, 64, "C", 4, 1)
    two = work.solve_work(200_000, 200, 64, "C", 4, 2)
    step = work._add(work.apply_work(200_000, 200, 64, "C", 4), work.matvec_work(200_000, 200, 4))
    assert two[0] - one[0] == pytest.approx(4 * step[0])
    assert work.solve_work(200_000, 200, 64, "C", 4, 0) == pytest.approx(step)
