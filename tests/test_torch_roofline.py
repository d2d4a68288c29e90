"""``Roofline`` / ``analyze`` and the link rate of ``launch/calibrate.py``.

The counterpart of ``tests/test_roofline.py::test_analyze_bottleneck_selection``
on the port's ``analyze``, which takes the per-device counts in a dict
(the port has no HLO to parse); the selection of each term as the
bottleneck on synthetic counts; the data sheet's ordering of the ceilings
(the JAX test's ``PEAK_FLOPS > HBM_BW > ICI_BW``); and
``measure_link_bw`` on two gloo ranks of the CPU (its units only: a
buffer's bytes over the median seconds).
"""

import dataclasses

import pytest

from repro.launch.roofline import Roofline as JaxRoofline
from repro_torch.launch import calibrate as cal
from repro_torch.launch.roofline import H100_DATASHEET, HardwareSpec, Roofline, analyze

HW = HardwareSpec("unit", peak_flops=1e12, hbm_bw=1e11, peak_bf16_flops=4e12, link_bw=1e10)


def test_analyze_bottleneck_selection():
    roof = analyze({}, chips=256, model_flops_global=0.0)
    assert roof.bottleneck in ("compute", "memory", "collective")
    h = H100_DATASHEET
    assert h.peak_bf16_flops > h.hbm_bw > h.link_bw


def test_roofline_has_the_jax_fields():
    assert [f.name for f in dataclasses.fields(Roofline)] == [
        f.name for f in dataclasses.fields(JaxRoofline)]


@pytest.mark.parametrize("stats, want", [
    ({"flops": 8e12, "hbm_bytes": 1e10, "coll_bytes": 1e8}, "compute"),
    ({"flops": 4e11, "hbm_bytes": 1e11, "coll_bytes": 1e8}, "memory"),
    ({"flops": 4e11, "hbm_bytes": 1e10, "coll_bytes": 3e10}, "collective"),
])
def test_analyze_picks_the_largest_term(stats, want):
    roof = analyze({**stats, "coll_detail": {"all_reduce/model": {"messages": 1}}}, chips=4,
                   model_flops_global=4 * stats["flops"] / 2, hw=HW)
    assert roof.bottleneck == want
    assert roof.compute_s == stats["flops"] / HW.peak_bf16_flops
    assert roof.memory_s == stats["hbm_bytes"] / HW.hbm_bw
    assert roof.collective_s == stats["coll_bytes"] / HW.link_bw
    assert roof.useful_ratio == 0.5 and roof.chips == 4
    assert roof.coll_detail == {"all_reduce/model": {"messages": 1}}
    assert set(roof.to_dict()) == {f.name for f in dataclasses.fields(Roofline)}


def test_analyze_takes_the_float32_rate_unless_bfloat16():
    roof = analyze({"flops": 1e12}, chips=1, model_flops_global=1e12, hw=HW, bf16=False)
    assert roof.compute_s == 1.0
    plain = dataclasses.replace(HW, peak_bf16_flops=None)
    assert analyze({"flops": 1e12}, chips=1, model_flops_global=0.0, hw=plain).compute_s == 1.0


def test_analyze_refuses_collective_bytes_without_a_link_rate():
    with pytest.raises(ValueError):
        analyze({"coll_bytes": 1.0}, chips=1, model_flops_global=0.0,
                hw=dataclasses.replace(HW, link_bw=None))


def test_link_rate_counts_buffer_bytes_over_seconds_on_two_cpu_ranks():
    rate = cal.measure_link_bw(nbytes=1 << 16, repeats=3, device="cpu")
    assert isinstance(rate, float) and rate > 0.0
