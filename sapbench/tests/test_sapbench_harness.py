"""The manifest and the files it names, the inputs' generator, the
reservoir, the metric readers' arithmetic and the trace reduction."""

import json
import re
from types import SimpleNamespace

import pytest
import torch

from sapbench import harness, tracing
from sapbench.tests.helpers import ROOT, tiny_root

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["sapbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for cfg in MANIFEST["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["file"].startswith("sapbench/") and (ROOT / cfg["file"]).is_file()
        assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        mix = json.loads((ROOT / "sapbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "sapbench" / "generators" / f"{mix['generator']}.py").is_file()
        assert len(w["why"]) <= 200
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "sapbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] == "solutions_per_s" and "bound" not in m
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.load_cell(ROOT, cell)
    e2e = {m["name"] for m in harness.cell_metrics(c, False)}
    assert "setup_s" in e2e and len(e2e) >= 2 and harness.cell_metrics(c, True)
    assert set(c.config["limits"]) == {"x_relerr", "resid"}


# A generator of a kind the harness has not seen: two systems factored at
# set-up, requests alternating between them.
DUMMY_GENERATOR = """
def systems(traffic):
    return traffic["held"]


def system(traffic, i):
    return i % traffic["held"]


def start(program, bands, traffic):
    facs = [program.factor(band) for band in bands]

    def request(i, b):
        return program.solve(facs[system(traffic, i)], b)

    return request
"""


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    sb = root / "sapbench"
    (sb / "configs" / "dummy-cfg.json").write_text(
        (sb / "configs" / "sap-dense-200k-d1.json").read_text().replace('"d": 1.0', '"d": 2.0'))
    (sb / "generators" / "dummy_kind.py").write_text(DUMMY_GENERATOR)
    (sb / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"generator": "dummy_kind", "held": 2, "rhs_per_request": 2, "warmup": 1,
         "judge_sample": 3}))
    (sb / "metrics" / "dummy_rhs.py").write_text(
        "def read(ctx):\n    return float(ctx.rhs_per_request)\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "dummy-cfg", "source": "test", "file":
                           "sapbench/configs/dummy-cfg.json", "reduced": [], "why": "test"})
    man["workloads"].append({"name": "dummy.cell", "config": "dummy-cfg",
                             "traffic": "dummy-mix", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "dummy_rhs", "unit": "rhs", "better": "higher",
                             "source": "program_counter", "layer": "Krylov",
                             "moves": "solutions_per_s", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.load_cell(root, "dummy.cell")
    assert cell.config["d"] == 2.0 and cell.traffic["rhs_per_request"] == 2
    assert cell.generator.systems(cell.traffic) == 2
    assert "dummy_rhs" in {m["name"] for m in harness.cell_metrics(cell, True)}
    assert harness.reader(root, "dummy_rhs")(_ctx(rhs_per_request=2)) == 2.0
    out = harness.run_cell(cell, 5, 0.2, False, "cpu")
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"solutions_per_s", "setup_s"}  # no memory on the CPU
    assert list(out)[-1] == "checks"


def test_inputs_follow_eq_2_11_and_the_seed():
    seed = 2**31 + 12345
    a = harness.make_bands(3, 40, 4, 0.5, seed, "cpu")
    assert torch.equal(a, harness.make_bands(3, 40, 4, 0.5, seed, "cpu"))
    assert not torch.equal(a, harness.make_bands(3, 40, 4, 0.5, seed + 1, "cpu"))
    off = a.abs().sum(-1) - a[..., 4].abs()
    assert torch.allclose(a[..., 4].abs(), 0.5 * off)
    assert float(a[..., :4].abs().max()) <= 1.0
    for j in range(9):  # entries outside the matrix are zero
        assert not a[:, : max(4 - j, 0), j].any() and not a[:, 40 - max(j - 4, 0):, j].any()


def test_reservoir_keeps_a_seeded_uniform_sample():
    def kept(seed, n):
        s = harness.Sample(4, 3, 1, seed, "cpu")
        for i in range(n):
            s.offer(i, i % 2, torch.full((3,), float(i)), torch.full((3, 1), float(i)))
        return sorted(s.request[j] for j in s.kept()), s

    first, s = kept(1, 100)
    assert first == kept(1, 100)[0] and len(first) == 4
    assert all(float(s.x[j, 0, 0]) == s.request[j] for j in s.kept())
    counts = [0] * 100
    for seed in range(300):
        for i in kept(seed, 100)[0]:
            counts[i] += 1
    assert min(counts) > 0 and abs(sum(counts[:50]) - sum(counts[50:])) < 0.15 * 600
    assert kept(1, 2)[0] == [0, 1]


def _ctx(**kw):
    base = dict(setup_s=9.5, window_s=10.0, latencies_s=[], rhs_per_request=1, iterations=[],
                solved=0, attempted=0, failed=0, work_mem_bytes=0, spans={}, trace=None,
                peaks=None, percentile=harness.percentile)
    base.update(kw)
    return SimpleNamespace(**base)


def test_percentile_is_over_all_requests_and_the_rate_over_the_whole_window():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    p95 = harness.reader(ROOT, "solution_ms.p95")
    rate = harness.reader(ROOT, "solutions_per_s")
    assert p95(_ctx(latencies_s=lat)) == pytest.approx(95.0)
    assert p95(_ctx(latencies_s=lat[::-1] + [1.0])) == pytest.approx(96.0)
    assert harness.percentile([5.0], 95) == 5.0
    assert rate(_ctx(solved=400, attempted=100, window_s=10.0)) == 40.0
    assert rate(_ctx(solved=0, attempted=0)) is None
    assert harness.reader(ROOT, "sweeps_per_solve")(
        _ctx(iterations=[[1.0, 2.0], [1.0, 1.0]])) == 1.25
    assert harness.reader(ROOT, "work_mem_gib")(_ctx(work_mem_bytes=3 * 2**29)) == 1.5


def test_trace_summary_busy_stages_and_idle_labels():
    ranges = [("sapbench.request", 0, 100), ("factor", 10, 50), ("factor.split", 10, 20),
              ("krylov", 50, 100), ("sapbench.request", 200, 300), ("factor", 200, 240)]
    device = [("k1", 12, 18), ("k2", 30, 45), ("k3", 60, 70), ("k4", 60, 65), ("k1", 210, 230),
              ("early", -50, -40)]
    s = tracing.summarize(ranges, device, ("factor", "krylov"))
    assert s.window_s == pytest.approx(300e-6)
    assert s.busy_s == pytest.approx((6 + 15 + 10 + 20) * 1e-6)
    assert s.stage_device_s["factor"] == pytest.approx(41e-6)
    assert s.stage_device_s["krylov"] == pytest.approx(15e-6)
    idle = dict(s.idle_gaps)
    assert idle["sapbench.request"] == pytest.approx((10 + 60) * 1e-6)  # 0-10, 240-300
    assert idle["factor.split"] == pytest.approx(4e-6)  # 10-12, 18-20
    assert idle["factor"] == pytest.approx(35e-6)  # 20-30, 45-50, 200-210, 230-240
    assert idle["krylov"] == pytest.approx(40e-6)  # 50-60, 70-100
    assert idle[tracing.OUTSIDE] == pytest.approx(100e-6)  # 100-200
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.device_ops[0] == ["k1", pytest.approx(26e-6)]
    assert harness.reader(ROOT, "device_idle_pct")(_ctx(trace=s)) == pytest.approx(83.0)


@pytest.mark.parametrize("mix", sorted(p.stem for p in (ROOT / "sapbench" / "traffic").glob("*.json")))
def test_every_mix_names_a_generator_whose_requests_stay_inside_its_systems(mix):
    traffic = json.loads((ROOT / "sapbench" / "traffic" / f"{mix}.json").read_text())
    gen = harness.load_module(ROOT / "sapbench" / "generators" / f"{traffic['generator']}.py",
                              "sapbench_generator_" + traffic["generator"])
    count = gen.systems(traffic)
    assert count >= 1 and traffic["rhs_per_request"] >= 1
    seen = {gen.system(traffic, i) for i in range(4 * count)}
    assert seen == set(range(count))  # every system made at set-up is solved, and no other
