"""The two metrics that read the program's counters, in a short traced run
of each cell on the CPU: reported, and equal to what the iterations of
every request the run made (the warm-up's too) and its factorizations
give.  Each run is a process of its own, since the counters are the
process's."""

import json
import math
import subprocess
import sys

import pytest

from sapbench.tests.helpers import ROOT, tiny_root

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

RUN = r"""
import json, os, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
torch.set_num_threads(1)
from pathlib import Path
from sapbench import harness

cell = harness.load_cell(Path({tiny!r}), {cell!r})
its, factors = [], []
start = cell.generator.start


def counted_start(program, bands, traffic):
    real_factor = program.factor

    def factor(band):
        factors.append(1)
        return real_factor(band)

    program.factor = factor
    request = start(program, bands, traffic)

    def counted(i, b):
        res = request(i, b)
        its.append([float(v) for v in res.iterations.reshape(-1).tolist()])
        return res

    return counted


cell.generator.start = counted_start
with open(os.devnull, "w") as log:
    out = harness.run_cell(cell, 2**31 + 11, 0.3, True, "cpu", log=log)
print(json.dumps({{"out": out, "its": its, "factors": len(factors),
                  "warmup": cell.traffic["warmup"]}}))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_counter_metrics_agree_with_the_iterations_of_a_traced_run(tmp_path, cell):
    tiny = tiny_root(tmp_path)
    code = RUN.format(src=str(ROOT / "src"), root=str(ROOT), tiny=str(tiny), cell=cell)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    out, its = got["out"], got["its"]
    assert out["correct"] and len(its) == got["warmup"] + out["attempted"]
    sweeps = [math.ceil(max(r)) for r in its]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert metrics["applies_per_solve"] == pytest.approx(sum(4 * s + 2 for s in sweeps) / len(its))
    # one read before the first sweep and one after each, and each factor's one
    assert metrics["host_syncs_per_solve"] == pytest.approx(
        (sum(s + 1 for s in sweeps) + got["factors"]) / len(its))
    assert out["metrics"]["host_syncs_per_solve"]["unit"] == "syncs"
    assert out["metrics"]["applies_per_solve"]["unit"] == "applies"
