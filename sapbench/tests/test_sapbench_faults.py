"""``correct`` comes out true for the program and false for the control
and for each fault a cell can have, at CPU-sized shapes: the harness's
look for a card skipped, the rest of a run driven with the timed path
broken underneath (the exchange between chips has no place on one chip,
and half of a batch none where a request solves one right-hand side)."""

import pytest
import torch

import repro_torch.core.krylov as krylov
import repro_torch.core.sap as sap
from sapbench import harness, readings
from sapbench.tests.helpers import tiny_root

CELLS = ["dense200k-d1.newsys", "dense200k-d06.newsys", "dense200k-d1.rhs"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


def _run(root, cell, seed=2**31 + 5):
    return harness.run_cell(harness.load_cell(root, cell), seed, 0.05, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_and_control_not(root, cell):
    c = harness.load_cell(root, cell)
    out = readings.readings(c, [3], [11], 0.05, "cpu")
    assert all(out["lower"][k] <= c.config["limits"][k] for k in out["lower"])
    assert all(out["upper"][k] > c.config["limits"][k] for k in out["upper"])


def _unchanged_state(state, step, maxiter, record_history, bnorm, norm=None):
    return {**state, "done": torch.ones_like(state["done"])}, None


def _altered_answer(original):
    def solve_impl(fac, bmat, record_history=False):
        res = original(fac, bmat, record_history)
        x = res.x.clone()
        x[x.shape[0] // 2] += x.abs().max()
        return res._replace(x=x)
    return solve_impl


# Half of a batch left out has no place either: every cell's request
# solves one right-hand side.
FAULTS = [(cell, fault) for cell in CELLS for fault in ("unchanged_state", "altered_answer")]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_fault_reads_incorrect(root, cell, fault, monkeypatch):
    if fault == "unchanged_state":
        monkeypatch.setattr(krylov, "_iterate", _unchanged_state)
    else:
        monkeypatch.setattr(sap, "_solve_impl", _altered_answer(sap._solve_impl))
    out = _run(root, cell)
    assert out["attempted"] > 0 and not out["correct"]
