"""On the card, at each cell's own sizes: the program's runs read below
every limit and the TF32 control above one, on three seeds each.

    PYTHONPATH=src python -m pytest -q -m gpu sapbench/tests
"""

import pytest
import torch

from sapbench import harness, readings
from sapbench.tests.helpers import ROOT

CELLS = ["dense200k-d1.newsys", "dense200k-d06.newsys", "dense200k-d1.rhs"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_limits_separate_program_and_control_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(ROOT, cell)
    out = readings.readings(c, [1001, 1002, 1003], [2001, 2002, 2003], 1.0, "cuda")
    limits = c.config["limits"]
    assert all(out["lower"][k] <= limits[k] for k in limits)
    assert any(out["upper"][k] > limits[k] for k in limits)
