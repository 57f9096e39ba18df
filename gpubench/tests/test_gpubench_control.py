"""The control: the port's own TF32 path (``set_matmul_precision('high')``)
in place of the configuration's float32, at the gnn32_ppi24k cell's own
size, has to come out not correct.  Needs a card (TF32 exists only there):

    python -m pytest gpubench/tests/test_gpubench_control.py -q -m cuda
"""
import time

import pytest
import torch

from gpubench.harness import load_cell, run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("cell", ["gnn32_ppi24k", "gcn2_ppi24k"])
def test_control_is_not_correct(card, cell):
    res = run_cell(load_cell(cell), 1234567, 1.0, False, card, time.perf_counter(),
                   fault="control")
    assert not res["correct"], res["checks"]
