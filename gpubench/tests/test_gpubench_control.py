"""The control: the port's own TF32 path (``set_matmul_precision('high')``)
in place of the configuration's float32, at each 24k cell's own size, has
to come out not correct; so has the bf16 cell with float32 max kernels.
Needs a card (TF32 and the launch counters exist only there):

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


@pytest.mark.parametrize("cell", ["gnn32_ppi24k", "gcn2_ppi24k", "gnn32bf16_ppi24k_b32"])
def test_control_is_not_correct(card, cell):
    res = run_cell(load_cell(cell), 1234567, 1.0, False, card, time.perf_counter(),
                   fault="control")
    assert not res["correct"], res["checks"]


def test_float32_max_kernels_in_the_bf16_cell_are_not_correct(card, monkeypatch):
    # the layers ignore the aggregation dtype that the port holds: the window's
    # max launches are float32, which only the launch counters see
    from plagnn_tpu_torch.models import layers

    monkeypatch.setattr(layers, "aggregation_dtype", lambda: None)
    res = run_cell(load_cell("gnn32bf16_ppi24k_b32"), 1234567, 1.0, False, card,
                   time.perf_counter())
    assert not res["correct"]
    assert res["checks"]["agg_dtype_off"]["value"] == 1.0, res["checks"]
