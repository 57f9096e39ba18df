"""A run with the timed path broken underneath comes out not correct: the
harness's whole run but the look for a card, on the CPU at a tiny size
(the port's kernels run their plain versions there)."""
import time

import pytest

from gpubench.harness import run_cell
from gpubench.tests.tiny import tiny_cell

CELLS = ("gnn32_ppi24k", "gcn2_ppi24k")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_cell(tiny_cell(cell), 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"fold_epochs_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer"])
def test_fault_is_caught(cell, fault):
    res = run_cell(tiny_cell(cell), 2**31 + 11, 0.2, False, "cpu", time.perf_counter(),
                   fault=fault)
    assert not res["correct"], res["checks"]
