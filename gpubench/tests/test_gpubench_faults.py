"""A run with the timed path broken underneath comes out not correct: the
harness's whole run but the look for a card, on the CPU at a tiny size
(the port's kernels run their plain versions there)."""
import time

import pytest

from gpubench import checks
from gpubench.harness import run_cell
from gpubench.tests.tiny import tiny_cell

CELLS = ("gnn32_ppi24k", "gcn2_ppi24k", "gnn32bf16_ppi24k_b32")


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


def test_sound_run_past_one_round_is_correct():
    # 7 folds of a 5-fold split: the second round's first two folds
    cell = tiny_cell("gnn32bf16_ppi24k_b32")
    cell.traffic = dict(cell.traffic, fold_batch=7)
    res = run_cell(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "delta_gap", "metrics_gap",
                                  "agg_dtype_off"}


@pytest.mark.parametrize("cell,runs_in", [("gnn32bf16_ppi24k_b32", "float32"),
                                          ("gnn32_ppi24k", "bfloat16")])
def test_messages_in_another_dtype_are_caught(cell, runs_in, monkeypatch):
    # the configuration's agg_dtype does not take effect: the port runs in another
    from plagnn_tpu_torch.utils import precision

    before, sound = precision.aggregation_dtype(), precision.set_aggregation_dtype
    monkeypatch.setattr(precision, "set_aggregation_dtype", lambda dtype: sound(runs_in))
    try:
        res = run_cell(tiny_cell(cell), 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    finally:
        sound(before)
    assert not res["correct"]
    assert res["checks"]["agg_dtype_off"] == {"value": 1.0, "limit": 0.0}


@pytest.mark.parametrize("stated,port,launches,want", [
    ("bfloat16", "bfloat16", {"spmm_max_fwd_bf16": 6, "spmm_max_bwd_bf16": 6,
                              "spmm_sum_fwd_f32": 4}, 0.0),
    ("bfloat16", "bfloat16", {"spmm_max_fwd_f32": 6, "spmm_max_bwd_f32": 6}, 1.0),
    ("bfloat16", "bfloat16", {"spmm_max_fwd_bf16": 3, "spmm_max_bwd_f32": 1}, 0.25),
    ("bfloat16", "bfloat16", {"spmm_sum_fwd_bf16": 4}, 1.0),       # no max in bf16
    ("float32", "float32", {"spmm_sum_gcn_fwd_f32": 4, "spmm_sum_gcn_bwd_f32": 4}, 0.0),
    ("float32", "float32", {"spmm_max_fwd_hub_bf16": 2, "spmm_max_fwd_f32": 2}, 0.5),
    ("bfloat16", "float32", None, 1.0),
    ("bfloat16", "bfloat16", None, 0.0),                            # the CPU counts nothing
])
def test_dtype_off_reads_the_windows_max_launches(stated, port, launches, want):
    assert checks.dtype_off(stated, port, launches) == want
