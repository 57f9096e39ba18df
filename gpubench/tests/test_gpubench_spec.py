"""BENCHMARK.json's names resolve to the files of the benchmark, and the
harness finds configurations, mixes, metrics and limits by name."""
import json
import re

import pytest

from gpubench import checks
from gpubench.harness import BENCH_DIR, ROOT, MetricContext, load_cell, load_reader
from gpubench.tracing import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_units_and_files():
    b = _bench()
    assert b["command"] == ["python3", "gpubench/run.py"] and b["paths"] == ["gpubench"]
    metrics = b["end_to_end"] + b["per_layer"]
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gpubench/")
    for w in b["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("cell", ["gnn32_ppi24k", "gnn32_synth10m", "gcn2_ppi24k",
                                  "gcn2_synth10m", "gnn32bf16_ppi24k_b32"])
def test_load_cell_finds_every_part_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert set(c.limits) >= set(checks.NUMBERS)
    assert {m["name"] for m in c.end_to_end} == {"fold_epochs_per_s", "peak_mem_gib",
                                                  "setup_s"}
    assert len(c.per_layer) >= 1
    for m in c.per_layer:
        assert callable(load_reader(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError):
        load_cell("no_such_cell")


def _null_limit(**change):
    return dict({"limit": None, "lower": 1e-3, "upper": None, "upper_from": None,
                 "why": "no control or fault reading bounds it"}, **change)


def test_a_cell_whose_limits_compare_nothing_is_refused(tmp_path, monkeypatch):
    from gpubench import harness

    for sub in ("traffic", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "traffic" / "ppi24k_b10.json").write_text(
        (BENCH_DIR / "traffic" / "ppi24k_b10.json").read_text())
    (tmp_path / "limits" / "gnn32_ppi24k.json").write_text(
        json.dumps({n: _null_limit() for n in checks.NUMBERS}))
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    with pytest.raises(ValueError, match="compares none"):
        load_cell("gnn32_ppi24k")


@pytest.mark.parametrize("change", [{"lower": None}, {"upper": 0.1}, {"why": ""}])
def test_a_null_limit_without_its_readings_is_refused(change):
    limits = {n: {"limit": 1.0, "lower": 0.1, "upper": 10.0} for n in checks.NUMBERS}
    limits["probs_gap"] = _null_limit(**change)
    with pytest.raises(ValueError, match="probs_gap"):
        checks.check_limits(limits, "toy")
    limits["probs_gap"] = _null_limit()
    checks.check_limits(limits, "toy")


def _ctx(kernels, window=(0.0, 1e6), epochs=2):
    trace = Trace(kernels=kernels, window=window, gaps=[], lost=0)
    return MetricContext(trace=trace, traced_epochs=epochs, epoch_ms=[3.0, 1.0, 2.0],
                         wall_per_epoch_s=0.5,
                         flops_per_epoch=67e9, agg_bytes_per_epoch=335 * 10**6,
                         peaks={"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
                         graph_build_s=1.5)


def test_readers_split_the_device_time_into_groups():
    kernels = [("sm90_xmma_gemm_f32f32", 0.0, 4000.0),
               ("void spmm_max_fwd_kernel<float, short>", 5000.0, 1000.0),
               ("void spmm_sum_combine_kernel<float>", 7000.0, 1000.0),
               ("void at::native::vectorized_elementwise_kernel", 9000.0, 2000.0),
               ("Memcpy DtoH (Device -> Pageable)", 12000.0, 1000.0)]
    ctx = _ctx(kernels)
    read = {n: load_reader(n).read(ctx) for n in (
        "dense.gemm_ms", "aggregation.kernel_ms", "elementwise.kernel_ms",
        "aggregation.spmm_roofline", "device.idle_share", "device.mfu",
        "runner.epoch_ms_p50", "setup.graph_build_s")}
    assert read["dense.gemm_ms"] == 2.0 and read["aggregation.kernel_ms"] == 1.0
    assert read["elementwise.kernel_ms"] == 1.5
    assert abs(read["aggregation.spmm_roofline"] - 10.0) < 1e-9   # 0.1 ms of 1 ms
    assert abs(read["device.idle_share"] - 99.1) < 1e-9   # 9 ms busy in 1 s
    assert abs(read["device.mfu"] - 0.2) < 1e-9           # 67 GFLOP an epoch of 0.5 s
    assert read["runner.epoch_ms_p50"] == 2.0 and read["setup.graph_build_s"] == 1.5


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = _ctx([("sm90_xmma_gemm_f32f32", 0.0, 10.0)])
    assert load_reader("aggregation.kernel_ms").read(ctx) is None
    assert load_reader("aggregation.spmm_roofline").read(ctx) is None
    ctx.peaks = None
    assert load_reader("device.mfu").read(ctx) is None
