"""The port's gather probe (plagnn_tpu_torch/bench/dma_ceiling.py) against
the JAX package's (benchmarks/dma_ceiling.py) on the CPU.

The JAX kernel runs in interpret mode, as tests/test_dma_ceiling.py runs
it; the port's wrapper takes its plain version on CPU tensors.  The probe
copies rows and computes nothing, so every comparison is exact (bit for
bit); the reader's interpolation is the same arithmetic as bench.py's, so
it agrees within 1e-12 relative.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import dma_ceiling as jdc  # noqa: E402
from plagnn_tpu_torch.bench import dma_ceiling as dc  # noqa: E402

JAX_FILE = os.path.join(ROOT, "benchmarks", "results", "dma_ceiling.json")


def _slot0(x, idx, ng, g):
    """Slot 0's rows at the end by direct indexing: group
    ((T_E // g - 1) // ng) * ng of the last window."""
    gi = (dc.T_E // g - 1) // ng * ng
    start = idx.numel() - dc.T_E + gi * g
    return x[idx[start:start + g].long()]


@pytest.mark.parametrize("pattern", ["random", "sequential"])
@pytest.mark.parametrize("row_bytes", [4096, 8192])
def test_build_bench_inputs_equal_jax(row_bytes, pattern):
    n_rows, ng = 96, 2
    _, n_fetch, (idx, x, _, _) = jdc.build_bench(
        n_rows, row_bytes, 3 * dc.T_E - 5, ng, pattern, interpret=True)
    _, n_fetch_t, (idx_t, x_t, g) = dc.build_bench(
        n_rows, row_bytes, 3 * dc.T_E - 5, ng, pattern, device="cpu")
    assert n_fetch_t == n_fetch == 3 * dc.T_E
    assert g == dc.G
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x).reshape(n_rows, -1))


# A handful of the JAX kernel's interpret-mode runs (about a second each):
# every ring depth and order, one and three windows.  At ng = 8 a ring of
# 8 x 8 rows of 4 KB (256 KB) is more than a block's 227 KB: the wrapper
# refuses it, so the plain version, which has no such limit, stands in.
@pytest.mark.parametrize("ng,pattern,windows", [
    (2, "random", 1), (2, "sequential", 3), (4, "random", 3), (4, "sequential", 1),
    (8, "random", 3), (8, "sequential", 1)])
def test_dma_ring_equals_jax_kernel(ng, pattern, windows):
    n_rows = 64
    _, _, (idx, x, _, fn) = jdc.build_bench(
        n_rows, 4096, windows * dc.T_E, ng, pattern, interpret=True)
    want = np.asarray(jax.jit(fn)(idx, x)).reshape(jdc.G, -1)
    # the inputs do not depend on the ring: built at a depth whose ring fits
    _, _, (idx_t, x_t, _) = dc.build_bench(
        n_rows, 4096, windows * dc.T_E, min(ng, 4), pattern, device="cpu", g=dc.G)
    if ng == 8:
        with pytest.raises(ValueError, match="shared memory"):
            dc.dma_ring(x_t, idx_t, ng)
        got = dc.dma_ring_plain(x_t, idx_t, ng)
    else:
        got = dc.dma_ring(x_t, idx_t, ng)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("row_bytes", [256, 1024, 20480])
def test_plain_slot0_at_port_widths(row_bytes, g):
    """g must divide T_E: 1, 2, 4 and 8 are fetched, 3, 5, 6 and 7 refused."""
    ng = 3
    gen = np.random.default_rng(row_bytes + g)
    n_rows = 50
    x = torch.from_numpy(gen.random((n_rows, row_bytes // 4), np.float32))
    idx = torch.from_numpy(gen.integers(0, n_rows, 3 * dc.T_E).astype(np.int32))
    if dc.T_E % g:
        with pytest.raises(ValueError, match="must divide T_E"):
            dc.dma_ring(x, idx, ng, g)
        return
    want = _slot0(x, idx, ng, g)
    assert torch.equal(dc.dma_ring_plain(x, idx, ng, g), want)
    if dc.ring_bytes(row_bytes, ng, g) <= dc.SMEM_BYTES:
        assert torch.equal(dc.dma_ring(x, idx, ng, g), want)


def test_plain_batches_windows():
    """Windows gathered in batches (64 MB of rows at most) give the same
    slot as one window at a time."""
    gen = np.random.default_rng(5)
    x = torch.from_numpy(gen.random((40, 4096), np.float32))   # 16 KB rows
    idx = torch.from_numpy(gen.integers(0, 40, 9 * dc.T_E).astype(np.int32))
    assert dc._PLAIN_BYTES // (dc.T_E * 16384) == 4   # 3 batches of windows
    assert torch.equal(dc.dma_ring_plain(x, idx, 1, 1), _slot0(x, idx, 1, 1))


def test_wrapper_refusals():
    gen = np.random.default_rng(1)
    idx = torch.from_numpy(gen.integers(0, 10, dc.T_E).astype(np.int32))
    # a layer-1 row of 10 x 503 f32 is 20,120 B: not a multiple of 16
    x = torch.zeros(10, 5030)
    with pytest.raises(ValueError, match="multiples of 16"):
        dc.dma_ring(x, idx, 8, 1)
    # the same rows padded to 20,480 B are taken, also as a view of a wider table
    assert dc.dma_ring(torch.zeros(10, 5120), idx, 8, 1).shape == (1, 5120)
    assert dc.dma_ring(torch.zeros(10, 5124)[:, :5120], idx, 8, 1).shape == (1, 5120)
    with pytest.raises(ValueError, match="multiples of 16"):
        dc.dma_ring(torch.zeros(10, 5121)[:, :5120], idx, 8, 1)
    x = torch.zeros(10, 256)
    with pytest.raises(ValueError, match="multiple of T_E"):
        dc.dma_ring(x, idx[:1000].contiguous(), 4)
    with pytest.raises(ValueError, match="multiple of T_E"):
        dc.dma_ring(x, idx[:0], 4)
    # 8 slots of 8 rows of 4 KB: 256 KB of ring
    with pytest.raises(ValueError, match="shared memory"):
        dc.dma_ring(torch.zeros(10, 1024), idx, 8, 8)
    with pytest.raises(ValueError, match="shared memory"):
        dc.ring_group(32768, 8)
    assert [dc.ring_group(w, 8) for w in (256, 1024, 4096, 8192, 16384, 20480, 24576)] == \
        [8, 8, 4, 2, 1, 1, 1]
    with pytest.raises(ValueError, match="ng"):
        dc.dma_ring(x, idx, dc.MAX_RING + 1, 1)
    with pytest.raises(ValueError, match=r"ids must lie in \[0, 10\)"):
        dc.dma_ring(x, idx + 1, 2)
    with pytest.raises(ValueError, match="int32"):
        dc.dma_ring(x, idx.long(), 2)
    with pytest.raises(ValueError, match="float32"):
        dc.dma_ring(x.double(), idx, 2)


def test_build_bench_cuts_g_and_pads_ids():
    ids = torch.arange(7, dtype=torch.int32)
    run, n_fetch, (idx, x, g) = dc.build_bench(16, 4096, 0, 8, "edges", device="cpu",
                                               rng="torch", ids=ids)
    assert (n_fetch, g, tuple(x.shape)) == (dc.T_E, 4, (16, 1024))
    assert torch.equal(idx, torch.arange(dc.T_E, dtype=torch.int32) % 7)
    assert torch.equal(run(), _slot0(x, idx, 8, 4))
    _, n_fetch, (idx, x, g) = dc.build_bench(300, 256, 10, 2, "random", device="cpu",
                                             rng="torch")
    assert (n_fetch, g) == (dc.T_E, dc.G)
    assert int(idx.min()) >= 0 and int(idx.max()) < 300


def test_cuda_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel: the wrapper asks the loader for the
    library (which cannot build here) instead of running the plain version."""
    calls = []

    def fake_load(name):
        calls.append(name)
        raise RuntimeError("no kernel library")

    class FakeCuda:
        type = "cuda"

    x = torch.zeros(4, 64)
    idx = torch.zeros(dc.T_E, dtype=torch.int32)
    monkeypatch.setattr(dc._build, "load", fake_load)
    monkeypatch.setattr(dc, "_check", lambda *a: None)
    monkeypatch.setattr(dc, "_check_ids", lambda *a: None)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: FakeCuda()))
    with pytest.raises(RuntimeError, match="no kernel library"):
        dc.dma_ring(x, idx, 2)
    assert calls == ["dma_ceiling"]


@pytest.mark.parametrize("kb", [2, 4, 10, 24, 64, 80])
def test_reader_equals_bench_py(kb):
    import bench

    want = bench.load_achievable_rate()
    got = dc.load_achievable_rate(path=JAX_FILE)
    assert got.source == JAX_FILE and got.n_rows == 24064
    for which in ("mid", "lo", "hi"):
        w = want(kb * 1024, which)
        assert got(kb * 1024, which) == pytest.approx(w, rel=1e-12, abs=0)


def _sweep_file(path, tables):
    """A port sweep file of random depth-8 points {n_rows: [(row_bytes, gbps)]}."""
    sweep = [{"row_bytes": w, "row_kb": w / 1024, "ring_depth": 8, "pattern": "random",
              "n_rows": rows, "gbps": gbps}
             for rows, pts in tables.items() for w, gbps in pts]
    sweep.append({"row_bytes": 512, "ring_depth": 4, "pattern": "random", "n_rows": 100,
                  "gbps": 1e6})
    path.write_text(json.dumps({"device": "test card", "sweep": sweep}))
    return str(path)


def test_reader_resolution_and_tables(tmp_path, monkeypatch):
    two = _sweep_file(tmp_path / "two.json", {24064: [(256, 100.0), (1024, 300.0)],
                                              330112: [(256, 10.0), (1024, 30.0)]})
    other = _sweep_file(tmp_path / "other.json", {5000: [(256, 7.0), (512, 9.0)]})
    broken = tmp_path / "broken.json"
    broken.write_text("{")
    rate = dc.load_achievable_rate(two)
    assert (rate.n_rows, rate.device, rate.source) == (24064, "test card", two)
    assert rate(640) == pytest.approx(200e9) and rate(100) == 100e9 and rate(4096) == 300e9
    assert rate(640, "lo") == rate(640, "hi") == rate(640)   # no spread: the median
    assert dc.load_achievable_rate(two, n_rows=200_000).n_rows == 330112
    assert dc.load_achievable_rate(two, n_rows=60_000).n_rows == 24064
    assert dc.load_achievable_rate(other, n_rows=330112).n_rows == 5000  # the only one
    monkeypatch.setenv(dc.ENV, other)
    assert dc.load_achievable_rate().source == other
    assert dc.load_achievable_rate(two).source == two          # the path first
    assert dc.load_achievable_rate(str(broken)).source == other  # falls through
    monkeypatch.delenv(dc.ENV)
    with pytest.raises(ValueError, match="n_rows"):
        dc.load_achievable_rate(two, n_rows=0)
    baked = dc.load_achievable_rate(str(tmp_path / "absent.json"))
    if dc.BAKED_RATES:
        assert baked.source == "baked" and baked.device == dc.BAKED_DEVICE
        rows = min(dc.BAKED_RATES, key=lambda k: abs(np.log(k / dc.DEFAULT_N_ROWS)))
        assert baked.points == tuple(
            (w, m * 1e9, lo * 1e9, hi * 1e9) for w, m, lo, hi in sorted(dc.BAKED_RATES[rows]))
    else:
        assert baked is None


def test_main_on_cpu_writes_what_the_reader_reads(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    res = dc.main(["-d", "cpu", "--rows-bytes", "256", "1024", "32768", "--n-rows", "64",
                   "--target-mb", "1", "--reps", "2", "--depth-sweep", "4", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "dma_random_row_gbps" and line["device"] == "cpu"
    assert "host clock" in line["timer"]
    data = json.loads(out.read_text())
    assert data == json.loads(json.dumps(res))
    # 32 KB rows do not fit a ring of 8: skipped; the depth sweep adds one point
    assert sorted((r["pattern"], r["row_bytes"], r["ring_depth"]) for r in data["sweep"]) == [
        ("random", 256, 8), ("random", 1024, 4), ("random", 1024, 8),
        ("sequential", 256, 8), ("sequential", 1024, 8)]
    for r in data["sweep"]:
        assert r["n_fetch"] == 4 * dc.T_E and r["n_rows"] == 64 and r["fits_l2"]
        assert r["table_bytes"] == 64 * r["row_bytes"] and r["g"] == dc.G
        assert 0 < r["gbps_lo"] <= r["gbps"] <= r["gbps_hi"]
    rate = dc.load_achievable_rate(str(out))
    assert rate.points[0][0] == 256 and rate.points[-1][0] == 1024
    r256 = [r for r in data["sweep"] if r["row_bytes"] == 256 and r["pattern"] == "random"]
    assert rate(256) == r256[0]["gbps"] * 1e9


def test_main_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dc.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
