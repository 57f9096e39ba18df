"""The port's mesh planner (plagnn_tpu_torch/parallel/planner.py, the CLI's
``plan-mesh`` and ``--mesh auto``) against the JAX package's
(plagnn_tpu/parallel/planner.py, benchmarks/anchors_io.py).

The halo counts and the rate interpolation must equal JAX's exactly; the
whole candidate table and the pick equal JAX's ``part="v5e"`` plan once the
port's link egress and stride alignment are patched to JAX's v5e values (in
these tests only: the port's own are the H100's).  Anchors resolve from an
explicit path, then ``$PLAGNN_TORCH_ANCHORS``, then the baked constants,
never from the JAX package's file or variable.
"""
import builtins
import dataclasses
import json
import os
import re

import numpy as np
import pytest

from plagnn_tpu.parallel import planner as jp
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.parallel import planner as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tolerance tests/test_torch_parallel.py holds a mesh run's logits to
LOGITS_ATOL = 1e-4


def _graph(seed, n=300, e=3000):
    """A seeded power-law-ish graph (hubs clustered at low ids, so the
    contiguous blocks are skewed) with self-loops."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    dst = rng.choice(n, e, p=w / w.sum())
    src = rng.integers(0, n, e)
    loops = np.arange(n)
    return np.concatenate([src, loops]), np.concatenate([dst, loops]), n


def _assert_counts_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["own_rows"] == want["own_rows"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_counts_1d_equal_jax(p, balanced):
    src, dst, n = _graph(p)
    _assert_counts_equal(tp.counts_1d(src, dst, n, p, balanced=balanced),
                         jp.counts_1d(src, dst, n, p, balanced=balanced))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("grid", [(2, 2), (2, 4)])
def test_counts_2d_equal_jax(grid, balanced):
    src, dst, n = _graph(11 + grid[1])
    _assert_counts_equal(tp.counts_2d(src, dst, n, *grid, balanced=balanced),
                         jp.counts_2d(src, dst, n, *grid, balanced=balanced))


def test_counts_1d_hand_checked_case():
    """tests/test_planner.py's hand-checked case: 4 nodes, 2 ranks."""
    src = np.array([0, 1, 2, 3, 0])
    dst = np.array([2, 3, 0, 3, 1])
    cts = tp.counts_1d(src, dst, 4, 2, balanced=False)
    _assert_counts_equal(cts, jp.counts_1d(src, dst, 4, 2, balanced=False))
    np.testing.assert_array_equal(cts["edges_per_chip"], [2, 3])
    np.testing.assert_array_equal(cts["boundary_per_chip"], [1, 2])
    np.testing.assert_array_equal(cts["halo_recv_rows"], [1, 2])
    np.testing.assert_array_equal(cts["halo_send_rows"], [2, 1])


def test_snake_rows_is_the_partition_dealing():
    """The planner counts halos on partition_graph's own dealing."""
    from plagnn_tpu_torch.parallel.partition import partition_graph

    src, dst, n = _graph(3)
    pg = partition_graph(src, dst, n, 4, balance=True)
    deg = np.bincount(dst, minlength=n).astype(np.int64)
    np.testing.assert_array_equal(pg.node_row, tp._snake_rows(deg, 4, pg.own_rows))
    np.testing.assert_array_equal(tp._snake_rows(deg, 4, 80), jp._snake_rows(deg, 4, 80))


RATES = {10: 1.5e9, 16: 2.1e9, 24: 2.4e9, 32: 2.3e9, 64: 2.6e9}


@pytest.mark.parametrize("b", [1, 5, 10, 13, 16, 20, 24, 31, 32, 40, 64, 200])
def test_rate_single_chip_equals_jax(b):
    assert tp.rate_single_chip(b, RATES) == jp.rate_single_chip(b, RATES)


def test_rate_single_chip_at_anchors_and_ends():
    for b, r in RATES.items():
        assert tp.rate_single_chip(b, RATES) == r
    assert tp.rate_single_chip(5, RATES) == RATES[10] * 0.5       # ~b below
    assert tp.rate_single_chip(500, RATES) == RATES[64]           # flat past
    assert tp.rate_single_chip(20, RATES) == pytest.approx((RATES[16] + RATES[24]) / 2)


def _anchor_file(path, **fields):
    raw = {"bf16_rates": {str(b): r for b, r in RATES.items()},
           "structure_tax": 1.07, "hbm_fold_ceiling_full_graph": 40}
    raw.update(fields)
    path.write_text(json.dumps(raw))
    return str(path)


def test_load_anchors_path_env_baked(tmp_path, monkeypatch):
    """An explicit path, then $PLAGNN_TORCH_ANCHORS, then the baked
    constants; a malformed, empty, non-positive or tax < 1 file falls
    through.  Neither the JAX package's anchors file nor $PLAGNN_ANCHORS is
    ever opened."""
    opened = []
    real_open = builtins.open

    def recording_open(file, *a, **kw):
        opened.append(os.fspath(file))
        return real_open(file, *a, **kw)

    jax_file = _anchor_file(tmp_path / "jax.json")
    monkeypatch.setenv("PLAGNN_ANCHORS", jax_file)
    monkeypatch.delenv(tp.ANCHORS_ENV, raising=False)
    monkeypatch.setattr(builtins, "open", recording_open)

    baked = tp.load_anchors()
    assert baked["source"] == "baked" and baked["rates"] == tp.MEASURED_BF16_RATES
    assert (baked["tax"], baked["hbm_ceiling"], baked["max_b"]) == (
        tp.SHARD_STRUCTURE_TAX, tp.HBM_FOLD_CEILING_FULL_GRAPH, tp.MAX_MEASURED_B)
    assert opened == []

    env_file = _anchor_file(tmp_path / "env.json", structure_tax=1.2)
    monkeypatch.setenv(tp.ANCHORS_ENV, env_file)
    anc = tp.load_anchors()
    assert anc == {"rates": RATES, "tax": 1.2, "hbm_ceiling": 40, "max_b": 64,
                   "source": env_file}
    given = _anchor_file(tmp_path / "given.json")
    assert tp.load_anchors(given)["source"] == given      # the path beats the env
    assert tp.load_anchors("baked")["source"] == "baked"  # "baked" pins the constants

    bad = {"malformed": "{not json",
           "empty": json.dumps({"bf16_rates": {}}),
           "non_positive": json.dumps({"bf16_rates": {"10": 1e9, "16": 0.0}}),
           "tax_below_1": json.dumps({"bf16_rates": {"10": 1e9}, "structure_tax": 0.9}),
           "no_rates": json.dumps({"structure_tax": 1.1})}
    for name, text in bad.items():
        f = tmp_path / f"{name}.json"
        f.write_text(text)
        assert tp.load_anchors(str(f))["source"] == env_file, name
    monkeypatch.setenv(tp.ANCHORS_ENV, str(tmp_path / "malformed.json"))
    assert tp.load_anchors(str(tmp_path / "missing.json"))["source"] == "baked"
    assert not [p for p in opened if p == jax_file or "benchmarks" in p], opened


def test_write_anchors_leaves_jax_writers_json(tmp_path, monkeypatch):
    """The same calls through write_anchors and benchmarks/anchors_io.py's
    update_anchors leave the same JSON, the provenance stamps aside."""
    monkeypatch.syspath_prepend(ROOT)
    from benchmarks.anchors_io import update_anchors

    calls = [
        ({"bf16_rates": {"10": 1.5e9, "16": 2.0e9}, "structure_tax": 1.05}, "sweep"),
        ({"bf16_rates": {"32": 2.2e9, "10": 1.6e9}}, "partial sweep"),
        ({"hbm_fold_ceiling_full_graph": 150, "structure_tax": 1.0}, "ceiling"),
    ]
    paths = {"port": str(tmp_path / "port" / "a.json"), "jax": str(tmp_path / "jax" / "a.json")}
    stamp = re.compile(r" @ \d{4}-\d\d-\d\d \d\d:\d\d:\d\d$")

    def written():
        out = []
        for k in ("port", "jax"):
            with open(paths[k]) as f:
                d = json.load(f)
            d["provenance"] = {k: stamp.sub("", v) for k, v in d["provenance"].items()}
            out.append(d)
        return out

    for fields, writer in calls:
        assert tp.write_anchors(fields, writer, paths["port"]) == paths["port"]
        update_anchors(fields, writer, paths["jax"])
    got, want = written()
    assert got == want
    assert got["bf16_rates"] == {"10": 1.6e9, "16": 2.0e9, "32": 2.2e9}
    assert got["provenance"] == {"bf16_rates": "partial sweep", "structure_tax": "ceiling",
                                 "hbm_fold_ceiling_full_graph": "ceiling"}
    for p in paths.values():     # a truncated file is started over, in both
        with open(p, "a") as f:
            f.write("{")
    tp.write_anchors({"bf16_rates": {"64": 2.5e9}}, "after truncation", paths["port"])
    update_anchors({"bf16_rates": {"64": 2.5e9}}, "after truncation", paths["jax"])
    got, want = written()
    assert got == want
    assert got == {"bf16_rates": {"64": 2.5e9}, "provenance": {"bf16_rates": "after truncation"}}


def _v5e_constants(monkeypatch):
    """The port's link and stride constants set to the JAX planner's v5e ones."""
    monkeypatch.setitem(tp.LINK_EGRESS, "h100-sxm", jp.ICI_EGRESS["v5e"])
    monkeypatch.setattr(tp, "STRIDE_ALIGN", {"bfloat16": 2048, "float32": 1024})


@pytest.mark.parametrize("d", [2, 4, 8])
def test_plan_mesh_table_equals_jax(d, tmp_path, monkeypatch):
    """Under JAX's v5e constants and one anchors file, the port's whole
    candidate table (1-D and 2-D), its pick and its summary equal JAX's."""
    _v5e_constants(monkeypatch)
    anchors = _anchor_file(tmp_path / "anchors.json")
    src, dst, n = _graph(d, n=1200, e=15000)
    want = jp.plan_mesh(d, src, dst, n, total_jobs=100, part="v5e", include_2d=True,
                        anchors_path=anchors)
    got = tp.plan_mesh(d, src, dst, n, total_jobs=100, include_2d=True,
                       anchors_path=anchors)
    assert [dataclasses.asdict(c) for c in got.table] == [
        dataclasses.asdict(c) for c in want.table]
    assert dataclasses.asdict(got.chosen) == dataclasses.asdict(want.chosen)
    assert (got.n_devices, got.b_single, got.b_min_measured, got.anchors_source) == (
        want.n_devices, want.b_single, want.b_min_measured, want.anchors_source)
    assert got.summary() == want.summary()


def test_plan_mesh_hbm_bound_and_tail_equal_jax(tmp_path, monkeypatch):
    """A tight HBM bound (local fold batches capped, the single card
    HBM-limited) and a job count that leaves a partial last chunk."""
    _v5e_constants(monkeypatch)
    anchors = _anchor_file(tmp_path / "anchors.json")
    src, dst, n = _graph(5, n=1200, e=15000)
    kw = dict(total_jobs=37, hbm_node_folds=8 * n, b_candidates=(6, 10, 20))
    want = jp.plan_mesh(4, src, dst, n, part="v5e", anchors_path=anchors, **kw)
    got = tp.plan_mesh(4, src, dst, n, anchors_path=anchors, **kw)
    assert [dataclasses.asdict(c) for c in got.table] == [
        dataclasses.asdict(c) for c in want.table]
    assert dataclasses.asdict(got.chosen) == dataclasses.asdict(want.chosen)
    assert got.b_single == want.b_single == 8


def test_plan_mesh_cli_prints_the_plan(capsys, monkeypatch):
    monkeypatch.delenv(tp.ANCHORS_ENV, raising=False)
    plan = cli.main(["plan-mesh", "--devices", "8", "--nodes", "600", "--edges", "3000",
                     "--jobs", "30", "--part", "h100-pcie"])
    out = capsys.readouterr().out
    assert "mesh planner: D=8" in out and "anchors: baked" in out
    assert plan.summary() in out
    assert {(c.mesh_fold, c.mesh_graph) for c in plan.table} == {
        (1, 8), (2, 4), (4, 2), (8, 1)}


def test_parse_mesh_auto_matches_jax():
    from plagnn_tpu.cli import parse_mesh as jax_parse_mesh

    for spec in ("auto", "auto:1", "auto:8", " auto:3 "):
        assert cli.parse_mesh(spec) == jax_parse_mesh(spec)
    for spec in ("auto:0", "auto:x", "auto:-2"):
        with pytest.raises(SystemExit):
            jax_parse_mesh(spec)
        with pytest.raises(SystemExit):
            cli.parse_mesh(spec)


def _synth(root, nodes=96, edges=400):
    cli.main(["synth", "--data-root", str(root), "--nodes", str(nodes),
              "--edges", str(edges), "--seed", "7"])
    return str(root)


def _logits(root):
    d = os.path.join(root, "log", "GSE30931", "normal")
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith(".npy")}


def test_plan_auto_resolves_devices_and_fold_batch(tmp_path, monkeypatch, capsys):
    """_plan_auto plans from the condition's graph with its self-loops, D
    from the suffix, else the launcher's world size, else the visible
    cards, else 1 under -d cpu; an explicit --fold-batch constrains the
    local fold batches and warns when the pick cannot give it."""
    import argparse

    import scipy.sparse as sp

    import torch

    monkeypatch.delenv(tp.ANCHORS_ENV, raising=False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    root = _synth(tmp_path)
    coo = sp.load_npz(os.path.join(root, "generate_materials", "PPI_normal.npz")).tocoo()
    loops = np.arange(coo.shape[0])
    src, dst = np.concatenate([coo.row, loops]), np.concatenate([coo.col, loops])

    def plan(n_dev, d="cpu", fold_batch=None):
        args = argparse.Namespace(d=d, data_root=root, data="GSE30931", rounds=2, f=3,
                                  fold_batch=fold_batch, mesh="auto")
        cli._plan_auto(args, "normal", n_dev)
        return args

    one = tp.plan_mesh(1, src, dst, coo.shape[0], total_jobs=6).chosen
    assert (plan(None).mesh, plan(None).fold_batch) == ("fold=1,graph=1", one.fold_batch)
    for n_dev in (2, 4):
        want = tp.plan_mesh(n_dev, src, dst, coo.shape[0], total_jobs=6).chosen
        got = plan(n_dev)
        assert got.mesh == f"fold={want.mesh_fold},graph={want.mesh_graph}"
        assert got.fold_batch == want.fold_batch
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert plan(None).mesh == plan(4).mesh
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert plan(None, d="cuda").mesh == plan(2).mesh
    capsys.readouterr()
    want = tp.plan_mesh(4, src, dst, coo.shape[0], total_jobs=6, b_candidates=[6]).chosen
    got = plan(4, fold_batch=6)
    assert got.fold_batch == want.fold_batch
    warned = "requested --fold-batch 6 is not achievable" in capsys.readouterr().out
    assert warned == (want.fold_batch != 6)


def test_mesh_auto_plan_past_the_cards_raises(tmp_path, monkeypatch):
    """A plan for more cards than are visible raises before any rank starts."""
    import torch

    monkeypatch.delenv(tp.ANCHORS_ENV, raising=False)
    root = _synth(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        cli.main(["train-normal", "-data", "GSE30931", "--data-root", root,
                  "--mesh", "auto:2", "-e", "1", "--rounds", "1", "-f", "3"])


def test_train_mesh_auto_equals_the_chosen_mesh(tmp_path, monkeypatch, capsys):
    """train-normal --mesh auto:2 -d cpu prints the plan and trains on its
    mesh: the logits equal an explicit run at the fold=F,graph=P and fold
    batch it chose."""
    monkeypatch.delenv(tp.ANCHORS_ENV, raising=False)
    flags = ["-data", "GSE30931", "-d", "cpu", "-e", "2", "--rounds", "1", "-f", "3"]
    auto, explicit = _synth(tmp_path / "auto"), _synth(tmp_path / "explicit")
    capsys.readouterr()
    cli.main(["train-normal", "--data-root", auto, "--mesh", "auto:2"] + flags)
    out = capsys.readouterr().out
    m = re.search(r"mesh planner: D=2 -> fold=(\d+) x graph=(\d+) \(b_local=\d+, "
                  r"fold_batch=(\d+)", out)
    assert m, out
    fold, graph, fold_batch = map(int, m.groups())
    assert fold * graph == 2
    cli.main(["train-normal", "--data-root", explicit, "--mesh",
              f"fold={fold},graph={graph}", "--fold-batch", str(fold_batch)] + flags)
    got, want = _logits(auto), _logits(explicit)
    assert sorted(got) == sorted(want) and len(got) == 3
    for f in want:
        np.testing.assert_allclose(got[f], want[f], atol=LOGITS_ATOL, rtol=0, err_msg=f)

