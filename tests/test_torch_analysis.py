"""The port's post-training analysis (score, performance, statistics) against
the JAX package, on the CPU.

One 512-node synthetic bundle with 2 rounds x 3 folds of normal and
perturbation logits, a perturbed ``expr_inter`` per dataset and the
port-computed ``PPI_inter``; each package (and the port's CLI) runs on its
own copy of the directory.  The files must be byte-identical; the metrics
equal, the AUC (a rank statistic here, sklearn's trapezoid in the JAX
package) within 1e-12.
"""
import importlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from sklearn.metrics import roc_auc_score

from plagnn_tpu.analysis import score as jax_score
from plagnn_tpu.analysis import statistics as jax_statistics
from plagnn_tpu.data.topology import diff_stats as jax_diff_stats
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.analysis import performance, score, statistics
from plagnn_tpu_torch.data.expression import pcc_factors
from plagnn_tpu_torch.data.topology import modify_network_topology

# the JAX analysis package re-exports its function ``performance`` under the
# module's name
jax_performance = importlib.import_module("plagnn_tpu.analysis.performance")

NODES, EDGES, ROUNDS, FOLDS = 512, 4000, 2, 3
DATASETS = (("GSE30931", 2.75), ("GSE74572", 2.91), ("GSE27182", 2.99))
AUC_KEYS = ("AUC_micro", "AUC_macro")

pytestmark = pytest.mark.filterwarnings("ignore:mat_merge")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The bundle's root: synth, logits, perturbed expression and topology.
    Asserts that no pair's ΔPCC lies within 1e-12 of a dataset's
    thresholds, so the two packages' counts can be compared exactly."""
    root = str(tmp_path_factory.mktemp("bundle") / "data")
    cli.main(["synth", "--data-root", root, "--nodes", str(NODES),
              "--edges", str(EDGES)])
    gm = os.path.join(root, "generate_materials")
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
    rng = np.random.default_rng(5)
    for i, (name, thr) in enumerate(DATASETS):
        d = os.path.join(gm, f"{name}_data")
        expr_n = np.load(os.path.join(d, "expr_normal.npy"))
        expr_i = expr_n * np.exp(0.1 * rng.standard_normal(expr_n.shape))
        np.save(os.path.join(d, "expr_inter.npy"), expr_i)
        z_n, z_i = pcc_factors(expr_n), pcc_factors(expr_i)
        mean, std = jax_diff_stats(z_i, z_n)
        diff = z_i @ z_i.T - z_n @ z_n.T
        np.fill_diagonal(diff, 0.0)
        for t in (mean - thr * std, mean + thr * std):
            assert np.abs(diff - t).min() > 1e-12, name
        sp.save_npz(os.path.join(d, "PPI_inter"),
                    modify_network_topology(ppi, z_n, z_i, thr, device="cpu"))
    for state in ("normal", "perturbation"):
        log = os.path.join(root, "log", "GSE30931", state)
        os.makedirs(log)
        for r in range(1, ROUNDS + 1):
            for f in range(1, FOLDS + 1):
                np.save(os.path.join(log, f"{r}_{f}_loc_logits.npy"),
                        rng.random((NODES, 12)).astype(np.float32))
    return root


def _copy(bundle, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(bundle, dst)
    return dst


def _merge(root, merge_fn):
    merge_fn(os.path.join(root, "log"), NODES, rounds=ROUNDS, fold_num=FOLDS)


@pytest.fixture(scope="module")
def jax_run(bundle, tmp_path_factory):
    """The JAX package's score, performance and statistics on one copy."""
    root = _copy(bundle, tmp_path_factory.mktemp("jax"), "data")
    jax_score.score_all(root)
    _merge(root, jax_performance.mat_merge)
    perf = jax_performance.performance(root, rounds=ROUNDS, verbose=False)
    stats = jax_statistics.topology_statistics(root, verbose=False)
    return root, perf, stats


def _read(root, *parts):
    with open(os.path.join(root, *parts), "rb") as f:
        return f.read()


def _assert_same_outputs(root, jax_root):
    for name in ("loc_change_record.csv", "res_alldata.json"):
        assert _read(root, "res", "GSE30931", name) == _read(jax_root, "res", "GSE30931", name)
    assert _read(root, "log", "statistics.txt") == _read(jax_root, "log", "statistics.txt")


def _assert_same_performance(got, want):
    assert got.keys() == want.keys()
    for key, metrics in want.items():
        assert got[key].keys() == metrics.keys(), key
        for m, v in metrics.items():
            if m in AUC_KEYS:
                assert abs(got[key][m] - v) <= 1e-12, (key, m)
            else:
                assert got[key][m] == v, (key, m)


def test_score_all_files_byte_identical(bundle, jax_run, tmp_path):
    root = _copy(bundle, tmp_path, "data")
    score.score_all(root)
    for name in ("loc_change_record.csv", "res_alldata.json", "normal_logits.npy",
                 "perturbation_logits.npy"):
        assert _read(root, "res", "GSE30931", name) == _read(jax_run[0], "res", "GSE30931", name)
    with open(os.path.join(root, "res", "GSE30931", "loc_change_record.csv")) as f:
        assert len(f.readlines()) > 100
    assert json.loads(_read(root, "res", "GSE30931", "res_alldata.json"))


def test_performance_matches_jax(bundle, jax_run, tmp_path):
    root = _copy(bundle, tmp_path, "data")
    _merge(root, performance.mat_merge)
    got = performance.performance(root, rounds=ROUNDS, verbose=False)
    _assert_same_performance(got, jax_run[1])
    assert "AUC_micro" in got["GSE30931/normal"]
    assert set(got) == {"GSE30931/normal", "random_limit", "random"}


def test_topology_statistics_matches_jax(bundle, jax_run, tmp_path):
    root = _copy(bundle, tmp_path, "data")
    got = statistics.topology_statistics(root, verbose=False, device="cpu")
    assert _read(root, "log", "statistics.txt") == _read(jax_run[0], "log", "statistics.txt")
    want = jax_run[2]
    assert got.keys() == want.keys() == {name for name, _ in DATASETS}
    for name, res in want.items():
        assert got[name].keys() == res.keys()
        for key, v in res.items():
            if key in ("mean", "std"):
                assert math.isclose(got[name][key], v, rel_tol=1e-12, abs_tol=0.0)
            else:
                assert got[name][key] == v, (name, key)
        assert res["added"] > 0 and res["removed"] > 0 and res["r_num"] > 0


def test_port_cli_subcommands(bundle, jax_run, tmp_path):
    """score, performance and statistics -d cpu through the port's CLI."""
    root = _copy(bundle, tmp_path, "data")
    assert cli.main(["score", "--data-root", root]) is None
    perf = cli.main(["performance", "--data-root", root, "--rounds", str(ROUNDS),
                     "--folds", str(FOLDS)])
    stats = cli.main(["statistics", "--data-root", root, "-d", "cpu"])
    _assert_same_outputs(root, jax_run[0])
    _assert_same_performance(perf, jax_run[1])
    assert {k: v["r_num"] for k, v in stats.items()} == {
        k: v["r_num"] for k, v in jax_run[2].items()}


def test_statistics_without_card_raises(bundle, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = _copy(bundle, tmp_path, "data")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["statistics", "--data-root", root])
    assert not os.path.exists(os.path.join(root, "log", "statistics.txt"))


@pytest.mark.parametrize("seed", range(6))
def test_rank_auc_matches_sklearn_on_ties(seed):
    """Tie-heavy scores (a few distinct levels), unbalanced labels."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(20, 4000))
    labels = (rng.random(m) < rng.uniform(0.05, 0.5)).astype(np.float64)
    labels[:2] = (0.0, 1.0)
    levels = int(rng.integers(2, 9))
    scores = rng.integers(0, levels, m) / levels
    if seed % 2:
        scores = scores + (rng.random(m) < 0.5) * rng.random(m)
    got = performance.roc_auc(labels, scores)
    assert abs(got - roc_auc_score(labels, scores)) <= 1e-12


def test_rank_auc_one_class_nan():
    """One class only: the port warns and returns nan, as the sklearn
    installed beside the JAX package does, with sklearn's message and a
    UserWarning subclass of sklearn's name; more than two classes still
    raise."""
    labels = np.zeros(10)
    scores = np.linspace(0, 1, 10)
    msg = ("Only one class is present in y_true. ROC AUC score is not defined "
           "in that case.")
    with pytest.warns(performance.UndefinedMetricWarning) as got:
        assert np.isnan(performance.roc_auc(labels, scores))
    with pytest.warns(UserWarning) as want:
        assert np.isnan(roc_auc_score(labels, scores))
    assert [str(w.message) for w in got] == [str(w.message) for w in want] == [msg]
    assert issubclass(performance.UndefinedMetricWarning, UserWarning)
    assert type(want[0].message).__name__ == "UndefinedMetricWarning"
    with pytest.warns(performance.UndefinedMetricWarning):
        assert np.isnan(performance.roc_auc(np.ones(4), scores[:4]))
    with pytest.raises(ValueError, match="binary"):
        performance.roc_auc(np.arange(10) % 3, scores)
