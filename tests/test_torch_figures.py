"""The port's figures' data against the JAX package, on the CPU.

The ΔPCC histogram (the kernel's plain version here) against the JAX
package's numpy GEMM blocks: its d rounds differently, so counts must be
equal where no d lies within 1e-12 of a bin edge, and may differ by at most
the pairs that do elsewhere.  Against a direct ``np.histogram`` of the
port's own d the plain version is exact.  The host functions (save_diff,
hist_data_from_diff, the alpha distributions, the curves) must give the
JAX package's files byte for byte and its values exactly (the JS distance
within 1e-15).
"""
import json
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plagnn_tpu import cli as jax_cli
from plagnn_tpu.analysis import figures as jax_figures
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.analysis import figures
from plagnn_tpu_torch.data.expression import pcc_factors
from plagnn_tpu_torch.ops import pcc_scan

NEAR = 1e-12
DATASETS = ("GSE30931", "GSE74572", "GSE27182")


def _factors(n, k, seed, zero_row=False):
    """(z_inter, z_nor) of perturbed gamma expression, as pcc_factors makes
    them; ``zero_row``: row 1 has zero variance in both conditions."""
    rng = np.random.default_rng(seed)
    expr_n = rng.gamma(2.0, 2.0, (n, k))
    expr_i = expr_n * np.exp(0.1 * rng.standard_normal(expr_n.shape))
    if zero_row:
        expr_n[1] = expr_i[1] = 3.0
    return pcc_factors(expr_i), pcc_factors(expr_n)


def _ppi(n, seed, self_loop):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    if self_loop:
        r, c = np.append(r, 2), np.append(c, 2)
    return sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))


def _near_edge_pairs(z_i, z_n, bins):
    """Off-diagonal pairs whose numpy-GEMM d lies within NEAR of an edge."""
    d = z_i @ z_i.T - z_n @ z_n.T
    off = d[~np.eye(len(d), dtype=bool)]
    at = np.clip(np.searchsorted(bins, off), 1, len(bins) - 1)
    gap = np.minimum(np.abs(off - bins[at - 1]), np.abs(off - bins[at]))
    return int((gap <= NEAR).sum())


@pytest.mark.parametrize("n,zero_row,self_loop,block_rows", [
    (37, False, False, 2048), (37, True, True, 10), (300, False, True, 64),
    (300, True, False, 2048)])
def test_diff_histogram_matches_jax(monkeypatch, n, zero_row, self_loop, block_rows):
    z_i, z_n = _factors(n, 3, n + block_rows, zero_row)
    ppi = _ppi(n, n, self_loop)
    # the plain version's row blocks split the rows too
    monkeypatch.setattr(pcc_scan, "_PLAIN_BLOCK", block_rows * n)
    bins, linked, unlinked = figures.diff_histogram(z_i, z_n, ppi, device="cpu")
    jbins, jlinked, junlinked = jax_figures.diff_histogram(z_i, z_n, ppi,
                                                           block_rows=block_rows)
    assert np.array_equal(bins, jbins) and len(bins) == 201
    assert linked.dtype == unlinked.dtype == np.int64
    near = _near_edge_pairs(z_i, z_n, bins)
    if zero_row:
        assert near > 0  # d = 0 lies 1.78e-15 below the middle edge
        assert unlinked[99] + linked[99] >= 2 * (n - 1)
    else:
        assert near == 0
    assert np.abs(linked - jlinked).sum() <= 2 * near
    assert np.abs(unlinked - junlinked).sum() <= 2 * near
    if near == 0:
        assert np.array_equal(linked, jlinked) and np.array_equal(unlinked, junlinked)
    # every off-diagonal pair inside [-2, 2] is counted once
    assert linked.sum() + unlinked.sum() == n * n - n


def _csr_and_dense(n, seed):
    z_i, z_n = (torch.from_numpy(z) for z in _factors(n, 3, seed, zero_row=True))
    ppi = _ppi(n, seed, self_loop=True)
    csr = figures.positive_csr(ppi, "cpu")
    d = pcc_scan._diff_block(z_i, z_n, 0, n).numpy()
    dense = ppi.toarray() > 0
    return z_i, z_n, csr, d, dense


@pytest.mark.parametrize("n", [37, 200])
def test_plain_histogram_equals_np_histogram(n):
    """Custom edges that d takes exactly, d on the last edge, values below
    and above the range: the plain version equals np.histogram of the
    port's own d, linked and unlinked apart, the diagonal excluded."""
    z_i, z_n, csr, d, dense = _csr_and_dense(n, 5)
    off = ~np.eye(n, dtype=bool)
    vals = np.unique(d[off])
    edges = vals[np.linspace(len(vals) // 10, 9 * len(vals) // 10, 12).astype(int)]
    edges = np.unique(np.concatenate([edges, [0.0]]))  # the zero row's d = 0 on an edge
    linked, unlinked = pcc_scan.pcc_diff_histogram(z_i, z_n, torch.from_numpy(edges), csr)
    want_l = np.histogram(d[off & dense], edges)[0]
    want_u = np.histogram(d[off & ~dense], edges)[0]
    assert np.array_equal(linked.numpy(), want_l) and np.array_equal(unlinked.numpy(), want_u)
    assert (d[off] == edges[-1]).any() and (d[off] == edges[0]).any()
    assert (d[off] < edges[0]).any() and (d[off] > edges[-1]).any()
    assert linked.sum() + unlinked.sum() < off.sum()


def test_histogram_refuses_malformed_edges_and_wide_k():
    z_i, z_n, csr, _, _ = _csr_and_dense(37, 6)
    for bad in ([0.5], [0.0, 0.0, 1.0], [1.0, 0.0], [0.0, np.inf], [0.0, np.nan, 1.0]):
        with pytest.raises(ValueError, match="edges"):
            pcc_scan.pcc_diff_histogram(z_i, z_n, torch.tensor(bad, dtype=torch.float64), csr)
    with pytest.raises(TypeError, match="float64"):
        pcc_scan.pcc_diff_histogram(z_i, z_n, torch.tensor([0.0, 1.0]), csr)
    wide = torch.zeros((8, 17), dtype=torch.float64)
    no_edges = (torch.zeros(9, dtype=torch.int64), torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="k = 17"):
        pcc_scan.pcc_diff_histogram(wide, wide, torch.tensor([0.0, 1.0], dtype=torch.float64),
                                    no_edges)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A 160-node synth bundle trained by the port's CLI (2 rounds x 2 folds
    of 2 epochs, normal and perturbation), with a perturbed expr_inter.npy
    per dataset."""
    root = str(tmp_path_factory.mktemp("fig") / "data")
    cli.main(["synth", "--data-root", root, "--nodes", "160", "--edges", "1200"])
    flags = ["-data", "GSE30931", "--data-root", root, "-d", "cpu", "-e", "2",
             "--rounds", "2", "-f", "2", "--fold-batch", "2"]
    cli.main(["train-normal"] + flags)
    cli.main(["train-inter"] + flags)
    rng = np.random.default_rng(9)
    for name in DATASETS:
        d = os.path.join(root, "generate_materials", f"{name}_data")
        expr_n = np.load(os.path.join(d, "expr_normal.npy"))
        np.save(os.path.join(d, "expr_inter.npy"),
                expr_n * np.exp(0.1 * rng.standard_normal(expr_n.shape)))
    return root


def _read(*parts):
    with open(os.path.join(*parts), "rb") as f:
        return f.read()


def test_save_diff_and_hist_data_byte_identical(bundle, tmp_path):
    gm = os.path.join(bundle, "generate_materials")
    d = os.path.join(gm, "GSE30931_data")
    z_i = pcc_factors(np.load(os.path.join(d, "expr_inter.npy")))
    z_n = pcc_factors(np.load(os.path.join(d, "expr_normal.npy")))
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
    outs = {}
    for name, mod in (("port", figures), ("jax", jax_figures)):
        out = str(tmp_path / name)
        os.makedirs(out)
        mod.save_diff(z_i, z_n, ppi, out, block_rows=64)
        outs[name] = (out, mod.hist_data_from_diff(out))
    for f in ("diff.npy", "diff_link.npy", "diff_unlink.npy", "hist_data.json"):
        assert _read(outs["port"][0], f) == _read(outs["jax"][0], f), f
    assert outs["port"][1] == outs["jax"][1]


def test_host_figure_data_matches_jax(bundle, tmp_path):
    gm = os.path.join(bundle, "generate_materials")
    loc_path = os.path.join(gm, "loc_matrix.npz")
    assert figures.subcellular_fig_data(loc_path) == jax_figures.subcellular_fig_data(loc_path)
    pred = np.random.default_rng(3).random((50, 12)) > 0.7
    assert np.array_equal(figures.organelle_distribution(pred),
                          jax_figures.organelle_distribution(pred))
    loc = sp.load_npz(loc_path).toarray()
    label_dist = loc.sum(0) / max(loc.sum(), 1)
    log_root = os.path.join(bundle, "log")
    assert figures.fig_alpha_data_from_txt(log_root) == jax_figures.fig_alpha_data_from_txt(
        log_root)
    for cond in ("normal", "perturbation"):
        ld = os.path.join(log_root, "GSE30931", cond)
        # the JSON channel, and the txt fallback on a copy without it
        bare = str(tmp_path / cond)
        shutil.copytree(ld, bare)
        for fd in (f for f in os.listdir(bare) if f.startswith("fig_data_")):
            data = json.loads(_read(bare, fd))
            for folds in data["validation"].values():
                for curves in folds.values():
                    curves.pop("pred_num_final")
            with open(os.path.join(bare, fd), "w") as f:
                json.dump(data, f)
        for d in (ld, bare):
            got = figures.final_pred_counts(d, "0.1")
            assert got.shape == (4, 12)
            assert np.array_equal(got, jax_figures.final_pred_counts(d, "0.1"))
        js = figures.fig_alpha(ld, str(tmp_path / f"{cond}.json"), label_dist)
        want = jax_figures.fig_alpha(ld, str(tmp_path / f"{cond}.png"), label_dist)
        assert js.keys() == want.keys() == {"0.1"}
        assert abs(js["0.1"] - want["0.1"]) <= 1e-15
        data = json.loads(_read(str(tmp_path / f"{cond}.json")))
        assert data["alphas"]["0.1"]["js"] == js["0.1"]
        assert data["label_dist"] == label_dist.tolist()
        for fd in sorted(f for f in os.listdir(ld) if f.startswith("fig_data_")):
            got = figures.fig_and_perf(os.path.join(ld, fd))
            want = jax_figures.fig_and_perf(os.path.join(ld, fd))
            assert got.keys() == want.keys()
            for m in want:
                assert got[m].keys() == want[m].keys()
                for alpha in want[m]:
                    assert np.array_equal(got[m][alpha], want[m][alpha])
    assert figures.fig_alpha(str(tmp_path / "nothing"), str(tmp_path / "none.json"),
                             label_dist) is None


def test_cli_figures_cpu_matches_jax(bundle, tmp_path, capsys):
    """figures -d cpu --diff-hist --alpha-dist --save-diff through the
    port's CLI: its JSON equals the JAX functions' results on the same
    files, and its diff*.npy and hist_data.json the JAX CLI's bytes."""
    root = str(tmp_path / "port")
    shutil.copytree(bundle, root)
    jax_root = str(tmp_path / "jax")
    shutil.copytree(os.path.join(bundle, "generate_materials"),
                    os.path.join(jax_root, "generate_materials"))
    written = cli.main(["figures", "--data-root", root, "-d", "cpu", "--diff-hist",
                        "--alpha-dist", "--save-diff"])
    assert "no PNG is drawn" in capsys.readouterr().out
    jax_cli.main(["figures", "--data-root", jax_root, "--save-diff"])
    gm, jgm = (os.path.join(r, "generate_materials") for r in (root, jax_root))
    ppi = sp.load_npz(os.path.join(gm, "PPI_normal.npz"))
    for name in DATASETS:
        d, jd = os.path.join(gm, f"{name}_data"), os.path.join(jgm, f"{name}_data")
        for f in ("diff.npy", "diff_link.npy", "diff_unlink.npy", "hist_data.json"):
            assert _read(d, f) == _read(jd, f), (name, f)
        z_i = pcc_factors(np.load(os.path.join(d, "expr_inter.npy")))
        z_n = pcc_factors(np.load(os.path.join(d, "expr_normal.npy")))
        bins, linked, unlinked = jax_figures.diff_histogram(z_i, z_n, ppi)
        assert _near_edge_pairs(z_i, z_n, bins) == 0
        hist = json.loads(_read(d, "diff_hist.json"))
        assert hist == {"bins": bins.tolist(), "linked": linked.tolist(),
                        "unlinked": unlinked.tolist()}
        assert os.path.join(d, "diff_hist.json") in written
    loc = sp.load_npz(os.path.join(gm, "loc_matrix.npz")).toarray()
    label_dist = loc.sum(0) / max(loc.sum(), 1)
    for cond in ("normal", "perturbation"):
        ld = os.path.join(root, "log", "GSE30931", cond)
        alpha = json.loads(_read(ld, "alpha_dist.json"))
        want = jax_figures.fig_alpha(ld, str(tmp_path / f"{cond}.png"), label_dist)
        assert abs(alpha["alphas"]["0.1"]["js"] - want["0.1"]) <= 1e-15
        curves = jax_figures.fig_and_perf(os.path.join(ld, "fig_data_2.json"))
        for m in ("AIM", "COV", "mlACC"):
            got = json.loads(_read(ld, f"{m}.json"))
            assert got == {a: c.tolist() for a, c in curves[m].items()}
            assert os.path.join(ld, f"{m}.json") in written


def test_cli_figures_diff_hist_needs_a_card_or_cpu(bundle, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "data")
    shutil.copytree(bundle, root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["figures", "--data-root", root, "--diff-hist"])
    assert not os.path.exists(os.path.join(root, "generate_materials", "GSE30931_data",
                                           "diff_hist.json"))
    # without --diff-hist no device is needed
    written = cli.main(["figures", "--data-root", root, "--alpha-dist"])
    assert os.path.join(root, "log", "GSE30931", "normal", "alpha_dist.json") in written
