"""The port's preprocess stage (BioGRID, UniProt, GEO, expression, ECC, PCA)
against the JAX package, on the CPU.

Raw inputs are made inside the tests from a seed (a mitab, one expression
CSV per dataset, a UniProt dat and the cellular-component list, as
tests/test_preprocess_pipeline.py makes them); each package runs on its own
copy.  Held exactly: the JSON files (bytes), every .npz array (values and
dtype), ``expr_*.npy`` (bytes: the CSV values have 15-17 significant digits
and 1-3 probes per protein in shuffled order, so the float parser and the
compensated group mean are both exercised), the ECC counts and the geo CSV
(bytes).  The PCA features are sklearn's to rounding, within PCA_RTOL of
the largest singular value (the port's products and factorizations round
differently from sklearn's), where the PCA is defined: see
``assert_pca_close`` for columns whose singular values (nearly) coincide
and for loadings whose sign svd_flip cannot tell.
"""
import csv
import gzip
import io
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from scipy.linalg import lu as scipy_lu
from sklearn.decomposition import PCA

from plagnn_tpu.data import ecc as jax_ecc
from plagnn_tpu.data import expression as jax_expression
from plagnn_tpu.data import geo as jax_geo
from plagnn_tpu.data import preprocess as jax_preprocess
from plagnn_tpu.data.synthetic import powerlaw_ppi
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.data import csv_values, ecc, expression, geo, pca, preprocess
from plagnn_tpu_torch.data.artifacts import load_condition
from plagnn_tpu_torch.ops import common_neighbors as cn
from plagnn_tpu_torch.ops.pcc_scan import csr_tensors

PCA_RTOL = 1e-9   # per column, relative to the largest singular value
SIGMA_GAP = 1e-6  # least relative gap between neighbouring singular values
CC_TERMS = ["GO:0005938", "GO:0005829", "GO:0015629", "GO:0005794",
            "GO:0005783", "GO:0005730", "GO:0005777", "GO:0005739",
            "GO:0005764", "GO:0005813", "GO:0005634", "GO:0005886"]
MITAB = "BIOGRID-ORGANISM-Homo_sapiens-4.4.203.mitab.txt"


def _value(rng):
    """An expression value with 15-17 significant digits."""
    v = rng.gamma(2.0, 2.0) * 10.0 ** rng.integers(-3, 4)
    return f"{v:.{int(rng.integers(15, 18))}g}"


def make_raw_inputs(root, n_prot, n_edges, seed):
    """The raw files ``preprocess`` reads, under root/support_materials."""
    rng = np.random.default_rng(seed)
    sm = os.path.join(root, "support_materials")
    os.makedirs(sm, exist_ok=True)
    prots = [f"P{i:05d}" for i in range(n_prot)]

    edges = set()
    while len(edges) < n_edges:
        a, b = rng.integers(0, n_prot, 2)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    with open(os.path.join(sm, MITAB), "w") as f:
        f.write("#header\n")
        for k, (a, b) in enumerate(sorted(edges)):
            mi = ("psi-mi:MI:0915(physical association)", "psi-mi:MI:0407(direct)",
                  "psi-mi:MI:0403(colocalization)")[k % 3]
            f.write("\t".join(["x", "y", f"biogrid:1|uniprot/swiss-prot:{prots[a]}|x",
                               f"biogrid:2|uniprot/swiss-prot:{prots[b]}|y"]
                              + ["-"] * 7 + [mi]) + "\n")
        f.write("\t".join(["x", "y", "uniprot/swiss-prot:Q99999", "uniprot/swiss-prot:Q88888"]
                          + ["-"] * 7 + ["psi-mi:MI:0999(other)"]) + "\n")

    for ds in preprocess.DEFAULT_DATASETS:
        samples = list(ds.normal_samples) + list(ds.intervention_samples)
        rows = []
        for p in prots:
            if rng.random() < 0.05:
                continue  # a protein without probes: zero-filled
            rows += [[p] + [_value(rng) for _ in samples]
                     for _ in range(int(rng.integers(1, 4)))]
        rows += [[f"X{i:04d}"] + [_value(rng) for _ in samples] for i in range(5)]
        with open(os.path.join(root, ds.expr_csv), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "uniprot_id"] + samples)
            for k, i in enumerate(rng.permutation(len(rows))):
                w.writerow([k + 1] + rows[i])

    with open(os.path.join(sm, "cellular_component.txt"), "w") as f:
        f.write("\n".join(CC_TERMS) + "\n")
    entries = []
    for p in prots:
        lines = [f"ID   {p}_HUMAN", f"AC   {p};"]
        for go in rng.choice(CC_TERMS, size=rng.integers(0, 4), replace=False):
            lines.append(f"DR   GO; {go}; C:somewhere; "
                         f"{rng.choice(['IDA', 'IEA', 'TAS'])}:x.")
        entries.append("\n".join(lines) + "\n")
    with gzip.open(os.path.join(sm, "uniprot_sprot_human.dat.gz"), "wt") as f:
        f.write("//\n".join(entries) + "//\n")


def _files(root):
    out = {}
    for base, _, names in os.walk(os.path.join(root, "generate_materials")):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, root)] = path
    return out


def assert_pca_close(got, want, mat, n):
    """got and want agree where the PCA is defined: the input's singular
    values fall into clusters closer than SIGMA_GAP (relative to the
    largest, s0) to their neighbours.  A lone value's column is compared
    entry by entry; a cluster inside the cut by its columns' Gram matrix C
    Cᵀ (a rotation within the cluster leaves it unchanged); a cluster that
    the cut splits (only under the full solver, whose columns are exact
    singular vectors) by each column's norm and its distance from the
    cluster's subspace.  Tolerance PCA_RTOL·s0 (PCA_RTOL·s0² for Gram
    entries)."""
    x = mat.toarray() if sp.issparse(mat) else np.asarray(mat)
    xc = x - x.mean(0)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = PCA_RTOL * s[0]
    cuts = np.flatnonzero(np.diff(-s) >= SIGMA_GAP * s[0]) + 1
    for a, b in zip(np.concatenate([[0], cuts]), np.concatenate([cuts, [len(s)]])):
        if a >= n:
            break
        g, w = got[:, a:min(b, n)], want[:, a:min(b, n)]
        if b - a == 1:
            if np.abs(g - w).max() > tol:  # the flip's sign may be undefined
                assert _sign_tie(xc, w[:, 0], s[a]), f"column {a}"
                assert np.abs(g + w).max() <= tol, f"column {a}"
        elif b <= n:
            assert np.abs(g @ g.T - w @ w.T).max() <= tol * s[0], f"columns {a}-{b - 1}"
        else:
            assert pca.choose_solver(x.shape, n) == "full", \
                "the randomized solver's cut splits a cluster of singular values"
            basis = u[:, a:b]
            for m in (g, w):
                assert np.abs(m - basis @ (basis.T @ m)).max() <= tol
                assert np.abs(np.linalg.norm(m, axis=0) - s[a:n]).max() <= tol


def _sign_tie(xc, col, sigma):
    """svd_flip makes a component's largest-magnitude loading v positive;
    where loadings of both signs share that magnitude to rounding (1e-9
    relative: symmetric proteins), the sign is undefined.  v = Xcᵀ·col/σ²
    (col = u·σ)."""
    v = xc.T @ col / sigma ** 2
    top = v[np.abs(v) >= np.abs(v).max() * (1 - 1e-9)]
    return bool((top > 0).any() and (top < 0).any())


def _npy_header(path):
    with open(path, "rb") as f:
        return f.read(128)


def assert_same_artifacts(port_root, jax_root):
    """Every artifact of one run equals the other's (see the module doc)."""
    port, ref = _files(port_root), _files(jax_root)
    assert sorted(port) == sorted(ref)
    for rel, path in sorted(ref.items()):
        other = port[rel]
        if rel.endswith(".json"):
            assert open(other, "rb").read() == open(path, "rb").read(), rel
        elif rel.endswith(".npz"):
            a, b = np.load(other), np.load(path)
            assert sorted(a.files) == sorted(b.files), rel
            for key in b.files:
                assert a[key].dtype == b[key].dtype, (rel, key)
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{rel} {key}")
        elif rel.endswith("_pca.npy"):
            assert _npy_header(other) == _npy_header(path), rel
            src = rel.replace("_pca.npy", ".npz")
            if "GCN" in rel:
                ds_dir = os.path.dirname(path)
                cond = "normal" if "normal" in rel else "inter"
                ppi = (sp.load_npz(os.path.join(jax_root, "generate_materials",
                                                "PPI_normal.npz")) if cond == "normal"
                       else sp.load_npz(os.path.join(ds_dir, "PPI_inter.npz")))
                expr_ = np.load(os.path.join(ds_dir, f"expr_{cond}.npy"))
                mat = sp.csr_matrix(jax_expression.pcc_dense(expr_)).multiply(ppi.tocsr())
            else:
                mat = sp.load_npz(os.path.join(jax_root, src))
            n = np.load(path).shape[1]
            assert_pca_close(np.load(other), np.load(path), mat, n)
        else:
            assert open(other, "rb").read() == open(path, "rb").read(), rel


# (proteins, PPI pairs, PCA components, seed): 40 proteins take sklearn's
# full solver; 560 its randomized one (n_iter 7)
PIPELINES = [(40, 120, 5, 11), (560, 2200, 5, 3)]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "lean"])
@pytest.mark.parametrize("n_prot,n_edges,comps,seed", PIPELINES,
                         ids=[f"n{p[0]}" for p in PIPELINES])
def test_preprocess_matches_jax(tmp_path, n_prot, n_edges, comps, seed, dense):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    make_raw_inputs(port_root, n_prot, n_edges, seed)
    shutil.copytree(port_root, jax_root)
    assert [vars(d) for d in preprocess.DEFAULT_DATASETS] == [
        vars(d) for d in jax_preprocess.DEFAULT_DATASETS]
    jax_preprocess.preprocess(jax_root, pca_components=comps,
                              dense_gcn_artifacts=dense, verbose=False)
    steps = preprocess.preprocess(port_root, pca_components=comps,
                                  dense_gcn_artifacts=dense, verbose=False, device="cpu")
    names = [s for s, _ in steps]
    assert names.count("PPI") == 1 and len([s for s in names if "ECC" in s and
                                            "PCA" not in s]) == 4
    assert len([s for s in names if s.startswith("PCA")]) == 10
    assert_same_artifacts(port_root, jax_root)
    gcn = os.path.join(port_root, "generate_materials", "GSE30931_data", "GCN_normal.npz")
    assert os.path.exists(gcn) == dense

    # the second run writes nothing
    before = {rel: open(p, "rb").read() for rel, p in _files(port_root).items()}
    mtimes = {rel: os.stat(p).st_mtime_ns for rel, p in _files(port_root).items()}
    steps = preprocess.preprocess(port_root, pca_components=comps,
                                  dense_gcn_artifacts=dense, verbose=False, device="cpu")
    assert all(name.endswith("expression") for name, _ in steps)
    assert {rel: open(p, "rb").read() for rel, p in _files(port_root).items()} == before
    assert {rel: os.stat(p).st_mtime_ns for rel, p in _files(port_root).items()} == mtimes

    for cond in ("normal", "inter"):
        bundle = load_condition(port_root, "GSE30931", cond)
        assert bundle.n_real == n_prot
        assert bundle.feats.shape[1] == 3 + 2 * comps
        assert np.isfinite(bundle.feats).all()


def test_cli_preprocess_matches_jax(tmp_path):
    """The CLI with its defaults (every dataset, 250 components: sklearn's
    full solver at 300 proteins) and ``-d cpu``, lean mode."""
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    make_raw_inputs(port_root, 300, 1500, 5)
    shutil.copytree(port_root, jax_root)
    jax_preprocess.preprocess(jax_root, dense_gcn_artifacts=False, verbose=False)
    steps = cli.main(["preprocess", "--data-root", port_root, "--no-dense-gcn", "-d", "cpu"])
    assert len(steps) == 1 + 4 + 3 + 3 + 1 + 10  # PPI, ECC, expression, topology, labels, PCA
    assert_same_artifacts(port_root, jax_root)


def test_cli_preprocess_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["preprocess", "--data-root", str(tmp_path / "absent")])
    assert not os.path.exists(tmp_path / "absent")


# ---------------------------------------------------------------------------
# the CSV semantics: float parser, column types, group mean
# ---------------------------------------------------------------------------


def _tokens(rng, count):
    out = []
    for _ in range(count):
        nd = int(rng.integers(1, 20))
        digits = "".join(rng.choice(list("0123456789"), nd))
        pos = int(rng.integers(0, nd + 1))
        t = digits[:pos] + "." + digits[pos:] if rng.random() < 0.8 else digits
        if rng.random() < 0.3:
            t += "e" + str(rng.choice(["", "-", "+"])) + str(int(rng.integers(0, 30)))
        if rng.random() < 0.3:
            t = "-" + t
        out.append(t)
    return out


def test_float_parser_matches_pandas():
    """20,000 tokens of 1-19 digits, decimal points and exponents: the
    parser's doubles equal read_csv's and to_numeric's bit for bit (where
    float() differs from them on about 8% of these)."""
    toks = _tokens(np.random.default_rng(0), 20000)
    mine = np.array([csv_values.parse_float(t) for t in toks])
    by_csv = pd.read_csv(io.StringIO("x\n" + "\n".join(toks) + "\n"))["x"].to_numpy()
    by_num = pd.to_numeric(pd.Series(toks, dtype="str"), errors="coerce").to_numpy()
    assert np.array_equal(mine.view(np.int64), by_csv.view(np.int64))
    assert np.array_equal(mine.view(np.int64), by_num.view(np.int64))
    assert (np.array([float(t) for t in toks]) != mine).sum() > 100


@pytest.mark.parametrize("fields", [
    ["1", "2", "3"], ["1", "2.0"], ["1", "", "3"], ["1", "x"], ["1", "NA"],
    ["+1", "-2", "01", "-0"], ["1e5", "2"], ["inf", "-inf", "Infinity", "nan"],
    ["1.", ".5"], ["0x10", "1_000", "1,5", "TRUE", "1e", "None"], ["", ""],
    ["-0.0", "1e-05", "1e16", "123456789012345678"],
])
def test_to_numeric_matches_pandas(fields):
    got = csv_values.numeric_column(fields, coerce=True)
    want = pd.to_numeric(pd.Series(fields, dtype="str"), errors="coerce").to_numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)
    written = pd.DataFrame({"i": range(len(want)), "v": want}).to_csv(index=False,
                                                                     header=False)
    assert csv_values.format_column(got) == [
        line.split(",", 1)[1] for line in written.splitlines()]


def _expression_csv(path, rng, n=300):
    """Proteins with 1-5 probes in shuffled order, values from 1e-8 to 1e8
    with 14-17 digits, NA strings, an all-NA group column, ids that are NA
    strings or absent from the protein list, and an integer column."""
    prots = [f"P{i:05d}" for i in range(n)]
    rows = []
    for p in prots:
        if rng.random() < 0.05 or p == "P00003":
            continue
        for _ in range(int(rng.integers(1, 6))):
            vals = []
            for _ in range(6):
                r = rng.random()
                if r < 0.03:
                    vals.append(str(rng.choice(["NA", "", "nan", "NULL"])))
                elif r < 0.5:
                    v = rng.standard_normal() * 10.0 ** rng.integers(-8, 9)
                    vals.append(f"{v:.{int(rng.integers(14, 18))}g}")
                else:
                    vals.append(repr(float(rng.gamma(2.0, 2.0))))
            rows.append([p] + vals)
    rows += [[str(rng.choice(["NA", "", f"X{i}"]))] + [str(rng.random()) for _ in range(6)]
             for i in range(20)]
    rows.append(["P00003", "NA", "1", "2", "3", "4", "5"])  # column S0 all NA
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "uniprot_id"] + [f"S{c}" for c in range(6)] + ["I"])
        for k, i in enumerate(rng.permutation(len(rows))):
            w.writerow([k + 1] + rows[i] + [int(rng.integers(0, 100))])
    return prots


@pytest.mark.parametrize("seed", range(4))
def test_align_expression_bit_exact(tmp_path, seed):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "e.csv")
    prots = _expression_csv(path, rng)
    for samples in (["S0", "S1", "S2"], ["S3", "S4", "S5"], ["I", "S0"]):
        got = expression.align_expression(path, samples, prots)
        want = jax_expression.align_expression(path, samples, prots)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.isnan(expression.align_expression(path, ["S0"], prots)[3, 0])
    gcn, expr = expression.construct_gcn_matrix(path, ["S0", "S1", "S2"], prots)
    jgcn, jexpr = jax_expression.construct_gcn_matrix(path, ["S0", "S1", "S2"], prots)
    assert np.array_equal(expr, jexpr, equal_nan=True)
    for key in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(gcn, key), getattr(jgcn, key))


# ---------------------------------------------------------------------------
# geo
# ---------------------------------------------------------------------------


def _geo_value(rng, kind):
    if kind == "int":
        return str(int(rng.integers(-1000, 10**6)))
    r = rng.random()
    if r < 0.05:
        return str(rng.choice(["NA", "", "nan", "null", "x1", "1e", "inf", "-inf", "1,5"]))
    if r < 0.15:
        return str(int(rng.integers(-50, 50)))
    if r < 0.3:
        v = rng.standard_normal() * 10.0 ** rng.integers(-12, 25)
        return f"{v:.{int(rng.integers(1, 18))}g}"
    if r < 0.35:
        return str(rng.choice(["-0.0", "0", "1e-05", "1e16", "1e+22", "0.0001", ".5", "5."]))
    return repr(float(rng.gamma(2.0, 2.0)))


def _geo_inputs(tmp_path, seed):
    """A series matrix (int and float columns, repeated probes, coerced
    strings) and a probe map (probes with 0-n accessions, NA accessions,
    quoted commas and quotes, upper-case column names)."""
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(0, 60)), int(rng.integers(1, 5))
    kinds = [str(rng.choice(["int", "float"])) for _ in range(k)]
    sm, pm = tmp_path / f"sm{seed}.txt", tmp_path / f"pm{seed}.csv"
    with open(sm, "w") as f:
        f.write('!Series_title\t"x"\n')
        f.write("\t".join(['"ID_REF"'] + [f'"GSM{c}"' for c in range(k)]) + "\n\n")
        for i in range(n):
            f.write("\t".join([f'"pr{i % 50}"'] + [_geo_value(rng, kinds[c])
                                                   for c in range(k)]) + "\n")
        f.write("!series_matrix_table_end\n")
    with open(pm, "w") as f:
        f.write(str(rng.choice(["probe_id,uniprot_id\n", "PROBE_ID,UniProt_ID\n"])))
        for _ in range(int(rng.integers(0, 80))):
            u = rng.choice([f"Q{rng.integers(100):05d}", "NA", "", '"A,B"', '"x""y"'])
            f.write(f"pr{rng.integers(0, 60)},{u}\n")
    return str(sm), str(pm)


@pytest.mark.parametrize("seed", range(6))
def test_geo_csv_byte_identical(tmp_path, seed):
    sm, pm = _geo_inputs(tmp_path, seed)
    geo.write_expr_set(sm, pm, str(tmp_path / "port.csv"))
    jax_geo.write_expr_set(sm, pm, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    table = geo.build_expr_set(sm, pm)
    frame = jax_geo.build_expr_set(sm, pm)
    assert table.header == list(frame.columns)
    for name, col in zip(table.header[1:], table.columns[1:]):
        assert col.dtype == frame[name].dtype, name


def _geo_reader_inputs(tmp_path):
    """The cases of tests/test_data.py: test_geo_reader and
    test_geo_to_expression_e2e."""
    sm1, pm1 = tmp_path / "series_matrix.txt", tmp_path / "probe_map.csv"
    sm1.write_text('!Series_title\t"x"\n"ID_REF"\t"GSM1"\t"GSM2"\n'
                   '"probe1"\t1.5\t2.5\n"probe2"\t3.0\t4.0\n"probe3"\t9.0\t9.9\n')
    pm1.write_text("probe_id,uniprot_id\nprobe1,P11111\nprobe2,P22222\nprobe2,P99999\n")
    sm2, pm2 = tmp_path / "GSEmini_series_matrix.txt", tmp_path / "probe_map2.csv"
    sm2.write_text('!Series_title\t"mini"\n!Series_platform_id\t"GPLx"\n'
                   '"ID_REF"\t"GSM1"\t"GSM2"\t"GSM3"\n"ILMN_1"\t1.0\t2.0\t3.0\n'
                   '"ILMN_2"\t5.0\t5.0\t5.0\n"ILMN_3"\t7.0\t8.0\t9.0\n'
                   '"ILMN_4"\t1.0\t1.0\t1.0\n"ILMN_5"\t4.0\t4.0\t4.0\n')
    pm2.write_text("probe_id,uniprot_id\nILMN_1,P11111\nILMN_2,P11111\n"
                   "ILMN_3,P22222\nILMN_5,P99999\n")
    return (str(sm1), str(pm1)), (str(sm2), str(pm2))


def test_geo_cases_of_the_jax_tests(tmp_path):
    (sm1, pm1), (sm2, pm2) = _geo_reader_inputs(tmp_path)
    table = geo.build_expr_set(sm1, pm1)
    assert table.header == ["uniprot_id", "GSM1", "GSM2"]
    assert list(table["uniprot_id"]) == ["P11111", "P22222", "P99999"]
    assert float(table["GSM1"][list(table["uniprot_id"]).index("P22222")]) == 3.0
    for sm, pm in ((sm1, pm1), (sm2, pm2)):
        geo.write_expr_set(sm, pm, str(tmp_path / "port.csv"))
        jax_geo.write_expr_set(sm, pm, str(tmp_path / "jax.csv"))
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    protein_list = ["P11111", "P22222", "P33333"]
    expr = expression.align_expression(str(tmp_path / "port.csv"), ["GSM1", "GSM2", "GSM3"],
                                       protein_list)
    np.testing.assert_array_equal(expr, [[3.0, 3.5, 4.0], [7.0, 8.0, 9.0], [0.0, 0.0, 0.0]])


def test_cli_geo(tmp_path):
    sm, pm = _geo_inputs(tmp_path, 2)
    assert cli.main(["geo", sm, pm, str(tmp_path / "port.csv")]) is None
    jax_geo.write_expr_set(sm, pm, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


# ---------------------------------------------------------------------------
# ECC and the common-neighbour counts
# ---------------------------------------------------------------------------


def _hub_graph():
    """Nodes 0 and 1 joined to each other and to nodes 2..901 (rows of
    more than 3 x 256), a self-loop at 5, random edges among the first 1000
    nodes, and 200 isolated nodes."""
    n = 1200
    rng = np.random.default_rng(0)
    hub = np.arange(2, 902)
    r = np.concatenate([np.zeros(900, np.int64), np.ones(900, np.int64), [0],
                        rng.integers(0, 1000, 3000), [5]])
    c = np.concatenate([hub, hub, [1], rng.integers(0, 1000, 3000), [5]])
    m = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    return ((m + m.T) > 0).astype(np.int64).tocoo()


ECC_GRAPHS = {
    "powerlaw120": lambda: powerlaw_ppi(120, 800, seed=3),
    "powerlaw3000": lambda: powerlaw_ppi(3000, 30000, seed=5),
    "hub_selfloop_isolated": _hub_graph,
}


@pytest.mark.parametrize("name", sorted(ECC_GRAPHS))
def test_ecc_exact(name):
    ppi = ECC_GRAPHS[name]()
    got = ecc.edge_clustering_coefficients(ppi, device="cpu")
    want = jax_ecc.edge_clustering_coefficients(ppi)
    for key in ("row", "col", "data"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert got.shape == want.shape
    if ppi.shape[0] <= 1200:
        ref = jax_ecc.edge_clustering_coefficients_dense_reference(ppi)
        assert (got.tocsr() != ref.tocsr()).nnz == 0
        port_ref = ecc.edge_clustering_coefficients_dense_reference(ppi)
        assert (port_ref.tocsr() != ref.tocsr()).nnz == 0
    eps = ecc.edge_clustering_coefficients(ppi, 0.25, device="cpu")
    np.testing.assert_array_equal(eps.data, jax_ecc.edge_clustering_coefficients(ppi, 0.25).data)


def _queries(ppi):
    a = ppi.tocsr().astype(np.float64)
    a.data[:] = 1.0
    q = sp.triu(a, k=1).tocoo()
    return a, q.row, q.col


def _kernel_replay(csr, rows, cols, slice_queries, window_words):
    """numpy replay of csrc/common_neighbors.cu over the wrapper's tables:
    block b finds its longer row L by the slice ends and its queries in the
    sorted order; it builds L's bitmap window by window (skipping windows
    that hold none of L's ids), and warp w of 8 takes queries w, w + 8, ...
    of the slice, walking each shorter row 4 x 32 elements a step, one bit
    test each, until the row leaves the window.  Returns the counts, the blocks
    that had a slice and the windows built."""
    indptr, indices = (t.numpy() for t in csr)
    n = len(indptr) - 1
    longer = cn.longer_rows(csr[0], torch.from_numpy(rows), torch.from_numpy(cols))
    order, row_q, slice_end = (t.numpy() for t in cn._slices(longer, n, slice_queries))
    span = 32 * max(min((n + 31) // 32, window_words), 1)
    out = np.zeros(len(rows), np.int64)
    live = windows = 0
    for b in range(n + -(-len(rows) // slice_queries)):
        row = int(np.searchsorted(slice_end, b, side="right"))
        if row == n:
            continue
        live += 1
        q0 = row_q[row] + (b - (slice_end[row - 1] if row else 0)) * slice_queries
        q1 = min(q0 + slice_queries, row_q[row + 1])
        assert q0 < q1 and (longer.numpy()[order[q0:q1]] == row).all()
        lrow = indices[indptr[row]:indptr[row + 1]]
        if not len(lrow):
            continue
        lp, w0, first = 0, lrow[0] & ~31, True
        while True:
            windows += 1
            bits = np.zeros(span, bool)
            ids = lrow[lp:]
            bits[ids[ids < w0 + span] - w0] = True
            for warp in range(8):
                for q in order[q0 + warp:q1:8]:
                    s = cols[q] if rows[q] == row else rows[q]
                    srow = indices[indptr[s]:indptr[s + 1]]
                    e0 = 0 if first else int(np.searchsorted(srow, w0))
                    for step in range(e0, len(srow), 128):  # 4 loads a lane at once
                        x = np.full(128, 1 << 40)
                        got = srow[step:step + 128] - w0
                        x[:len(got)] = got
                        inside = (x >= 0) & (x < span)
                        out[q] += int(bits[x[inside]].sum())
                        if not (x[96:] < span).all():
                            break
            if w0 + span > lrow[-1]:
                break
            lp = int(np.searchsorted(lrow, w0 + span))
            w0, first = lrow[lp] & ~31, False
    return out, live, windows


@pytest.mark.parametrize("slice_queries,window_words", [(cn.SLICE_QUERIES, cn.WINDOW_WORDS),
                                                        (3, 4)])
def test_common_neighbors_kernel_replay(slice_queries, window_words):
    """The kernel's walk over the wrapper's tables gives the plain
    version's counts: one window a row at the default size, many windows
    of 128 ids with slices of 3 queries (each hub's queries over many
    slices, each rebuilding the hub's bitmap)."""
    a, rows, cols = _queries(_hub_graph())
    csr = csr_tensors(a, "cpu")
    r32, c32 = (torch.from_numpy(v.astype(np.int32)) for v in (rows, cols))
    plain = cn.common_neighbors(csr, r32, c32).numpy()
    got, live, windows = _kernel_replay(csr, r32.numpy(), c32.numpy(), slice_queries,
                                        window_words)
    assert np.array_equal(got, plain)
    deg = np.diff(a.indptr)
    per_row = np.bincount(np.where(deg[rows] > deg[cols], rows, cols))
    assert live == (-(-per_row // slice_queries)).sum()
    assert per_row.max() > 3 * slice_queries
    assert (windows > live) == (window_words < a.shape[0] // 32)


def test_common_neighbors_plain_blocks(monkeypatch):
    """Small blocks of the plain version give the same counts."""
    a, rows, cols = _queries(powerlaw_ppi(500, 4000, seed=1))
    csr = csr_tensors(a, "cpu")
    r32, c32 = (torch.from_numpy(v.astype(np.int32)) for v in (rows, cols))
    whole = cn.common_neighbors(csr, r32, c32)
    monkeypatch.setattr(cn, "_PLAIN_BLOCK", 37)
    assert torch.equal(cn.common_neighbors(csr, r32, c32), whole)
    a2 = (a @ a).tocsr()
    assert np.array_equal(whole.numpy(), np.asarray(a2[rows, cols]).ravel())


def test_common_neighbors_refuses_bad_input():
    indptr = torch.tensor([0, 2, 3, 3], dtype=torch.int64)
    q = torch.tensor([0], dtype=torch.int32)
    for bad in ([1, 0, 2], [1, 1, 2]):  # unsorted, repeated
        with pytest.raises(ValueError, match="strictly ascending"):
            cn.common_neighbors((indptr, torch.tensor(bad, dtype=torch.int32)), q, q)
    good = (indptr, torch.tensor([0, 1, 2], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        cn.common_neighbors(good, q.long(), q)
    with pytest.raises(ValueError, match="query ids"):
        cn.common_neighbors(good, q, q + 3)


def test_common_neighbors_cuda_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel: the wrapper asks the loader for the
    library (which cannot build here) instead of running the plain version."""
    calls = []

    def fake_load(name):
        calls.append(name)
        raise RuntimeError("no kernel library")

    class FakeCuda:
        type = "cuda"

    monkeypatch.setattr(cn._build, "load", fake_load)
    monkeypatch.setattr(cn, "_csr_flag", lambda csr, n, dev, strict: (*csr, None))
    monkeypatch.setattr(cn, "_query_flag", lambda *a: None)
    monkeypatch.setattr(cn, "_raise_flags", lambda checks: None)
    monkeypatch.setattr(cn, "common_neighbors_plain", None)
    csr = (torch.tensor([0, 1, 2], dtype=torch.int64), torch.tensor([1, 0], dtype=torch.int32))
    q = torch.tensor([0], dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: FakeCuda()))
    with pytest.raises(RuntimeError, match="no kernel library"):
        cn.common_neighbors(csr, q, q + 1)
    assert calls == ["common_neighbors"]


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------


def _spectrum_matrix(n, m, comps, rng):
    """A dense n x m matrix with distinct leading singular values (50 ..
    10, evenly spaced, over comps + 20 of them) on a floor of 0.5."""
    k = min(comps + 20, n, m)
    u = np.linalg.qr(rng.standard_normal((n, n)))[0][:, :min(n, m)]
    v = np.linalg.qr(rng.standard_normal((m, m)))[0][:, :min(n, m)]
    s = np.concatenate([np.linspace(50, 10, k), np.full(min(n, m) - k, 0.5)])
    return (u * s) @ v.T


# (n, m, components, solver): full at max(shape) <= 500 and at n >= 0.8
# min(shape); randomized with n_iter 7 (n < 0.1 min) and 4
PCA_CASES = [(40, 40, 5, "full"), (500, 480, 30, "full"), (600, 600, 20, "randomized"),
             (600, 600, 100, "randomized"), (650, 600, 490, "full"),
             (700, 640, 250, "randomized")]


@pytest.mark.parametrize("n,m,comps,solver", PCA_CASES)
def test_pca_matches_sklearn(n, m, comps, solver):
    x = _spectrum_matrix(n, m, comps, np.random.default_rng(n + comps))
    ref = PCA(n_components=comps, random_state=42)
    want = ref.fit_transform(x)
    assert ref._fit_svd_solver == solver == pca.choose_solver(x.shape, comps)
    got = pca.pca(x, comps, device="cpu")
    saved = []
    for a in (got, want):
        buf = io.BytesIO()
        np.save(buf, a)
        saved.append(buf.getvalue()[:128])
    assert saved[0] == saved[1]  # the same fortran_order in the header
    assert_pca_close(got, want, x, comps)


def test_pca_sparse_input_and_timings():
    """A scipy COO input is scattered into a dense tensor (duplicates
    summed) and gives the dense input's result; timings are recorded."""
    rng = np.random.default_rng(1)
    x = _spectrum_matrix(520, 520, 10, rng)
    r, c = np.nonzero(np.abs(x) > 0.0)
    coo = sp.coo_matrix((np.concatenate([x[r, c] / 2, x[r, c] / 2]),
                         (np.concatenate([r, r]), np.concatenate([c, c]))), shape=x.shape)
    times = {}
    got = pca.pca(coo, 10, device="cpu", timings=times)
    want = PCA(n_components=10, random_state=42).fit_transform(coo.toarray())
    assert_pca_close(got, want, coo, 10)
    assert sorted(times) == ["dense", "power", "svd"]


def test_pca_refuses_covariance_solver_and_bad_sizes():
    with pytest.raises(NotImplementedError, match="covariance_eigh"):
        pca.choose_solver((1000, 10), 5)
    with pytest.raises(ValueError, match="n_components"):
        pca.pca(np.eye(30), 31, device="cpu")


def test_lu_pl_matches_scipy():
    y = np.random.default_rng(2).standard_normal((300, 40))
    got = pca._lu_pl(torch.from_numpy(y)).numpy()
    want, _ = scipy_lu(y, permute_l=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
