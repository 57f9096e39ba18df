"""The port's ΔPCC scans and perturbation-topology step against the JAX
package, on the CPU (the scans' plain versions).

Each case's factors are made from a seed with numpy and go through both
packages.  The JAX package scans with numpy GEMMs, the port with one
rounding per product and sum, so the two d values of a pair may differ in
their last bits: every fixture asserts that no pair lies within 1e-12 of
lo or hi (or, for the case whose conditions are equal, that every d is
exactly 0), and the counts and edge lists are then compared exactly.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plagnn_tpu.analysis import statistics as jax_statistics
from plagnn_tpu.data import expression as jax_expression
from plagnn_tpu.data import topology as jax_topology
from plagnn_tpu_torch.data import expression, topology
from plagnn_tpu_torch.ops import pcc_scan

MARGIN = 1e-12
THR = 2.0

# (n, k, kind): n not a multiple of any tile or block; "zero_rows" gives
# some proteins all-zero expression in one condition (invalid rows),
# "equal" makes the perturbed condition equal the normal one (std = 0).
CASES = [(n, k, "random") for n in (37, 517) for k in (1, 3, 8)] + [
    (517, 3, "zero_rows"), (37, 3, "equal")]


def _case(n, k, kind, seed=0):
    """(expr_n, expr_i, z_n, z_i, ppi): expression of both conditions,
    their factors (k = 1 has no variance to standardize, so its factors
    are raw normal numbers) and a PPI of unique off-diagonal pairs."""
    rng = np.random.default_rng(seed + 100 * n + k)
    expr_n = rng.gamma(2.0, 2.0, (n, k))
    expr_i = expr_n * np.exp(0.3 * rng.standard_normal((n, k)))
    if kind == "zero_rows":
        expr_n[rng.choice(n, n // 10, replace=False)] = 0.0
        expr_i[rng.choice(n, n // 10, replace=False)] = 0.0
    if kind == "equal":
        expr_i = expr_n.copy()
    if k == 1:
        z_n, z_i = rng.standard_normal((n, 1)), rng.standard_normal((n, 1))
    else:
        z_n, z_i = jax_expression.pcc_factors(expr_n), jax_expression.pcc_factors(expr_i)
    pairs = rng.integers(0, n, (6 * n, 2))
    pairs = np.unique(pairs[pairs[:, 0] != pairs[:, 1]], axis=0)
    ppi = sp.coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    return expr_n, expr_i, z_n, z_i, ppi


def _dense_diff(z_i, z_n):
    d = z_i @ z_i.T - z_n @ z_n.T
    np.fill_diagonal(d, 0.0)
    return d


def _thresholds(z_i, z_n, kind):
    """(lo, hi) from the JAX statistics, after the margin check."""
    mean, std = jax_topology.diff_stats(z_i, z_n)
    lo, hi = mean - THR * std, mean + THR * std
    d = _dense_diff(z_i, z_n)
    if kind == "equal":
        assert std == 0.0 and lo == hi == 0.0
        assert not d.any()
    else:
        assert np.abs(d - lo).min() > MARGIN and np.abs(d - hi).min() > MARGIN
    return lo, hi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


@pytest.mark.parametrize("n,k,kind", CASES)
def test_pcc_factors_match_jax(n, k, kind):
    expr_n, expr_i, *_ = _case(n, k, kind)
    for expr in (expr_n, expr_i):
        want = jax_expression.pcc_factors(expr)
        np.testing.assert_allclose(expression.pcc_factors(expr), want, rtol=0, atol=1e-15)
        got = expression.pcc_factors_torch(expr, "cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("n,k,kind", CASES)
def test_pcc_at_edges_match_jax(n, k, kind):
    _, _, z_n, z_i, ppi = _case(n, k, kind)
    want = jax_expression.pcc_at_edges(z_i, ppi.row, ppi.col)
    np.testing.assert_allclose(expression.pcc_at_edges(z_i, ppi.row, ppi.col), want,
                               rtol=0, atol=1e-15)
    got = expression.pcc_at_edges_torch(_t(z_i), torch.from_numpy(ppi.row.astype(np.int64)),
                                        torch.from_numpy(ppi.col.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("n,k,kind", CASES)
def test_diff_stats_match_jax(n, k, kind):
    _, _, z_n, z_i, _ = _case(n, k, kind)
    want = jax_topology.diff_stats(z_i, z_n)
    got = topology.diff_stats(_t(z_i), _t(z_n))
    if kind == "equal":
        assert got == want == (0.0, 0.0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n,k,kind", CASES)
def test_count_scan_matches_jax(n, k, kind):
    _, _, z_n, z_i, _ = _case(n, k, kind)
    lo, hi = _thresholds(z_i, z_n, kind)
    want = jax_statistics.threshold_counts(z_i, z_n, lo, hi)
    assert pcc_scan.pcc_diff_counts(_t(z_i), _t(z_n), lo, hi) == want
    d = _dense_diff(z_i, z_n)
    assert want == (int((d < lo).sum()), int((d > hi).sum()))


@pytest.mark.parametrize("n,k,kind", CASES)
def test_topology_matches_jax_factor_path(n, k, kind):
    """The port's topology step (plain hit scan on the CPU) against the JAX
    factor path: the same edges in the same COO order (kept edges, then the
    added pairs row-major)."""
    _, _, z_n, z_i, ppi = _case(n, k, kind)
    _thresholds(z_i, z_n, kind)
    want = jax_topology.modify_network_topology(ppi, z_n, z_i, THR)
    got = topology.modify_network_topology(ppi, z_n, z_i, THR, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.row, want.row)
    np.testing.assert_array_equal(got.col, want.col)
    np.testing.assert_array_equal(got.data, want.data)
    if kind == "equal":
        assert got.nnz == ppi.nnz


@pytest.mark.parametrize("n,k,kind", CASES)
def test_topology_matches_dense_oracle(n, k, kind):
    """Against the reference's dense path on the dense PCC matrices (zero
    diagonal): the same edge set."""
    _, _, z_n, z_i, ppi = _case(n, k, kind)
    _thresholds(z_i, z_n, kind)
    pcc_n, pcc_i = z_n @ z_n.T, z_i @ z_i.T
    np.fill_diagonal(pcc_n, 0.0)
    np.fill_diagonal(pcc_i, 0.0)
    want = jax_topology._modify_dense(ppi.tocsr().astype(np.int8), pcc_n, pcc_i, THR)
    got = topology.modify_network_topology(ppi, z_n, z_i, THR, device="cpu")
    assert set(zip(got.row.tolist(), got.col.tolist())) == set(
        zip(want.row.tolist(), want.col.tolist()))
    # the port's own copy of the dense path gives the same matrix
    ours = topology._modify_dense(ppi.tocsr().astype(np.int8), pcc_n, pcc_i, THR)
    assert (ours != want).nnz == 0


def test_hit_scan_excludes_edges_in_row_major_order():
    """The plain hit scan against a dense numpy reference, with a CSR that
    holds some of the hits and a row all of whose hits are edges."""
    _, _, z_n, z_i, _ = _case(517, 3, "random", seed=5)
    lo, hi = _thresholds(z_i, z_n, "random")
    hits = _dense_diff(z_i, z_n) > hi
    r, c = np.nonzero(hits)
    take = np.zeros(len(r), bool)
    take[::3] = True
    row0 = r[0]
    take[r == row0] = True
    edges = sp.coo_matrix((np.ones(take.sum()), (r[take], c[take])), shape=hits.shape)
    csr = pcc_scan.csr_tensors(edges, "cpu")
    got_r, got_c = pcc_scan.pcc_diff_hits(_t(z_i), _t(z_n), hi, csr)
    want = hits.copy()
    want[r[take], c[take]] = False
    wr, wc = np.nonzero(want)
    assert row0 not in set(wr.tolist())
    np.testing.assert_array_equal(got_r.numpy(), wr)
    np.testing.assert_array_equal(got_c.numpy(), wc)
    assert got_r.dtype == got_c.dtype == torch.int32


def test_csr_tensors_and_checks():
    """csr_tensors drops explicit zeros and sorts each row; the wrapper
    refuses unsorted rows, out-of-range ids, k > 16 and other dtypes."""
    m = sp.csr_matrix((np.array([1, 0, 1, 1]), np.array([3, 1, 0, 2]),
                       np.array([0, 2, 4, 4, 4])), shape=(4, 4))
    indptr, indices = pcc_scan.csr_tensors(m, "cpu")
    assert indptr.tolist() == [0, 1, 3, 3, 3] and indices.tolist() == [3, 0, 2]
    z = torch.zeros((4, 3), dtype=torch.float64)
    unsorted = (torch.tensor([0, 2, 2, 2, 2]), torch.tensor([3, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="ascending"):
        pcc_scan.pcc_diff_hits(z, z, 0.5, unsorted)
    out_of_range = (torch.tensor([0, 1, 1, 1, 1]), torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="ascending"):
        pcc_scan.pcc_diff_hits(z, z, 0.5, out_of_range)
    falling = (torch.tensor([0, 2, 1, 2, 2]), torch.tensor([3, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="indptr rising"):
        pcc_scan.pcc_diff_hits(z, z, 0.5, falling)
    # a row boundary may step down: each row ascends on its own
    two_rows = (torch.tensor([0, 1, 2, 2, 2]), torch.tensor([3, 0], dtype=torch.int32))
    r, c = pcc_scan.pcc_diff_hits(z, z, 0.5, two_rows)
    assert r.numel() == c.numel() == 0
    wide = torch.zeros((4, pcc_scan.MAX_K + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="k = 17"):
        pcc_scan.pcc_diff_counts(wide, wide, 0.0, 0.0)
    with pytest.raises(TypeError, match="float64"):
        pcc_scan.pcc_diff_counts(z.float(), z.float(), 0.0, 0.0)


def test_cuda_tensors_never_fall_back(monkeypatch):
    """A CUDA tensor goes to the kernel: the wrapper asks the loader for the
    library (which cannot build here) instead of running the plain version."""
    calls = []

    def fake_load(name):
        calls.append(name)
        raise RuntimeError("no kernel library")

    class FakeCuda:
        type = "cuda"

    monkeypatch.setattr(pcc_scan._build, "load", fake_load)
    monkeypatch.setattr(pcc_scan, "_check_z", lambda *a: None)
    monkeypatch.setattr(pcc_scan, "_check_csr", lambda csr, n, dev: csr)
    z = torch.zeros((4, 3), dtype=torch.float64)
    csr = (torch.zeros(5, dtype=torch.int64), torch.zeros(0, dtype=torch.int32))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: FakeCuda()))
    with pytest.raises(RuntimeError, match="no kernel library"):
        pcc_scan.pcc_diff_counts(z, z, -0.5, 0.5)
    with pytest.raises(RuntimeError, match="no kernel library"):
        pcc_scan.pcc_diff_hits(z, z, 0.5, csr)
    assert calls == ["pcc_diff_scan", "pcc_diff_scan"]
