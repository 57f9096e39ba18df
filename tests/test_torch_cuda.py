"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card and nvcc, and skip without them (the decision is
made inside the fixture, never at import).  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py imports jax, which a machine set up
for the port need not have.)
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plagnn_tpu_torch.ops import common_neighbors as cn
from plagnn_tpu_torch.ops import pcc_scan
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import ROW_CHUNK, build_graph
from plagnn_tpu_torch.ops.spmm import spmm_sum

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _graph(seed=0, n=300):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 2000), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n - 30, 2000), np.zeros(n, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    g = build_graph(pairs[:, 0], pairs[:, 1], n)
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, 3 * 13)) * 2) / 2, 0)
    return g, x.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_kernel_bit_exact(card, dtype):
    g, x = _graph()
    gd = g.to(card)
    xd = torch.from_numpy(x).to(card, dtype)
    name = "spmm_max_fwd_" + ("f32" if dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    out, arg = sk.spmm_max_fwd(gd, xd)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    out_p, arg_p = sk.spmm_max_fwd_plain(g, torch.from_numpy(x).to(dtype))
    assert torch.equal(out.cpu(), out_p)
    assert torch.equal(arg.cpu(), arg_p)


def test_autograd_on_card_matches_cpu(card):
    """dx through SpmmMax: the card's kernels against the CPU's plain
    versions; float32 sums of the same hits in different orders."""
    g, x = _graph(1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    grads = []
    for dev, graph in ((card, g.to(card)), (torch.device("cpu"), g)):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        (sk.spmm_max(graph, xt) * torch.from_numpy(w).to(dev)).sum().backward()
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_kernel_matches_plain(card, dtype, transpose):
    """float32: within 1e-5 of the summed magnitudes (the same terms in
    another order); bfloat16 on small integers: exact (every float32
    partial sum exact, one rounding)."""
    g, _ = _graph(3)
    rng = np.random.default_rng(4)
    if dtype == torch.float32:
        x = torch.from_numpy(rng.standard_normal((g.n_nodes, 3 * 13)).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(-8, 9, (g.n_nodes, 3 * 13)).astype(np.float32))
    x = x.to(dtype)
    name = f"spmm_sum_{'bwd' if transpose else 'fwd'}_" + (
        "f32" if dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    out = sk.spmm_sum_rows(g.to(card), x.to(card), transpose)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    out_p = sk.spmm_sum_plain(g, x, transpose)
    if dtype == torch.bfloat16:
        assert torch.equal(out.cpu(), out_p)
    else:
        mag = sk.spmm_sum_plain(g, x.abs(), transpose)
        assert bool(((out.cpu() - out_p).abs() <= 1e-5 * mag + 1e-7).all())


def test_sum_kernel_deterministic(card):
    g, _ = _graph(5)
    gd = g.to(card)
    x = torch.randn(g.n_nodes, 700, device=card)
    for transpose in (False, True):
        assert torch.equal(sk.spmm_sum_rows(gd, x, transpose),
                           sk.spmm_sum_rows(gd, x, transpose))


def test_sum_autograd_on_card_matches_cpu(card):
    """dx through SpmmSum: the transpose kernel on the card against the
    plain version on the CPU."""
    g, _ = _graph(6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((g.n_nodes, 2, 21)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    grads = []
    for dev, graph in ((card, g.to(card)), (torch.device("cpu"), g)):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        (spmm_sum(graph, xt) * torch.from_numpy(w).to(dev)).sum().backward()
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


# Row-chunked kernels (csrc/row_chunks.cuh): the sum, the max forward and
# the max backward.  Widths: 39 and 111 take the scalar path, 120 16-byte
# vectors, 5030 8-byte float32 / 4-byte bfloat16 and int16 vectors; the last
# case cuts every row of more than 8 edges.
CHUNK_CASES = [(39, ROW_CHUNK), (111, ROW_CHUNK), (120, ROW_CHUNK),
               (5030, ROW_CHUNK), (111, 8)]


def _split_graph(row_chunk):
    """Row 0 has 3*ROW_CHUNK + 6 in-edges and node 0 as many out-edges (so
    both directions split row 0 into 4 chunks at ROW_CHUNK), over random
    edges; the last 30 nodes and the padding rows have no edges."""
    rng = np.random.default_rng(11)
    n, hub = 1000, 3 * ROW_CHUNK + 6
    live = n - 30
    src = np.concatenate([rng.integers(0, live, 6000), 1 + np.arange(hub),
                          np.zeros(hub, np.int64)])
    dst = np.concatenate([rng.integers(0, live, 6000), np.zeros(hub, np.int64),
                          1 + np.arange(hub)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    g = build_graph(pairs[:, 0], pairs[:, 1], n, row_chunk=row_chunk)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    return g


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,row_chunk", CHUNK_CASES)
def test_chunked_sum_matches_plain(card, k, row_chunk, dtype, transpose):
    """float32: within 1e-5 of the summed magnitudes and bit-identical run
    to run; bfloat16 on small integers: exact."""
    g = _split_graph(row_chunk).to(card)
    gen = torch.Generator(device=card).manual_seed(k)
    if dtype == torch.float32:
        x = torch.randn((g.n_nodes, k), generator=gen, device=card)
    else:
        x = torch.randint(-8, 9, (g.n_nodes, k), generator=gen, device=card).to(dtype)
    name = f"spmm_sum_{'bwd' if transpose else 'fwd'}_" + (
        "f32" if dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    out = sk.spmm_sum_rows(g, x, transpose)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    out_p = sk.spmm_sum_plain(g, x, transpose)
    if dtype == torch.bfloat16:
        assert torch.equal(out, out_p)
    else:
        assert torch.equal(out, sk.spmm_sum_rows(g, x, transpose))
        mag = sk.spmm_sum_plain(g, x.abs(), transpose)
        assert bool(((out - out_p).abs() <= 1e-5 * mag + 1e-7).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,row_chunk", CHUNK_CASES)
def test_chunked_max_bwd_matches_plain(card, k, row_chunk, dtype):
    """float32: within 1e-5 of the hit magnitudes and bit-identical run to
    run; bfloat16 (small-integer gradients): within 1 ulp."""
    g = _split_graph(row_chunk).to(card)
    gen = torch.Generator(device=card).manual_seed(k)
    x = torch.randn((g.n_nodes, k), generator=gen, device=card)
    x = (torch.round(x * 2) / 2).relu_()  # ties, as after relu
    _, arg = sk.spmm_max_fwd_plain(g, x)
    if dtype == torch.float32:
        gr = torch.randn((g.n_nodes, k), generator=gen, device=card)
    else:
        gr = torch.randint(-8, 9, (g.n_nodes, k), generator=gen, device=card).to(dtype)
    name = "spmm_max_bwd_" + ("f32" if dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    dx = sk.spmm_max_bwd(g, gr, arg)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    dx_p = sk.spmm_max_bwd_plain(g, gr, arg)
    err = (dx.float() - dx_p.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= _bf16_ulp(torch.maximum(dx.float().abs(),
                                                    dx_p.float().abs()))).all())
    else:
        assert torch.equal(dx, sk.spmm_max_bwd(g, gr, arg))
        mag = sk.spmm_max_bwd_plain(g, gr.abs(), arg)
        assert bool((err <= 1e-5 * mag + 1e-7).all())


def _check_max_fwd(g, x, with_argmax):
    """out and arg bit-exact with the plain version, one launch counted, and
    bit-identical over two launches."""
    name = "spmm_max_fwd_" + ("" if with_argmax else "noarg_") + (
        "f32" if x.dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    out, arg = sk.spmm_max_fwd(g, x, with_argmax=with_argmax)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    out_p, arg_p = sk.spmm_max_fwd_plain(g, x, with_argmax=with_argmax)
    assert torch.equal(out, out_p)
    out_2, arg_2 = sk.spmm_max_fwd(g, x, with_argmax=with_argmax)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), out_2.view(bits))
    if with_argmax:
        assert torch.equal(arg, arg_p) and torch.equal(arg, arg_2)
    else:
        assert arg is None and arg_2 is None


@pytest.mark.parametrize("with_argmax", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,row_chunk", CHUNK_CASES)
def test_chunked_max_fwd_matches_plain(card, k, row_chunk, dtype, with_argmax):
    g = _split_graph(row_chunk).to(card)
    gen = torch.Generator(device=card).manual_seed(k)
    x = torch.randn((g.n_nodes, k), generator=gen, device=card)
    x = (torch.round(x * 2) / 2).relu_().to(dtype)  # ties, as after relu
    _check_max_fwd(g, x, with_argmax)


def _cross_chunk_graph():
    """Row 0 takes 3*ROW_CHUNK + 5 in-edges from nodes 1, 2, ... (the node at
    rank r is r + 1): 4 chunks.  Columns by k % 4: all equal; all -inf; a
    maximum first reached at the first edge of chunk 1, 2 or 3 of row 0 and
    tied at every later chunk's first edge and the last edge; relu ties."""
    rng = np.random.default_rng(17)
    n, hub, k = 900, 3 * ROW_CHUNK + 5, 62
    src = np.concatenate([rng.integers(0, n, 5000), 1 + np.arange(hub)])
    dst = np.concatenate([rng.integers(1, n - 20, 5000), np.zeros(hub, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    g = build_graph(pairs[:, 0], pairs[:, 1], n)
    assert g.chunks.split_row.tolist() == [0] and g.in_degree[0] == hub
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, k)) * 2) / 2, 0)
    cols = np.arange(k)
    x[:, cols % 4 == 0] = 0.5
    x[:, cols % 4 == 1] = -np.inf
    for c in cols[cols % 4 == 2]:
        x[:, c] = np.minimum(x[:, c], 1.0)
        x[1 + np.arange(1 + (c // 4) % 3, 4) * ROW_CHUNK, c] = 3.0
        x[hub, c] = 3.0
    return g, x.astype(np.float32)


@pytest.mark.parametrize("with_argmax", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_max_fwd_cross_chunk_ties(card, dtype, with_argmax):
    """Ties across a split row's chunks go to the lower chunk; all-equal and
    all -inf rows keep their first source."""
    g, x = _cross_chunk_graph()
    xd = torch.from_numpy(x).to(card, dtype)
    _check_max_fwd(g.to(card), xd, with_argmax)
    if with_argmax:
        _, arg = sk.spmm_max_fwd(g.to(card), xd)
        row0 = arg[0].cpu().numpy()
        cols = np.arange(x.shape[1])
        np.testing.assert_array_equal(row0[cols % 4 < 2], 1)
        np.testing.assert_array_equal(
            row0[cols % 4 == 2], 1 + (1 + (cols[cols % 4 == 2] // 4) % 3) * ROW_CHUNK)


def test_chunked_grid_limit_raises(card):
    """A K that needs more than 65,535 K-slices (odd, so scalar bfloat16
    loads, 8 a lane, 256 a slice) is refused by the C entry points and
    raised, not cut: the sum and the max forward, with and without the
    argmax."""
    g = build_graph(np.arange(5), np.arange(1, 6), 10).to(card)
    k = 65535 * 256 + 1
    x = torch.zeros((g.n_nodes, k), dtype=torch.bfloat16, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.spmm_sum_rows(g, x)
    for with_argmax in (True, False):
        with pytest.raises(RuntimeError, match="CUDA error"):
            sk.spmm_max_fwd(g, x, with_argmax=with_argmax)


# ---------------------------------------------------------------------------
# The ΔPCC scans (csrc/pcc_diff_scan.cu): exact against their plain versions.
# ---------------------------------------------------------------------------

PCC_SHAPES = [(n, k) for n in (1, 37, 1000, 4097) for k in (1, 3, 8, 16)]


def _pcc_factors(card, n, k, seed=0):
    """Random float64 factors with an eighth of the rows zero in each
    condition (invalid proteins: d = 0 on their pairs)."""
    rng = np.random.default_rng(seed + 7 * n + k)
    z = rng.standard_normal((2, n, k))
    for c in range(2):
        z[c, rng.choice(n, n // 8, replace=False)] = 0.0
    return (torch.from_numpy(z[0]).to(card), torch.from_numpy(z[1]).to(card))


def _pcc_dense(z_i, z_n):
    return pcc_scan._diff_block(z_i, z_n, 0, z_i.shape[0])


def _pcc_thresholds(d):
    """(lo, hi) pairs to test: thresholds that some off-diagonal d takes
    exactly (strictness), 0 (every zero row's pairs tie there) and the
    spread of d."""
    off = d[~torch.eye(d.shape[0], dtype=torch.bool, device=d.device)]
    if off.numel() == 0:
        return [(-0.5, 0.5), (0.0, 0.0)]
    q = torch.quantile(off[:1 << 24], torch.tensor([0.05, 0.95], dtype=d.dtype,
                                                    device=d.device)).tolist()
    exact = off[torch.argmin((off - q[1]).abs())].item()
    return [(q[0], q[1]), (off[0].item(), exact), (0.0, 0.0)]


@pytest.mark.parametrize("n,k", PCC_SHAPES)
def test_pcc_count_kernel_matches_plain(card, n, k):
    z_i, z_n = _pcc_factors(card, n, k)
    d = _pcc_dense(z_i, z_n)
    for lo, hi in _pcc_thresholds(d):
        before = pcc_scan.LAUNCHES["pcc_diff_count_f64"]
        got = pcc_scan.pcc_diff_counts(z_i, z_n, lo, hi)
        assert pcc_scan.LAUNCHES["pcc_diff_count_f64"] == before + 1
        want = pcc_scan.pcc_diff_counts_plain(z_i, z_n, lo, hi)
        assert got == want == (int((d < lo).sum()), int((d > hi).sum()))
        assert pcc_scan.pcc_diff_counts(z_i, z_n, lo, hi) == got


def _pcc_csr(card, n, hit_r, hit_c, seed):
    """A CSR holding every third hit, all the hits of the first row that has
    any, and random other pairs."""
    rng = np.random.default_rng(seed)
    take = np.zeros(len(hit_r), bool)
    take[::3] = True
    if len(hit_r):
        take[hit_r == hit_r[0]] = True
    extra = rng.integers(0, n, (4 * n, 2))
    r = np.concatenate([hit_r[take], extra[:, 0]])
    c = np.concatenate([hit_c[take], extra[:, 1]])
    m = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    return pcc_scan.csr_tensors(m, card), (hit_r[0] if len(hit_r) else None)


@pytest.mark.parametrize("n,k", PCC_SHAPES)
def test_pcc_hit_kernel_matches_plain(card, n, k):
    """The ordered hit list equals the plain version's, pair for pair, with
    and without a CSR to exclude, and is the same over two launches; a row
    whose hits are all edges gives none."""
    z_i, z_n = _pcc_factors(card, n, k, seed=1)
    d = _pcc_dense(z_i, z_n)
    no_edges = (torch.zeros(n + 1, dtype=torch.int64, device=card),
                torch.zeros(0, dtype=torch.int32, device=card))
    for _, hi in _pcc_thresholds(d):
        free_r, free_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, no_edges)
        csr, full_row = _pcc_csr(card, n, free_r.cpu().numpy(), free_c.cpu().numpy(), n + k)
        for edges in (no_edges, csr):
            before = pcc_scan.LAUNCHES["pcc_diff_hits_f64"]
            rows, cols = pcc_scan.pcc_diff_hits(z_i, z_n, hi, edges)
            torch.cuda.synchronize()
            assert pcc_scan.LAUNCHES["pcc_diff_hits_f64"] == before + 1
            want_r, want_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, edges)
            assert torch.equal(rows, want_r) and torch.equal(cols, want_c)
            again = pcc_scan.pcc_diff_hits(z_i, z_n, hi, edges)
            assert torch.equal(again[0], rows) and torch.equal(again[1], cols)
        if full_row is not None:
            assert not bool((rows == int(full_row)).any())
            assert rows.numel() < free_r.numel()


def test_pcc_scan_refuses_wide_k_and_oversized_grid(card):
    """k = 17 is refused before any launch; a count grid of more than 65,535
    row tiles (256 rows each) is refused by the C entry point and raised."""
    wide = torch.zeros((8, 17), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="k = 17"):
        pcc_scan.pcc_diff_counts(wide, wide, 0.0, 0.0)
    tall = torch.zeros((65535 * 256 + 1, 1), dtype=torch.float64, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pcc_scan.pcc_diff_counts(tall, tall, -1.0, 1.0)


# ---------------------------------------------------------------------------
# The ECC's common-neighbour counts (csrc/common_neighbors.cu)
# ---------------------------------------------------------------------------


def _cn_inputs(card, n, seed, hub=0):
    """A symmetric CSR of n nodes (the last fifth isolated: empty rows),
    with ``hub`` nodes joined to each other and to most nodes, and a
    self-loop at node 0; queries are its upper-triangle edges, some random
    pairs and some (i, i)."""
    rng = np.random.default_rng(seed)
    live = max(n - n // 5, 1)
    r = rng.integers(0, live, 4 * n)
    c = rng.integers(0, live, 4 * n)
    if hub:
        r = np.concatenate([r, np.repeat(np.arange(hub), live)])
        c = np.concatenate([c, np.tile(np.arange(live), hub)])
    r, c = np.append(r, 0), np.append(c, 0)
    m = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    m = (m + m.T) > 0
    csr = pcc_scan.csr_tensors(m.astype(np.int8), card)
    q = sp.triu(m, 1).tocoo()
    extra = rng.integers(0, n, (n, 2))
    rows = np.concatenate([q.row, extra[:, 0], np.arange(0, n, 7)])
    cols = np.concatenate([q.col, extra[:, 1], np.arange(0, n, 7)])
    return csr, (torch.from_numpy(rows.astype(np.int32)).to(card),
                 torch.from_numpy(cols.astype(np.int32)).to(card))


@pytest.mark.parametrize("n", [1, 37, 1000, 4097])
def test_common_neighbors_kernel_matches_plain(card, n):
    csr, (rows, cols) = _cn_inputs(card, n, n)
    before = cn.LAUNCHES["ecc_common_neighbors_i32"]
    got = cn.common_neighbors(csr, rows, cols)
    torch.cuda.synchronize()
    assert cn.LAUNCHES["ecc_common_neighbors_i32"] == before + 1
    assert torch.equal(got, cn.common_neighbors_plain(csr, rows, cols))
    assert torch.equal(cn.common_neighbors(csr, rows, cols), got)


@pytest.mark.parametrize("row_chunk", [256, 8, 1])
def test_common_neighbors_kernel_split_rows(card, row_chunk):
    """Three hubs of ~3,300 neighbours each: their pairs split into 13+
    chunks of 256 (hundreds at small row_chunk) that add into one count."""
    csr, (rows, cols) = _cn_inputs(card, 4097, 5, hub=3)
    deg = (csr[0][1:] - csr[0][:-1])
    chunks = (torch.minimum(deg[rows.long()], deg[cols.long()]) + row_chunk - 1) // row_chunk
    assert int(chunks.max()) > 12
    got = cn.common_neighbors(csr, rows, cols, row_chunk=row_chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, cn.common_neighbors_plain(csr, rows, cols))


def test_common_neighbors_kernel_empty_rows_and_queries(card):
    """Queries on empty rows count 0 and launch nothing when no query has
    an item; no queries at all give an empty result."""
    n = 50
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=card)
    indices = torch.zeros(0, dtype=torch.int32, device=card)
    q = torch.arange(n, dtype=torch.int32, device=card)
    got = cn.common_neighbors((indptr, indices), q, q.flip(0).contiguous())
    assert got.dtype == torch.int32 and not bool(got.any())
    none = torch.zeros(0, dtype=torch.int32, device=card)
    assert cn.common_neighbors((indptr, indices), none, none).numel() == 0


def test_common_neighbors_kernel_refuses_unsorted(card):
    indptr = torch.tensor([0, 3, 4, 4], dtype=torch.int64, device=card)
    q = torch.tensor([0], dtype=torch.int32, device=card)
    for bad in ([2, 1, 0, 0], [1, 1, 2, 0]):  # descending, repeated
        with pytest.raises(ValueError, match="strictly ascending"):
            cn.common_neighbors((indptr, torch.tensor(bad, dtype=torch.int32, device=card)),
                                q, q + 1)
