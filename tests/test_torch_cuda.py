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

from plagnn_tpu_torch.bench import dma_ceiling as dc
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
# The positional argmax: the max kernels' rank form (a graph past 2^15
# padded nodes), against the plain versions and the id-based kernels.
# ---------------------------------------------------------------------------

# (POS_RANK_CAP, row_chunk): no mega row (row 0's 773 edges split into 4
# chunks); row 0 a mega row of 20 segments walked as one chunk's worth of
# rows at a time (cap < chunk), as chunks of the cap's size, and split into
# chunks of 8 across segments of 100.
POS_LAYOUTS = [(None, ROW_CHUNK), (40, ROW_CHUNK), (40, 40), (100, 8)]


@pytest.mark.parametrize("rank_cap,row_chunk", POS_LAYOUTS)
@pytest.mark.parametrize("k", [5, 62, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_positional_kernels_match_plain_and_id_based(card, monkeypatch, dtype, k,
                                                     rank_cap, row_chunk):
    """On the cross-chunk tie graph: the positional forward's out and argmax
    (side table included) bit-exact with the plain version and bit-identical
    run to run, out equal to the id-based kernel's and the argmax naming its
    sources; dx equal to the id-based kernel's (the same hits summed in the
    same order) and bit-identical run to run, float32 within 1e-5 of the
    plain version's hit magnitudes, bfloat16 (small-integer gradients)
    within 1 ulp.  Row 0's ties go to its lowest rank."""
    from plagnn_tpu_torch.ops import graph_format as gf

    if rank_cap is not None:
        monkeypatch.setattr(gf, "POS_RANK_CAP", rank_cap)
    g0, x = _cross_chunk_graph()
    src, dst = g0.src.numpy(), g0.dst.numpy()
    n_real = g0.n_real_nodes
    gp = build_graph(src, dst, n_real, positional=True, row_chunk=row_chunk).to(card)
    gi = build_graph(src, dst, n_real, positional=False, row_chunk=row_chunk).to(card)
    assert gp.n_mega == (0 if rank_cap is None else 1)
    x = np.ascontiguousarray(np.concatenate([x, x], 1)[:, :k])
    xd = torch.from_numpy(x).to(card, dtype)
    tag = "f32" if dtype == torch.float32 else "bf16"
    before = (sk.LAUNCHES[f"spmm_max_fwd_pos_{tag}"], sk.LAUNCHES[f"spmm_max_bwd_pos_{tag}"])
    out, arg = sk.spmm_max_fwd(gp, xd)
    out_2, arg_2 = sk.spmm_max_fwd(gp, xd)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[f"spmm_max_fwd_pos_{tag}"] == before[0] + 2
    assert arg.dtype == torch.int16 and arg.shape == (gp.n_nodes + gp.n_mega, k)
    out_p, arg_p = sk.spmm_max_fwd_plain(gp, xd)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
    assert torch.equal(out.view(bits), out_2.view(bits)) and torch.equal(arg, arg_2)
    out_i, arg_i = sk.spmm_max_fwd(gi, xd)
    assert torch.equal(out.view(bits), out_i.view(bits))
    assert torch.equal(sk._arg_sources(gp, arg), sk._arg_sources(gi, arg_i))
    cols = np.arange(k) % 62
    row0 = sk._arg_sources(gp, arg)[0].cpu().numpy()
    np.testing.assert_array_equal(row0[cols % 4 < 2], 1)
    np.testing.assert_array_equal(
        row0[cols % 4 == 2], 1 + (1 + (cols[cols % 4 == 2] // 4) % 3) * ROW_CHUNK)

    gen = torch.Generator(device=card).manual_seed(k)
    if dtype == torch.float32:
        gr = torch.randn((gp.n_nodes, k), generator=gen, device=card)
    else:
        gr = torch.randint(-8, 9, (gp.n_nodes, k), generator=gen, device=card).to(dtype)
    dx = sk.spmm_max_bwd(gp, gr, arg)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[f"spmm_max_bwd_pos_{tag}"] == before[1] + 1
    assert torch.equal(dx.view(bits), sk.spmm_max_bwd(gp, gr, arg).view(bits))
    assert torch.equal(dx.view(bits), sk.spmm_max_bwd(gi, gr, arg_i).view(bits))
    dx_p = sk.spmm_max_bwd_plain(gp, gr, arg)
    err = (dx.float() - dx_p.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= _bf16_ulp(torch.maximum(dx.float().abs(),
                                                    dx_p.float().abs()))).all())
    else:
        mag = sk.spmm_max_bwd_plain(gp, gr.abs(), arg)
        assert bool((err <= 1e-5 * mag + 1e-7).all())


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
    """k = 17 is refused before any launch; a triangle of more tile pairs
    (128 rows a tile) than an int numbers is refused by the C entry point
    and raised."""
    wide = torch.zeros((8, 17), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="k = 17"):
        pcc_scan.pcc_diff_counts(wide, wide, 0.0, 0.0)
    tall = torch.zeros((65535 * 256 + 1, 1), dtype=torch.float64, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pcc_scan.pcc_diff_counts(tall, tall, -1.0, 1.0)


def _hist_edges(d):
    """The reference's 201 edges, and custom edges that some off-diagonal d
    takes exactly (the first and the last among them, and 0, which every
    zero row's pairs take), narrower than d's spread."""
    default = torch.from_numpy(np.arange(-2.0, 2.0 + 1e-9, 0.02)).to(d.device)
    off = d[~torch.eye(d.shape[0], dtype=torch.bool, device=d.device)]
    vals = torch.unique(off[:1 << 22])
    if vals.numel() < 4:
        custom = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64, device=d.device)
    else:
        pick = torch.linspace(vals.numel() // 10, 9 * vals.numel() // 10, 12,
                              device=d.device).long()
        custom = torch.unique(torch.cat([vals[pick], torch.zeros(1, dtype=d.dtype,
                                                                 device=d.device)]))
    return default, custom


def _hub_csr(card, n, seed):
    """Rows 0 and 1 linked to every node (hub rows), random pairs elsewhere."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.zeros(n, np.int64), np.ones(n, np.int64) % max(n, 1),
                        rng.integers(0, n, 3 * n)])
    c = np.concatenate([np.arange(n), np.arange(n), rng.integers(0, n, 3 * n)])
    m = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    return pcc_scan.csr_tensors(m, card)


@pytest.mark.parametrize("n,k", PCC_SHAPES)
def test_pcc_hist_kernel_matches_plain(card, n, k):
    """Linked and unlinked counts equal the plain version's bin for bin,
    with the reference's edges and with edges that d takes, on factors with
    zero rows and a CSR with hub rows; the same over two launches."""
    z_i, z_n = _pcc_factors(card, n, k, seed=2)
    csr = _hub_csr(card, n, n + k)
    for edges in _hist_edges(_pcc_dense(z_i, z_n)):
        before = pcc_scan.LAUNCHES["pcc_diff_hist_f64"]
        linked, unlinked = pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)
        torch.cuda.synchronize()
        assert pcc_scan.LAUNCHES["pcc_diff_hist_f64"] == before + 1
        want_l, want_u = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr)
        assert torch.equal(linked, want_l) and torch.equal(unlinked, want_u)
        again = pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)
        assert torch.equal(again[0], linked) and torch.equal(again[1], unlinked)


@pytest.mark.parametrize("k,n_bins", [(3, 1000), (3, 8192), (16, 8192)])
def test_pcc_hist_kernel_many_bins(card, k, n_bins):
    """More bins than 32 copies of the block histogram fit: the launcher
    takes fewer copies (8 at 1,000 bins), or one at pcc_scan.MAX_BINS."""
    z_i, z_n = _pcc_factors(card, 1000, k, seed=3)
    csr = _hub_csr(card, 1000, k)
    d = _pcc_dense(z_i, z_n)
    edges = torch.linspace(float(d.min()) / 2, float(d.max()) / 2, n_bins + 1,
                           dtype=torch.float64, device=card)
    got = pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)
    torch.cuda.synchronize()
    want = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


def _ppi_like_csr(card, n, seed):
    """A symmetric CSR (a PPI's shape: a power-law of degrees, hubs joined
    to each other) with self-loops at every fifth node."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.8
    r = rng.choice(n, 6 * n, p=w / w.sum())
    c = rng.integers(0, n, 6 * n)
    loops = np.arange(0, n, 5)
    m = sp.coo_matrix((np.ones(len(r) + len(loops)), (np.concatenate([r, loops]),
                                                      np.concatenate([c, loops]))),
                      shape=(n, n))
    return pcc_scan.csr_tensors((m + m.T).tocsr(), card)


@pytest.mark.parametrize("n", [300, 4097])
def test_pcc_kernels_symmetric_csr_with_self_loops(card, n):
    """All three entries on a symmetric PPI-like CSR with self-loops (the
    topology step's and figures' shape of input; no one-way entries to
    correct), n no multiple of either tile size."""
    z_i, z_n = _pcc_factors(card, n, 3, seed=4)
    csr = _ppi_like_csr(card, n, n)
    d = _pcc_dense(z_i, z_n)
    for lo, hi in _pcc_thresholds(d):
        assert pcc_scan.pcc_diff_counts(z_i, z_n, lo, hi) == \
            pcc_scan.pcc_diff_counts_plain(z_i, z_n, lo, hi)
        rows, cols = pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr)
        want_r, want_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, csr)
        assert torch.equal(rows, want_r) and torch.equal(cols, want_c)
    for edges in _hist_edges(d):
        got = pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)
        want = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].sum()) > 0


@pytest.mark.parametrize("n,k", [(37, 3), (1000, 8), (4097, 1)])
def test_pcc_hit_kernel_negative_threshold(card, n, k):
    """hi < 0: every (i, i) with d = 0 > hi is a hit unless (i, i) is an
    edge; counts add the diagonal to d < lo where 0 < lo."""
    z_i, z_n = _pcc_factors(card, n, k, seed=5)
    d = _pcc_dense(z_i, z_n)
    off = d[~torch.eye(n, dtype=torch.bool, device=card)]
    hi = float(torch.quantile(off[:1 << 24], 0.3))
    assert hi < 0
    csr = _ppi_like_csr(card, n, k)
    rows, cols = pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr)
    want_r, want_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, csr)
    assert torch.equal(rows, want_r) and torch.equal(cols, want_c)
    diag = int((rows == cols).sum())
    assert 0 < diag < n  # the self-loops hold some back
    assert pcc_scan.pcc_diff_counts(z_i, z_n, -hi, hi) == \
        pcc_scan.pcc_diff_counts_plain(z_i, z_n, -hi, hi)


def _repeated_entry_csr(card, n, seed):
    """_hub_csr with the first entry of every fifth row repeated (ascending,
    not strictly, as the hit and histogram entries take it)."""
    indptr, indices = (t.cpu().numpy() for t in _hub_csr("cpu", n, seed))
    rows = [list(indices[indptr[i]:indptr[i + 1]]) for i in range(n)]
    for i in range(2, n, 5):
        if rows[i]:
            rows[i].insert(0, rows[i][0])
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in rows])]).astype(np.int64)
    idx = np.array([v for x in rows for v in x], np.int32)
    return torch.from_numpy(ptr).to(card), torch.from_numpy(idx).to(card)


@pytest.mark.parametrize("n", [37, 1000])
def test_pcc_hist_and_hits_repeated_entries(card, n):
    """Repeated CSR entries count once: the histogram's one-way correction
    skips a repeat, the hit marks test membership."""
    z_i, z_n = _pcc_factors(card, n, 3, seed=6)
    csr = _repeated_entry_csr(card, n, n)
    d = _pcc_dense(z_i, z_n)
    for edges in _hist_edges(d):
        got = pcc_scan.pcc_diff_histogram(z_i, z_n, edges, csr)
        want = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, edges, csr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for _, hi in _pcc_thresholds(d):
        rows, cols = pcc_scan.pcc_diff_hits(z_i, z_n, hi, csr)
        want_r, want_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, csr)
        assert torch.equal(rows, want_r) and torch.equal(cols, want_c)


def test_pcc_hist_refuses_wide_k_and_malformed_edges(card):
    z = torch.zeros((8, 3), dtype=torch.float64, device=card)
    csr = (torch.zeros(9, dtype=torch.int64, device=card),
           torch.zeros(0, dtype=torch.int32, device=card))
    ok = torch.tensor([-1.0, 1.0], dtype=torch.float64, device=card)
    wide = torch.zeros((8, 17), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="k = 17"):
        pcc_scan.pcc_diff_histogram(wide, wide, ok, csr)
    for bad in ([0.5], [0.0, 0.0, 1.0], [1.0, -1.0], [0.0, float("inf")]):
        with pytest.raises(ValueError, match="edges"):
            pcc_scan.pcc_diff_histogram(
                z, z, torch.tensor(bad, dtype=torch.float64, device=card), csr)


# The edge-weighted sum: float32 within 1e-5 of the summed magnitudes and
# bit-identical run to run (values uniform in [0.5, 1.5)); bfloat16 exact on
# small integers with dyadic values (every product and partial sum exact).
VAL_CASES = [(39, ROW_CHUNK), (120, ROW_CHUNK), (4000, ROW_CHUNK), (39, 8), (120, 8)]


def _weighted_split_graph(row_chunk, dyadic):
    g = _split_graph(row_chunk)
    rng = np.random.default_rng(row_chunk)
    src = g.src.numpy()
    val = rng.uniform(0.5, 1.5, len(src))
    if dyadic:
        val = np.round(val * 8) / 8
    return build_graph(src, g.dst.numpy(), g.n_real_nodes, row_chunk=row_chunk,
                       edge_val=val)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,row_chunk", VAL_CASES)
def test_weighted_sum_matches_plain(card, k, row_chunk, dtype, transpose):
    g = _weighted_split_graph(row_chunk, dyadic=dtype == torch.bfloat16).to(card)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    gen = torch.Generator(device=card).manual_seed(k)
    if dtype == torch.float32:
        x = torch.randn((g.n_nodes, k), generator=gen, device=card)
    else:
        x = torch.randint(-8, 9, (g.n_nodes, k), generator=gen, device=card).to(dtype)
    name = f"spmm_sum_val_{'bwd' if transpose else 'fwd'}_" + (
        "f32" if dtype == torch.float32 else "bf16")
    before = sk.LAUNCHES[name]
    out = sk.spmm_sum_rows(g, x, transpose, use_val=True)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    out_p = sk.spmm_sum_plain(g, x, transpose, use_val=True)
    if dtype == torch.bfloat16:
        assert torch.equal(out, out_p)
    else:
        assert torch.equal(out, sk.spmm_sum_rows(g, x, transpose, use_val=True))
        mag = sk.spmm_sum_plain(g, x.abs(), transpose, use_val=True)
        assert bool(((out - out_p).abs() <= 1e-5 * mag + 1e-7).all())
    # the unweighted kernel is another function of these inputs
    assert not torch.equal(out, sk.spmm_sum_rows(g, x, transpose))


def test_weighted_sum_autograd_on_card_matches_cpu(card):
    g = _weighted_split_graph(ROW_CHUNK, dyadic=False)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((g.n_nodes, 3, 13)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    grads = []
    for dev, graph in ((card, g.to(card)), (torch.device("cpu"), g)):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        (spmm_sum(graph, xt, use_val=True) * torch.from_numpy(w).to(dev)).sum().backward()
        grads.append(xt.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("slice_queries", [cn.SLICE_QUERIES, 8, 1])
def test_common_neighbors_kernel_split_rows(card, slice_queries):
    """Three hubs of ~3,300 neighbours each: the queries of a hub (the
    longer row of most of its pairs) spread over many slices, each block
    rebuilding the hub's bitmap, and add into their own counts."""
    csr, (rows, cols) = _cn_inputs(card, 4097, 5, hub=3)
    per_row = torch.bincount(cn.longer_rows(csr[0], rows, cols).long())
    assert int(per_row.max()) > 12 * slice_queries
    got = cn.common_neighbors(csr, rows, cols, slice_queries=slice_queries)
    torch.cuda.synchronize()
    assert torch.equal(got, cn.common_neighbors_plain(csr, rows, cols))


@pytest.mark.parametrize("words", [1, 4, 40])
def test_common_neighbors_kernel_windows(card, monkeypatch, words):
    """A bitmap of 32 x words ids, less than N = 4,097: each block walks
    its row's ids in windows (skipping those that hold none) and searches
    each shorter row once per window; hubs and empty rows included."""
    csr, (rows, cols) = _cn_inputs(card, 4097, 7, hub=2)
    monkeypatch.setattr(cn, "WINDOW_WORDS", words)
    got = cn.common_neighbors(csr, rows, cols, slice_queries=16)
    torch.cuda.synchronize()
    assert torch.equal(got, cn.common_neighbors_plain(csr, rows, cols))


def test_common_neighbors_kernel_ppi_like(card):
    """A symmetric PPI-like CSR with self-loops, queries its upper-triangle
    edges as data/ecc.py asks them."""
    csr = _ppi_like_csr(card, 3001, 9)
    indptr, indices = (t.cpu().numpy() for t in csr)
    r = np.repeat(np.arange(3001), np.diff(indptr))
    up = r < indices
    rows = torch.from_numpy(r[up].astype(np.int32)).to(card)
    cols = torch.from_numpy(indices[up].astype(np.int32)).to(card)
    got = cn.common_neighbors(csr, rows, cols)
    torch.cuda.synchronize()
    assert torch.equal(got, cn.common_neighbors_plain(csr, rows, cols))


def test_common_neighbors_kernel_empty_rows_and_queries(card):
    """Queries on empty rows count 0 (every block leaves at once); no
    queries at all give an empty result."""
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


def _shard_graphs(p):
    """Every shard's interior and boundary graph of a balanced P-way
    partition of a power-law graph (hub rows split into chunks; rows with
    no interior or no boundary edge stay empty)."""
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.parallel.partition import partition_graph

    ppi = powerlaw_ppi(3000, 40000, 7)
    pg = partition_graph(ppi.row, ppi.col, 3000, p, add_self_loops=True, balance=True)
    return [(f"{part} {r}", getattr(pg.shard(r), part))
            for r in range(p) for part in ("interior", "boundary")]


@pytest.mark.parametrize("with_argmax", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [2, 4])
def test_empty_value_max_kernel_on_shard_graphs(card, p, dtype, with_argmax):
    """spmm_max_fwd(empty_value=-inf), the sharded path's interior and
    boundary passes: out and arg bit-exact with the plain version (empty
    rows -inf and -1), one launch counted as *_empty_*, bit-identical run to
    run; with the argmax, the backward as test_chunked_max_bwd_matches_plain
    holds it."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    name = "spmm_max_fwd_" + ("" if with_argmax else "noarg_") + "empty_" + tag
    splits = 0
    for label, g in _shard_graphs(p):
        g = g.to(card)
        splits += g.chunks.n_split
        gen = torch.Generator(device=card).manual_seed(len(label))
        x = torch.randn((g.n_nodes, 130), generator=gen, device=card)
        x = (torch.round(x * 2) / 2).relu_().to(dtype)
        before = sk.LAUNCHES[name]
        out, arg = sk.spmm_max_fwd(g, x, with_argmax=with_argmax, empty_value=-np.inf)
        torch.cuda.synchronize()
        assert sk.LAUNCHES[name] == before + 1, label
        out_p, arg_p = sk.spmm_max_fwd_plain(g, x, with_argmax, empty_value=-np.inf)
        assert torch.equal(out, out_p), label
        empty = (g.in_degree == 0)
        assert bool(torch.isneginf(out[empty].float()).all()), label
        out_2, arg_2 = sk.spmm_max_fwd(g, x, with_argmax=with_argmax, empty_value=-np.inf)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(bits), out_2.view(bits)), label
        if not with_argmax:
            assert arg is None
            continue
        assert torch.equal(arg, arg_p) and torch.equal(arg, arg_2), label
        assert bool((arg[empty] == -1).all()), label
        if dtype == torch.float32:
            gr = torch.randn((g.n_nodes, 130), generator=gen, device=card)
        else:
            gr = torch.randint(-8, 9, (g.n_nodes, 130), generator=gen,
                               device=card).to(dtype)
        dx = sk.spmm_max_bwd(g, gr, arg)
        dx_p = sk.spmm_max_bwd_plain(g, gr, arg)
        err = (dx.float() - dx_p.float()).abs()
        if dtype == torch.bfloat16:
            assert bool((err <= _bf16_ulp(torch.maximum(dx.float().abs(),
                                                        dx_p.float().abs()))).all())
        else:
            mag = sk.spmm_max_bwd_plain(g, gr.abs(), arg)
            assert bool((err <= 1e-5 * mag + 1e-7).all()), label
    assert splits > 0


# ---------------------------------------------------------------------------
# The hub cache: each hub kernel against the same kernel without the hub and
# against its plain version.
# ---------------------------------------------------------------------------


def _hub_fixture_graph(row_chunk=ROW_CHUNK):
    """tests/test_pallas_kernels.py's _hub_graph (200 nodes, 5 hot sources)."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 200, 3000)
    dst = rng.integers(0, 200, 3000)
    src = np.where(rng.random(3000) < 0.3, rng.integers(0, 5, 3000), src)
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    return pairs[:, 0], pairs[:, 1], 200


# k = 100 at K = 1,024: a 100 KB arena forward (150 KB backward in float32),
# past the 48 KB a launch gets without the opt-in
HUB_CASES = [(8, 1024, ROW_CHUNK), (100, 1024, ROW_CHUNK), (16, 111, 8), (64, 5030, ROW_CHUNK)]


def _hub_pair(src, dst, n, k, row_chunk, card):
    g0 = build_graph(src, dst, n, row_chunk=row_chunk)
    return g0.to(card), g0.with_hub(k, k).to(card)


def _tag(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hub_k,k,row_chunk", HUB_CASES)
def test_hub_max_kernels_match_no_hub_and_plain(card, dtype, hub_k, k, row_chunk):
    """Forward out and argmax bit-exact against the kernel without the hub
    and the plain version; dx bit-identical to the kernel without the hub,
    against plain within 1e-5 of the hit magnitudes (float32) or 1 ulp
    (bfloat16, small-integer gradients)."""
    g0, gh = _hub_pair(*_hub_fixture_graph(), hub_k, row_chunk, card)
    gen = torch.Generator(device=card).manual_seed(k)
    x = (torch.round(torch.randn((g0.n_nodes, k), generator=gen, device=card) * 4) / 4)
    x = x.relu_().to(dtype)
    before = {n: sk.LAUNCHES[n] for n in (f"spmm_max_fwd_hub_{_tag(dtype)}",
                                           f"spmm_max_bwd_hub_{_tag(dtype)}")}
    out0, arg0 = sk.spmm_max_fwd(g0, x)
    out, arg = sk.spmm_max_fwd(gh, x)
    if dtype == torch.float32:
        gr = torch.randn((g0.n_nodes, k), generator=gen, device=card)
    else:
        gr = torch.randint(-8, 9, (g0.n_nodes, k), generator=gen, device=card).to(dtype)
    dx0 = sk.spmm_max_bwd(g0, gr, arg0)
    dx = sk.spmm_max_bwd(gh, gr, arg)
    torch.cuda.synchronize()
    assert all(sk.LAUNCHES[n] == c + 1 for n, c in before.items())
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), out0.view(bits)) and torch.equal(arg, arg0)
    assert torch.equal(dx.view(bits), dx0.view(bits))
    assert torch.equal(dx.view(bits), sk.spmm_max_bwd(gh, gr, arg).view(bits))
    out_p, arg_p = sk.spmm_max_fwd_plain(gh, x)
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
    dx_p = sk.spmm_max_bwd_plain(gh, gr, arg)
    err = (dx.float() - dx_p.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= _bf16_ulp(torch.maximum(dx.float().abs(),
                                                    dx_p.float().abs()))).all())
    else:
        assert bool((err <= 1e-5 * sk.spmm_max_bwd_plain(gh, gr.abs(), arg) + 1e-7).all())


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hub_k,k,row_chunk", HUB_CASES)
def test_hub_sum_kernels_match_no_hub_and_plain(card, dtype, transpose, hub_k, k, row_chunk):
    """Bit-identical to the kernel without the hub; against plain within
    1e-5 of the summed magnitudes (float32) or exact (bfloat16 on small
    integers)."""
    g0, gh = _hub_pair(*_hub_fixture_graph(), hub_k, row_chunk, card)
    gen = torch.Generator(device=card).manual_seed(k + 1)
    if dtype == torch.float32:
        x = torch.randn((g0.n_nodes, k), generator=gen, device=card)
    else:
        x = torch.randint(-8, 9, (g0.n_nodes, k), generator=gen, device=card).to(dtype)
    name = f"spmm_sum_{'bwd' if transpose else 'fwd'}_hub_{_tag(dtype)}"
    before = sk.LAUNCHES[name]
    out = sk.spmm_sum_rows(gh, x, transpose)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), sk.spmm_sum_rows(g0, x, transpose).view(bits))
    out_p = sk.spmm_sum_plain(gh, x, transpose)
    if dtype == torch.bfloat16:
        assert torch.equal(out, out_p)
    else:
        mag = sk.spmm_sum_plain(gh, x.abs(), transpose)
        assert bool(((out - out_p).abs() <= 1e-5 * mag + 1e-7).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_max_cross_chunk_ties(card, dtype):
    """The cross-chunk tie graph with row 0's first sources in the arena:
    bit-exact against the kernel without the hub and the plain version, and
    ties across row 0's chunks still go to the lower chunk."""
    g, x = _cross_chunk_graph()
    src, dst = g.src.numpy(), g.dst.numpy()
    # row 0's first 16 sources in the arena: extra out-edges make them the
    # most fetched
    ids = np.arange(1, 17)
    extra = np.repeat(ids, 40)
    gh = build_graph(np.concatenate([src, extra]),
                     np.concatenate([dst, 500 + np.arange(len(extra)) % 300]),
                     g.n_real_nodes)
    g0 = gh.to(card)
    ghh = gh.with_hub(16, 16)
    assert set(ghh.hub.ids.tolist()) == set(ids.tolist())
    xd = torch.from_numpy(x).to(card, dtype)
    out0, arg0 = sk.spmm_max_fwd(g0, xd)
    out, arg = sk.spmm_max_fwd(ghh.to(card), xd)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), out0.view(bits)) and torch.equal(arg, arg0)
    out_p, arg_p = sk.spmm_max_fwd_plain(ghh, x_cpu := torch.from_numpy(x).to(dtype))
    assert torch.equal(out.cpu(), out_p) and torch.equal(arg.cpu(), arg_p)
    cols = np.arange(x.shape[1])
    row0 = arg[0].cpu().numpy()
    np.testing.assert_array_equal(row0[cols % 4 < 2], 1)
    np.testing.assert_array_equal(
        row0[cols % 4 == 2], 1 + (1 + (cols[cols % 4 == 2] // 4) % 3) * ROW_CHUNK)
    gr = torch.randint(-8, 9, x_cpu.shape, generator=torch.Generator().manual_seed(3))
    gr = gr.to(card, dtype)
    assert torch.equal(sk.spmm_max_bwd(ghh.to(card), gr, arg).view(bits),
                       sk.spmm_max_bwd(g0, gr, arg0).view(bits))


def _hub_shard_interiors(form):
    """Interior graphs of a balanced 2-way partition, the graphs a mesh's
    hub runs on: a power-law graph's (int16 argmax), 70,000 nodes with few
    edges and 40 hot sources (gather space past 2^15 rows: int32 argmax),
    or a sparse graph without self-loops whose interiors have fewer
    distinct sources than a 64-row hub (dummy slots)."""
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.parallel.partition import partition_graph

    rng = np.random.default_rng(11)
    loops = True
    if form == "id16":
        ppi = powerlaw_ppi(3000, 40000, 7)
        src, dst, n = ppi.row, ppi.col, 3000
    elif form == "id32":
        n = 70_000
        src = np.concatenate([rng.integers(0, 40, 6000), rng.integers(0, n, 6000)])
        dst = rng.integers(0, n, 12000)
    else:
        n, loops = 400, False
        src = np.concatenate([rng.integers(0, 12, 300), rng.integers(0, n, 60)])
        dst = rng.integers(0, n, 360)
    pg = partition_graph(src, dst, n, 2, add_self_loops=loops, balance=True)
    return [pg.shard(r).interior for r in range(2)]


# (argmax form, hub rows, K): int16 / int32 argmax at one and several
# K-slices, and a hub with dummy slots
HUB_SHARD_CASES = [("id16", 16, 130), ("id16", 64, 1024), ("id32", 64, 130),
                   ("id32", 32, 1024), ("dummy", 64, 130)]


@pytest.mark.parametrize("empty_value", [-np.inf, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form,hub_k,k", HUB_SHARD_CASES)
def test_hub_kernels_on_shards_match_no_hub_and_plain(card, form, hub_k, k, dtype,
                                                      empty_value):
    """The hub kernels on a mesh's interior graphs (``empty_value=-inf``, the
    interior pass; 0, the local pass at graph=1): forward out and argmax
    bit-exact against the kernel without the hub and the plain version
    (empty rows empty_value and -1), dx on small-integer gradients (exact
    float32 sums) bit-equal to both, one hub launch each."""
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    tag = _tag(dtype)
    for i, g in enumerate(_hub_shard_interiors(form)):
        gh = g.with_hub(hub_k, hub_k).to(card)
        g0 = g.to(card)
        assert sk.arg_dtype(g0) == (torch.int32 if form == "id32" else torch.int16)
        assert (gh.hub.n_hub < hub_k) == (form == "dummy") and gh.hub.n_covered > 0
        gen = torch.Generator(device=card).manual_seed(k + i)
        x = torch.round(torch.randn((g0.n_nodes, k), generator=gen, device=card) * 4) / 4
        x = x.relu_().to(dtype)
        gr = torch.randint(-8, 9, (g0.n_nodes, k), generator=gen, device=card).to(dtype)
        before = {d: sk.LAUNCHES[f"spmm_max_{d}_hub_{tag}"] for d in ("fwd", "bwd")}
        out, arg = sk.spmm_max_fwd(gh, x, empty_value=empty_value)
        dx = sk.spmm_max_bwd(gh, gr, arg)
        torch.cuda.synchronize()
        assert all(sk.LAUNCHES[f"spmm_max_{d}_hub_{tag}"] == c + 1 for d, c in before.items())
        out0, arg0 = sk.spmm_max_fwd(g0, x, empty_value=empty_value)
        out_p, arg_p = sk.spmm_max_fwd_plain(gh, x, empty_value=empty_value)
        assert arg.dtype == sk.arg_dtype(g0)
        for o, a in ((out0, arg0), (out_p, arg_p)):
            assert torch.equal(out.view(bits), o.view(bits)) and torch.equal(arg, a)
        empty = g0.in_degree == 0
        assert bool(empty.any()) and bool((arg[empty] == -1).all())
        assert bool((out[empty].float() == empty_value).all())
        for want in (sk.spmm_max_bwd(g0, gr, arg0), sk.spmm_max_bwd_plain(gh, gr, arg)):
            assert torch.equal(dx.view(bits), want.view(bits))


def test_hub_arena_past_the_card_refused(card):
    """An arena above the card's 227 KB a block is refused, never cut: the
    wrapper raises (500 rows x 1 KB forward)."""
    g0, gh = _hub_pair(*_hub_fixture_graph(), 500, ROW_CHUNK, card)
    x = torch.ones((g0.n_nodes, 1024), device=card)
    with pytest.raises(RuntimeError, match="spmm_max_fwd_hub launch failed"):
        sk.spmm_max_fwd(gh, x)
    with pytest.raises(RuntimeError, match="spmm_sum_hub launch failed"):
        sk.spmm_sum_rows(gh, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_warps_query(card, dtype):
    """The occupancy entry points: a hub block holds as many warps of an SM
    as the kernel without the hub at the path's first-layer widths, and
    the query launches nothing."""
    before = dict(sk.LAUNCHES)
    for kind, k_width in (("max_fwd", 5030), ("max_bwd", 5030), ("sum", 4000)):
        with_hub, without = sk.hub_warps(kind, dtype, k_width, 64)
        assert with_hub == without > 0, (kind, with_hub, without)
    assert sk.LAUNCHES == before


# ---------------------------------------------------------------------------
# The max kernels' K-slice widths (ops/spmm_kernels.py: slice_bytes): at every
# forced width the forward is bit-exact and dx bit-identical to the 1 KB
# width's (the same lanes' walks over the same edges in the same order), and
# both hold against the plain versions.
# ---------------------------------------------------------------------------

def _slice_graph(card, monkeypatch, form):
    """The cross-chunk tie graph as ``form``: positional with row 0 a mega row
    (POS_RANK_CAP 40: 20 segments, the cap below the chunk), id-based with an
    int16 argmax, or id-based over 33,000 nodes (int32 argmax)."""
    from plagnn_tpu_torch.ops import graph_format as gf

    g0, x = _cross_chunk_graph()
    src, dst = g0.src.numpy(), g0.dst.numpy()
    if form == "pos":
        monkeypatch.setattr(gf, "POS_RANK_CAP", 40)
        g = build_graph(src, dst, g0.n_real_nodes, positional=True)
        assert g.n_mega == 1
    else:
        n = g0.n_real_nodes if form == "id16" else 33000
        g = build_graph(src, dst, n, positional=False)
    return g.to(card), x


@pytest.mark.parametrize("width", sk.SLICE_WIDTHS)
@pytest.mark.parametrize("k", [111, 1024, 4024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["pos", "id16", "id32"])
def test_slice_widths_match_1kb_and_plain(card, monkeypatch, form, dtype, k, width):
    g, x = _slice_graph(card, monkeypatch, form)
    n = g.n_nodes
    if x.shape[0] < n:   # id32: the extra nodes have no edges; their rows are 0
        x = np.concatenate([x, np.zeros((n - x.shape[0], x.shape[1]), np.float32)])
    xv = np.ascontiguousarray(np.tile(x[:n], (1, -(-k // x.shape[1])))[:, :k])
    xd = torch.from_numpy(xv).to(card, dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    kw = {"force_slice": width}
    out, arg = sk.spmm_max_fwd(g, xd, **kw)
    out0, arg0 = sk.spmm_max_fwd(g, xd, force_slice=1024)
    torch.cuda.synchronize()
    assert arg.dtype == (torch.int32 if form == "id32" else torch.int16)
    assert torch.equal(out.view(bits), out0.view(bits)) and torch.equal(arg, arg0)
    out_p, arg_p = sk.spmm_max_fwd_plain(g, xd)
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
    out_n, _ = sk.spmm_max_fwd(g, xd, with_argmax=False, **kw)
    assert torch.equal(out_n.view(bits), out0.view(bits))

    gen = torch.Generator(device=card).manual_seed(k)
    if dtype == torch.float32:
        gr = torch.randn((n, k), generator=gen, device=card)
    else:
        gr = torch.randint(-8, 9, (n, k), generator=gen, device=card).to(dtype)
    dx = sk.spmm_max_bwd(g, gr, arg, **kw)
    dx0 = sk.spmm_max_bwd(g, gr, arg, force_slice=1024)
    assert torch.equal(dx.view(bits), dx0.view(bits))
    dx_p = sk.spmm_max_bwd_plain(g, gr, arg)
    err = (dx.float() - dx_p.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= _bf16_ulp(torch.maximum(dx.float().abs(),
                                                    dx_p.float().abs()))).all())
    else:
        mag = sk.spmm_max_bwd_plain(g, gr.abs(), arg)
        assert bool((err <= 1e-5 * mag + 1e-7).all())


def test_slice_width_refusals(card):
    """A width the kernels do not take raises; the C entry refuses a grid
    past 65,535 K-slices at a narrow width as at 1 KB."""
    g = build_graph(np.arange(5), np.arange(1, 6), 10).to(card)
    x = torch.zeros((g.n_nodes, 64), device=card)
    with pytest.raises(ValueError, match="K-slice width"):
        sk.spmm_max_fwd(g, x, force_slice=48)
    k = 65535 * 8 + 8     # f32 at 32 B: one lane of 2 x 4 elements, 65,536 slices
    xw = torch.zeros((g.n_nodes, k), device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.spmm_max_fwd(g, xw, force_slice=32)


def test_launch_slices_record_the_width(card):
    """Each max wrapper records the K-slice width it passed to its kernel
    (chip_smoke.py's ``slice_bytes``): the forced width, else the rule's;
    the sum kernel its fixed 1 KB."""
    g = build_graph(np.arange(50), (np.arange(50) * 7) % 50, 60).to(card)
    n, k = g.n_nodes, 96
    x = torch.rand((n, k), device=card)
    for w in (None, 256, 1024):
        _, arg = sk.spmm_max_fwd(g, x, force_slice=w)
        assert sk.LAUNCH_SLICES["spmm_max_fwd_f32", n, k] == (w or sk.slice_bytes(n, 4))
        sk.spmm_max_bwd(g, x, arg, force_slice=w)
        assert sk.LAUNCH_SLICES["spmm_max_bwd_f32", n, k] == (w or sk.slice_bytes(n, 4, 2))
    sk.spmm_sum_rows(g, x)
    assert sk.LAUNCH_SLICES["spmm_sum_fwd_f32", n, k] == 1024


def test_mesh_auto_on_the_card_launches_the_max_kernels(card, tmp_path, monkeypatch):
    """The planner on its baked H100 anchors picks fold=1,graph=1 for one
    card, and a one-epoch ``--mesh auto:1`` run trains at its fold batch
    through the max kernels, 3 forwards and 3 backwards an epoch."""
    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.parallel import planner

    monkeypatch.delenv(planner.ANCHORS_ENV, raising=False)
    root = str(tmp_path)
    cli.main(["synth", "--data-root", root, "--nodes", "512", "--edges", "4000"])
    plan = cli.main(["plan-mesh", "--devices", "1", "--data-root", root, "--jobs", "6"])
    assert plan.anchors_source == "baked"
    assert (plan.chosen.mesh_fold, plan.chosen.mesh_graph) == (1, 1)
    sk.reset_launches()
    stats = cli.main(["train-normal", "-data", "GSE30931", "--data-root", root,
                      "-e", "1", "--rounds", "2", "-f", "3", "--mesh", "auto:1"])
    torch.cuda.synchronize()
    assert [s.folds for s in stats] == [min(plan.chosen.fold_batch, 6)]
    assert sk.LAUNCHES["spmm_max_fwd_f32"] == sk.LAUNCHES["spmm_max_bwd_f32"] == 3


@pytest.mark.parametrize("pattern", ["random", "sequential"])
@pytest.mark.parametrize("shape", dc.CHECK_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dma_ring_kernel_matches_plain(card, shape, pattern):
    """The gather probe's slot 0 equals its plain version's bit for bit, one
    launch counted, run to run, at every (row_bytes, ng, g, windows) of
    CHECK_SHAPES (window counts above and off a multiple of the grid)."""
    row_bytes, ng, g, windows = shape
    _, n_fetch, (idx, x, _) = dc.build_bench(dc.CHECK_ROWS, row_bytes, windows * dc.T_E, ng,
                                             pattern, device=card, g=g)
    before = dc.LAUNCHES["dma_ring_f32"]
    out = dc.dma_ring(x, idx, ng, g)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["dma_ring_f32"] == before + 1
    assert out.shape == (g, row_bytes // 4)
    assert torch.equal(out, dc.dma_ring_plain(x, idx, ng, g))
    assert torch.equal(dc.dma_ring(x, idx, ng, g), out)


def test_dma_ring_kernel_on_a_pitched_table_and_build_bench_run(card):
    """A table whose rows lie further apart than their width (a view), and
    build_bench's run(), which launches on inputs it checked once."""
    gen = torch.Generator(device=card).manual_seed(3)
    wide = torch.rand((500, 4 * 68), generator=gen, device=card)
    x = wide[:, :256]                       # 1 KB rows, 1,088 B apart
    idx = torch.randint(0, 500, (5 * dc.T_E,), generator=gen, device=card, dtype=torch.int32)
    assert torch.equal(dc.dma_ring(x, idx, 5, 4), dc.dma_ring_plain(x, idx, 5, 4))
    run, _, (idx, x, g) = dc.build_bench(24064, 1024, 40 * dc.T_E, 8, "random",
                                         device=card, rng="torch")
    before = dc.LAUNCHES["dma_ring_f32"]
    out = run()
    torch.cuda.synchronize()
    assert dc.LAUNCHES["dma_ring_f32"] == before + 1
    assert torch.equal(out, dc.dma_ring_plain(x, idx, 8, g))
    with pytest.raises(ValueError, match="ids must lie"):
        dc.dma_ring(x, idx + 24064, 8, g)


def test_dma_measure_on_the_card(card, tmp_path):
    """measure's record and main's file on the card: CUDA events, the
    launches counted, the reader reads the file back."""
    dc.reset_launches()
    rec = dc.measure(1024, 8, "random", 24064, target_mb=64, reps=3, device=card)
    assert rec["timer"] == "cuda events" and rec["fits_l2"] and rec["g"] == 8
    assert dc.LAUNCHES["dma_ring_f32"] == 1 + 1 + 3 * rec["launches_per_rep"]
    assert 0 < rec["gbps_lo"] <= rec["gbps"] <= rec["gbps_hi"]
    out = tmp_path / "sweep.json"
    dc.main(["--rows-bytes", "256", "1024", "--n-rows", "24064", "--target-mb", "16",
             "--reps", "2", "--depth-sweep", "--patterns", "random", "--out", str(out)])
    rate = dc.load_achievable_rate(str(out))
    assert [p[0] for p in rate.points] == [256, 1024] and rate.n_rows == 24064
    assert rate.device
