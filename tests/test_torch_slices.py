"""The max kernels' K-slice rule (``ops/spmm_kernels.py: slice_bytes``).

The two max kernels walk a K-slice of the rows' columns at a time, and the
blocks in flight share it.  The wrapper keeps the 1 KB slice while N_pad
rows of it (x in the forward; g and the argmax in the backward) come to at
most ``WIDE_SLICE_FROM`` bytes, and past that takes the width measured
fastest on the 165 k- and 330 k-node graphs for the direction and dtype
(``WIDE_SLICE``).  Here, on the CPU:
the width the rule gives at every shape a path launches, that each width is
whole lane vectors and its grid fits, the launch order of the chunks, and
the refusals of the forcing keyword.
"""
import numpy as np
import pytest
import torch

from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo
from plagnn_tpu_torch.parallel.partition import partition_graph

NODES, EDGES, SEED = 24041, 700000, 70   # the synthetic PPI-scale graph
BIG_N_PAD = 330112                       # BASELINE.json config 5 (330,000 nodes)
FOLDS, BIG_FOLDS = 10, 8
WIDTHS = (503, 400, 300)                 # per-fold width of GNN32's aggregations
ESIZE = {torch.float32: 4, torch.bfloat16: 2}


@pytest.fixture(scope="module")
def ppi():
    return powerlaw_ppi(NODES, EDGES, SEED)


def _check_layout(width, k, esize, arg_size=0):
    """The width holds whole lane vectors (V elements of ``esize`` bytes, the
    wrapper's vector at K) and its grid fits the 65,535 K-slices of
    row_chunks.cuh: grids."""
    v = sk.vector_width(k, max(esize, arg_size))
    lanes, per_slice, slices = sk.slice_layout(width, k, esize, arg_size)
    assert width % (v * esize) == 0
    assert per_slice % v == 0 and per_slice * esize <= width
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    assert slices * per_slice >= k > (slices - 1) * per_slice
    assert slices <= 65535


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [FOLDS * w for w in WIDTHS] + [FOLDS * 12])
def test_24k_shapes_keep_1kb(ppi, dtype, k):
    """Every 24k-node shape (GNN32's K = 10 x 503 / 400 / 300, GCN2 conv2's
    10 x 12) takes today's 1 KB slice, forward and backward (int16 argmax),
    so those paths launch the 32-lane kernels with the parent's grids."""
    n_pad = from_scipy_coo(ppi, add_self_loops=True).n_nodes
    assert n_pad == 24064
    es = ESIZE[dtype]
    for arg_size in (0, 2):
        width = sk.slice_bytes(n_pad, es, arg_size)
        assert width == 1024
        _check_layout(width, k, es, arg_size)
        lanes, per_slice, _ = sk.slice_layout(width, k, es, arg_size)
        assert lanes == 32 and per_slice * es == (1024 if k % 2 == 0 or es == 4 else 512)


# (P, dtype) -> (forward width, backward width) at the shard gather spaces
SHARD_WIDTHS = {
    (2, torch.float32): (1024, 1024),
    (2, torch.bfloat16): (1024, 1024),
    (4, torch.float32): (1024, 1024),
    (4, torch.bfloat16): (1024, 1024),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,ks", [(2, [FOLDS * w for w in WIDTHS] + [5 * w for w in WIDTHS]),
                                  (4, [FOLDS * w for w in WIDTHS])])
def test_shard_gather_spaces(ppi, dtype, p, ks):
    """The graph shards of the mesh path (the balanced partitions of phase
    4m: gather spaces of 35,928 rows at P = 2, 28,928 at P = 4; id-based,
    an int32 argmax past 2^15 rows) take the width the rule gives their
    gather space: 1 KB at both, forward and backward, where the card
    measured it fastest (the largest working set, P = 2's bf16 backward,
    35,928 x 3 KB, stays under WIDE_SLICE_FROM)."""
    pg = partition_graph(ppi.row, ppi.col, NODES, p, add_self_loops=True, balance=True)
    assert pg.n_local == {2: 35928, 4: 28928}[p]
    graph = pg.shard(0).interior
    n_pad = graph.n_nodes
    es = ESIZE[dtype]
    arg_size = torch.empty(0, dtype=sk.arg_dtype(graph)).element_size()
    assert arg_size == {2: 4, 4: 2}[p]
    fwd, bwd = SHARD_WIDTHS[p, dtype]
    assert sk.slice_bytes(n_pad, es) == fwd
    assert sk.slice_bytes(n_pad, es, arg_size) == bwd
    assert n_pad * (1024 + 1024 // es * arg_size) <= sk.WIDE_SLICE_FROM
    for k in ks:
        _check_layout(fwd, k, es)
        _check_layout(bwd, k, es, arg_size)


# (dtype, argmax bytes) -> (forward width, backward width) at N_pad 330,112
BIG_WIDTHS = {
    (torch.float32, 2): (256, 1024),    # positional: the training path
    (torch.bfloat16, 2): (1024, 512),
    (torch.float32, 4): (256, 256),     # id-based int32 (phase 4g's check)
    (torch.bfloat16, 4): (1024, 256),
}


@pytest.mark.parametrize("dtype,arg_size", sorted(BIG_WIDTHS, key=str))
@pytest.mark.parametrize("k", [BIG_FOLDS * w for w in WIDTHS])
def test_big_graph_widths(dtype, arg_size, k):
    """At 330,112 rows every 1 KB working set is past WIDE_SLICE_FROM (338
    MB of x, 507-1,014 MB of g and argmax), and each kernel takes the width
    measured fastest there: 256 B (groups of 8 lanes) for the f32 forward
    and the id-based backwards, 512 B (16 lanes) for the bf16 positional
    backward, 1 KB for the bf16 forward and the f32 positional backward."""
    es = ESIZE[dtype]
    fwd, bwd = BIG_WIDTHS[dtype, arg_size]
    assert BIG_N_PAD * 1024 > sk.WIDE_SLICE_FROM
    assert sk.slice_bytes(BIG_N_PAD, es) == fwd == sk.WIDE_SLICE[es, 0]
    assert sk.slice_bytes(BIG_N_PAD, es, arg_size) == bwd == sk.WIDE_SLICE[es, arg_size]
    _check_layout(fwd, k, es)
    _check_layout(bwd, k, es, arg_size)
    assert sk.slice_layout(fwd, k, es)[0] == fwd // 32
    assert sk.slice_layout(bwd, k, es, arg_size)[0] == bwd // 32


def test_rule_narrows_with_rows():
    """The width is 1 KB exactly while N_pad rows of the 1 KB slice come to
    at most WIDE_SLICE_FROM bytes, and WIDE_SLICE's width for the direction
    and dtype at every size past it; every width the rule gives holds whole
    vectors at every K parity and fits the grid at GNN32's widths."""
    for (es, arg_size), wide in sk.WIDE_SLICE.items():
        assert wide in sk.SLICE_WIDTHS
        row = 1024 + 1024 // es * arg_size
        fit = sk.WIDE_SLICE_FROM // row
        assert sk.slice_bytes(fit, es, arg_size) == 1024
        assert sk.slice_bytes(fit + 1, es, arg_size) == wide
        for n in (128, 24064, fit, fit + 1, 65536, 330112, 10**6, 10**7):
            w = sk.slice_bytes(n, es, arg_size)
            assert w == (1024 if n <= fit else wide)
            for k in (111, 1024, 4024, 5030):
                _check_layout(w, k, es, arg_size)


def test_chunk_launch_order():
    """RowChunks.order lists every chunk once, longest first, ties in chunk
    order, in both directions."""
    rng = np.random.default_rng(5)
    src = np.concatenate([rng.integers(0, 500, 4000), np.arange(1, 400)])
    dst = np.concatenate([rng.integers(0, 480, 4000), np.zeros(399, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    g = build_graph(pairs[:, 0], pairs[:, 1], 500, row_chunk=64)
    for ch in (g.chunks, g.t_chunks):
        order = ch.order.numpy()
        assert ch.order.dtype == torch.int32
        np.testing.assert_array_equal(np.sort(order), np.arange(ch.n_chunks))
        lens = np.diff(ch.ptr.numpy())[order]
        assert (np.diff(lens) <= 0).all()
        for length in np.unique(lens):
            assert (np.diff(order[lens == length]) > 0).all()


def test_force_slice_refusals():
    """force_slice takes only the kernels' widths, and never on a graph with
    a hub (the hub kernels keep the 1 KB slice); on the CPU a forced width
    gives the plain version's result."""
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 90, 600), rng.integers(0, 90, 600)
    g = build_graph(src, dst, 90)
    x = torch.rand(g.n_nodes, 24)
    for bad in (0, 16, 48, 2048):
        with pytest.raises(ValueError, match="K-slice width"):
            sk.spmm_max_fwd(g, x, force_slice=bad)
    out, arg = sk.spmm_max_fwd(g, x, force_slice=64)
    out_p, arg_p = sk.spmm_max_fwd_plain(g, x)
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
    with pytest.raises(ValueError, match="K-slice width"):
        sk.spmm_max_bwd(g, x, arg, force_slice=100)
    assert torch.equal(sk.spmm_max_bwd(g, x, arg, force_slice=32),
                       sk.spmm_max_bwd_plain(g, x, arg))
    gh = g.with_hub(8, 8)
    _, arg_h = sk.spmm_max_fwd(gh, x)
    with pytest.raises(ValueError, match="hub"):
        sk.spmm_max_fwd(gh, x, force_slice=512)
    with pytest.raises(ValueError, match="hub"):
        sk.spmm_max_bwd(gh, x, arg_h, force_slice=512)
