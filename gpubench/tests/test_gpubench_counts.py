"""The FLOP and byte counts against shapes worked out by hand."""
import torch

from gpubench import counts
from gpubench.harness import load_cell


def test_dense_flops_by_hand():
    gnn = load_cell("gnn32_ppi24k").config
    # per node and fold, multiply-adds: conv1 pool 503^2 and self 503*400
    # (input = features: weight gradient only), neigh 503*400; conv2/conv3
    # 3 x (in^2 + 2 in out); liner1 200*100; liner2 100*12; all else x 3
    macs = (2 * (503 * 503 + 503 * 400) + 3 * 503 * 400
            + 3 * (400 * 400 + 2 * 400 * 300) + 3 * (300 * 300 + 2 * 300 * 200)
            + 3 * 200 * 100 + 3 * 100 * 12)
    assert macs == 3405618
    assert counts.dense_flops_per_epoch(gnn, 24041, 10) == 2 * 24041 * 10 * macs
    assert abs(counts.dense_flops_per_epoch(gnn, 24041, 10) - 1.637e12) < 1e9
    gcn = load_cell("gcn2_ppi24k").config
    assert counts.dense_flops_per_epoch(gcn, 24041, 10) == 2 * 24041 * 10 * (
        2 * 503 * 400 + 3 * 400 * 12)


def test_graph_shape_and_aggregation_bytes_by_hand():
    # 3 nodes, edges 0->1, 1->0, 2->0, self-loops: in-degrees 3, 2, 1
    dst = torch.tensor([1, 0, 0])
    g = counts.graph_shape(3, dst, self_loops=True)
    assert (g.n_pad, g.edges, g.positional, g.n_mega, g.arg_bytes) == (128, 6, False, 0, 2)
    idx = 4 * (128 + 1 + 6)
    assert counts.max_fwd_bytes(g, 10, 4) == 128 * 10 * 4 + idx + 128 * 10 * 6
    assert counts.max_bwd_bytes(g, 10, 4) == 128 * 10 * 6 + idx + 128 * 10 * 4
    assert counts.sum_bytes(g, 10, 4) == 2 * 128 * 10 * 4 + idx
    gnn = load_cell("gnn32_ppi24k").config
    want = sum(counts.max_fwd_bytes(g, 2 * k, 4) + counts.max_bwd_bytes(g, 2 * k, 4)
               for k in (503, 400, 300))
    assert counts.aggregation_bytes_per_epoch(gnn, g, 2) == want
    gcn = load_cell("gcn2_ppi24k").config
    assert counts.aggregation_bytes_per_epoch(gcn, g, 2) == 2 * (
        counts.sum_bytes(g, 800, 4) + counts.sum_bytes(g, 24, 4))


def test_the_24k_layer1_forward_bound_of_the_kernel_table():
    # PERF.md's kernel table, row 1: 0.362 ms at 3.35 TB/s (N_pad 24,064,
    # 724,041 edges, K = 10 x 503, int16 argmax)
    g = counts.GraphShape(n=24041, n_pad=24064, edges=724041, positional=False, n_mega=0)
    ms = counts.max_fwd_bytes(g, 5030, 4) / 3.35e12 * 1e3
    assert abs(ms - 0.362) < 0.0005


def test_positional_bytes_add_the_rank_tables():
    g = counts.GraphShape(n=40000, n_pad=40064, edges=10**6, positional=True, n_mega=3)
    plain = counts.GraphShape(n=40000, n_pad=40064, edges=10**6, positional=False, n_mega=0)
    k = 100
    assert g.arg_bytes == 2 and plain.arg_bytes == 4
    side = 3 * k * 2
    assert counts.max_fwd_bytes(g, k, 4) == (counts.max_fwd_bytes(plain, k, 4)
                                             - 40064 * k * 2 + 4 * 40064 + side)
    assert counts.max_bwd_bytes(g, k, 4) == (counts.max_bwd_bytes(plain, k, 4)
                                             - 40064 * k * 2 + side + 4 * 10**6 + 4 * 40064)
    # a mega row: more than RANK_CAP in-edges (self-loop included)
    dst = torch.zeros(counts.RANK_CAP, dtype=torch.int64)
    assert counts.graph_shape(40000, dst, self_loops=True).n_mega == 1
    assert counts.graph_shape(40000, dst[1:], self_loops=True).n_mega == 0
