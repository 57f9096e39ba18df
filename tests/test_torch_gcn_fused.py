"""GCN's scaled sum (``spmm_kernels.spmm_sum_gcn``): GraphConv's norm='both'
propagation and bias in one pass of the sum kernel, against the composition
of separate passes that it replaces (x scaled by out-degree^-1/2, the
segment sum, the result scaled by in-degree^-1/2, plus the bias).

The scaled sum makes the composition's multiplies and adds, rounded in the
same places, so every comparison here is ``torch.equal``: on the CPU the
plain versions, on a card (tests marked ``cuda``, skipped without one) the
kernel against the composition of the card's own passes.  Card tests run
with

    python -m pytest tests/test_torch_gcn_fused.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from plagnn_tpu_torch.ops import spmm
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import ROW_CHUNK, build_graph


def _graph(seed=0, n=300, row_chunk=ROW_CHUNK, isolated=20):
    """Random edges plus every real node -> 0 (row 0 splits at a small
    ``row_chunk``), rows n-30..n with no in-edges and ``isolated`` nodes
    with no edge at all, besides the padding rows."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 2000), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n - 30, 2000), np.zeros(n, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    return build_graph(pairs[:, 0], pairs[:, 1], n + isolated, row_chunk=row_chunk)


def _scales(graph, dtype, shape):
    """(out-degree^-1/2, in-degree^-1/2) as the composition computes them,
    shaped to scale rows of ``shape``."""
    view = (-1,) + (1,) * (len(shape) - 1)
    return tuple(torch.rsqrt(d.clamp(min=1).to(dtype)).reshape(view)
                 for d in (graph.out_degree, graph.in_degree))


def _composed(graph, x, bias=None):
    """norm='both' as separate passes around ``spmm_sum``, plus the bias."""
    a, b = _scales(graph, x.dtype, x.shape)
    s = spmm.spmm_sum(graph, x * a) * b
    return s if bias is None else s + bias


def _composed_rows(graph, x, bias=None, transpose=False):
    a, b = _scales(graph, x.dtype, x.shape)
    if transpose:
        a, b = b, a
    s = sk.spmm_sum_rows(graph, x * a, transpose) * b
    return s if bias is None else s + bias


def _inputs(graph, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((graph.n_nodes, *shape), generator=gen).to(dtype)
    bias = torch.randn(shape, generator=gen).to(dtype)
    w = torch.randn((graph.n_nodes, *shape), generator=gen).to(dtype)
    return x, bias, w


def _grads(fn, graph, x, bias, w):
    """(out, dx, dbias) of ``fn(graph, x, bias)`` under the loss sum(out * w)."""
    x = x.clone().requires_grad_()
    bias = None if bias is None else bias.clone().requires_grad_()
    out = fn(graph, x, bias)
    (out * w).sum().backward()
    return out.detach(), x.grad, None if bias is None else bias.grad


# ---------------------------------------------------------------------------
# CPU: the plain version and the routing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("row_chunk", [8, ROW_CHUNK])
@pytest.mark.parametrize("k", [39, 120])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_rows_plain_match_composition(dtype, k, row_chunk, transpose):
    """The plain scaled sum equals the composition's passes over
    ``spmm_sum_rows``: K not a multiple of 4 (39), rows with no edges,
    degree-0 nodes (clamped at 1), split rows at row_chunk 8; the bias only
    forward, as the VJP takes none."""
    g = _graph(k, row_chunk=row_chunk)
    assert g.chunks.n_split > 0 or row_chunk == ROW_CHUNK
    assert int((g.in_degree == 0).sum()) > 0 and int((g.out_degree == 0).sum()) > 0
    x, bias, _ = _inputs(g, (k,), dtype, seed=k + row_chunk)
    b = None if transpose else bias
    got = sk.spmm_sum_gcn_rows(g, x, None if b is None else b.float(), transpose)
    assert got.dtype == dtype
    assert torch.equal(got, _composed_rows(g, x, b, transpose))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(39,), (3, 13)], ids=["2d", "folds"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gcn_propagate_matches_composition(dtype, shape, with_bias):
    """gcn_propagate(norm='both', bias=...) and its gradients with respect
    to x and the bias equal the composition's, bit for bit, on a graph
    with split rows; (N, B, F) rows take a (B, F) bias, as
    BatchedGraphConv's."""
    g = _graph(1, row_chunk=8)
    x, bias, w = _inputs(g, shape, dtype, seed=2)
    b = bias if with_bias else None
    got = _grads(lambda gr, v, c: spmm.gcn_propagate(gr, v, bias=c), g, x, b, w)
    want = _grads(_composed, g, x, b, w)
    for a, c in zip(got, want):
        assert (a is None and c is None) or torch.equal(a, c)


@pytest.mark.parametrize("norm,hub", [
    ("both", (0, 0)), ("both", (8, 8)), ("both", (8, 0)), ("both", (0, 8)),
    ("left", (0, 0)), ("right", (0, 0)), ("none", (0, 0))])
def test_scaled_route(monkeypatch, norm, hub):
    """norm='both' on a graph without a hub table takes the scaled sum; a
    hub table in either direction, and the other norms, take the passes
    around spmm_sum.  Every route gives the composition's bits."""
    calls = []
    scaled = spmm.spmm_sum_gcn
    monkeypatch.setattr(spmm, "spmm_sum_gcn",
                        lambda *a, **kw: calls.append(1) or scaled(*a, **kw))
    g0 = _graph(2)
    g = g0.with_hub(*hub) if any(hub) else g0
    x, bias, w = _inputs(g, (3, 13), torch.float32, seed=3)
    got = _grads(lambda gr, v, c: spmm.gcn_propagate(gr, v, norm, bias=c), g, x, bias, w)
    assert len(calls) == (norm == "both" and not any(hub))
    if norm == "both":
        want = _grads(_composed, g0, x, bias, w)
        for a, c in zip(got, want):
            assert torch.equal(a, c)


def test_gcn_scales_cached_on_the_graph():
    """The scales are the composition's values, computed once per graph and
    dtype; a copy of the graph starts without them."""
    g = _graph(3)
    for dt in (torch.float32, torch.bfloat16):
        pre, post = sk.gcn_scales(g, dt)
        a, b = _scales(g, dt, (1,))
        assert pre.dtype == post.dtype == torch.float32
        assert torch.equal(pre, a.reshape(-1).float())
        assert torch.equal(post, b.reshape(-1).float())
        assert sk.gcn_scales(g, dt)[0] is pre
    assert set(g.norm_scales) == {torch.float32, torch.bfloat16}
    assert g.to("cpu").norm_scales == {} and g.with_hub(0, 0).norm_scales == {}


def test_bias_refused():
    g = _graph(4)
    x = torch.randn(g.n_nodes, 3, 13)
    for norm in ("both", "none"):
        for bad in (torch.randn(13), torch.randn(3, 13, dtype=torch.float64)):
            with pytest.raises(ValueError):
                spmm.gcn_propagate(g, x, norm, bias=bad)
    x2 = x.reshape(g.n_nodes, -1)
    for bad in (torch.randn(38), torch.randn(39, dtype=torch.float64), torch.randn(39, 2)[:, 0]):
        with pytest.raises(ValueError):
            sk.spmm_sum_gcn_rows(g, x2, bad)


@pytest.mark.parametrize("model", ["batched_gcn2", "graph_conv"])
def test_models_match_the_hub_composition(model):
    """BatchedGCN2 (both convs W first, the bias in the store) and the
    single-fold GraphConv give the same output and parameter gradients on a
    graph as on its hub copy, which takes the composition."""
    from plagnn_tpu_torch.models.batched import BatchedGCN2
    from plagnn_tpu_torch.models.layers import GraphConv

    g = _graph(5, row_chunk=8)
    gen = torch.Generator().manual_seed(6)
    if model == "batched_gcn2":
        m = BatchedGCN2(3, 20, 16, num_classes=5)
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.3
        x = torch.randn(g.n_nodes, 20, generator=gen)
    else:
        m = GraphConv(20, 7, generator=gen)
        m.bias.data = torch.randn(7, generator=gen)
        x = torch.randn(g.n_nodes, 20, generator=gen)
    results = []
    for graph in (g, g.with_hub(8, 8)):
        m.zero_grad()
        out = m(graph, x)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        results.append([out.detach()] + [p.grad.clone() for p in m.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# On the card: the kernel against the card's composition, bit for bit.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


_GRAPHS = {}


def _card_graph(name):
    """GCN2's graphs: the 24k-node PPI-scale graph of chip_smoke.py and a
    330,000-node power-law graph (split rows in both), with self-loops."""
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    if name not in _GRAPHS:
        nodes, edges = {"24k": (24041, 700000), "330k": (330000, 3_000_000)}[name]
        _GRAPHS[name] = from_scipy_coo(powerlaw_ppi(nodes, edges, 70),
                                       add_self_loops=True).to("cuda")
    return _GRAPHS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype", [
    ("24k", (10, 400), torch.float32), ("24k", (10, 12), torch.float32),
    ("24k", (10, 400), torch.bfloat16), ("330k", (8, 32), torch.float32)],
    ids=["24k-k4000", "24k-k120", "24k-k4000-bf16", "330k-k256"])
def test_card_scaled_sum_bit_identical(card, name, shape, dtype):
    """At GCN2's shapes (24k nodes, K = 10 x 400 and 10 x 12; one 1 KB
    K-slice of a 330k-node graph), the scaled kernel's output and the
    gradients of x and the bias equal the composition of the card's passes
    (which launch the unscaled sum) bit for bit; one forward and one
    transpose launch of the scaled sum."""
    g = _card_graph(name)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    gen = torch.Generator(device=card).manual_seed(11)
    x = torch.randn((g.n_nodes, *shape), generator=gen, device=card).to(dtype)
    bias = torch.randn(shape, generator=gen, device=card).to(dtype)
    w = torch.randn((g.n_nodes, *shape), generator=gen, device=card).to(dtype)
    tag = "f32" if dtype == torch.float32 else "bf16"
    before = dict(sk.LAUNCHES)
    got = _grads(lambda gr, v, c: spmm.gcn_propagate(gr, v, bias=c), g, x, bias, w)
    torch.cuda.synchronize()
    for name_ in (f"spmm_sum_gcn_fwd_{tag}", f"spmm_sum_gcn_bwd_{tag}"):
        assert sk.LAUNCHES[name_] == before[name_] + 1
    for name_ in (f"spmm_sum_fwd_{tag}", f"spmm_sum_bwd_{tag}"):
        assert sk.LAUNCHES[name_] == before[name_]
    want = _grads(_composed, g, x, bias, w)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_card_gcn2_epoch_runs_only_the_scaled_sum(card, tmp_path):
    """One GCN2 training epoch through ``train()``: 2 scaled sums forward
    and 2 backward (conv1 and conv2), and no unscaled sum."""
    from plagnn_tpu_torch import cli
    from plagnn_tpu_torch.data.artifacts import load_condition
    from plagnn_tpu_torch.train.engine import TrainConfig, train

    root = str(tmp_path)
    cli.main(["synth", "--data-root", root, "--nodes", "512", "--edges", "4000"])
    b = load_condition(root, "GSE30931", "normal")
    sk.reset_launches()
    train(b.graph, b.feats, b.labels, b.label_with_loc, b.loc_mat,
          TrainConfig(model="gcn2", epoch_num=1, fold_num=3, fold_batch=3, fold_seeds=(1,)),
          str(tmp_path / "log") + "/", device_name="cuda")
    torch.cuda.synchronize()
    assert sk.LAUNCHES["spmm_sum_gcn_fwd_f32"] == sk.LAUNCHES["spmm_sum_gcn_bwd_f32"] == 2
    assert sk.LAUNCHES["spmm_sum_fwd_f32"] == sk.LAUNCHES["spmm_sum_bwd_f32"] == 0
