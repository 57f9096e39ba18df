"""Layer kinds as files (``kinds/<kind>.py``): the three kinds the first
cells use give the numbers they gave before they were files, and a kind in a
new file is found by the inputs, the reference and the counts with no other
edit.  Also the fold masks past one round and the bfloat16 configuration."""

import pytest
import torch
import torch.nn.functional as F

from gpubench import counts
from gpubench.harness import load_cell
from gpubench.inputs import fold_masks, make_inputs, param_laws, stream
from gpubench.program import Program
from gpubench.reference import model
from gpubench.reference.model import PlainGraph, first_max, forward, gcn_both, train_steps
from gpubench.tests.tiny import tiny_cell

G24 = counts.GraphShape(n=24041, n_pad=24064, edges=724041, positional=False, n_mega=0)
G330 = counts.GraphShape(n=330000, n_pad=330112, edges=10330000, positional=True, n_mega=7)

# What the harness counted before the kinds were files: (name, shape, bound)
# of every leaf in draw order, the matmuls, the FLOPs of (24,041 nodes, 10
# folds) and (330,000, 8), and the float32 bytes on G24 at 10 folds and on
# G330 at 8.
PINNED = {
    "gnn32_f32": {
        "laws": [
            ("conv1.w_self", (503, 400), 0.115278083540847),
            ("conv1.w_neigh", (503, 400), 0.115278083540847),
            ("conv1.bias", (400,), 0.0),
            ("conv1.w_pool", (503, 503), 0.10921734946179222),
            ("conv1.b_pool", (503,), 0.04458779620677098),
            ("conv2.w_self", (400, 300), 0.13093073414159542),
            ("conv2.w_neigh", (400, 300), 0.13093073414159542),
            ("conv2.bias", (300,), 0.0),
            ("conv2.w_pool", (400, 400), 0.12247448713915891),
            ("conv2.b_pool", (400,), 0.05),
            ("conv3.w_self", (300, 200), 0.1549193338482967),
            ("conv3.w_neigh", (300, 200), 0.1549193338482967),
            ("conv3.bias", (200,), 0.0),
            ("conv3.w_pool", (300, 300), 0.14142135623730953),
            ("conv3.b_pool", (300,), 0.05773502691896257),
            ("liner1.weight", (200, 100), 0.07071067811865475),
            ("liner1.bias", (100,), 0.07071067811865475),
            ("liner2.weight", (100, 12), 0.1),
            ("liner2.bias", (12,), 0.1)],
        "matmuls": [(253009, False), (201200, False), (201200, True), (160000, True),
                    (120000, True), (120000, True), (90000, True), (60000, True),
                    (60000, True), (20000, True), (1200, True)],
        "flops": (1637489246760.0, 17981663040000.0),
        "bytes": (5807752944, 63927952632),
    },
    "gcn2_f32": {
        "laws": [
            ("conv1.weight", (503, 400), 0.08151391459392224),
            ("conv1.bias", (400,), 0.0),
            ("conv2.weight", (400, 12), 0.12067769800636945),
            ("conv2.bias", (12,), 0.0)],
        "matmuls": [(201200, False), (4800, True)],
        "flops": (200405776000.0, 2200704000000.0),
        "bytes": (1598268576, 17579348240),
    },
}
CELL_OF = {"gnn32_f32": "gnn32_ppi24k", "gcn2_f32": "gcn2_ppi24k"}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_moved_kinds_give_the_pinned_numbers(config):
    cfg, want = load_cell(CELL_OF[config]).config, PINNED[config]
    assert param_laws(cfg) == want["laws"]
    assert counts._matmuls(cfg) == want["matmuls"]
    assert (counts.dense_flops_per_epoch(cfg, 24041, 10),
            counts.dense_flops_per_epoch(cfg, 330000, 8)) == want["flops"]
    assert (counts.aggregation_bytes_per_epoch(cfg, G24, 10),
            counts.aggregation_bytes_per_epoch(cfg, G330, 8)) == want["bytes"]


def test_the_bf16_configuration_counts_its_max_bytes_at_two():
    cfg = load_cell("gnn32bf16_ppi24k_b32").config
    assert model.agg_dtype(cfg) == torch.bfloat16
    assert counts._matmuls(cfg) == PINNED["gnn32_f32"]["matmuls"]
    want = sum(counts.max_fwd_bytes(G24, 32 * k, 2) + counts.max_bwd_bytes(G24, 32 * k, 2)
               for k in (503, 400, 300))
    assert counts.aggregation_bytes_per_epoch(cfg, G24, 32, 2) == want
    # GraphConv's sums stay float32 whatever the element size asked
    gcn = load_cell("gcn2_ppi24k").config
    assert (counts.aggregation_bytes_per_epoch(gcn, G24, 10, 2)
            == PINNED["gcn2_f32"]["bytes"][0])


def _parent_forward(config, graph, x, p):
    """The reference's forward as it was before the kinds were files."""
    h = x
    for layer in config["layers"]:
        name, kind = layer["name"], layer["kind"]
        if kind == "sage_pool":
            pooled = torch.relu(h @ p[f"{name}.w_pool"] + p[f"{name}.b_pool"])
            m = first_max(graph, pooled)
            h = h @ p[f"{name}.w_self"] + m @ p[f"{name}.w_neigh"] + p[f"{name}.bias"]
        elif kind == "graph_conv":
            w = p[f"{name}.weight"]
            h = gcn_both(graph, h @ w) if w.shape[0] > w.shape[1] else gcn_both(graph, h) @ w
            h = h + p[f"{name}.bias"]
        else:
            h = h @ p[f"{name}.weight"] + p[f"{name}.bias"]
        act = layer["act"]
        if act == "leaky_relu":
            h = F.leaky_relu(h, config.get("leaky_slope", 0.01))
        elif act == "relu":
            h = torch.relu(h)
        else:
            h = torch.sigmoid(h)
    return h


@pytest.mark.parametrize("cell", ["gnn32_ppi24k", "gcn2_ppi24k"])
def test_reference_forward_is_the_parents_on_tiny_sizes(cell):
    c = tiny_cell(cell)
    inp = make_inputs(c.config, c.traffic, 2**31 + 3, "cpu")
    n = inp.n
    graph = PlainGraph.build(inp.src, inp.dst, n, True)
    for fold in range(c.traffic["fold_batch"]):
        outs, grads = [], []
        for fn in (forward, _parent_forward):
            p = {k: v[fold].clone().requires_grad_(True) for k, v in inp.weights.items()}
            out = fn(c.config, graph, inp.feats[:n], p)
            out.pow(2).sum().backward()
            outs.append(out.detach())
            grads.append({k: v.grad for k, v in p.items()})
        assert torch.equal(outs[0], outs[1])
        assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


TOY_KIND = '''"""A toy kind: out = gcn_both(h W) * scale, one (in, out) weight and a
per-column scale; a float32 sum and its VJP at K = folds x out."""
from gpubench.counts import sum_bytes
from gpubench.reference.model import gcn_both


def leaves(layer):
    i, o = layer["in"], layer["out"]
    return [("weight", (i, o), 0.5), ("scale", (o,), 0.25)]


def forward(layer, config, graph, h, p):
    return gcn_both(graph, h @ p["weight"]) * p["scale"]


def matmuls(layer, first):
    return [(layer["in"] * layer["out"], not first)]


def aggregation_bytes(layer, g, folds, esize):
    return 2 * sum_bytes(g, folds * layer["out"], esize)
'''


def test_a_toy_kind_in_a_new_file_needs_no_edit(tmp_path, monkeypatch):
    (tmp_path / "toy_scaled_conv.py").write_text(TOY_KIND)
    monkeypatch.setattr(model, "KIND_DIRS", [*model.KIND_DIRS, tmp_path])
    c = tiny_cell("gcn2_ppi24k")
    cfg = dict(c.config, layers=[
        {"name": "conv1", "kind": "graph_conv", "in": 503, "out": 16, "act": "relu"},
        {"name": "toy", "kind": "toy_scaled_conv", "in": 16, "out": 12, "act": "leaky_relu"},
        {"name": "out", "kind": "linear", "in": 12, "out": 12, "act": "sigmoid"}])
    laws = param_laws(cfg)
    assert [(k, s, b) for k, s, b in laws if k.startswith("toy.")] == [
        ("toy.weight", (16, 12), 0.5), ("toy.scale", (12,), 0.25)]
    inp = make_inputs(cfg, c.traffic, 11, "cpu")
    folds = c.traffic["fold_batch"]
    assert inp.weights["toy.scale"].shape == (folds, 12)
    assert float(inp.weights["toy.scale"].abs().max()) <= 0.25
    # the reference runs it: a step moves its leaves
    n = inp.n
    graph = PlainGraph.build(inp.src, inp.dst, n, True)
    steps = train_steps(cfg, graph, inp.feats[:n], inp.labels[:n], inp.train_masks[:, :n],
                        inp.weights, 1)
    assert steps.probs[0].shape == (folds, n, 12)
    assert float(steps.grad1["toy.scale"].abs().max()) > 0
    # the counts add its matmul and its sums
    assert counts._matmuls(cfg) == [(503 * 16, False), (16 * 12, True), (12 * 12, True)]
    g = counts.graph_shape(n, inp.dst, True)
    assert counts.aggregation_bytes_per_epoch(cfg, g, folds) == (
        2 * counts.sum_bytes(g, folds * 16, 4) + 2 * counts.sum_bytes(g, folds * 12, 4))


def test_an_unknown_kind_or_activation_is_refused():
    c = tiny_cell("gcn2_ppi24k")
    bad_kind = dict(c.config, layers=[dict(c.config["layers"][0], kind="no_such_kind")])
    with pytest.raises(ValueError, match="no_such_kind"):
        param_laws(bad_kind)
    bad_act = dict(c.config, layers=[dict(c.config["layers"][0], act="swish")])
    inp = make_inputs(c.config, c.traffic, 5, "cpu")
    graph = PlainGraph.build(inp.src, inp.dst, inp.n, True)
    p = {k: v[0] for k, v in inp.weights.items()}
    with pytest.raises(ValueError, match="swish"):
        forward(bad_act, graph, inp.feats[:inp.n], p)


def _parent_fold_masks(label_idx, n_pad, fold_num, fold_batch, gen):
    """fold_masks as it was before fold batches past one round."""
    n_lab = label_idx.numel()
    order = label_idx[torch.randperm(n_lab, generator=gen)]
    sizes = [n_lab // fold_num + (f < n_lab % fold_num) for f in range(fold_num)]
    train = torch.zeros((fold_batch, n_pad), dtype=torch.bool)
    val = torch.zeros_like(train)
    start = 0
    for f in range(fold_batch):
        train[f, label_idx] = True
        va = order[start:start + sizes[f]]
        train[f, va] = False
        val[f, va] = True
        start += sizes[f]
    return train, val


def _labelled(n=2003, n_pad=2048):
    return torch.nonzero(torch.rand(n, generator=torch.Generator().manual_seed(1)) < 0.6
                         ).squeeze(1), n_pad


@pytest.mark.parametrize("fold_batch", [1, 3, 8, 10])
def test_fold_masks_within_one_round_are_the_parents(fold_batch):
    idx, n_pad = _labelled()
    new_gen, old_gen = stream(2**31 + 7, "folds", "cpu"), stream(2**31 + 7, "folds", "cpu")
    new = fold_masks(idx, n_pad, 10, fold_batch, new_gen)
    old = _parent_fold_masks(idx, n_pad, 10, fold_batch, old_gen)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    assert torch.equal(new_gen.get_state(), old_gen.get_state())     # the same draws


def test_fold_masks_past_one_round_partition_each_round():
    idx, n_pad = _labelled()
    train, val = fold_masks(idx, n_pad, 10, 32, stream(9, "folds", "cpu"))
    lab = torch.zeros(n_pad, dtype=torch.bool)
    lab[idx] = True
    assert torch.equal(train | val, lab.expand(32, -1)) and not (train & val).any()
    for r in range(3):                       # rounds 0-2 whole, round 3 folds 30 and 31
        rnd = val[10 * r:10 * r + 10]
        assert torch.equal(rnd.sum(0), lab.long())
        sizes = sorted(int(v.sum()) for v in rnd)
        assert sizes[-1] - sizes[0] <= 1
    assert not (val[30] & val[31]).any()
    assert int(val[30].sum()) == int(val[0].sum())
    # each round a split of its own; round 0 is the one-round split
    assert not torch.equal(val[0], val[10]) and not torch.equal(val[10], val[20])
    first, _ = fold_masks(idx, n_pad, 10, 10, stream(9, "folds", "cpu"))
    assert torch.equal(first, train[:10])


@pytest.fixture
def agg_dtype_restored():
    from plagnn_tpu_torch.utils import precision

    before = precision.aggregation_dtype()
    yield precision
    precision.set_aggregation_dtype(before)


def test_each_program_sets_its_configurations_aggregation_dtype(agg_dtype_restored):
    precision = agg_dtype_restored
    for cell, want in (("gnn32bf16_ppi24k_b32", torch.bfloat16), ("gnn32_ppi24k", None),
                       ("gnn32bf16_ppi24k_b32", torch.bfloat16)):
        c = tiny_cell(cell)
        inp = make_inputs(c.config, c.traffic, 3, "cpu")
        program = Program(c.config, c.traffic, inp, "cpu")
        assert precision.aggregation_dtype() == want
        program.epochs(1)
        assert precision.aggregation_dtype() == want
        assert program.message_dtype() == str(want or torch.float32).removeprefix("torch.")


def test_the_bf16_reference_max_is_the_ports_plain_path(agg_dtype_restored):
    from plagnn_tpu_torch.models.layers import aggregate_max
    from plagnn_tpu_torch.ops.graph_format import build_graph

    precision = agg_dtype_restored
    precision.set_aggregation_dtype("bfloat16")
    gen = torch.Generator().manual_seed(5)
    n, k = 300, 24
    src = torch.randint(0, n, (3000,), generator=gen)
    dst = torch.randint(0, n, (3000,), generator=gen)
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    src, dst = key // n, key % n
    port = build_graph(src.numpy(), dst.numpy(), n, add_self_loops=True)
    ref = PlainGraph.build(src, dst, n, True)
    # relu'd values a little apart from bfloat16's rounding, and exact ties
    x = torch.relu(torch.randn((n, k), generator=gen))
    x[::7] = x[::7].bfloat16().float()
    g = torch.randn((n, k), generator=gen)
    x_r = x.clone().requires_grad_(True)
    out_r = first_max(ref, x_r, torch.bfloat16)
    (out_r * g).sum().backward()
    x_p = torch.zeros((port.n_nodes, k))
    x_p[:n] = x
    x_p.requires_grad_(True)
    out_p = aggregate_max(port, x_p)
    g_p = torch.zeros_like(out_p)
    g_p[:n] = g
    (out_p * g_p).sum().backward()
    assert out_p.dtype == torch.float32
    assert torch.equal(out_p[:n].detach(), out_r.detach())
    assert torch.equal(x_p.grad[:n], x_r.grad)
    assert torch.equal(x_r.grad, x_r.grad.bfloat16().float())       # rounded once
    # the float32 max of the same messages differs: the rounding is there
    assert not torch.equal(first_max(ref, x), out_r.detach())
