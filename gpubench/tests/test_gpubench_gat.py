"""The GAT configuration (``configs/gat_ppi_f32.json``, ``kinds/gat_conv.py``)
against the port, on the CPU at tiny sizes: the kind's plain forward equals
the port's GAT layers (their plain path) on the same leaves, its leaves are
the port's parameters, the configuration's heads and widths are what the
port builds from the keys ``program.py`` passes, its slope-1.0 activation is
the identity, its counts are pinned; and the three configurations that came
before it give the inputs, reference steps and counts they gave."""
import hashlib
import json
import math

import pytest
import torch
import torch.nn.functional as F

from gpubench import counts
from gpubench.harness import load_cell
from gpubench.inputs import make_inputs, param_laws
from gpubench.reference.model import PlainGraph, load_kind, train_steps
from gpubench.tests.tiny import tiny_cell
from plagnn_tpu_torch.models.batched import BatchedGATConv
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.train import engine

CELL = "gat_ppi24k_b32"
KIND = load_kind("gat_conv")


def _train_config(config, traffic):
    """The TrainConfig ``program.Program`` builds (the same keys)."""
    return engine.TrainConfig(
        lr=config["lr"], fold_num=config["fold_num"], epoch_num=config["epoch_num"],
        alpha_list=(config["alpha"],), fold_batch=traffic["fold_batch"],
        model=config["model"], hidden=tuple(config["hidden"]),
        num_classes=config["num_classes"], compute_auc=True,
        auc_every=traffic["auc_every"], verbose=False, hub_cache=config["hub_cache"])


def test_heads_and_widths_are_the_ports():
    c = load_cell(CELL)
    cfg = _train_config(c.config, c.traffic)
    layers = c.config["layers"]
    model = engine.init_fold_model(cfg, c.config["in_feats"], [0], "cpu")
    assert model.heads == tuple(c.config["heads"]) == tuple(l["heads"] for l in layers) \
        == (4, 4, 6)
    assert cfg.hidden == tuple(l["out"] for l in layers[:-1]) == (256, 256)
    assert layers[-1]["out"] == cfg.num_classes == 12
    assert [l["in"] for l in layers] == [503, 1024, 1024]
    assert [l["residual"] for l in layers] == ["none", "identity", "linear"]
    assert [l["merge"] for l in layers] == ["concat", "concat", "mean"]
    assert [l["elu"] for l in layers] == [True, True, False]


def test_leaves_are_the_ports_parameters():
    """Names and one fold's shapes of every leaf equal the port's model's
    (init_fold_model, as program.py builds it), and its init bounds are
    DGL's Xavier variance as uniform bounds."""
    c = load_cell(CELL)
    model = engine.init_fold_model(_train_config(c.config, c.traffic), c.config["in_feats"],
                                   [0, 1], "cpu")
    port = {k: tuple(v.shape[1:]) for k, v in model.named_parameters()}
    laws = param_laws(c.config)
    assert {k: s for k, s, _ in laws} == port
    bounds = {k: b for k, _, b in laws}
    gain = math.sqrt(2.0)
    assert bounds["conv1.fc"] == gain * math.sqrt(6 / (503 + 1024))
    assert bounds["conv3.attn_l"] == gain * math.sqrt(6 / (72 + 12))
    assert bounds["conv3.res_fc"] == gain * math.sqrt(6 / (1024 + 72))
    assert bounds["conv2.bias"] == 0.0


def _graphs(n=40, seed=3):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (6 * n,), generator=gen)
    dst = torch.randint(0, n, (6 * n,), generator=gen)
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    src, dst = key // n, key % n
    return (build_graph(src.numpy(), dst.numpy(), n, add_self_loops=True, row_chunk=8),
            PlainGraph.build(src, dst, n, True), n)


LAYERS = [
    {"name": "a", "kind": "gat_conv", "in": 7, "out": 5, "heads": 3, "residual": "none",
     "merge": "concat", "elu": True, "act": "leaky_relu"},
    {"name": "b", "kind": "gat_conv", "in": 15, "out": 5, "heads": 3, "residual": "identity",
     "merge": "concat", "elu": True, "act": "leaky_relu"},
    {"name": "c", "kind": "gat_conv", "in": 15, "out": 4, "heads": 2, "residual": "linear",
     "merge": "mean", "elu": False, "act": "sigmoid"},
]


@pytest.mark.parametrize("layer", LAYERS, ids=[l["residual"] for l in LAYERS])
def test_kind_forward_is_the_ports(layer):
    """The kind's forward (ELU and the merge inside) and its gradients equal
    the port's BatchedGATConv (one fold; the mean taken as BatchedGAT takes
    it) on the same leaves, float32: sums in another order."""
    port_g, ref_g, n = _graphs()
    gen = torch.Generator().manual_seed(4)
    leaves = {k: (torch.rand(s, generator=gen) * 2 - 1) * (b or 0.3)
              for k, s, b in KIND.leaves(layer)}
    x = torch.randn(n, layer["in"], generator=gen)
    conv = BatchedGATConv(1, layer["in"], layer["out"], layer["heads"],
                          residual=layer["residual"] != "none", elu=layer["elu"])
    assert conv.residual == layer["residual"]
    conv.load_state_dict({k: v[None] for k, v in leaves.items()})
    x_p = torch.zeros(port_g.n_nodes, layer["in"])
    x_p[:n] = x
    out_p = conv(port_g, x_p.requires_grad_())[:, 0]
    if layer["merge"] == "mean":
        out_p = out_p.view(port_g.n_nodes, layer["heads"], -1).mean(1)
    p = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    x_r = x.clone().requires_grad_()
    out_r = KIND.forward(layer, {}, ref_g, x_r, p)
    w = torch.randn(out_r.shape, generator=gen)
    (out_p[:n] * w).sum().backward()
    (out_r * w).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out_p[:n].detach(), out_r.detach(), **tol)
    torch.testing.assert_close(x_p.grad[:n], x_r.grad, **tol)
    for k, v in conv.named_parameters():
        torch.testing.assert_close(v.grad[0], p[k].grad, **tol, msg=k)


def test_slope_one_is_the_identity():
    """``act`` leaky_relu at the configuration's slope 1.0 returns its input
    and passes the gradient, bit for bit."""
    assert load_cell(CELL).config["leaky_slope"] == 1.0
    x = torch.randn(1000, dtype=torch.float32) * 10
    x[:3] = torch.tensor([0.0, -0.0, -1e-38])
    x.requires_grad_()
    y = F.leaky_relu(x, 1.0)
    g = torch.randn(1000)
    y.backward(g)
    assert torch.equal(y.detach(), x.detach()) and torch.equal(x.grad, g)


G_SMALL = counts.GraphShape(n=1000, n_pad=1024, edges=21000, positional=False, n_mega=0)


def test_counts_are_pinned():
    c = load_cell(CELL).config
    assert counts._matmuls(c) == [
        (503 * 1024, False), (1024, True), (1024, True),
        (1024 * 1024, True), (1024, True), (1024, True),
        (1024 * 72, True), (1024 * 72, True), (72, True), (72, True)]
    assert counts.dense_flops_per_epoch(c, 1000, 2) == 2.0 * 1000 * 2 * 4630960
    # fwd: wh read, out written (K = 2 x 4 x 256), el, er, lse (8 groups), index
    fwd = (2 * 1024 * 2048 + 3 * 1024 * 8) * 4 + 4 * (1025 + 21000)
    bwd = (3 * 1024 * 2048 + 5 * 1024 * 8) * 4 + 8 * (1025 + 21000) + 4 * 21000
    assert KIND.fwd_bytes(G_SMALL, 2048, 8) == fwd and KIND.bwd_bytes(G_SMALL, 2048, 8) == bwd
    k3, g3 = 2 * 72, 2 * 6
    want = 2 * (fwd + bwd) + KIND.fwd_bytes(G_SMALL, k3, g3) + KIND.bwd_bytes(G_SMALL, k3, g3)
    for esize in (4, 2):                         # float32 whatever the element size
        assert counts.aggregation_bytes_per_epoch(c, G_SMALL, 2, esize) == want


def test_a_tiny_run_reads_small_and_the_faults_do_not():
    """The harness's reference follows the port's first steps on the tiny
    cell; a half batch and a flipped answer are far off."""
    from gpubench.harness import reference_readings
    from gpubench.program import Program, plant

    c = tiny_cell(CELL)
    inp = make_inputs(c.config, c.traffic, 2**31 + 17, "cpu")
    program = Program(c.config, c.traffic, inp, "cpu")
    snaps = {}
    for name in (None, "half_batch", "answer"):
        with plant(name):
            program.reset_round()
            snaps[name or "sound"] = program.first_steps(c.traffic["check_steps"])
    r = reference_readings(c, 2**31 + 17, snaps, "cpu")
    assert max(r["sound"].values()) < 1e-5, r["sound"]
    assert r["half_batch"]["loss_gap"] > 1e-2 and r["answer"]["metrics_gap"] > 1e-2


# What the three configurations before GAT gave at this commit's parent, on
# their tiny cells at seed 2^31 + 21: a hash of the inputs, the reference's
# two steps (the last step's probabilities summed, its losses, the norms of
# the first gradient and of the last leaves; float64, one thread) and a hash
# of the counts (matmuls, FLOPs and float32 bytes at 24,041 nodes, 32 folds).
BEFORE = {
    "gnn32_ppi24k": ("f059b00c5445ab33", "c802d60d460393bb",
                     [5630.206101058051, [4.354182720184326, 3.0457346439361572,
                                          3.394164562225342],
                      40.33034487060729, 140.30538514670613]),
    "gcn2_ppi24k": ("3361c08199da3cc4", "af73cf62bde3daa1",
                    [5338.304898515344, [2.9882941246032715, 2.9284703731536865,
                                         2.940073013305664],
                     1.9422721262831024, 37.499329157085526]),
    "gnn32bf16_ppi24k_b32": ("f059b00c5445ab33", "c802d60d460393bb",
                             [5630.220826437697, [4.354921340942383, 3.0463383197784424,
                                                  3.3944671154022217],
                              40.33284626882103, 140.3053792391403]),
}
G24 = counts.GraphShape(n=24041, n_pad=24064, edges=724041, positional=False, n_mega=0)


def _inputs_hash(inp):
    h = hashlib.sha256()
    for t in (inp.src, inp.dst, inp.feats, inp.labels, inp.train_masks, inp.val_masks):
        h.update(t.contiguous().numpy().tobytes())
    for k in sorted(inp.weights):
        h.update(k.encode())
        h.update(inp.weights[k].contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_earlier_configurations_are_unchanged(cell, one_thread):
    inputs_h, counts_h, ref = BEFORE[cell]
    c = tiny_cell(cell)
    inp = make_inputs(c.config, c.traffic, 2**31 + 21, "cpu")
    assert _inputs_hash(inp) == inputs_h
    cnt = [counts._matmuls(c.config), counts.dense_flops_per_epoch(c.config, 24041, 32),
           counts.aggregation_bytes_per_epoch(c.config, G24, 32, 4)]
    assert hashlib.sha256(json.dumps(cnt).encode()).hexdigest()[:16] == counts_h
    n = inp.n
    st = train_steps(c.config, PlainGraph.build(inp.src, inp.dst, n, True), inp.feats[:n],
                     inp.labels[:n], inp.train_masks[:, :n], inp.weights, 2)
    got = [float(st.probs[-1].double().sum()), [float(x) for x in st.loss[-1]],
           float(sum(v.double().norm() ** 2 for v in st.grad1.values()) ** 0.5),
           float(sum(v.double().norm() ** 2 for v in st.theta.values()) ** 0.5)]
    # float32 sums on another CPU may round otherwise: a few ulp of each
    assert got[0] == pytest.approx(ref[0], rel=1e-6)
    assert got[1] == pytest.approx(ref[1], rel=1e-6)
    assert got[2:] == pytest.approx(ref[2:], rel=1e-6)
