"""The port's segment sum, the ops built on it, GraphConv, SAGE mean/sum and
GCN2 against the JAX package, on the same numpy inputs.

Tolerances: the sum against the Pallas kernel (interpret mode) atol 1e-4,
as tests/test_pallas_kernels.py holds that kernel to its numpy oracle; the
ops and layers rtol/atol 1e-5 (float32 sums of the same terms in another
order); bf16 sums exact on small-integer inputs (every float32 partial sum
is exact and both sides round once); the GCN2 runner as
tests/test_torch_train.py holds the GNN32 runner.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu.data import synthetic as jax_synth
from plagnn_tpu.models import gnn32 as jax_gnn32
from plagnn_tpu.models import layers as jax_layers
from plagnn_tpu.ops import build_graph as jax_build_graph
from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
from plagnn_tpu.ops import pad_features
from plagnn_tpu.ops import spmm as jax_spmm
from plagnn_tpu.ops.pallas.spmm_kernels import build_pallas_graph, pallas_spmm_sum
from plagnn_tpu.train import engine as jax_engine
from plagnn_tpu_torch.models.batched import BatchedGCN2
from plagnn_tpu_torch.models.convert import params_from_jax
from plagnn_tpu_torch.models.gnn32 import GCN2
from plagnn_tpu_torch.models.layers import GraphConv, SageConv
from plagnn_tpu_torch.ops import spmm
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo
from plagnn_tpu_torch.train import engine, kfold, losses

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph_edges(seed, n_real=200, e=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_real, e)
    dst = rng.integers(0, n_real, e)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sum_grad(graph, x_np, w_np, dtype=torch.float32):
    x = torch.tensor(x_np, requires_grad=True)
    y = spmm.spmm_sum(graph, x.to(dtype)).float()
    (y * torch.from_numpy(w_np)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def test_sum_matches_pallas_interpret():
    """The size tests/test_pallas_kernels.py uses: N_pad 256, B=2, F=512."""
    src, dst = _graph_edges(1)
    pg = build_pallas_graph(src, dst, 256, rows_per_block=128)
    g = build_graph(src, dst, 200)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, 2, 512)).astype(np.float32)
    w = rng.standard_normal((256, 2, 512)).astype(np.float32)

    def loss(xx):
        return jnp.sum(pallas_spmm_sum(pg, xx, interpret=True) * w)

    y_j, dx_j = jax.jit(lambda xx: (pallas_spmm_sum(pg, xx, interpret=True),
                                    jax.grad(loss)(xx)))(jnp.asarray(x))
    y_p, dx_p = _port_sum_grad(g, x, w)
    np.testing.assert_allclose(y_p, np.asarray(y_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dx_p, np.asarray(dx_j), rtol=0, atol=1e-4)


def test_sum_bf16_route_matches_pallas_interpret():
    """bf16 messages: the sum in float32, rounded to bf16 once, forward and
    transpose.  Small-integer inputs and cotangents keep every float32
    partial sum exact, so both sides are equal."""
    src, dst = _graph_edges(1)
    pg = build_pallas_graph(src, dst, 256, rows_per_block=128)
    g = build_graph(src, dst, 200)
    rng = np.random.default_rng(13)
    x = rng.integers(-8, 9, (256, 4, 512)).astype(np.float32)
    w = rng.integers(-8, 9, (256, 4, 512)).astype(np.float32)

    def fwd(xx):
        return pallas_spmm_sum(pg, xx.astype(jnp.bfloat16), interpret=True)

    def loss(xx):
        return jnp.sum(fwd(xx).astype(jnp.float32) * w)

    y_j, dx_j = jax.jit(lambda xx: (fwd(xx), jax.grad(loss)(xx)))(jnp.asarray(x))
    y_p, dx_p = _port_sum_grad(g, x, w, dtype=torch.bfloat16)
    np.testing.assert_array_equal(y_p, np.asarray(y_j.astype(jnp.float32)))
    np.testing.assert_array_equal(dx_p, np.asarray(dx_j))


@pytest.mark.parametrize("b,f", [(3, 13), (1, 7)])
def test_sum_and_mean_match_jax_at_odd_widths(b, f):
    src, dst = _graph_edges(3, n_real=150, e=1200)
    jg = jax_build_graph(src, dst, 150, add_self_loops=True, widths=(4, 16, 64))
    g = build_graph(src, dst, 150, add_self_loops=True)
    n = g.n_nodes
    rng = np.random.default_rng(b * 100 + f)
    x = rng.standard_normal((n, b, f)).astype(np.float32)
    w = rng.standard_normal((n, b, f)).astype(np.float32)
    for jax_op, op in ((jax_spmm.spmm_sum, spmm.spmm_sum),
                       (jax_spmm.spmm_mean, spmm.spmm_mean)):
        def loss(xx, jax_op=jax_op):
            y = jax_op(jg, xx.reshape(n, -1)).reshape(xx.shape)
            return jnp.sum(y * w), y

        (_, y_j), dx_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        y_p = op(g, xt)
        (y_p * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)


@pytest.mark.parametrize("norm", ["both", "left", "right", "none"])
def test_gcn_propagate_matches_jax(norm):
    src, dst = _graph_edges(5, n_real=150, e=1200)
    jg = jax_build_graph(src, dst, 150, add_self_loops=False, widths=(4, 16, 64))
    g = build_graph(src, dst, 150, add_self_loops=False)  # degree-0 rows too
    rng = np.random.default_rng(7)
    x = rng.standard_normal((g.n_nodes, 3, 11)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def loss(xx):  # the JAX op takes (N, F) rows; the port any trailing dims
        y = jax_spmm.gcn_propagate(jg, xx.reshape(xx.shape[0], -1), norm=norm)
        y = y.reshape(xx.shape)
        return jnp.sum(y * w), y

    (_, y_j), dx_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y_p = spmm.gcn_propagate(g, xt, norm=norm)
    (y_p * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)


def test_sddmm_dot_matches_jax_on_real_edges():
    src, dst = _graph_edges(6, n_real=150, e=1200)
    jg = jax_build_graph(src, dst, 150, add_self_loops=True, widths=(4, 16, 64))
    g = build_graph(src, dst, 150, add_self_loops=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((g.n_nodes, 9)).astype(np.float32)
    y = rng.standard_normal((g.n_nodes, 9)).astype(np.float32)
    e_j = np.asarray(jax_spmm.sddmm_dot(jg, jnp.asarray(x), jnp.asarray(y)))
    e_p = spmm.sddmm_dot(g, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert e_p.shape == (g.n_edges,)
    np.testing.assert_allclose(e_p, e_j[:g.n_edges], **TOL)


def _setup(n=120):
    ppi, feats, loc, _ = jax_synth.synthetic_dataset(
        n_nodes=n, n_edges=700, seed=7, feature_dims=(3, 10, 10))
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    g = from_scipy_coo(ppi, add_self_loops=True)
    return jg, g, pad_features(feats, g.n_nodes)


@pytest.mark.parametrize("in_feats,out_feats", [(23, 6), (6, 23)])
def test_graph_conv_both_matmul_orders(in_feats, out_feats):
    jg, g, x = _setup()
    x = x[:, :in_feats]
    params = jax_layers.init_graph_conv(jax.random.PRNGKey(4), in_feats, out_feats)
    params = {k: v + 0.1 for k, v in _np_tree(params).items()}  # a non-zero bias
    y_j = jax.jit(lambda p, xx: jax_layers.graph_conv(p, jg, xx))(params, jnp.asarray(x))
    layer = GraphConv(in_feats, out_feats)
    layer.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        y_p = layer(g, torch.from_numpy(x))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_sage_conv_mean_and_sum(aggregator):
    jg, g, x = _setup()
    params = jax_layers.init_sage_conv(jax.random.PRNGKey(6), x.shape[1], 9, aggregator)
    assert set(params) == {"w_self", "w_neigh", "bias"}
    y_j = jax.jit(lambda p, xx: jax_layers.sage_conv(p, jg, xx, aggregator))(
        params, jnp.asarray(x))
    layer = SageConv(x.shape[1], 9, aggregator)
    assert set(layer.state_dict()) == set(params)
    layer.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        y_p = layer(g, torch.from_numpy(x))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), **TOL)


def test_gcn2_forward_one_fold_and_fold_batched():
    jg, g, x = _setup()
    cfg = jax_engine.TrainConfig(model="gcn2", hidden=(13,))
    params = _np_tree(jax.jit(
        lambda k: jax_engine.init_fold_params(k, cfg, x.shape[1], 3))(jax.random.PRNGKey(9)))
    apply_j = jax.jit(lambda p, xx: jax_gnn32.gcn2_apply(p, jg, xx))
    outs_j = [np.asarray(apply_j(jax.tree.map(lambda a: a[b], params), jnp.asarray(x)))
              for b in range(3)]

    one = GCN2(x.shape[1], 13)
    one.load_state_dict(params_from_jax(jax.tree.map(lambda a: a[1], params)))
    batched = BatchedGCN2(3, x.shape[1], 13)
    batched.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out_one = one(g, torch.from_numpy(x))
        out_b = batched(g, torch.from_numpy(x))
    np.testing.assert_allclose(out_one.numpy(), outs_j[1], **TOL)
    assert out_b.shape == (g.n_nodes, 3, 12)
    for b in range(3):
        np.testing.assert_allclose(out_b[:, b].numpy(), outs_j[b], **TOL)
    # stacking per-fold models gives each fold its own forward
    models = [GCN2(x.shape[1], 13, generator=torch.Generator().manual_seed(s))
              for s in (1, 2)]
    with torch.no_grad():
        out_s = BatchedGCN2.stack(models)(g, torch.from_numpy(x))
        for b, m in enumerate(models):
            torch.testing.assert_close(out_s[:, b], m(g, torch.from_numpy(x)), **TOL)


def test_gcn2_runner_matches_jax_over_8_epochs():
    """8 epochs x 3 folds from the same JAX-initialised params against
    ``make_fold_runner(cfg.model="gcn2")``, one fold at a time (a vmapped
    XLA:CPU run is not a bit-level reference, ROADMAP Queue 3); tolerances
    as test_runner_matches_jax_over_8_epochs."""
    ppi, feats, loc, label_list = jax_synth.synthetic_dataset(
        n_nodes=512, n_edges=4000, seed=70)
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    g = from_scipy_coo(ppi, add_self_loops=True)
    n = g.n_nodes
    feats_p = pad_features(feats, n)
    labels_p = pad_features(loc, n)
    node_valid = np.arange(n) < 512
    w = losses.weight_cal(loc)
    tr_np, va_np = kfold.fold_node_masks(label_list, n, 3, 12)
    jcfg = jax_engine.TrainConfig(model="gcn2", lr=1e-3, fold_num=3, epoch_num=8,
                                  hidden=(13,), verbose=False)
    params = _np_tree(jax.jit(
        lambda k: jax_engine.init_fold_params(k, jcfg, feats.shape[1], 3))(
            jax.random.PRNGKey(5)))
    run_j, _ = jax_engine.make_fold_runner(
        jg, jnp.asarray(feats_p), jnp.asarray(labels_p), w, jnp.asarray(node_valid), jcfg)
    init_opt = jax.jit(run_j.init_opt)
    per_fold = []
    for i in range(3):
        p_i = jax.tree.map(lambda a: a[i:i + 1], params)
        per_fold.append(run_j(p_i, init_opt(p_i), jnp.asarray(tr_np[i:i + 1]),
                              jnp.asarray(va_np[i:i + 1]), jnp.float32(0.1)))
    probs_j = np.concatenate([np.asarray(r[2]) for r in per_fold])
    hist_j = jax.tree.map(lambda *a: np.concatenate(a),
                          *[jax.device_get(r[3]) for r in per_fold])

    pcfg = engine.TrainConfig(model="gcn2", lr=1e-3, fold_num=3, epoch_num=8,
                              hidden=(13,), verbose=False)
    model = BatchedGCN2(3, feats.shape[1], 13)
    model.load_state_dict(params_from_jax(params))
    run_p = engine.make_batched_fold_runner(
        g, torch.from_numpy(feats_p), torch.from_numpy(labels_p), w,
        torch.from_numpy(node_valid), pcfg)
    _, _, probs_p, hist_p, _ = run_p(
        model, None, torch.from_numpy(tr_np), torch.from_numpy(va_np), 0.1)

    np.testing.assert_allclose(probs_p.numpy(), probs_j, rtol=1e-4, atol=1e-4)
    for split in ("train", "val"):
        np.testing.assert_allclose(hist_p[split]["loss"], hist_j[split]["loss"],
                                   rtol=1e-4, atol=1e-4)
    rows = {"train": tr_np.sum(1), "val": va_np.sum(1)}
    for split, keys in (("train", ("aim", "cov", "acc")),
                        ("val", ("aim", "cov", "acc", "f1_micro", "f1_macro",
                                 "auc_micro", "auc_macro"))):
        for k in keys:
            allow = 2.0 / rows[split][:, None] + 1e-5
            diff = np.abs(hist_p[split][k] - hist_j[split][k])
            assert np.all(diff <= allow), (split, k, diff.max())
    np.testing.assert_allclose(hist_p["pred_num"], hist_j["pred_num"], atol=3)


def test_init_fold_model_dispatches_on_model():
    cfg = engine.TrainConfig(model="gcn2", hidden=(13, 9, 7, 5))
    m = engine.init_fold_model(cfg, 20, [1, 2], "cpu").requires_grad_(False)
    assert isinstance(m, BatchedGCN2)
    assert m.conv1.weight.shape == (2, 20, 13) and m.conv2.weight.shape == (2, 13, 12)
    # Xavier (gain 1) weights, zero biases, as init_graph_conv
    assert float(m.conv1.weight.abs().max()) <= np.sqrt(6.0 / 33)
    assert float(m.conv1.bias.abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown model"):
        engine.init_fold_model(engine.TrainConfig(model="gin"), 20, [1], "cpu")
