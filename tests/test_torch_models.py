"""The port's GNN32 (one fold and fold-batched) against the JAX package,
from the same JAX-initialised parameters carried across with
``params_from_jax``.

Tolerance rtol/atol 1e-5: both sides run float32 end to end (JAX at HIGHEST
matmul precision, the port with TF32 off) and the aggregation is exact, so
the activations differ only by float32 summation order in the matmuls.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu.data import synthetic_dataset
from plagnn_tpu.models.batched import gnn32_apply_batched
from plagnn_tpu.models.gnn32 import gnn32_activations, init_gnn32
from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
from plagnn_tpu.ops import pad_features
from plagnn_tpu.ops.spmm import spmm_max as jax_spmm_max
from plagnn_tpu.train import TrainConfig
from plagnn_tpu.train.engine import init_fold_params
from plagnn_tpu_torch.models.batched import BatchedGNN32
from plagnn_tpu_torch.models.convert import params_from_jax
from plagnn_tpu_torch.models.gnn32 import GNN32
from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

HIDDEN = (13, 9, 7, 5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(n=120):
    ppi, feats, loc, _ = synthetic_dataset(
        n_nodes=n, n_edges=700, seed=7, feature_dims=(3, 10, 10))
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    g = from_scipy_coo(ppi, add_self_loops=True)
    x = pad_features(feats, g.n_nodes)
    return jg, g, x


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_tf32_off_by_default():
    import plagnn_tpu_torch.utils.precision as prec

    assert prec.matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    try:
        prec.set_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        prec.set_matmul_precision("highest")
    assert torch.backends.cudnn.allow_tf32 is False


def test_activation_ladder_matches_jax():
    jg, g, x = _setup()
    params = init_gnn32(jax.random.PRNGKey(3), x.shape[1], *HIDDEN)
    acts_j = jax.jit(lambda p, xx: gnn32_activations(p, jg, xx))(params, jnp.asarray(x))
    model = GNN32(x.shape[1], *HIDDEN)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        acts_p = model.activations(g, torch.from_numpy(x))
    assert list(acts_p) == list(acts_j)
    for name in acts_j:
        np.testing.assert_allclose(acts_p[name].numpy(), np.asarray(acts_j[name]),
                                   err_msg=name, **TOL)


def test_fold_batched_forward_matches_jax():
    jg, g, x = _setup()
    n = g.n_nodes
    cfg = TrainConfig(hidden=HIDDEN)
    params = jax.jit(lambda k: init_fold_params(k, cfg, x.shape[1], 3))(
        jax.random.PRNGKey(9))

    def agg(xp):  # the XLA segment max over the fold-packed rows
        return jax_spmm_max(jg, xp.reshape(n, -1)).reshape(xp.shape)

    out_j = jax.jit(lambda p, xx: gnn32_apply_batched(p, agg, xx))(params, jnp.asarray(x))
    model = BatchedGNN32(3, x.shape[1], *HIDDEN)
    model.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        out_p = model(g, torch.from_numpy(x))
    assert out_p.shape == (n, 3, 12)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **TOL)


def test_fold_batching_matches_per_fold_models():
    """Stacking per-fold models gives each fold its own forward."""
    _, g, x = _setup()
    models = [GNN32(x.shape[1], *HIDDEN, generator=torch.Generator().manual_seed(s))
              for s in (1, 2, 3)]
    batched = BatchedGNN32.stack(models)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out_b = batched(g, xt)
        for b, m in enumerate(models):
            torch.testing.assert_close(out_b[:, b], m(g, xt), **TOL)
