"""The port's graph container and segment-max op against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The
forward (out and argmax) must be exactly equal: max picks one of its
inputs, and both sides keep the first maximum in (dst, src) order.  dx is
allclose at atol 1e-5: both route every gradient element to the same
source, but sum a source's hits in different orders in float32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu.ops import build_graph as jax_build_graph
from plagnn_tpu.ops.pallas.spmm_kernels import (
    _run_spmm,
    build_pallas_graph,
    pallas_spmm_max,
)
from plagnn_tpu.ops.spmm import ell_reduce_max, spmm_max as jax_spmm_max
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph

DX_ATOL = 1e-5


def _graph_edges(seed, n_real=200, e=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_real, e)
    dst = rng.integers(0, n_real, e)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _tie_heavy(rng, shape):
    """relu of values on a coarse grid: many exact ties, zeros above all."""
    return np.maximum(np.round(rng.standard_normal(shape) * 2) / 2, 0).astype(np.float32)


def _port_grad(graph, x_np, w_np, dtype=torch.float32):
    x = torch.tensor(x_np, requires_grad=True)
    y = sk.spmm_max(graph, x.to(dtype)).float()
    (y * torch.from_numpy(w_np)).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("self_loops", [False, True])
def test_graph_container_matches_jax(self_loops):
    src, dst = _graph_edges(1)
    jg = jax_build_graph(src, dst, 200, add_self_loops=self_loops)
    g = build_graph(src, dst, 200, add_self_loops=self_loops)
    e = jg.n_edges
    assert (g.n_nodes, g.n_real_nodes, g.n_edges) == (jg.n_nodes, 200, e)
    assert g.n_nodes == 256  # round_up(200 + 1, 128): dummy node at 255
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(jg.src)[:e])
    np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jg.dst)[:e])
    # the JAX indptr counts its padding edges in the dummy row; the port
    # pads no edges, so only the dummy row's end differs
    np.testing.assert_array_equal(g.indptr.numpy()[:-1], np.asarray(jg.indptr)[:-1])
    assert g.indptr[-1] == e
    np.testing.assert_array_equal(g.in_degree.numpy(), np.asarray(jg.in_degree))
    np.testing.assert_array_equal(g.out_degree.numpy(), np.asarray(jg.out_degree))
    # transpose CSR: edges by (src, dst)
    s, d = g.src.numpy(), g.dst.numpy()
    order = np.lexsort((d, s))
    np.testing.assert_array_equal(g.t_dst.numpy(), d[order])
    np.testing.assert_array_equal(
        np.diff(g.t_indptr.numpy()), np.bincount(s, minlength=g.n_nodes))


def test_plain_matches_pallas_interpret():
    """The size tests/test_pallas_kernels.py uses: N_pad 256, B=2, F=512."""
    src, dst = _graph_edges(1)
    pg = build_pallas_graph(src, dst, 256, rows_per_block=128)
    g = build_graph(src, dst, 200)
    rng = np.random.default_rng(2)
    x = _tie_heavy(rng, (256, 2, 512))
    w = rng.standard_normal((256, 2, 512)).astype(np.float32)

    out_j, arg_j = jax.jit(lambda xx: _run_spmm(
        pg.fwd, xx, reduce="max", with_argmax=True, interpret=True))(jnp.asarray(x))
    out_p, arg_p = sk.spmm_max_fwd(g, torch.from_numpy(x.reshape(256, -1)))
    np.testing.assert_array_equal(out_p.numpy().reshape(x.shape), np.asarray(out_j))
    assert arg_p.dtype == torch.int16
    np.testing.assert_array_equal(arg_p.numpy().reshape(x.shape), np.asarray(arg_j))

    dx_j = jax.jit(jax.grad(
        lambda xx: jnp.sum(pallas_spmm_max(pg, xx, interpret=True) * w)))(jnp.asarray(x))
    _, dx_p = _port_grad(g, x, w)
    np.testing.assert_allclose(dx_p, np.asarray(dx_j), rtol=0, atol=DX_ATOL)


@pytest.mark.parametrize("b,f", [(3, 13), (1, 7), (4, 33)])
def test_plain_matches_xla_at_odd_widths(b, f):
    """Any B*F: the port takes odd widths without padding."""
    src, dst = _graph_edges(3, n_real=150, e=1200)
    jg = jax_build_graph(src, dst, 150, add_self_loops=True, widths=(4, 16, 64))
    g = build_graph(src, dst, 150, add_self_loops=True)
    n = g.n_nodes
    rng = np.random.default_rng(b * 100 + f)
    x = _tie_heavy(rng, (n, b, f))
    w = rng.standard_normal((n, b, f)).astype(np.float32)

    out_j, arg_j = jax.jit(lambda xx: ell_reduce_max(jg.ell, xx, with_argmax=True))(
        jnp.asarray(x.reshape(n, -1)))
    out_p, arg_p = sk.spmm_max_fwd(g, torch.from_numpy(x.reshape(n, -1)))
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(arg_p.numpy().astype(np.int32), np.asarray(arg_j))

    dx_j = jax.jit(jax.grad(lambda xx: jnp.sum(
        jax_spmm_max(jg, xx.reshape(n, -1)).reshape(xx.shape) * w)))(jnp.asarray(x))
    y_p, dx_p = _port_grad(g, x, w)
    np.testing.assert_array_equal(y_p, np.asarray(out_j).reshape(x.shape))
    np.testing.assert_allclose(dx_p, np.asarray(dx_j), rtol=0, atol=DX_ATOL)


def test_bf16_forward_exact():
    src, dst = _graph_edges(4, n_real=150, e=1200)
    jg = jax_build_graph(src, dst, 150, add_self_loops=True, widths=(4, 16, 64))
    g = build_graph(src, dst, 150, add_self_loops=True)
    rng = np.random.default_rng(5)
    x = _tie_heavy(rng, (g.n_nodes, 3 * 11))
    out_j, arg_j = jax.jit(lambda xx: ell_reduce_max(jg.ell, xx, with_argmax=True))(
        jnp.asarray(x).astype(jnp.bfloat16))
    out_p, arg_p = sk.spmm_max_fwd(g, torch.from_numpy(x).to(torch.bfloat16))
    assert out_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(out_p.float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    np.testing.assert_array_equal(arg_p.numpy().astype(np.int32), np.asarray(arg_j))


def test_bf16_grad_matches_jax_bf16_route():
    """bf16 messages through the JAX package's bf16 kernels (interpret mode,
    cf. tests/test_pallas_kernels.py:165): bf16-representable inputs and
    integer cotangents keep every float32 partial sum exact, so dx (summed
    in float32, rounded to bf16 once) is equal, not just close."""
    src, dst = _graph_edges(1)
    pg = build_pallas_graph(src, dst, 256, rows_per_block=128)
    g = build_graph(src, dst, 200)
    rng = np.random.default_rng(13)
    x = _tie_heavy(rng, (256, 4, 512))
    w = rng.integers(1, 9, (256, 4, 512)).astype(np.float32)

    def loss_bf(xx):
        y = pallas_spmm_max(pg, xx.astype(jnp.bfloat16), interpret=True)
        return jnp.sum(y.astype(jnp.float32) * w)

    dx_j = np.asarray(jax.jit(jax.grad(loss_bf))(jnp.asarray(x)))
    y_p, dx_p = _port_grad(g, x, w, dtype=torch.bfloat16)
    np.testing.assert_array_equal(dx_p, dx_j)


def test_argmax_int32_above_int16_nodes():
    """Past 2^15 padded nodes the id-based argmax (``positional=False``;
    the default there is the positional one, tests/test_torch_positional.py)
    widens to int32."""
    src = np.array([40000, 5, 7], np.int64)
    dst = np.array([3, 3, 40000], np.int64)
    g = build_graph(src, dst, 40001, positional=False)
    x = torch.zeros(g.n_nodes, 2)
    x[40000] = torch.tensor([1.0, -1.0])
    out, arg = sk.spmm_max_fwd(g, x)
    assert arg.dtype == torch.int32
    assert arg[3].tolist() == [40000, 5]
    assert out[3].tolist() == [1.0, 0.0]
    assert arg[0].tolist() == [-1, -1] and out[0].tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="2\\^15"):
        sk.spmm_max_bwd(g, x, arg.to(torch.int16))


def test_no_argmax_without_grad_and_launch_counters_stay_zero_on_cpu():
    src, dst = _graph_edges(6, n_real=50, e=200)
    g = build_graph(src, dst, 50)
    x = torch.rand(g.n_nodes, 5)
    sk.reset_launches()
    out, arg = sk.spmm_max_fwd(g, x, with_argmax=False)
    assert arg is None
    torch.testing.assert_close(sk.spmm_max(g, x), out, rtol=0, atol=0)
    assert all(v == 0 for v in sk.LAUNCHES.values())  # no kernel on the CPU
