"""The port's other ops against the JAX package, on the CPU: the
edge-weighted segment sum, neighbour sampling, node reordering, the
clustered synthetic PPI and the trace helpers.

Inputs are made from a seed with numpy and given to both packages.  The
host modules (sampling, reordering, clustered_ppi) must give identical
arrays; the weighted sum (the kernel's plain version here, XLA in the JAX
package) and its gradient agree within 1e-5 in float32, the two summing the
same products in different orders.
"""
import json
import os

import jax.numpy as jnp
from jax import grad as jax_grad
from jax import jit
import numpy as np
import pytest
import torch

from plagnn_tpu.data.synthetic import clustered_ppi as jax_clustered_ppi
from plagnn_tpu.ops import graph_format as jax_gf
from plagnn_tpu.ops import reorder as jax_reorder
from plagnn_tpu.ops import sampling as jax_sampling
from plagnn_tpu.ops import spmm as jax_spmm
from plagnn_tpu_torch.data.synthetic import clustered_ppi, powerlaw_ppi
from plagnn_tpu_torch.ops import reorder, sampling
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.ops.spmm import spmm_max, spmm_sum
from plagnn_tpu_torch.utils import profiling


def _weighted_edges(seed=0, n=64):
    """Random edges without self-pairs, with a hub row (node 0 takes 30
    in-edges, more than row_chunk=8 holds), and edge values in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 300), 1 + np.arange(30)])
    dst = np.concatenate([rng.integers(0, n, 300), np.zeros(30, np.int64)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    val = rng.uniform(0.5, 1.5, len(pairs)).astype(np.float32)
    return pairs[:, 0], pairs[:, 1], val, n


def test_weighted_sum_and_grad_match_jax():
    src, dst, val, n = _weighted_edges()
    g = build_graph(src, dst, n, add_self_loops=True, edge_val=val, row_chunk=8)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    jg = jax_gf.build_graph(src, dst, n, add_self_loops=True, edge_val=val)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((g.n_nodes, 2, 7)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    out = spmm_sum(g, xt, use_val=True)
    (out * torch.from_numpy(w)).sum().backward()

    # the JAX weighted sum takes (N, K): the port's (N, 2, 7) packed
    x2, w2 = x.reshape(len(x), -1), w.reshape(len(w), -1)

    def loss(xj):
        return jnp.sum(jax_spmm.spmm_sum(jg, xj, use_val=True) * w2)

    fwd = jit(lambda xj: jax_spmm.spmm_sum(jg, xj, use_val=True))
    want = np.asarray(fwd(jnp.asarray(x2))).reshape(x.shape)
    want_grad = np.asarray(jit(jax_grad(loss))(jnp.asarray(x2))).reshape(x.shape)
    np.testing.assert_allclose(out.detach().numpy()[:n], want[:n], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy()[:n], want_grad[:n], rtol=1e-5, atol=1e-5)
    # the unweighted sum is another function on these values
    assert not np.allclose(spmm_sum(g, torch.from_numpy(x)).numpy()[:n], want[:n])


def test_weighted_sum_transpose_values_follow_their_edges():
    """t_val holds each edge's value in the transpose CSR's order; the
    self-loops carry 1.0."""
    src, dst, val, n = _weighted_edges(2)
    g = build_graph(src, dst, n, add_self_loops=True, edge_val=val)
    of = {(int(s), int(d)): v for s, d, v in zip(src, dst, val)}
    of.update({(i, i): np.float32(1.0) for i in range(n)})
    t_src = np.repeat(np.arange(g.n_nodes), np.diff(g.t_indptr.numpy()))
    for pairs, vals in (((g.src, g.dst), g.val), ((t_src, g.t_dst), g.t_val)):
        got = {(int(s), int(d)): v for s, d, v in zip(*pairs, vals.numpy())}
        assert got == of


def test_weighted_sum_refusals():
    src, dst, val, n = _weighted_edges(3)
    x = torch.zeros((build_graph(src, dst, n).n_nodes, 4))
    with pytest.raises(ValueError, match="graph has no edge values"):
        spmm_sum(build_graph(src, dst, n), x, use_val=True)
    with pytest.raises(ValueError, match="graph has no edge values"):
        sk.spmm_sum_rows(build_graph(src, dst, n), x, transpose=True, use_val=True)
    with pytest.raises(ValueError, match="one value per edge"):
        build_graph(src, dst, n, edge_val=val[:-1])


@pytest.mark.parametrize("n,e,seed", [(300, 4000, 5), (1024, 20_000, 9), (2048, 40_000, 70)])
def test_clustered_ppi_identical(n, e, seed):
    got, want = clustered_ppi(n, e, seed=seed), jax_clustered_ppi(n, e, seed=seed)
    assert got.shape == want.shape
    for a in ("row", "col", "data"):
        assert np.array_equal(getattr(got, a), getattr(want, a))
        assert getattr(got, a).dtype == getattr(want, a).dtype


@pytest.mark.parametrize("fanout,seeds", [(3, None), (5, "some"), (1000, None)])
def test_sample_neighbors_identical(fanout, seeds):
    ppi = powerlaw_ppi(400, 6000, seed=4)
    sel = np.random.default_rng(8).choice(400, 150, replace=False) if seeds else None
    got = sampling.sample_neighbors(ppi.row, ppi.col, 400, fanout, seed=11, seeds=sel)
    want = jax_sampling.sample_neighbors(ppi.row, ppi.col, 400, fanout, seed=11, seeds=sel)
    for a, b in zip(got, want):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    counts = np.bincount(got[1], minlength=400)
    assert counts.max() <= fanout
    if sel is not None:
        assert set(np.unique(got[1])) <= set(sel.tolist())


def test_sampled_graph_aggregations_match_jax():
    """spmm_max and spmm_sum (and their gradients) on the port's
    sampled_graph against the JAX ops on the JAX sampled_graph of the same
    seed: the same sampled edges, so the same results."""
    n, fanout = 300, 4
    ppi = powerlaw_ppi(n, 5000, seed=6)
    g = sampling.sampled_graph(ppi.row, ppi.col, n, fanout, seed=3)
    jg = jax_sampling.sampled_graph(ppi.row, ppi.col, n, fanout, seed=3)
    assert g.n_edges == jg.n_edges and g.n_nodes == jg.n_nodes
    rng = np.random.default_rng(2)
    x = np.maximum(rng.standard_normal((g.n_nodes, 15)), 0).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    for port_op, jax_op in ((spmm_max, jax_spmm.spmm_max), (spmm_sum, jax_spmm.spmm_sum)):
        xt = torch.tensor(x, requires_grad=True)
        out = port_op(g, xt)
        (out * torch.from_numpy(w)).sum().backward()

        def loss(xj, op=jax_op):
            return jnp.sum(op(jg, xj) * w)

        want = np.asarray(jit(lambda xj, op=jax_op: op(jg, xj))(jnp.asarray(x)))
        want_grad = np.asarray(jit(jax_grad(loss))(jnp.asarray(x)))
        np.testing.assert_allclose(out.detach().numpy()[:n], want[:n], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy()[:n], want_grad[:n], rtol=1e-5, atol=1e-5)


def test_sampled_graph_takes_no_edge_multiple():
    ppi = powerlaw_ppi(64, 400, seed=1)
    with pytest.raises(TypeError):
        sampling.sampled_graph(ppi.row, ppi.col, 64, 3, edge_multiple=1024)


@pytest.mark.parametrize("topology", ["powerlaw", "clustered"])
def test_orderings_identical(topology):
    ppi = (powerlaw_ppi(512, 4096, seed=3) if topology == "powerlaw"
           else clustered_ppi(1024, 16_000, seed=5))
    n = ppi.shape[0]
    src, dst = ppi.row.astype(np.int64), ppi.col.astype(np.int64)
    for name in ("rcm_order", "greedy_coalesce_order"):
        got = getattr(reorder, name)(src, dst, n)
        assert np.array_equal(got, getattr(jax_reorder, name)(src, dst, n))
        assert sorted(got.tolist()) == list(range(n))
        s, d = reorder.relabel_edges(src, dst, got)
        assert all(np.array_equal(a, b) for a, b in
                   zip((s, d), jax_reorder.relabel_edges(src, dst, got)))
        assert reorder.group_runs(s, d) == jax_reorder.group_runs(s, d)
    assert reorder.coalesce_report(src, dst, n) == jax_reorder.coalesce_report(src, dst, n)
    assert reorder.G == jax_reorder.G == 8


def test_group_runs_hand_case():
    src = np.array(list(range(4, 12)) + list(range(0, 16, 2)) + [1, 2, 3])
    dst = np.array([0] * 8 + [1] * 8 + [2] * 3)
    assert reorder.group_runs(src, dst) == (1, 3) == jax_reorder.group_runs(src, dst)


def test_reordered_aggregations_restore():
    """A relabelled graph with features x[perm] gives the identity order's
    results after out[inv_perm]: max exactly, the sum exactly on small
    integers."""
    ppi = clustered_ppi(600, 8000, seed=2)
    n = ppi.shape[0]
    src, dst = ppi.row.astype(np.int64), ppi.col.astype(np.int64)
    base = build_graph(src, dst, n, add_self_loops=True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-4, 5, (base.n_nodes, 6)).astype(np.float32))
    x[n:] = 0
    want_max, want_sum = spmm_max(base, x), spmm_sum(base, x)
    for perm in (reorder.rcm_order(src, dst, n), reorder.greedy_coalesce_order(src, dst, n)):
        s, d = reorder.relabel_edges(src, dst, perm)
        g = build_graph(s, d, n, add_self_loops=True)
        xp = x.clone()
        xp[:n] = x[torch.from_numpy(perm)]
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        for op, want in ((spmm_max, want_max), (spmm_sum, want_sum)):
            got = op(g, xp)[torch.from_numpy(inv)]
            assert torch.equal(got, want[:n])


def test_trace_on_cpu(tmp_path):
    x = torch.arange(6.0).reshape(2, 3) + 2
    log = tmp_path / "trace"
    with profiling.trace(str(log)):
        (x @ x.T).sum()
    path = os.path.join(str(log), profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)
    assert any(ev.get("name") == profiling.TRACE_BLOCK for ev in events)
    assert profiling.kernel_launches(path) == (0, [], 0)


@pytest.mark.parametrize("kept, lost", [((1, 2, 3), 0), ((1, 3), 1), ((), 3)])
def test_kernel_launches_counts_launches_without_a_kernel_event(tmp_path, kept, lost):
    """Launches 1-3 lie in the block's range, launches 0 and 5 before it
    (the warm-up's): kernel 0 is lost, kernel 5 ran."""
    events = [{"name": profiling.TRACE_BLOCK, "cat": "user_annotation", "ts": 8.0,
               "dur": 40.0, "args": {}},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 2.0,
               "args": {"correlation": 0}},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 10.0,
               "args": {"correlation": 1}},
              {"name": "cudaLaunchKernelExC", "cat": "cuda_runtime", "ts": 20.0,
               "args": {"correlation": 2}},
              {"name": "cuLaunchKernel", "cat": "cuda_driver", "ts": 30.0,
               "args": {"correlation": 3}},
              {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 40.0,
               "args": {"correlation": 4}},
              {"name": "aten::mm", "cat": "cpu_op", "ts": 5.0, "args": {}}]
    # launch c at 10 c, its kernel 3 c - 8 us later: 5 us before its
    # launch for c = 1, 1 us after it for c = 3
    events += [{"name": f"kernel_{c}", "cat": "kernel", "ts": 13.0 * c - 8, "dur": 1.0 * c,
                "args": {"correlation": c}} for c in kept]
    events += [{"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 41.0, "dur": 0.5,
                "args": {"correlation": 4}},
               {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 3.0,
                "args": {"correlation": 5}},
               {"name": "warm_up", "cat": "kernel", "ts": 4.0, "dur": 1.0,
                "args": {"correlation": 5}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got_lost, offsets, warm_lost = profiling.kernel_launches(str(path))
    assert (got_lost, warm_lost) == (lost, 1)
    assert sorted(offsets) == sorted(3.0 * c - 8 for c in kept)
    assert sorted(profiling.block_device_events(str(path))) == sorted(
        [("Memcpy HtoD", 0.5)] + [(f"kernel_{c}", 1.0 * c) for c in kept])
