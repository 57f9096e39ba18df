"""The port's multi-device path (plagnn_tpu_torch/parallel) against the JAX
package's (plagnn_tpu/parallel) and against the port's single-device path.

Ranks are gloo CPU processes started by ``parallel.launch.spawn_local``
with a file rendezvous under a temporary directory and a bounded wait, so
a hang fails its test.  A spawn costs a torch import a rank, so one world
of 2 ranks and one of 4 (the ``worlds`` fixture) run every check that
needs no world of its own, each task writing its results to its own
directory, which its test then compares.  The workers below are
module-level so the spawned children can unpickle them; a child re-imports
this module, so it imports only torch, numpy and the port at the top, and
JAX only inside the tests and the fixture (the JAX references run in the
test process, on conftest's 8 CPU devices)."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plagnn_tpu_torch import cli
from plagnn_tpu_torch.data import synthetic
from plagnn_tpu_torch.models.batched import BatchedGNN32
from plagnn_tpu_torch.models.convert import params_from_jax
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo, pad_features
from plagnn_tpu_torch.parallel.launch import spawn_local
from plagnn_tpu_torch.parallel.partition import (
    partition_graph, shard_features, unshard_rows)
from plagnn_tpu_torch.parallel.sharded import (
    halo_exchange, make_mesh, make_sharded_fold_runner, make_sharded_forward,
    sharded_gcn_propagate, sharded_sage_conv)
from plagnn_tpu_torch.train import engine, kfold, losses
from plagnn_tpu_torch.train.runner import EPOCH_PHASES
from plagnn_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 150     # a hung rank fails its test well inside the suite's limit
HIDDEN = (13, 9, 7, 5)
# float32 in another reduction order (psum'd partial sums, a split max)
ATOL = 1e-5
# what a rank's collective raises when a peer process has ended
PEER_GONE = "Connection reset by peer|Connection closed by peer"


def _spawn(fn, n, tmp_path, *args):
    spawn_local(fn, n, backend="gloo", devices=["cpu"] * n,
                rdzv_dir=str(tmp_path / "rdzv"), args=args, timeout_s=SPAWN_TIMEOUT_S)


def _world_worker(rank, device, tasks):
    """Every task of a shared world, in order, on every rank."""
    for fn, args in tasks:
        fn(rank, device, *args)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """worlds(n) -> the directory of the shared world of n ranks, spawned
    at its first use; task ``name`` wrote into its subdirectory ``name``."""
    done = {}

    def get(n):
        if n not in done:
            root = tmp_path_factory.mktemp(f"world{n}")
            tasks = []
            for name, fn, args in _world_tasks(n):
                (root / name).mkdir()
                tasks.append((fn, (str(root / name), *args)))
            _spawn(_world_worker, n, root, tasks)
            done[n] = root
        return done[n]

    return get


def _world_tasks(n):
    """(name, worker, arguments after its output directory) of the world of
    n ranks; JAX makes the parameters here, in the test process."""
    small = (140, 900, 11, 4, 12, (3, 20, 20))
    tasks = [("halo", _halo_worker, (n,)),
             ("fwd", _forward_worker, (n, _gnn_params()))]
    if n == 2:
        wide = (512, 4000, 70, 3, 12)
        tasks += [("runner_jax", _runner_worker,
                   (1, 2, _jax_fold_params(3, _n_feats(wide)), 8, wide)),
                  ("bf16", _bf16_worker, (dict(mesh_fold=1, mesh_graph=2),))]
    else:
        tasks += [(f"runner_f{f}g{g}", _runner_worker,
                   (f, g, _jax_fold_params(4, _n_feats(small)), 5, small))
                  for f, g in ((2, 2), (1, 4))]
        tasks += [("pad", _engine_worker, (PAD_KW,))]
    return tasks


def _bundle(n_nodes=140, n_edges=900, seed=11):
    """(ppi COO, feats, loc, label_list) of the synthetic dataset: the JAX
    package's bit for bit."""
    return synthetic.synthetic_dataset(n_nodes=n_nodes, n_edges=n_edges, seed=seed,
                                       feature_dims=(3, 8, 8))


def _pairs(src, dst):
    """Edges as sorted (dst, src) pairs."""
    a = np.stack([np.asarray(dst, np.int64), np.asarray(src, np.int64)], 1)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


# ---------------------------------------------------------------------------
# Partition tables (host, no ranks).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_partition_tables_match_jax(p, balance, overlap):
    from plagnn_tpu.parallel import partition_graph as jax_partition

    ppi, _, _, _ = _bundle()
    n = ppi.shape[0]
    got = partition_graph(ppi.row, ppi.col, n, p, add_self_loops=True,
                          balance=balance, overlap=overlap)
    ref = jax_partition(ppi.row, ppi.col, n, p, add_self_loops=True, widths=(4, 16, 64),
                        balance=balance, overlap=overlap)
    assert (got.n_chips, got.own_rows, got.halo_per_peer, got.n_real_nodes, got.n_edges) == (
        ref.n_chips, ref.own_rows, ref.halo_per_peer, ref.n_real_nodes, ref.n_edges)
    np.testing.assert_array_equal(got.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(got.in_degree, np.asarray(ref.in_degree))
    np.testing.assert_array_equal(got.out_degree, np.asarray(ref.out_degree))
    for name in ("row_map", "node_row"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None) == (not balance)
        if balance:
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (got.interior_edges is None) == (ref.interior is None) == (not overlap)
    sets = [("local", got.local_edges, ref.local)]
    if overlap:
        sets += [("interior", got.interior_edges, ref.interior),
                 ("boundary", got.boundary_edges, ref.boundary)]
    for name, edges, jg in sets:
        dummy = jg.n_nodes - 1
        for r in range(p):
            js, jd = np.asarray(jg.src[r]), np.asarray(jg.dst[r])
            real = ~((js == dummy) & (jd == dummy))
            want = _pairs(js[real], jd[real])
            np.testing.assert_array_equal(_pairs(*edges[r]), want, err_msg=f"{name} {r}")
            if name != "local":
                g = getattr(got.shard(r), name)
                assert g.n_nodes == jg.n_nodes
                np.testing.assert_array_equal(_pairs(g.src.numpy(), g.dst.numpy()), want)
    for r in range(p):
        if not overlap:
            # a shard runs the interior and boundary passes only
            with pytest.raises(ValueError, match="overlap"):
                got.shard(r)
            continue
        shard = got.shard(r)
        np.testing.assert_array_equal(shard.send_idx.numpy(), got.send_idx[r])
        np.testing.assert_array_equal(shard.in_degree.numpy(), got.in_degree[r])
    if p == 1 and overlap:
        # a graph axis of size 1 runs its single pass over the interior
        np.testing.assert_array_equal(_pairs(*got.interior_edges[0]),
                                      _pairs(*got.local_edges[0]))
        assert len(got.boundary_edges[0][0]) == 0


@pytest.mark.parametrize("balance", [False, True])
def test_shard_features_round_trip_matches_jax(balance):
    from plagnn_tpu.parallel import partition_graph as jax_partition
    from plagnn_tpu.parallel import shard_features as jax_shard
    from plagnn_tpu.parallel import unshard_rows as jax_unshard

    ppi, feats, _, _ = _bundle()
    n = ppi.shape[0]
    got = partition_graph(ppi.row, ppi.col, n, 4, add_self_loops=True, balance=balance)
    ref = jax_partition(ppi.row, ppi.col, n, 4, add_self_loops=True, widths=(4, 16, 64),
                        balance=balance)
    shards = shard_features(feats, got)
    np.testing.assert_array_equal(shards, jax_shard(feats, ref))
    np.testing.assert_array_equal(unshard_rows(shards, got), jax_unshard(shards, ref))
    np.testing.assert_array_equal(unshard_rows(shards, got), feats)


# ---------------------------------------------------------------------------
# spmm_max's empty_value (the plain version; the kernel's tests need a card).
# ---------------------------------------------------------------------------


def test_spmm_max_empty_value_rule():
    """An empty row gives empty_value with argmax -1; a row of -inf inputs
    gives -inf and its first source; the default stays 0; the backward
    routes nothing from an empty row."""
    # row 0 <- {1, 2}; row 1 <- {0, 3} (its inputs are -inf in column 1);
    # row 2 and 3 empty
    g = build_graph(np.array([1, 2, 3, 0]), np.array([0, 0, 1, 1]), 4, node_multiple=8)
    x = torch.tensor([[1.0, -np.inf], [2.0, 5.0], [2.0, 7.0], [0.5, -np.inf]])
    x = torch.cat([x, torch.zeros(g.n_nodes - 4, 2)])
    x[0, 1] = -np.inf
    for ev in (0.0, -np.inf, 3.5):
        out, arg = sk.spmm_max_fwd(g, x, empty_value=ev)
        assert out[0].tolist() == [2.0, 7.0] and arg[0].tolist() == [1, 2]
        assert out[1].tolist() == [1.0, -np.inf] and arg[1].tolist() == [0, 0]
        assert torch.all(out[2:] == ev) and torch.all(arg[2:] == -1)
        noarg, none = sk.spmm_max_fwd(g, x, with_argmax=False, empty_value=ev)
        assert none is None and torch.equal(noarg, out)
    assert torch.equal(sk.spmm_max(g, x), sk.spmm_max_fwd(g, x)[0])
    assert torch.all(sk.spmm_max(g, x)[2:] == 0)
    xr = x.clone().requires_grad_()
    out = sk.spmm_max(g, xr, empty_value=-np.inf)
    assert torch.isneginf(out[2:]).all()
    gout = torch.ones_like(out)
    out.backward(gout)
    want = torch.zeros_like(x)
    want[1, 0] = 1.0   # row 0 col 0: first maximum at source 1
    want[2, 1] = 1.0   # row 0 col 1: source 2
    want[0, 0] = 1.0   # row 1 col 0: source 0
    want[0, 1] = 1.0   # row 1 col 1: all -inf, first source 0
    np.testing.assert_array_equal(xr.grad.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_max_empty_value_matches_jax(dtype):
    import jax.numpy as jnp

    from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
    from plagnn_tpu.ops.spmm import spmm_max as jax_spmm_max

    ppi, _, _, _ = _bundle()
    n = ppi.shape[0]
    # rows 0-9 keep no in-edge: they take the empty value
    keep = ppi.col >= 10
    import scipy.sparse as sp

    cut = sp.coo_matrix((ppi.data[keep], (ppi.row[keep], ppi.col[keep])), shape=ppi.shape)
    g = from_scipy_coo(cut)
    jg = jax_from_scipy_coo(cut, widths=(4, 16, 64))
    x = np.random.default_rng(3).standard_normal((g.n_nodes, 7)).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()   # exact in either dtype
    got = sk.spmm_max(g, torch.from_numpy(x).to(dtype), empty_value=-np.inf).float().numpy()
    want = np.asarray(jax_spmm_max(jg, jnp.asarray(x[:jg.n_nodes]), empty_value=-jnp.inf))
    np.testing.assert_array_equal(got[:n], want[:n])
    assert np.isneginf(got[:10]).all()


# ---------------------------------------------------------------------------
# Halo exchange.
# ---------------------------------------------------------------------------


def _halo_worker(rank, device, out_dir, p):
    ppi, _, _, _ = _bundle(n_nodes=60, n_edges=300, seed=5)
    pg = partition_graph(ppi.row, ppi.col, ppi.shape[0], p, add_self_loops=True,
                         balance=True)
    mesh = make_mesh(p, 1)
    send = torch.from_numpy(pg.send_idx[rank])
    c, s = pg.own_rows, pg.halo_per_peer
    xs = [np.random.default_rng(100 + q).standard_normal((c, 2, 3)) for q in range(p)]
    gs = [np.random.default_rng(200 + q).standard_normal((p * s, 2, 3)) for q in range(p)]
    x = torch.tensor(xs[rank], dtype=torch.float32, requires_grad=True)
    halo = halo_exchange(x, send, mesh.graph_group)
    halo.backward(torch.tensor(gs[rank], dtype=torch.float32))
    # numpy references from the send tables
    want = np.zeros((p * s, 2, 3))
    for q in range(p):
        for k in range(s):
            row = pg.send_idx[q, rank, k]
            if row >= 0:
                want[q * s + k] = xs[q][row]
    want_dx = np.zeros((c, 2, 3))
    for q in range(p):
        for k in range(s):
            row = pg.send_idx[rank, q, k]
            if row >= 0:
                want_dx[row] += gs[q][rank * s + k]
    # float64 gradcheck of the exchange across the ranks: every rank walks
    # the same global basis, perturbing (numerical columns) or seeding the
    # backward (analytical rows) only where the element is its own
    eps = 1e-6
    x64 = torch.tensor(xs[rank][:, :1, 0])   # one column keeps the basis small
    n_in, n_out = c * x64.shape[1], p * s * x64.shape[1]
    num = torch.zeros((p * n_in, n_out), dtype=torch.float64)
    for r0 in range(p):
        for i in range(n_in):
            cols = []
            for sign in (1, -1):
                xp = x64.clone()
                if r0 == rank:
                    xp.view(-1)[i] += sign * eps
                cols.append(halo_exchange(xp, send, mesh.graph_group).reshape(-1))
            num[r0 * n_in + i] = (cols[0] - cols[1]) / (2 * eps)
    ana = torch.zeros((p * n_out, n_in), dtype=torch.float64)
    for r1 in range(p):
        for j in range(n_out):
            xg = x64.clone().requires_grad_()
            h = halo_exchange(xg, send, mesh.graph_group)
            seed = torch.zeros(n_out, dtype=torch.float64)
            if r1 == rank:
                seed[j] = 1.0
            h.backward(seed.reshape(h.shape))
            ana[r1 * n_out + j] = xg.grad.reshape(-1)
    np.savez(os.path.join(out_dir, f"halo_{rank}.npz"), halo=halo.detach().numpy(),
             want=want, dx=x.grad.numpy(), want_dx=want_dx, num=num.numpy(),
             ana=ana.numpy(), n_in=n_in, n_out=n_out)


@pytest.mark.parametrize("p", [2, 4])
def test_halo_exchange_forward_backward_and_gradcheck(worlds, p):
    out = worlds(p) / "halo"
    res = [np.load(out / f"halo_{r}.npz") for r in range(p)]
    for r in res:
        np.testing.assert_allclose(r["halo"], r["want"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["dx"], r["want_dx"], rtol=1e-5, atol=1e-5)
        assert np.abs(r["want"]).sum() > 0 and np.abs(r["want_dx"]).sum() > 0
    n_in, n_out = int(res[0]["n_in"]), int(res[0]["n_out"])
    # J[out (r1, j), in (r0, i)]: numerically from rank r1's outputs,
    # analytically from rank r0's input gradient
    j_num = np.concatenate([r["num"].T for r in res])          # (p*n_out, p*n_in)
    j_ana = np.concatenate([r["ana"] for r in res], axis=1)    # (p*n_out, p*n_in)
    assert j_num.shape == j_ana.shape == (p * n_out, p * n_in)
    np.testing.assert_allclose(j_ana, j_num, atol=1e-6)
    assert np.count_nonzero(j_ana) > 0


# ---------------------------------------------------------------------------
# Sharded forward against the JAX package's on its CPU mesh.
# ---------------------------------------------------------------------------


def _forward_worker(rank, device, out_dir, p, params):
    ppi, feats, _, _ = _bundle()
    n = ppi.shape[0]
    pg = partition_graph(ppi.row, ppi.col, n, p, add_self_loops=True, balance=True)
    mesh = make_mesh(p, 1)
    shard = pg.shard(rank, device)
    x_own = torch.from_numpy(shard_features(feats.astype(np.float32), pg)[rank])
    model = BatchedGNN32(1, feats.shape[1], *HIDDEN)
    model.load_state_dict(params_from_jax(
        {k: {n_: v[None] for n_, v in d.items()} for k, d in params.items()}))
    with torch.no_grad():
        gnn = make_sharded_forward(mesh, shard)(model, x_own)[:, 0]
        gcn = sharded_gcn_propagate(shard, mesh, x_own)
        conv = {k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in params["conv1"].items()}
        sage = sharded_sage_conv(conv, shard, mesh, x_own, aggregator="sum")
    np.savez(os.path.join(out_dir, f"fwd_{rank}.npz"), gnn=gnn.numpy(), gcn=gcn.numpy(),
             sage=sage.numpy())


@functools.lru_cache(maxsize=None)
def _gnn_params():
    import jax

    from plagnn_tpu.models import init_gnn32

    _, feats, _, _ = _bundle()
    return jax.tree.map(np.asarray, init_gnn32(jax.random.PRNGKey(3), feats.shape[1],
                                               *HIDDEN, 12))


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_forward_matches_jax(worlds, p):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS

    from plagnn_tpu.parallel import make_mesh as jax_mesh
    from plagnn_tpu.parallel import make_sharded_forward as jax_forward
    from plagnn_tpu.parallel import partition_graph as jax_partition
    from plagnn_tpu.parallel import shard_features as jax_shard
    from plagnn_tpu.parallel.sharded import sharded_gcn_propagate as jax_gcn
    from plagnn_tpu.parallel.sharded import sharded_sage_conv as jax_sage

    ppi, feats, _, _ = _bundle()
    n = ppi.shape[0]
    params = _gnn_params()
    jpg = jax_partition(ppi.row, ppi.col, n, p, add_self_loops=True, widths=(4, 16, 64),
                        balance=True)
    mesh = jax_mesh(n_graph=p, n_fold=1)
    xs = jnp.asarray(jax_shard(feats.astype(np.float32), jpg))
    want_gnn = np.asarray(jax_forward(mesh, jpg)(params, xs))

    def per_shard(local, interior, boundary, send_idx, x, ind, outd):
        def first(t):
            return jax.tree.map(lambda a: a[0], t)

        lg = first(local)
        gcn = jax_gcn(lg, send_idx[0], x[0], ind[0], outd[0])
        sage = jax_sage(params["conv1"], lg, send_idx[0], x[0], aggregator="sum",
                        interior=first(interior), boundary=first(boundary))
        return gcn[None], sage[None]

    spec = PS("graph")
    want_gcn, want_sage = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=(spec,) * 7, out_specs=(spec, spec)))(
            jpg.local, jpg.interior, jpg.boundary, jpg.send_idx, xs, jpg.in_degree,
            jpg.out_degree)

    out = worlds(p) / "fwd"
    for r in range(p):
        got = np.load(out / f"fwd_{r}.npz")
        np.testing.assert_allclose(got["gnn"], want_gnn[r], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got["gcn"], np.asarray(want_gcn)[r], atol=ATOL, rtol=0)
        # the un-normalised sum reaches |300|: float32 order, relative
        np.testing.assert_allclose(got["sage"], np.asarray(want_sage)[r], atol=ATOL,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# The sharded runner.
# ---------------------------------------------------------------------------


def _n_feats(shape):
    return _runner_inputs(*shape)[1].shape[1]


def _runner_inputs(n_nodes, n_edges, seed, n_folds, fold_seed, dims=(3, 250, 250)):
    ppi, feats, loc, label_list = synthetic.synthetic_dataset(
        n_nodes=n_nodes, n_edges=n_edges, seed=seed, feature_dims=dims)
    g = from_scipy_coo(ppi, add_self_loops=True)
    tr, va = kfold.fold_node_masks(label_list, g.n_nodes, n_folds, fold_seed)
    return g, feats.astype(np.float32), loc.astype(np.float32), losses.weight_cal(loc), tr, va


def _flat_history(hist):
    out = {f"{s}/{k}": v for s in ("train", "val") for k, v in hist[s].items()}
    out["pred_num"] = hist["pred_num"]
    return out


def _runner_worker(rank, device, out_dir, fold, graph, params, n_epochs, shape):
    g, feats, loc, w, tr, va = _runner_inputs(*shape)
    n = g.n_real_nodes
    pg = partition_graph(g.src.numpy(), g.dst.numpy(), n, graph, balance=True)
    mesh = make_mesh(graph, fold)
    shard = pg.shard(mesh.graph_index, device)
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=n_epochs, hidden=HIDDEN, verbose=False)
    run = make_sharded_fold_runner(mesh, pg, shard, feats, loc, w, cfg, device)
    mine = mesh.fold_slice(len(tr))
    model = BatchedGNN32(mine.stop - mine.start, feats.shape[1], *HIDDEN)
    model.load_state_dict({k: v[mine] for k, v in params_from_jax(params).items()})
    _, _, probs, hist, epoch_ms = run(model, None, torch.from_numpy(tr),
                                      torch.from_numpy(va), 0.1)
    assert len(epoch_ms) == n_epochs and probs.shape == (len(tr), n, 12)
    # the sharded epoch's phases: one row an epoch, adding up to its epoch_ms
    for row, ms in zip(profiling.PHASES[-n_epochs:], epoch_ms):
        assert tuple(row) == EPOCH_PHASES and abs(sum(row.values()) - ms) < 1e-6
    if rank == 0:
        np.savez(os.path.join(out_dir, "runner.npz"), probs=probs.numpy(),
                 **_flat_history(hist))


@functools.lru_cache(maxsize=None)
def _jax_fold_params(n_folds, in_feats, seed=5):
    import jax

    from plagnn_tpu.train import engine as jax_engine

    jcfg = jax_engine.TrainConfig(hidden=HIDDEN, verbose=False)
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_engine.init_fold_params(k, jcfg, in_feats, n_folds))(
            jax.random.PRNGKey(seed)))


def _assert_history_close(got, want, rows, atol, flips=2.0):
    """Losses within atol; threshold metrics within ``flips`` predictions
    of their row count (a prediction at float32 noise from its row's
    threshold may flip); pred_num within 3."""
    for key in got:
        if key == "pred_num":
            np.testing.assert_allclose(got[key], want[key], atol=3)
        elif key.endswith("loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=atol, atol=atol,
                                       err_msg=key)
        else:
            split = key.split("/")[0]
            allow = flips / rows[split][:, None] + atol
            diff = np.abs(got[key] - want[key])
            assert np.all(diff <= allow), (key, diff.max())


@pytest.mark.parametrize("fold,graph", [(2, 2), (1, 4)])
def test_sharded_runner_matches_single_device(worlds, fold, graph):
    shape = (140, 900, 11, 4, 12, (3, 20, 20))
    g, feats, loc, w, tr, va = _runner_inputs(*shape)
    params = _jax_fold_params(4, feats.shape[1])
    cfg = engine.TrainConfig(lr=1e-3, epoch_num=5, hidden=HIDDEN, verbose=False)
    n = g.n_real_nodes
    run = engine.make_batched_fold_runner(
        g, torch.from_numpy(pad_features(feats, g.n_nodes)),
        torch.from_numpy(pad_features(loc, g.n_nodes)), w,
        torch.arange(g.n_nodes) < n, cfg)
    model = BatchedGNN32(4, feats.shape[1], *HIDDEN)
    model.load_state_dict(params_from_jax(params))
    _, _, probs, hist, _ = run(model, None, torch.from_numpy(tr), torch.from_numpy(va), 0.1)

    got = np.load(worlds(fold * graph) / f"runner_f{fold}g{graph}" / "runner.npz")
    np.testing.assert_allclose(got["probs"], probs.numpy()[:, :n], atol=ATOL, rtol=0)
    rows = {"train": tr.sum(1), "val": va.sum(1)}
    _assert_history_close({k: got[k] for k in got.files if k != "probs"},
                          _flat_history(hist), rows, ATOL)


def test_sharded_runner_matches_jax_runner_over_8_epochs(worlds):
    """The whole slice: the port's fold=1,graph=2 runner against the JAX
    package's XLA runner, one fold at a time (a vmapped JAX run wider than
    1 is no reference on XLA:CPU; tests/test_torch_train.py), 8 epochs, 3
    folds, 1e-4 (float32 drift over 8 Adam steps), threshold metrics with
    the flip allowance."""
    import jax
    import jax.numpy as jnp

    from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
    from plagnn_tpu.train import engine as jax_engine

    shape = (512, 4000, 70, 3, 12)
    g, feats, loc, w, tr, va = _runner_inputs(*shape)
    ppi, _, _, _ = synthetic.synthetic_dataset(n_nodes=512, n_edges=4000, seed=70)
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    params = _jax_fold_params(3, feats.shape[1])
    n_pad = g.n_nodes
    jcfg = jax_engine.TrainConfig(lr=1e-3, fold_num=3, epoch_num=8, hidden=HIDDEN,
                                  verbose=False)
    run_j, _ = jax_engine.make_fold_runner(
        jg, jnp.asarray(pad_features(feats, n_pad)), jnp.asarray(pad_features(loc, n_pad)),
        w, jnp.asarray(np.arange(n_pad) < 512), jcfg)
    init_opt = jax.jit(run_j.init_opt)
    per_fold = []
    for i in range(3):
        p_i = jax.tree.map(lambda a: a[i:i + 1], params)
        per_fold.append(run_j(p_i, init_opt(p_i), jnp.asarray(tr[i:i + 1]),
                              jnp.asarray(va[i:i + 1]), jnp.float32(0.1)))
    probs_j = np.concatenate([np.asarray(r[2]) for r in per_fold])[:, :512]
    hist_j = jax.tree.map(lambda *a: np.concatenate(a),
                          *[jax.device_get(r[3]) for r in per_fold])

    got = np.load(worlds(2) / "runner_jax" / "runner.npz")
    np.testing.assert_allclose(got["probs"], probs_j, rtol=1e-4, atol=1e-4)
    rows = {"train": tr.sum(1), "val": va.sum(1)}
    _assert_history_close({k: got[k] for k in got.files if k != "probs"},
                          _flat_history(hist_j), rows, 1e-4)


# ---------------------------------------------------------------------------
# The engine and the CLI.
# ---------------------------------------------------------------------------


def _engine_data():
    ppi, feats, loc, label_list = synthetic.synthetic_dataset(
        n_nodes=96, n_edges=500, seed=4, feature_dims=(3, 6, 6))
    g = from_scipy_coo(ppi, add_self_loops=True)
    return (g, pad_features(feats, g.n_nodes), pad_features(loc, g.n_nodes), label_list,
            loc)


def _engine_cfg(**kw):
    base = dict(lr=1e-3, fold_num=2, epoch_num=4, fold_batch=2, fold_seeds=(12, 22),
                hidden=HIDDEN, compute_auc=True, auc_every=2, verbose=False)
    base.update(kw)
    return engine.TrainConfig(**base)


# 3 jobs, fold_batch 4, mesh fold=2,graph=2
PAD_KW = dict(fold_num=3, fold_batch=4, fold_seeds=(12,), mesh_fold=2, mesh_graph=2)


def _crash_after_two(round_idx, alpha, c0, done):
    if done == 2:
        raise RuntimeError("injected crash after epoch 2")


def _engine_worker(rank, device, out, kw, crash=False):
    if crash:
        kw = dict(kw, chunk_callback=_crash_after_two)
    g, feats, labels, label_list, loc = _engine_data()
    engine.train(g, feats, labels, label_list, loc, _engine_cfg(**kw), out + os.sep,
                 device_name=str(device))


def _artifacts(d):
    d = str(d)
    npy = {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".npy")}
    figs = {f: json.load(open(os.path.join(d, f))) for f in sorted(os.listdir(d))
            if f.startswith("fig_data_")}
    return npy, figs


def _assert_same_artifacts(got_dir, want_dir, n_logits):
    (npy_a, fig_a), (npy_b, fig_b) = _artifacts(want_dir), _artifacts(got_dir)
    assert sorted(npy_a) == sorted(npy_b) and len(npy_a) == n_logits
    for f in npy_a:
        np.testing.assert_allclose(npy_b[f], npy_a[f], atol=ATOL, rtol=0, err_msg=f)
    assert sorted(fig_a) == sorted(fig_b)
    for f, fig in fig_a.items():
        for split, by_alpha in fig.items():
            for alpha, folds in by_alpha.items():
                for fold, curves in folds.items():
                    for k, v in curves.items():
                        got = np.asarray(fig_b[f][split][alpha][fold][k], float)
                        v = np.asarray(v, float)
                        if k == "pred_num_final":
                            np.testing.assert_allclose(got, v, atol=3)
                        elif k == "loss":
                            np.testing.assert_allclose(got, v, rtol=ATOL, atol=ATOL)
                        else:   # threshold metrics: a flip of 2 of >= 10 rows
                            np.testing.assert_allclose(got, v, atol=0.2 + ATOL,
                                                       err_msg=f"{split}/{fold}/{k}")
                            assert np.mean(np.abs(got - v) > ATOL) <= 0.5
    assert not [f for f in os.listdir(got_dir) if f.startswith("ckpt_")]


def _train_single(out, **kw):
    g, feats, labels, label_list, loc = _engine_data()
    engine.train(g, feats, labels, label_list, loc, _engine_cfg(**kw), str(out) + os.sep,
                 device_name="cpu")


def test_engine_mesh_pads_partial_chunk(worlds, tmp_path):
    """3 jobs, fold_batch 4, mesh fold=2,graph=2: the chunk of 3 is padded
    to 4 by repeating a job; only the 3 real jobs' artifacts are written,
    equal to the single-device run's."""
    _train_single(tmp_path / "single", **dict(PAD_KW, mesh_fold=1, mesh_graph=1))
    _assert_same_artifacts(worlds(4) / "pad", tmp_path / "single", 3)


def test_engine_mesh_checkpoint_resumes_to_same_artifacts(tmp_path):
    """--checkpoint-every on a fold=2,graph=2 mesh: a crash after epoch 2
    leaves rank 0's checkpoint of the whole fold batch; the rerun resumes
    from it on every rank and writes the uninterrupted single-device run's
    artifacts."""
    kw = dict(epoch_num=5, fold_seeds=(12,), checkpoint_every=2)
    _train_single(tmp_path / "single", epoch_num=5, fold_seeds=(12,))
    mesh_kw = dict(kw, mesh_fold=2, mesh_graph=2)
    with pytest.raises(Exception, match=f"injected crash|{PEER_GONE}"):
        _spawn(_engine_worker, 4, tmp_path, str(tmp_path / "mesh"), mesh_kw, True)
    assert os.path.exists(tmp_path / "mesh" / "ckpt_a0_j0.npz")
    _spawn(_engine_worker, 4, tmp_path, str(tmp_path / "mesh"), mesh_kw)
    _assert_same_artifacts(tmp_path / "mesh", tmp_path / "single", 2)


def _bf16_worker(rank, device, out, kw):
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    set_aggregation_dtype("bfloat16")
    try:
        _bf16_run(rank, device, out, kw)
    finally:
        set_aggregation_dtype("float32")


def _bf16_run(rank, device, out, kw):
    g, feats, labels, label_list, loc = _engine_data()
    n = g.n_real_nodes
    pg = partition_graph(g.src.numpy(), g.dst.numpy(), n, 2, balance=True)
    mesh = make_mesh(2, 1)
    shard = pg.shard(rank, device)
    model = engine.init_fold_model(_engine_cfg(), feats.shape[1], [3, 4], device)
    x_own = torch.from_numpy(shard_features(feats[:n].astype(np.float32), pg)[rank])
    with torch.no_grad():
        own = make_sharded_forward(mesh, shard)(model, x_own)
    np.savez(os.path.join(out, f"bf16_fwd_{rank}.npz"), own=own.numpy(),
             rows=pg.row_map[rank * pg.own_rows:(rank + 1) * pg.own_rows])
    _engine_worker(rank, device, out, kw)


def test_engine_mesh_bf16_messages(worlds, tmp_path):
    """--agg-dtype bfloat16 on a fold=1,graph=2 mesh: the halo travels in
    bf16 and the max is exact, so the sharded forward equals the
    single-device bf16 forward (1e-5); trained, the own rows' gradients
    round twice (interior dx and halo dx, each to bf16, then added) where
    one card rounds once, so the logits stay closer to the single-device
    bf16 run than that run is to the float32 one."""
    from plagnn_tpu_torch.utils.precision import set_aggregation_dtype

    g, feats, labels, label_list, loc = _engine_data()
    model = engine.init_fold_model(_engine_cfg(), feats.shape[1], [3, 4], "cpu")
    set_aggregation_dtype("bfloat16")
    try:
        with torch.no_grad():
            want = model(g, torch.from_numpy(feats.astype(np.float32))).numpy()
        _train_single(tmp_path / "bf16")
    finally:
        set_aggregation_dtype("float32")
    _train_single(tmp_path / "f32")
    out = worlds(2) / "bf16"
    for r in range(2):
        got = np.load(out / f"bf16_fwd_{r}.npz")
        real = got["rows"] >= 0
        np.testing.assert_allclose(got["own"][real], want[got["rows"][real]], atol=ATOL,
                                   rtol=0)
    mesh, bf16, f32 = (_artifacts(d)[0] for d in (out, tmp_path / "bf16", tmp_path / "f32"))
    assert sorted(mesh) == sorted(bf16) and len(mesh) == 4
    to_bf16 = max(np.abs(mesh[f] - bf16[f]).max() for f in mesh)
    bf16_to_f32 = max(np.abs(bf16[f] - f32[f]).max() for f in mesh)
    assert to_bf16 < bf16_to_f32, (to_bf16, bf16_to_f32)


def test_cli_torchrun_mesh_matches_single_device(tmp_path):
    """train-normal under torchrun (2 gloo CPU ranks, --mesh graph=2) writes
    the single-device run's artifacts."""
    flags = ["-data", "GSE30931", "-d", "cpu", "-e", "4", "--rounds", "1", "-f", "3",
             "--fold-batch", "3"]
    roots = [str(tmp_path / "single"), str(tmp_path / "mesh")]
    for root in roots:
        cli.main(["synth", "--data-root", root, "--nodes", "200", "--edges", "1200",
                  "--seed", "7"])
    cli.main(["train-normal", "--data-root", roots[0]] + flags)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "plagnn_tpu_torch.cli", "train-normal",
         "--data-root", roots[1], "--mesh", "graph=2"] + flags,
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert r.stdout.count("[round 1/1]") == 1      # rank 0 alone reports
    d = [os.path.join(root, "log", "GSE30931", "normal") for root in roots]
    _assert_same_artifacts(d[1], d[0], 3)
    tsv = [open(os.path.join(x, "log.tsv")).read().splitlines() for x in d]
    assert len(tsv[0]) == len(tsv[1]) > 100
    # the same rows; a predicted label may flip at float32 noise
    assert [row.split("\t")[:5] for row in tsv[0]] == [row.split("\t")[:5] for row in tsv[1]]
    assert sum(a != b for a, b in zip(*tsv)) <= 0.02 * len(tsv[0])


def test_parse_mesh_matches_jax_cases():
    from plagnn_tpu.cli import parse_mesh as jax_parse_mesh

    for spec in ("fold=2,graph=4", "graph=8", "fold=1,graph=1", "fold=3",
                 " fold = 2 , graph = 2 ", "graph=2,"):
        assert cli.parse_mesh(spec) == jax_parse_mesh(spec)
    for spec in ("bogus=3", "fold=0", "fold2", "fold=x", "graph=-1"):
        with pytest.raises(SystemExit):
            jax_parse_mesh(spec)
        with pytest.raises(SystemExit):
            cli.parse_mesh(spec)
    assert cli.parse_mesh("auto") == jax_parse_mesh("auto") == ("auto", None)
    assert cli.parse_mesh("auto:4") == jax_parse_mesh("auto:4") == ("auto", 4)


def _failing_worker(rank, device):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()      # rank 0 waits for the dead rank


def test_spawn_local_fails_with_a_child(tmp_path):
    """The parent raises the first error: rank 1's own, or rank 0's from the
    collective its dead peer left (whichever process the parent sees end
    first); nothing hangs."""
    with pytest.raises(Exception, match=f"rank 1 fails|{PEER_GONE}"):
        spawn_local(_failing_worker, 2, backend="gloo", devices=["cpu"] * 2,
                    rdzv_dir=str(tmp_path), timeout_s=SPAWN_TIMEOUT_S, group_timeout_s=60)


def test_initialize_distributed_single_process_and_backend(monkeypatch):
    """No coordinator and no launcher: a single process, nothing
    initialised (JAX multihost.py:30-35); the backend is always named."""
    import torch.distributed as dist

    from plagnn_tpu_torch.parallel.multihost import initialize_distributed

    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(backend="gloo") == 1
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed(backend="mpi")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="number of processes"):
        initialize_distributed(backend="gloo")
