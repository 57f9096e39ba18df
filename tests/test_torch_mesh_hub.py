"""The hub cache on the mesh (per-shard hubs on each rank's interior pass)
against the JAX package's per-chip hub tables and against the same mesh
runs without the hub, on the CPU.

The hub's tables are exact against JAX's (``HubStream.ids[r][:k]``), and a
run with the hub is bit-identical to the same run without it: the arena
holds copies of the rows, read in the same order, so the aggregation, its
backward and everything downstream are the same bits.  Against the
single-device run a mesh run keeps ``tests/test_torch_parallel.py``'s
tolerance (ATOL, float32 in another reduction order).

Ranks are gloo CPU processes (``parallel.launch.spawn_local``): one world
of 2 ranks runs every task below, each writing into its own directory; the
workers live at module level so the children can unpickle them, and JAX is
imported only inside the tests."""
import json
import os

import numpy as np
import pytest
import torch

from plagnn_tpu_torch import cli
from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
from plagnn_tpu_torch.ops import hub as hub_mod
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.parallel.partition import partition_graph
from plagnn_tpu_torch.parallel.sharded import ShardedMaxAgg, make_mesh
from plagnn_tpu_torch.train import engine
from test_torch_parallel import (
    ATOL, _assert_same_artifacts, _engine_cfg, _engine_data, _spawn, _train_single,
    _world_worker)

HUB_K = 8
# the aggregation checks' graph: a power-law PPI without self-loops, so
# some own rows have no interior in-edge and the interior pass leaves them
# at -inf for the boundary pass to fill
AGG_GRAPH = (600, 5000, 3)
# (fold, graph) meshes of the world of 2 ranks
MESHES = ((1, 2), (2, 1))


def _ppi(n, e, seed):
    ppi = powerlaw_ppi(n, e, seed)
    return ppi.row, ppi.col, n


# ---------------------------------------------------------------------------
# The interior hub tables against JAX's per-chip hubs (host, no ranks).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [HUB_K, 200])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_interior_hub_ids_match_jax(p, balance, k):
    """Each rank's interior ``hub.ids`` / ``t_hub.ids`` equal JAX's
    per-chip ``HubStream.ids[r][:k]`` forward and transpose
    (``pallas_interior``; ``pallas_local`` on a graph axis of size 1, where
    the interior holds every edge); every fetched id is an own row; the
    boundary carries no hub.  k = 200 is more than a P = 4 shard's distinct
    interior sources: the dummy row pads it."""
    from plagnn_tpu.parallel import partition_graph as jax_partition

    src, dst, n = _ppi(600, 5000, 3)
    pg = partition_graph(src, dst, n, p, add_self_loops=True, balance=balance)
    ref = jax_partition(src, dst, n, p, add_self_loops=True, widths=(4, 16, 64),
                        balance=balance, pallas_rows_per_block=8, pallas_hub_k=k,
                        pallas_hub_k_bwd=k)
    jax_hub = ref.pallas_local if p == 1 else ref.pallas_interior
    padded = False
    for r in range(p):
        shard = pg.shard(r, "cpu", k, k)
        g = shard.interior
        assert g.n_nodes == pg.n_pad == jax_hub.fwd.n_pad_nodes
        for got, want in ((g.hub, jax_hub.fwd.hub), (g.t_hub, jax_hub.bwd.hub)):
            np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids)[r][:k])
            assert got.k == k and int(got.ids[:got.n_hub].max()) < pg.own_rows
            assert set(got.ids[got.n_hub:].tolist()) <= {pg.n_pad - 1}
            padded |= got.n_hub < k
        assert shard.boundary.hub is None and shard.boundary.t_hub is None
    assert padded == (k == 200 and p == 4)


def test_shard_without_a_hub_is_unchanged():
    """shard() with no k builds the interior without hub tables; with k
    the same graph plus the tables (same CSR, same chunks)."""
    src, dst, n = _ppi(600, 5000, 3)
    pg = partition_graph(src, dst, n, 2, add_self_loops=True, balance=True)
    plain, hub = pg.shard(1, "cpu"), pg.shard(1, "cpu", 4, 2)
    assert plain.interior.hub is None and plain.interior.t_hub is None
    assert (hub.interior.hub.k, hub.interior.t_hub.k) == (4, 2)
    for name in ("src", "dst", "indptr", "t_dst", "t_indptr"):
        assert torch.equal(getattr(plain.interior, name), getattr(hub.interior, name))
    assert torch.equal(plain.boundary.src, hub.boundary.src)


# ---------------------------------------------------------------------------
# resolve_hub on a mesh, and the shard past 2^15 rows (host, no ranks).
# ---------------------------------------------------------------------------


def test_resolve_hub_on_a_mesh_sizes_at_b_local():
    """On a mesh k is sized at the rank's fold batch, fold_batch //
    mesh_fold (JAX's b_local): at K = 10 x 13 on one device a 1,000-row
    arena halves to 125 (a stage of the max kernels' two), at the fold-only
    mesh's 5 x 13 to 250."""
    g = build_graph(np.arange(5), np.arange(1, 6), 10)
    cfg = dict(hub_cache="1000", fold_batch=10, hidden=(13, 9, 7, 5))
    assert engine.resolve_hub(engine.TrainConfig(**cfg), g, 5) == (125, 125)
    mesh = engine.TrainConfig(mesh_fold=2, **cfg)
    assert engine.resolve_hub(mesh, g, 5, shard_rows=g.n_nodes) == (250, 250) == \
        hub_mod.pick_hub_sizes("1000", 5 * 13, 4)
    assert engine.resolve_hub(engine.TrainConfig(mesh_graph=2, **cfg), g, 5,
                              shard_rows=g.n_nodes) == (125, 125)


def test_shard_past_2_15_rows_takes_an_int32_hub():
    """A shard whose gather space passes 2^15 rows (70,000 nodes in 2
    blocks, few edges) carries the int32 argmax: resolve_hub halves k_bwd
    (its arena holds 4 bytes an element: 64 rows of 1 KB + 1 KB pass a
    stage's 113 KB) where the same k fits with an int16 argmax, and takes
    no 2^15 guard on a mesh.  The shard's interior takes that hub, and its plain
    versions give the same bits with and without it."""
    rng = np.random.default_rng(5)
    n = 70_000
    hot = rng.integers(0, 40, 3000)
    src = np.concatenate([hot, rng.integers(0, n, 3000)])
    dst = rng.integers(0, n, 6000)
    pg = partition_graph(src, dst, n, 2, add_self_loops=True)
    assert pg.n_pad > (1 << 15) and sk.argmax_bytes(pg.n_pad) == 4
    cfg = engine.TrainConfig(hub_cache="128", mesh_graph=2, fold_batch=10)
    kf, kb = engine.resolve_hub(cfg, None, 503, shard_rows=pg.n_pad)
    assert (kf, kb) == (64, 32)
    assert engine.resolve_hub(cfg, None, 503, shard_rows=1 << 15) == (64, 64)
    assert hub_mod.arena_bytes(64, 5030, 4, 4) > hub_mod.stage_budget() \
        >= hub_mod.arena_bytes(32, 5030, 4, 4)
    shard = pg.shard(0, "cpu", kf, kb)
    g = shard.interior
    assert sk.arg_dtype(g) == torch.int32 and g.hub.n_covered > 0
    g0 = pg.shard(0, "cpu").interior
    x = torch.from_numpy(rng.standard_normal((g.n_nodes, 6)).astype(np.float32)).relu_()
    out, arg = sk.spmm_max_fwd(g, x, empty_value=-np.inf)
    out0, arg0 = sk.spmm_max_fwd(g0, x, empty_value=-np.inf)
    assert torch.equal(out.view(torch.int32), out0.view(torch.int32))
    assert torch.equal(arg, arg0) and arg.dtype == torch.int32
    assert bool(torch.isneginf(out[g.in_degree == 0]).all())
    gr = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    assert torch.equal(sk.spmm_max_bwd(g, gr, arg).view(torch.int32),
                       sk.spmm_max_bwd(g0, gr, arg0).view(torch.int32))


def test_checkpoint_refuses_a_change_of_hub_on_a_mesh():
    """A mesh run's checkpoint fingerprint keeps hub_cache, so a resume
    across a change of hub is refused, as on one device."""
    saved = engine._checkpoint_fingerprint(engine.TrainConfig(hub_cache="8", mesh_fold=2,
                                                              mesh_graph=2))
    now = engine._checkpoint_fingerprint(engine.TrainConfig(hub_cache="off", mesh_fold=2,
                                                            mesh_graph=2))
    assert saved["hub_cache"] == "8" and saved["mesh_fold"] == 2
    with pytest.raises(ValueError, match="hub_cache"):
        engine._check_checkpoint_config("ckpt_a0_j0.npz", saved, now)


# ---------------------------------------------------------------------------
# The world of 2 gloo ranks.
# ---------------------------------------------------------------------------


def _bits(t):
    return t.detach().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _agg_worker(rank, device, out_dir, k):
    """The sharded max aggregation, forward and backward, f32 and bf16, at
    each mesh of MESHES, with a hub of k rows and without: the output's and
    dx's bits, the interior pass's -inf partial maxima, and which graphs
    the max wrappers ran with a hub (every call recorded)."""
    calls = []
    fwd, bwd = sk.spmm_max_fwd, sk.spmm_max_bwd

    def rec_fwd(graph, x, with_argmax=True, empty_value=0.0, **kw):
        calls.append(("fwd", graph.n_edges, graph.hub is not None, float(empty_value)))
        return fwd(graph, x, with_argmax, empty_value, **kw)

    def rec_bwd(graph, g, arg, **kw):
        calls.append(("bwd", graph.n_edges, graph.t_hub is not None, 0.0))
        return bwd(graph, g, arg, **kw)

    sk.spmm_max_fwd, sk.spmm_max_bwd = rec_fwd, rec_bwd
    try:
        src, dst, n = _ppi(*AGG_GRAPH)
        res = {}
        for fold, graph in MESHES:
            mesh = make_mesh(graph, fold)
            pg = partition_graph(src, dst, n, graph, balance=graph > 1)
            for kk in (0, k):
                shard = pg.shard(mesh.graph_index, device, kk, kk)
                tag = f"f{fold}g{graph}_k{kk}"
                res[f"{tag}_edges"] = np.array([shard.interior.n_edges,
                                                shard.boundary.n_edges])
                if kk:
                    res[f"{tag}_covered"] = np.array([shard.interior.hub.n_covered,
                                                      shard.interior.t_hub.n_covered])
                for dt in (torch.float32, torch.bfloat16):
                    gen = torch.Generator().manual_seed(100 * rank + 10 * fold + graph)
                    x = torch.round(torch.randn((pg.own_rows, 3, 5), generator=gen) * 4) / 4
                    x = x.relu_().to(dt).requires_grad_(True)
                    gr = torch.randn((pg.own_rows, 3, 5), generator=gen).to(dt)
                    del calls[:]
                    y = ShardedMaxAgg(shard, mesh)(x)
                    y.backward(gr)
                    name = f"{tag}_{'f32' if dt == torch.float32 else 'bf16'}"
                    res[f"{name}_out"], res[f"{name}_dx"] = _bits(y), _bits(x.grad)
                    res[f"{name}_calls"] = np.array(
                        [(d == "fwd", e, h, v) for d, e, h, v in calls], np.float64)
                    # the interior pass alone: -inf where an own row has no
                    # interior in-edge, the halo slots and the padding
                    pad = torch.zeros((shard.n_nodes, 15), dtype=dt)
                    pad[:pg.own_rows] = x.detach().reshape(pg.own_rows, -1)
                    part, arg = sk.spmm_max_fwd(shard.interior, pad, empty_value=-np.inf)
                    res[f"{name}_interior"], res[f"{name}_arg"] = _bits(part), arg.numpy()
                    rows = torch.isneginf(part.float()).all(1)
                    res[f"{name}_neginf"] = np.array([int(rows[:pg.own_rows].sum()),
                                                      int(rows.sum())])
        np.savez(os.path.join(out_dir, f"agg_{rank}.npz"), **res)
    finally:
        sk.spmm_max_fwd, sk.spmm_max_bwd = fwd, bwd


def _train_worker(rank, device, out_dir, fold, graph, hub_cache):
    g, feats, labels, label_list, loc = _engine_data()
    engine.train(g, feats, labels, label_list, loc,
                 _engine_cfg(mesh_fold=fold, mesh_graph=graph, hub_cache=hub_cache),
                 out_dir + os.sep, device_name=str(device))


def _train_tasks():
    return [(f"train_f{f}g{g}_{hub}", _train_worker, (f, g, hub))
            for f, g in MESHES for hub in ("off", str(HUB_K))]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The directory of the world of 2 ranks that ran every task; task
    ``name`` wrote into its subdirectory ``name``."""
    root = tmp_path_factory.mktemp("mesh_hub")
    tasks = []
    for name, fn, args in [("agg", _agg_worker, (HUB_K,))] + _train_tasks():
        (root / name).mkdir()
        tasks.append((fn, (str(root / name), *args)))
    _spawn(_world_worker, 2, root, tasks)
    return root


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fold,graph", MESHES)
def test_sharded_aggregation_with_hub_bit_equal(world2, fold, graph, dtype):
    """On gloo ranks, the sharded max aggregation and its backward give the
    same bits with the hub as without it, and so does the interior pass
    with its -inf rows; the hub covers edges; the interior pass (the local
    pass at graph=1) runs forward and backward with the hub, the boundary
    pass without it."""
    for r in range(2):
        got = np.load(world2 / "agg" / f"agg_{r}.npz")
        a, b = f"f{fold}g{graph}_k0_{dtype}", f"f{fold}g{graph}_k{HUB_K}_{dtype}"
        for part in ("out", "dx", "interior", "arg"):
            np.testing.assert_array_equal(got[f"{b}_{part}"], got[f"{a}_{part}"],
                                          err_msg=f"rank {r} {part}")
        own, every = got[f"{b}_neginf"]
        assert every > 0 and (got[f"{b}_arg"] == -1).any()
        assert own > 0 or graph == 1    # own rows fed by remote sources only
        assert got[f"f{fold}g{graph}_k{HUB_K}_covered"].min() > 0
        interior, boundary = got[f"f{fold}g{graph}_k{HUB_K}_edges"]
        calls = got[f"{b}_calls"]
        passes = 1 if graph == 1 else 2
        assert len(calls) == 2 * passes
        for is_fwd, n_edges, has_hub, empty in calls:
            assert n_edges in (interior, boundary)
            assert bool(has_hub) == (n_edges == interior), (is_fwd, n_edges)
            if is_fwd:
                assert empty == (-np.inf if graph > 1 else 0.0)
        assert not got[f"{a}_calls"][:, 2].any()


@pytest.mark.parametrize("fold,graph", MESHES)
def test_train_on_a_mesh_with_hub_byte_identical(world2, tmp_path, fold, graph):
    """train() with hub_cache="8" on gloo ranks writes every file of the
    same mesh run with "off" byte for byte, and stays within the mesh
    tests' tolerance of the single-device run."""
    got, off = (world2 / f"train_f{fold}g{graph}_{h}" for h in (str(HUB_K), "off"))
    names = sorted(os.listdir(off))
    assert sorted(os.listdir(got)) == names and "log.tsv" in names
    for f in names:
        assert (got / f).read_bytes() == (off / f).read_bytes(), f
    _train_single(tmp_path / "single")
    _assert_same_artifacts(got, tmp_path / "single", 4)


def test_cli_mesh_with_hub_cache(tmp_path, capfd):
    """``train-normal --mesh fold=1,graph=2 --hub-cache 8 -d cpu`` (2 gloo
    ranks) prints the resolved k once and writes the files of the same run
    with ``--hub-cache off`` byte for byte."""
    logs = {}
    for hub in (str(HUB_K), "off"):
        root = str(tmp_path / hub)
        cli.main(["synth", "--data-root", root, "--nodes", "200", "--edges", "1200",
                  "--seed", "7"])
        capfd.readouterr()
        cli.main(["train-normal", "-data", "GSE30931", "--data-root", root, "-d", "cpu",
                  "-e", "3", "--rounds", "1", "-f", "3", "--fold-batch", "3",
                  "--mesh", "fold=1,graph=2", "--hub-cache", hub])
        out = capfd.readouterr().out
        want = (f"k_fwd={HUB_K} k_bwd={HUB_K}" if hub != "off" else "k_fwd=0 k_bwd=0")
        assert out.count(f"hub cache: {want} (hub_cache='{hub}')") == 1, out
        logs[hub] = os.path.join(root, "log", "GSE30931", "normal")
    names = sorted(os.listdir(logs["off"]))
    assert sorted(os.listdir(logs[str(HUB_K)])) == names and len(names) > 3
    for f in names:
        with open(os.path.join(logs["off"], f), "rb") as a, \
                open(os.path.join(logs[str(HUB_K)], f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(logs["off"], "fig_data_1.json")) as fh:
        assert json.load(fh)["validation"]
