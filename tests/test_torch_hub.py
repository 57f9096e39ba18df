"""The hub cache of the port (``graph_format.HubTable``, ``ops/hub.py``, the
hub paths of ``ops/spmm_kernels.py``, ``TrainConfig.hub_cache``,
``--hub-cache``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  Tolerances: the hub's tables and
every plain version with the hub are exact (bit-equal to the same without
the hub: the arena holds copies of the rows, read in the same order);
against the JAX kernels in interpret mode the forward is exact, dx within
1e-5 in float32 (the JAX hub changes its own add order,
``plagnn_tpu/train/engine.py:413``) and equal in bfloat16 on integer
cotangents, the sums exact on integer-valued inputs (reassociation-proof,
as ``tests/test_pallas_kernels.py``'s hub sum test has them).
"""
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu import cli as jax_cli
from plagnn_tpu.ops.pallas.spmm_kernels import (
    _run_spmm,
    build_blocked_csr,
    build_pallas_graph,
    pallas_spmm_max,
    pallas_spmm_sum,
    pick_hub_sizes as jax_pick_hub_sizes,
)
from plagnn_tpu_torch import cli
from plagnn_tpu_torch.data.synthetic import synthetic_dataset
from plagnn_tpu_torch.ops import hub as hub_mod
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo, pad_features
from plagnn_tpu_torch.train import engine
from plagnn_tpu_torch.train.engine import TrainConfig, train

N_REAL, N_PAD = 200, 256
DX_ATOL = 1e-5   # tests/test_torch_spmm.py's float32 dx tolerance


def _hub_graph(rng, n_real=N_REAL, e=3000, n_hot=5, frac=0.3):
    """tests/test_pallas_kernels.py's fixture: a random graph with a few hot
    sources, so the hub is non-trivial."""
    src = rng.integers(0, n_real, e)
    dst = rng.integers(0, n_real, e)
    hot = rng.integers(0, n_hot, e)
    src = np.where(rng.random(e) < frac, hot, src)
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _tie_heavy(rng, n_pad, b, f):
    """tests/test_pallas_kernels.py's fixture: relu'd values on a coarse
    grid, so cross-row ties are common."""
    x = np.maximum(rng.standard_normal((n_pad, b, f)), 0)
    return ((x * 4).round() / 4).astype(np.float32)


def _graphs(seed=7, k=8, row_chunk=8):
    """(edges, the port's graph without and with a hub of k rows on both
    directions), chunks of ``row_chunk`` edges so rows split."""
    src, dst = _hub_graph(np.random.default_rng(seed))
    g0 = build_graph(src, dst, N_REAL, row_chunk=row_chunk)
    return (src, dst), g0, build_graph(src, dst, N_REAL, row_chunk=row_chunk,
                                       hub_k=k, hub_k_bwd=k)


@pytest.mark.parametrize("k", [8, 300])
def test_hub_tables_match_jax(k):
    """ids equal JAX's HubStream.ids[:k] forward and transpose (k = 300 is
    more than the 200 distinct sources: dummy-padded); the coded index
    decodes to the direction's neighbours."""
    (src, dst), g0, gh = _graphs(k=k)
    for hub, nbr, (a, b) in ((gh.hub, g0.src, (src, dst)), (gh.t_hub, g0.t_dst, (dst, src))):
        jax_ids = np.asarray(build_blocked_csr(a, b, N_PAD, rows_per_block=64,
                                               hub_k=k).hub.ids)[:k]
        np.testing.assert_array_equal(hub.ids.numpy(), jax_ids)
        assert hub.k == k and hub.n_hub == min(k, len(np.unique(a)))
        idx = hub.idx.numpy().astype(np.int64)
        on = idx < 0
        decoded = np.where(on, hub.ids.numpy()[np.maximum(-1 - idx, 0)], idx)
        np.testing.assert_array_equal(decoded, nbr.numpy())
        assert on.sum() == hub.n_covered > 0
        assert set(np.unique(-1 - idx[on])) <= set(range(hub.n_hub))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_with_hub_bit_equal(dtype):
    """Every plain version reading the arena equals itself without the hub,
    bit for bit: max out and argmax, max dx, the sum forward and transpose
    (split rows included: chunks of 8 edges)."""
    _, g0, gh = _graphs()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_tie_heavy(rng, g0.n_nodes, 3, 13).reshape(g0.n_nodes, -1)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dtype)
    out0, arg0 = sk.spmm_max_fwd(g0, x)
    outh, argh = sk.spmm_max_fwd(gh, x)
    assert torch.equal(out0.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       outh.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(arg0, argh)
    assert torch.equal(sk.spmm_max_bwd(g0, g, arg0), sk.spmm_max_bwd(gh, g, arg0))
    for transpose in (False, True):
        assert torch.equal(sk.spmm_sum_rows(g0, g, transpose),
                           sk.spmm_sum_rows(gh, g, transpose))
    # the weighted sum takes no hub: the same graph with values is unchanged
    assert sk.LAUNCHES["spmm_max_fwd_hub_f32"] == 0   # no kernel on the CPU


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_hub_max_matches_jax_interpret(dt):
    """pallas_spmm_max with hub_k = hub_k_bwd = 8 in interpret mode (the JAX
    kernel's hub stream and tie rule) against the port's hub plain
    versions: out and argmax exact; dx within 1e-5 in float32, equal in
    bfloat16 on integer cotangents.  B x F = 2 x 512 in float32, 2 x 1024
    in bfloat16 (the JAX kernel's bf16 tile)."""
    src, dst = _hub_graph(np.random.default_rng(8))
    pg = build_pallas_graph(src, dst, N_PAD, rows_per_block=64, hub_k=8, hub_k_bwd=8)
    gh = build_graph(src, dst, N_REAL, hub_k=8, hub_k_bwd=8)
    rng = np.random.default_rng(9)
    x = _tie_heavy(rng, N_PAD, 2, 512 if dt == jnp.float32 else 1024)
    if dt == jnp.float32:
        w = rng.standard_normal(x.shape).astype(np.float32)
    else:
        w = rng.integers(1, 9, x.shape).astype(np.float32)
    xj = jnp.asarray(x).astype(dt)
    out_j, arg_j = jax.jit(lambda xx: _run_spmm(
        pg.fwd, xx, reduce="max", with_argmax=True, interpret=True))(xj)
    dx_j = jax.jit(jax.grad(lambda xx: jnp.sum(
        pallas_spmm_max(pg, xx.astype(dt), interpret=True).astype(jnp.float32) * w)))(
            jnp.asarray(x))

    tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
    xt = torch.from_numpy(x.reshape(N_PAD, -1))
    out_p, arg_p = sk.spmm_max_fwd(gh, xt.to(tdt))
    np.testing.assert_array_equal(out_p.float().numpy().reshape(x.shape),
                                  np.asarray(out_j.astype(jnp.float32)))
    np.testing.assert_array_equal(arg_p.numpy().reshape(x.shape), np.asarray(arg_j))
    xt.requires_grad_(True)
    y_p = sk.spmm_max(gh, xt.to(tdt)).float()
    (y_p * torch.from_numpy(w.reshape(N_PAD, -1))).sum().backward()
    dx_p = xt.grad.numpy().reshape(x.shape)
    if dt == jnp.float32:
        np.testing.assert_allclose(dx_p, np.asarray(dx_j), rtol=0, atol=DX_ATOL)
    else:
        np.testing.assert_array_equal(dx_p, np.asarray(dx_j))


@pytest.mark.parametrize("hub_cache", ["8", "128", "226"])
def test_hub_sum_matches_jax_interpret(hub_cache):
    """pallas_spmm_sum in interpret mode, forward and VJP, against the
    port's hub sum on integer-valued inputs: exact, with both hubs at the k
    the two-stage sizing gives at K = 1,024 (8, and 128 / 226 halved to 64
    / 113 rows of 1 KB)."""
    k, k_bwd = hub_mod.pick_hub_sizes(hub_cache, 1024, 4, 0)
    assert k == k_bwd == {"8": 8, "128": 64, "226": 113}[hub_cache]
    rng = np.random.default_rng(10)
    src, dst = _hub_graph(rng)
    pg = build_pallas_graph(src, dst, N_PAD, rows_per_block=64, hub_k=k, hub_k_bwd=k)
    gh = build_graph(src, dst, N_REAL, hub_k=k, hub_k_bwd=k)
    x = rng.integers(-4, 5, (N_PAD, 2, 512)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda xx: pallas_spmm_sum(pg, xx, interpret=True), jnp.asarray(x))
    (dx_j,) = vjp(y_j)
    xt = torch.tensor(x.reshape(N_PAD, -1), requires_grad=True)
    y_p = sk.spmm_sum(gh, xt)
    y_p.backward(y_p.detach())
    np.testing.assert_array_equal(y_p.detach().numpy().reshape(x.shape), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy().reshape(x.shape), np.asarray(dx_j))


def test_positional_and_mesh_refuse_a_hub():
    src, dst = _hub_graph(np.random.default_rng(1))
    with pytest.raises(ValueError, match="positional"):
        build_graph(src, dst, N_REAL, positional=True, hub_k=8)
    with pytest.raises(ValueError, match="positional"):
        build_graph(src, dst, N_REAL, positional=True).with_hub(0, 4)
    assert build_graph(src, dst, N_REAL, positional=True).with_hub(0, 0).hub is None
    # past 2^15 nodes the id-based form takes a hub, as JAX's does
    big = build_graph(np.array([40000, 5, 7]), np.array([3, 3, 40000]), 40001,
                      positional=False, hub_k=2)
    assert big.hub.ids.tolist() == [5, 7] and big.t_hub is None
    g = build_graph(src, dst, N_REAL)
    # a mesh, fold-only included, takes the hub on its shards' interior
    # passes, sized on a shard's gather space; "auto" stays 0 there too
    for mesh in ({"mesh_graph": 2}, {"mesh_fold": 2}):
        assert engine.resolve_hub(TrainConfig(hub_cache="8", **mesh), g, 5,
                                  shard_rows=g.n_nodes) == (8, 8)
        assert engine.resolve_hub(TrainConfig(hub_cache="auto", **mesh), g, 5,
                                  shard_rows=g.n_nodes) == (0, 0)
        with pytest.raises(ValueError, match="shard_rows"):
            engine.resolve_hub(TrainConfig(hub_cache="8", **mesh), g, 5)
    # the JAX engine's guard: no hub past 2^15 padded nodes on one device
    assert engine.resolve_hub(TrainConfig(hub_cache="8"), big, 5) == (0, 0)
    assert engine.resolve_hub(TrainConfig(hub_cache="8"), g, 5) == (8, 8)


def test_pick_hub_sizes_values_and_halving():
    """The accepted values (JAX's off family gives (0, 0) in both), auto
    0 in both directions, dtypes and argmax sizes (the hub lost everywhere
    it was measured), and the halving at a wide K: an arena row is
    1 KB forward, 1 KB + 512 bytes (int16 argmax) in the max backward in
    float32, 1 KB both ways in the sum (no argmax), narrower at a narrow K;
    every hub kernel's budget a stage is half a block's 227 KB less 1 KB
    (two stages)."""
    for off in ("off", "0", 0, None):
        assert hub_mod.pick_hub_sizes(off, 5030, 4) == (0, 0) == jax_pick_hub_sizes(off, 5030, 4)
    for esize in (4, 2):
        for arg_size in (2, 0):
            assert hub_mod.pick_hub_sizes("auto", 5030, esize, arg_size) == (0, 0)
    assert hub_mod.pick_hub_sizes("8", 5030, 4) == hub_mod.pick_hub_sizes(8, 5030, 4) == (8, 8)
    # 1000 rows: 1000 KB forward, 1500 KB backward -> halved to fit 113 KB
    assert hub_mod.pick_hub_sizes("1000", 5030, 4) == (62, 62)
    assert hub_mod.arena_bytes(62, 5030, 4, 2) == 95_232 <= hub_mod.stage_budget()
    assert hub_mod.pick_hub_sizes("226", 5030, 4) == (113, 56)
    assert hub_mod.pick_hub_sizes("128", 5030, 2) == (64, 32)   # bf16: 2 KB rows backward
    assert hub_mod.pick_hub_sizes("512", 120, 4) == (128, 128)  # K = 120: 480-byte rows
    # the sum's two stages (no argmax): k halves as the max forward's does
    assert hub_mod.pick_hub_sizes("1000", 5030, 4, 0) == (62, 62)
    assert hub_mod.pick_hub_sizes("128", 4000, 4, 0) == (64, 64)   # GCN2 conv1
    assert hub_mod.pick_hub_sizes("512", 120, 4, 0) == (128, 128)
    assert hub_mod.pick_hub_sizes("114", 4000, 2, 0) == (57, 57)
    assert hub_mod.arena_stride(120, 4) == 120 and hub_mod.arena_stride(5030, 2) == 512
    assert hub_mod.HUB_SMEM_BYTES == 231_424 and hub_mod.stage_budget() == 115_712
    with pytest.raises(ValueError):
        hub_mod.pick_hub_sizes("-1", 5030, 4)


# The largest (k_fwd, k_bwd) a stage of the pipelined max arena holds at
# K = 5,030 / 4,000 / 3,000 by (message bytes, argmax bytes): 1 KB rows
# forward; backward 1.5 KB in float32 with an int16 argmax, 2 KB with an
# int32 one or in bfloat16 (512 elements of 2 + 2 bytes), 3 KB in bfloat16
# with an int32 argmax (512 x (2 + 4)).
STAGE_FITS = {(4, 2): (113, 75), (4, 4): (113, 56), (2, 2): (113, 56), (2, 4): (113, 37)}


@pytest.mark.parametrize("arg_size", [2, 4])
@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("k_width", [5030, 4000, 3000])
def test_two_stage_sizing(k_width, esize, arg_size):
    """At each layer's K, message size and argmax: the largest k whose
    stage fits half the budget is kept as asked and one more is halved;
    the halving from 128 and 226; the sum's stages (no argmax) hold the
    forward's rows both ways."""
    kf, kb = STAGE_FITS[esize, arg_size]
    budget = hub_mod.stage_budget()
    assert hub_mod.arena_bytes(kf, k_width, esize) <= budget
    assert hub_mod.arena_bytes(kf + 1, k_width, esize) > budget
    assert hub_mod.arena_bytes(kb, k_width, esize, arg_size) <= budget
    assert hub_mod.arena_bytes(kb + 1, k_width, esize, arg_size) > budget
    pick = hub_mod.pick_hub_sizes
    assert pick(str(kf), k_width, esize, arg_size)[0] == kf
    assert pick(str(kb), k_width, esize, arg_size)[1] == kb
    assert pick(str(kf + 1), k_width, esize, arg_size)[0] == (kf + 1) // 2
    assert pick(str(kb + 1), k_width, esize, arg_size)[1] == (kb + 1) // 2
    assert pick("128", k_width, esize, arg_size) == (64, 64 if kb >= 64 else 32)
    assert pick("226", k_width, esize, arg_size) == (113, 56 if kb >= 56 else 28)
    assert pick("226", k_width, esize, 0) == (113, 113) == (kf, kf)


@pytest.mark.parametrize("agg,esize", [(None, 4), ("bfloat16", 2)])
@pytest.mark.parametrize("model", ["gnn32", "gcn2"])
def test_resolve_hub_takes_auto_policy(model, agg, esize, monkeypatch):
    """resolve_hub's ``"auto"`` takes no hub for GNN32 (either message
    size) or GCN2, on one card, on a mesh (fold-only too), and past 2^15
    padded nodes on one card."""
    from plagnn_tpu_torch.utils import precision

    monkeypatch.setattr(precision, "_AGG_DTYPE", None if agg is None else torch.bfloat16)
    src, dst = _hub_graph(np.random.default_rng(2))
    g = build_graph(src, dst, N_REAL)
    cfg = dict(hub_cache="auto", model=model, fold_batch=10)
    assert engine.resolve_hub(TrainConfig(**cfg), g, 503) == (0, 0)
    for mesh in ({"mesh_graph": 2}, {"mesh_fold": 2}):
        assert engine.resolve_hub(TrainConfig(**cfg, **mesh), g, 503,
                                  shard_rows=g.n_nodes) == (0, 0)
    big = build_graph(np.array([40000, 5, 7]), np.array([3, 3, 40000]), 40001,
                      positional=False)
    assert engine.resolve_hub(TrainConfig(**cfg), big, 503) == (0, 0)


# GCN2's hub sizes at its conv1 width (10 folds x min(503, 400) = 4,000
# float32 elements, 1 KB rows both ways, no argmax) by hub_cache
GCN2_HUB_SIZES = {"8": (8, 8), "113": (113, 113), "114": (57, 57), "128": (64, 64),
                  "1000": (62, 62)}


@pytest.mark.parametrize("mesh", [None, "graph", "fold"])
@pytest.mark.parametrize("hub_cache", sorted(GCN2_HUB_SIZES))
def test_resolve_hub_gcn2_two_stage_sizes(hub_cache, mesh):
    """resolve_hub for GCN2: the sum's two stages at its widths, the same
    k both ways (the VJP's arena holds no argmax, so a shard past 2^15
    rows halves nothing more); a fold-only mesh sizes at its fold batch of
    5 (2,000 elements: 1 KB rows again, the same k)."""
    src, dst = _hub_graph(np.random.default_rng(3))
    g = build_graph(src, dst, N_REAL)
    cfg = dict(hub_cache=hub_cache, model="gcn2", fold_batch=10)
    if mesh is None:
        got = engine.resolve_hub(TrainConfig(**cfg), g, 503)
    else:
        kw = {"mesh_graph": 2} if mesh == "graph" else {"mesh_fold": 2}
        got = engine.resolve_hub(TrainConfig(**cfg, **kw), g, 503, shard_rows=40_000)
    assert got == GCN2_HUB_SIZES[hub_cache]
    assert got == hub_mod.pick_hub_sizes(hub_cache, 4000, 4, 0)


def _train_bundle(tmp_dir, **cfg_kw):
    """3 epochs x 2 folds of GNN32 on the 512-node synthetic bundle;
    returns every artifact's bytes."""
    ppi, feats, loc, label_list = synthetic_dataset(n_nodes=512, n_edges=4000, seed=70)
    graph = from_scipy_coo(ppi, add_self_loops=True)
    kw = dict(lr=1e-3, fold_num=2, epoch_num=3, fold_batch=2, fold_seeds=(12,),
              hidden=(13, 9, 7, 5), verbose=False)
    kw.update(cfg_kw)
    train(graph, pad_features(feats, graph.n_nodes), pad_features(loc, graph.n_nodes),
          label_list, loc, TrainConfig(**kw), str(tmp_dir) + "/", device_name="cpu")
    return {f: open(os.path.join(tmp_dir, f), "rb").read()
            for f in sorted(os.listdir(tmp_dir))}


@pytest.mark.parametrize("model", ["gnn32", "gcn2"])
def test_train_with_hub_bit_identical(tmp_path, model):
    """train(hub_cache=8) writes the artifacts of hub_cache="off", log.tsv
    and the logits included, byte for byte."""
    ref = _train_bundle(tmp_path / "off", model=model, hub_cache="off")
    got = _train_bundle(tmp_path / "hub", model=model, hub_cache="8")
    assert set(got) == set(ref) and "log.tsv" in ref and "1_2_loc_logits.npy" in ref
    for f in ref:
        assert got[f] == ref[f], f


def test_resume_refuses_a_change_of_hub_cache(tmp_path):
    """A mid-round checkpoint written under one hub_cache is refused under
    another, as the JAX package's fingerprint refuses it."""
    calls = []

    def bomb(r, a, c0, done):
        calls.append(done)
        raise RuntimeError("injected crash")

    with pytest.raises(RuntimeError, match="injected crash"):
        _train_bundle(tmp_path, hub_cache="off", checkpoint_every=2, chunk_callback=bomb)
    assert os.path.exists(tmp_path / "ckpt_a0_j0.npz")
    with pytest.raises(ValueError, match="hub_cache"):
        _train_bundle(tmp_path, hub_cache="8", checkpoint_every=2)
    assert engine._checkpoint_fingerprint(TrainConfig(hub_cache="8"))["hub_cache"] == "8"


def test_cli_hub_cache_flag(tmp_path, capfd):
    """--hub-cache parses (the resolved k is in the run's log), an invalid
    value exits with the JAX CLI's message, and ``--mesh auto:2`` takes it
    (2 gloo ranks; rank 0 prints the resolved k, and the planner's note
    that its plan models no hub)."""
    root = str(tmp_path)
    cli.main(["synth", "--data-root", root, "--nodes", "256", "--edges", "1500",
              "--seed", "7"])
    flags = ["-data", "GSE30931", "--data-root", root, "-d", "cpu", "-e", "2",
             "--rounds", "1", "-f", "2", "--fold-batch", "2"]
    cli.main(["train-normal", "--hub-cache", "16"] + flags)
    assert "hub cache: k_fwd=16 k_bwd=16 (hub_cache='16')" in capfd.readouterr().out
    for bad in ("abc", "-3"):
        with pytest.raises(SystemExit) as ours:
            cli.main(["train-normal", "--hub-cache", bad] + flags)
        with pytest.raises(SystemExit) as theirs:
            jax_cli.main(["train-normal", "--hub-cache", bad, "-data", "GSE30931",
                          "--data-root", root, "-e", "1", "--rounds", "1", "-f", "2"])
        assert str(ours.value) == str(theirs.value) == (
            f"invalid --hub-cache {bad!r}: expected 'auto', 'off', or an integer k")
    shutil.rmtree(os.path.join(root, "log"))     # else the run resumes past round 1
    capfd.readouterr()
    cli.main(["train-normal", "--hub-cache", "8", "--mesh", "auto:2"] + flags)
    out = capfd.readouterr().out
    assert "the plan models the aggregation without the hub cache" in out
    assert out.count("hub cache: k_fwd=8 k_bwd=8 (hub_cache='8')") == 1
    assert out.count("[round 1/1]") == 1
    assert os.path.exists(os.path.join(root, "log", "GSE30931", "normal",
                                       "1_2_loc_logits.npy"))
