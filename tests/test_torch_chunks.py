"""The row-chunk tables of the port's graph container (``RowChunks``).

The sum, max-forward and max-backward kernels (``csrc/row_chunks.cuh``)
walk each CSR row in chunks of at most ``row_chunk`` edges and combine a
split row's partials in ascending chunk order.  Here, on the CPU: the
tables' invariants, the split against the JAX package's positional mega-row
split (``build_pallas_graph``), the kernels' traversal replayed in numpy
from the tables against the plain versions (and, for the max forward, the
JAX package's kernel in interpret mode), and the build's rebuild rule for
the shared header.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plagnn_tpu.ops.pallas.spmm_kernels import _run_spmm, build_pallas_graph
from plagnn_tpu_torch.ops import _build
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import ROW_CHUNK, build_graph


def _hub_graph(seed, n=300, e=2000, hub=None):
    """Random edges plus a hub: row 0 takes in-edges from ``hub`` nodes and
    node 0 sends out-edges to as many; the last 30 nodes have no edges."""
    rng = np.random.default_rng(seed)
    live = n - 30
    hub = live - 1 if hub is None else hub
    src = np.concatenate([rng.integers(0, live, e), 1 + np.arange(hub),
                          np.zeros(hub, np.int64)])
    dst = np.concatenate([rng.integers(0, live, e), np.zeros(hub, np.int64),
                          1 + np.arange(hub)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    return pairs[:, 0], pairs[:, 1], n


GRAPHS = {
    "hub": lambda: _hub_graph(0),
    "sparse": lambda: _hub_graph(1, n=200, e=150, hub=5),
    "no-edges": lambda: (np.zeros(0, np.int64), np.zeros(0, np.int64), 50),
}


def _tables(graph):
    return (("fwd", graph.indptr, graph.chunks), ("transpose", graph.t_indptr,
                                                  graph.t_chunks))


@pytest.mark.parametrize("cap", [1, 7, 32, ROW_CHUNK])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_chunk_table_invariants(name, cap):
    src, dst, n = GRAPHS[name]()
    g = build_graph(src, dst, n, add_self_loops=name != "no-edges", row_chunk=cap)
    for _, indptr, ch in _tables(g):
        indptr = indptr.numpy().astype(np.int64)
        row, ptr, slot = ch.row.numpy(), ch.ptr.numpy(), ch.slot.numpy()
        split_row, split_ptr = ch.split_row.numpy(), ch.split_ptr.numpy()
        deg = np.diff(indptr)
        assert ch.cap == cap and ch.n_chunks == len(row) == len(slot) == len(ptr) - 1
        assert all(t.dtype == torch.int32 for t in (ch.row, ch.ptr, ch.slot,
                                                    ch.split_row, ch.split_ptr))
        # every edge in exactly one chunk, in ascending order, of its row
        assert ptr[0] == 0 and ptr[-1] == g.n_edges and (np.diff(ptr) >= 0).all()
        assert (np.diff(row) >= 0).all()
        assert (ptr[:-1] >= indptr[row]).all() and (ptr[1:] <= indptr[row + 1]).all()
        # at most cap edges a chunk; every row, empty ones too, has a chunk
        assert np.diff(ptr).max(initial=0) <= cap
        np.testing.assert_array_equal(np.unique(row), np.arange(g.n_nodes))
        np.testing.assert_array_equal(np.bincount(row, minlength=g.n_nodes),
                                      np.maximum(1, -(-deg // cap)))
        # chunk j of a row starts at rank j * cap (the JAX rule rank // cap)
        first = np.searchsorted(row, row)
        np.testing.assert_array_equal(ptr[:-1] - indptr[row],
                                      (np.arange(len(row)) - first) * cap)
        # split rows: over cap; slots unique, contiguous, in chunk order
        np.testing.assert_array_equal(split_row, np.flatnonzero(deg > cap))
        assert ch.n_split == len(split_row) and ch.n_slots == split_ptr[-1]
        assert (slot[~np.isin(row, split_row)] == -1).all()
        for i, r in enumerate(split_row):
            np.testing.assert_array_equal(
                slot[row == r], np.arange(split_ptr[i], split_ptr[i + 1]))
    moved = g.to("meta")
    assert moved.chunks.row.device.type == "meta"
    assert moved.t_chunks.split_ptr.device.type == "meta"


def _jax_mega_row_edges():
    """The fixture of the JAX package's mega-row test: 90 real nodes (N_pad
    128), rows 3 and 7 with more than 40 in-edges."""
    rng = np.random.default_rng(9)
    # tests/test_pallas_kernels.py's make_graph(rng, n_real=90, e=1000)
    src, dst = rng.integers(0, 90, 1000), rng.integers(0, 90, 1000)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    extra_s = np.concatenate([60 + np.arange(51), 40 + np.arange(46)])
    extra_d = np.concatenate([np.full(51, 3), np.full(46, 7)])
    pairs = np.unique(np.stack([np.concatenate([src, extra_s]),
                                np.concatenate([dst, extra_d])], 1), axis=0)
    return pairs[:, 0], pairs[:, 1], 90


def test_chunk_split_matches_jax_positional_split(monkeypatch):
    """On the fixture of the JAX package's mega-row test, a chunk size of 40
    splits the rows ``build_pallas_graph(positional=True)`` splits at
    ``POS_RANK_CAP = 40``, into as many chunks as it has sub-rows, and chunk
    j holds the edges of rank j*40 ... j*40+39."""
    from plagnn_tpu.ops.pallas import spmm_kernels as K

    cap = 40
    monkeypatch.setattr(K, "POS_RANK_CAP", cap)
    src, dst, _ = _jax_mega_row_edges()
    split = build_pallas_graph(src, dst, 128, rows_per_block=64,
                               positional=True).fwd.split
    g = build_graph(src, dst, 90, row_chunk=cap)
    assert g.n_nodes == 128
    ch = g.chunks
    jax_rows = np.asarray(split.rows)
    np.testing.assert_array_equal(ch.split_row.numpy(), jax_rows)
    np.testing.assert_array_equal(np.diff(ch.split_ptr.numpy()),
                                  (np.asarray(split.subs) >= 0).sum(1))
    row, ptr = ch.row.numpy(), ch.ptr.numpy()
    indptr = g.indptr.numpy()
    for r in jax_rows:
        for j, c in enumerate(np.flatnonzero(row == r)):
            ranks = np.arange(ptr[c], ptr[c + 1]) - indptr[r]
            np.testing.assert_array_equal(
                ranks, np.arange(j * cap, min((j + 1) * cap, indptr[r + 1] - indptr[r])))


def _replay(ch, idx, k, edge_terms, out_dtype):
    """The kernels' traversal in numpy: each chunk sums its edges' terms in
    ascending edge order in float32; a whole row's chunk rounds and stores,
    a split row's chunk stores its partial, and the partials are then added
    in ascending chunk order and rounded once."""
    row, ptr, slot = ch.row.numpy(), ch.ptr.numpy(), ch.slot.numpy()
    out = np.zeros((len(np.unique(row)), k), np.float32)
    partial = np.zeros((ch.n_slots, k), np.float32)
    for c in range(ch.n_chunks):
        acc = np.zeros(k, np.float32)
        for e in range(ptr[c], ptr[c + 1]):
            acc += edge_terms(row[c], int(idx[e]))
        if slot[c] < 0:
            out[row[c]] = acc
        else:
            partial[slot[c]] = acc
    sp = ch.split_ptr.numpy()
    for i, r in enumerate(ch.split_row.numpy()):
        acc = np.zeros(k, np.float32)
        for s in range(sp[i], sp[i + 1]):
            acc += partial[s]
        out[r] = acc
    return torch.from_numpy(out).to(out_dtype)


@pytest.mark.parametrize("cap", [3, 8, ROW_CHUNK])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_replay_of_sum_matches_plain(dtype, transpose, cap):
    """float32: within 1e-5 of the summed magnitudes (another order);
    bfloat16 on small integers: exact."""
    src, dst, n = _hub_graph(2, hub=40)
    g = build_graph(src, dst, n, row_chunk=cap)
    rng = np.random.default_rng(3)
    k = 11
    if dtype == torch.float32:
        x = rng.standard_normal((g.n_nodes, k)).astype(np.float32)
    else:
        x = rng.integers(-8, 9, (g.n_nodes, k)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xf = xt.float().numpy()
    ch, idx = (g.t_chunks, g.t_dst) if transpose else (g.chunks, g.src)
    assert (ch.n_split > 0) == (cap < 40)  # the hub's 40 edges split
    got = _replay(ch, idx.numpy(), k, lambda r, o: xf[o], dtype)
    want = sk.spmm_sum_plain(g, xt, transpose)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        mag = sk.spmm_sum_plain(g, xt.abs(), transpose)
        assert bool(((got - want).abs() <= 1e-5 * mag + 1e-7).all())


@pytest.mark.parametrize("cap", [3, ROW_CHUNK])
def test_chunk_replay_of_max_bwd_matches_plain(cap):
    """dx[s] = sum over s -> n of [arg[n] == s] g[n], replayed over the
    transpose chunks, against the plain backward (float32, another order)."""
    src, dst, n = _hub_graph(4, hub=40)
    g = build_graph(src, dst, n, row_chunk=cap)
    rng = np.random.default_rng(5)
    k = 13
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, k)) * 2) / 2, 0)
    _, arg = sk.spmm_max_fwd_plain(g, torch.from_numpy(x.astype(np.float32)))
    gr = torch.from_numpy(rng.standard_normal((g.n_nodes, k)).astype(np.float32))
    a, gn = arg.numpy().astype(np.int64), gr.numpy()
    got = _replay(g.t_chunks, g.t_dst.numpy(), k,
                  lambda r, o: np.where(a[o] == r, gn[o], np.float32(0)), torch.float32)
    want = sk.spmm_max_bwd_plain(g, gr, arg)
    mag = sk.spmm_max_bwd_plain(g, gr.abs(), arg)
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-7).all())


def _replay_max(ch, idx, xf):
    """The max forward's traversal in numpy: each chunk walks its edges in
    ascending order, takes the first one whatever its value and a later one
    only where it is strictly greater; a whole row's chunk stores (value,
    source), an empty row's 0 and -1; a split row's chunks store partials,
    which are then combined from the first slot on, a later slot taken only
    where strictly greater."""
    row, ptr, slot = ch.row.numpy(), ch.ptr.numpy(), ch.slot.numpy()
    n, k = xf.shape
    out = np.zeros((n, k), np.float32)
    arg = np.full((n, k), -1, np.int64)
    p_val = np.zeros((ch.n_slots, k), np.float32)
    p_src = np.zeros((ch.n_slots, k), np.int64)
    for c in range(ch.n_chunks):
        best = np.zeros(k, np.float32)
        src = np.full(k, -1, np.int64)
        for e in range(ptr[c], ptr[c + 1]):
            v = xf[idx[e]]
            take = np.ones(k, bool) if e == ptr[c] else v > best
            best = np.where(take, v, best)
            src = np.where(take, idx[e], src)
        if slot[c] < 0:
            out[row[c]], arg[row[c]] = best, src
        else:
            p_val[slot[c]], p_src[slot[c]] = best, src
    sp = ch.split_ptr.numpy()
    for i, r in enumerate(ch.split_row.numpy()):
        best, src = p_val[sp[i]].copy(), p_src[sp[i]].copy()
        for s in range(sp[i] + 1, sp[i + 1]):
            take = p_val[s] > best
            best = np.where(take, p_val[s], best)
            src = np.where(take, p_src[s], src)
        out[r], arg[r] = best, src
    return out, arg


def _max_inputs(g, cap, k, seed, neg_inf=True):
    """relu-style ties, plus: column 0 equal everywhere (every row all
    equal); column 1 -inf everywhere (every row all -inf; with ``neg_inf``
    false, 0 everywhere instead); column 2 with the longest row's maximum
    first reached at the first edge of its second chunk (rank ``cap``) and
    tied at the first edge of each later chunk.  Returns x, that row, and
    the source that must win its column 2 (None where the row does not
    split)."""
    rng = np.random.default_rng(seed)
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, k)) * 2) / 2, 0)
    x[:, 0] = 1.5
    x[:, 1] = -np.inf if neg_inf else 0.0
    indptr, src = g.indptr.numpy(), g.src.numpy()
    r = int(np.argmax(np.diff(indptr)))
    ranks = np.arange(cap, indptr[r + 1] - indptr[r], cap)
    x[:, 2] = np.minimum(x[:, 2], 2.0)
    x[src[indptr[r] + ranks], 2] = 5.0
    return x.astype(np.float32), r, int(src[indptr[r] + cap]) if len(ranks) else None


MAX_GRAPHS = {
    "hub": lambda: _hub_graph(6),
    "jax-mega-row": _jax_mega_row_edges,
}


@pytest.mark.parametrize("cap", [1, 3, 8, 40, ROW_CHUNK])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MAX_GRAPHS))
def test_chunk_replay_of_max_fwd_matches_plain(name, dtype, cap):
    """out and arg of the replayed chunk walk bit-exact with the plain
    forward; all-equal and all -inf rows keep their first source, empty
    rows give 0 and -1, and ties across chunks go to the lower chunk."""
    src, dst, n = MAX_GRAPHS[name]()
    g = build_graph(src, dst, n, row_chunk=cap)
    # every graph splits at the small caps; at ROW_CHUNK only the hub does
    assert (g.chunks.n_split > 0) == (cap <= 40 or name == "hub")
    x, r, winner = _max_inputs(g, cap, 9, seed=cap)
    xt = torch.from_numpy(x).to(dtype)
    out, arg = _replay_max(g.chunks, g.src.numpy(), xt.float().numpy())
    want_out, want_arg = sk.spmm_max_fwd_plain(g, xt)
    assert torch.equal(torch.from_numpy(out).to(dtype), want_out)
    assert torch.equal(torch.from_numpy(arg).to(want_arg.dtype), want_arg)
    indptr = g.indptr.numpy()
    live = np.diff(indptr) > 0
    np.testing.assert_array_equal(arg[live, :2], np.repeat(
        g.src.numpy()[indptr[:-1][live], None], 2, axis=1))
    assert (arg[~live] == -1).all() and (out[~live] == 0).all()
    assert (winner is not None) == (g.chunks.n_split > 0)
    if winner is not None:
        assert arg[r, 2] == winner and out[r, 2] == 5.0


@pytest.mark.parametrize("dtype,b", [(jnp.float32, 2), (jnp.bfloat16, 4)])
def test_chunk_replay_of_max_fwd_matches_jax_interpret(dtype, b):
    """At cap 40 on the JAX mega-row fixture, the replayed chunk walk gives
    the JAX kernel's out and argmax (``_run_spmm`` in interpret mode over a
    non-positional ``build_pallas_graph``: argmax as source ids).  Column 1
    is 0, not -inf: the JAX kernel takes a row whose maximum is -inf for an
    empty one (out 0, argmax -1)."""
    src, dst, n = _jax_mega_row_edges()
    g = build_graph(src, dst, n, row_chunk=40)
    pg = build_pallas_graph(src, dst, 128, rows_per_block=64, positional=False)
    x, _, _ = _max_inputs(g, 40, b * 512, seed=41, neg_inf=False)
    xj = jnp.asarray(x.reshape(128, b, 512)).astype(dtype)
    out_j, arg_j = jax.jit(lambda xx: _run_spmm(
        pg.fwd, xx, reduce="max", with_argmax=True, interpret=True))(xj)
    xf = np.asarray(xj.astype(jnp.float32)).reshape(128, -1)
    out, arg = _replay_max(g.chunks, g.src.numpy(), xf)
    np.testing.assert_array_equal(out, np.asarray(out_j.astype(jnp.float32)).reshape(128, -1))
    np.testing.assert_array_equal(arg, np.asarray(arg_j).astype(np.int64).reshape(128, -1))


def test_lib_path_follows_shared_header(tmp_path, monkeypatch):
    """Editing only csrc/row_chunks.cuh changes the library path of every
    source (so a stale library is never loaded); an unchanged tree keeps
    it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert before == {name: _build.lib_path(name) for name in _build.SOURCES}
    header = csrc / "row_chunks.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.lib_path(name) for name in _build.SOURCES}
    for name in _build.SOURCES:
        assert after[name] != before[name]
        assert after[name].parent == before[name].parent
