"""The positional argmax and the big-graph path against the JAX package.

Past 2^15 padded nodes both packages record the max's argmax as a rank
within the destination row, int16 at any node count
(``build_pallas_graph(positional=None)``, the port's ``build_graph``).
The port keeps a mega row's segment (rank // POS_RANK_CAP) in a side
table where the JAX package moves the row to sub-rows, so the argmax
itself differs between them; out and dx must not.  Inputs are made with
numpy from a seed; small integers keep every sum exact, so out and dx are
compared exactly.  On the CPU the port runs the kernels' plain versions;
numpy replays of the CUDA kernels' positional traversal hold them to the
same rules.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from plagnn_tpu.data import synthetic as jax_synth
from plagnn_tpu.ops import build_graph as jax_build_graph
from plagnn_tpu.ops import from_scipy_coo as jax_from_scipy_coo
from plagnn_tpu.ops import pad_features
from plagnn_tpu.ops.pallas import spmm_kernels as K
from plagnn_tpu.ops.pallas.spmm_kernels import build_pallas_graph, pallas_spmm_max
from plagnn_tpu.ops.spmm import spmm_max as jax_spmm_max
from plagnn_tpu.train import engine as jax_engine
from plagnn_tpu_torch.models.batched import BatchedGNN32
from plagnn_tpu_torch.models.convert import params_from_jax
from plagnn_tpu_torch.ops import graph_format as gf
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph, from_scipy_coo
from plagnn_tpu_torch.parallel.partition import partition_graph
from plagnn_tpu_torch.train import engine, kfold, losses


def _make_graph(rng, n_real, e):
    """tests/test_pallas_kernels.py's make_graph."""
    src = rng.integers(0, n_real, e)
    dst = rng.integers(0, n_real, e)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _mega_row_edges():
    """The fixture of tests/test_pallas_kernels.py::test_positional_mega_row_split:
    90 real nodes (N_pad 128), rows 3 and 7 with more than 40 in-edges."""
    rng = np.random.default_rng(9)
    src, dst = _make_graph(rng, 90, 1000)
    src = np.concatenate([src, 60 + np.arange(51), 40 + np.arange(46)])
    dst = np.concatenate([dst, np.full(51, 3), np.full(46, 7)])
    pairs = np.unique(np.stack([src, dst], 1), axis=0)
    return pairs[:, 0], pairs[:, 1], rng


def _jax_out_grad(pg, x):
    """out and d sum(out^2) / dx of the JAX Pallas kernels (interpret
    mode), in float32."""
    def f(xx):
        return pallas_spmm_max(pg, xx, interpret=True).astype(jnp.float32)

    out = np.asarray(f(x))
    dx = np.asarray(jax.grad(lambda xx: jnp.sum(f(xx) ** 2))(x).astype(jnp.float32))
    return out, dx


def _port_out_grad(graph, x_np, dtype):
    """The port's out and d sum(out^2) / dx through SpmmMax (plain
    versions), in float32, and the argmax its forward saved."""
    x = torch.tensor(x_np, dtype=dtype, requires_grad=True)
    saved = []

    def pack(t):
        if not t.is_floating_point():
            saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = sk.spmm_max(graph, x).float()
    (y ** 2).sum().backward()
    return y.detach().numpy(), x.grad.float().numpy(), saved


@pytest.mark.parametrize("dt,b", [(jnp.float32, 2), (jnp.bfloat16, 4)])
def test_positional_matches_jax_pallas_routing(dt, b):
    """(a) tests/test_pallas_kernels.py::test_positional_argmax_routing's
    fixture (N_pad 128, f = 512): out and the gradient of sum(out^2) equal
    the JAX Pallas kernels' on a positional graph, and the port's own
    id-based graph's."""
    rng = np.random.default_rng(11)
    src, dst = _make_graph(rng, 120, 1400)
    n_pad, f = 128, 512
    pg = build_pallas_graph(src, dst, n_pad, rows_per_block=64, positional=True)
    x = rng.integers(0, 4, (n_pad, b, f)).astype(np.float32)
    out_j, dx_j = _jax_out_grad(pg, jnp.asarray(x).astype(dt))

    tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
    g = build_graph(src, dst, 120, positional=True)
    assert g.n_nodes == n_pad and g.positional and g.n_mega == 0
    out_p, dx_p, saved = _port_out_grad(g, x, tdt)
    np.testing.assert_array_equal(out_p, out_j)
    np.testing.assert_array_equal(dx_p, dx_j)
    # the residual: exactly N_pad x K int16 ranks
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [(torch.int16, (n_pad, b * f))]
    out_i, dx_i, _ = _port_out_grad(build_graph(src, dst, 120, positional=False), x, tdt)
    np.testing.assert_array_equal(out_p, out_i)
    np.testing.assert_array_equal(dx_p, dx_i)


_JAX_MEGA = {}   # the JAX result of test_mega_rows_match_jax_split, made once


@pytest.mark.parametrize("row_chunk", [gf.ROW_CHUNK, 8])
def test_mega_rows_match_jax_split(monkeypatch, row_chunk):
    """(b) The JAX mega-row fixture with POS_RANK_CAP 40 in both packages:
    out and dx equal the JAX split's, the argmax gains one side-table row
    per mega row, and it names the id-based argmax's sources."""
    monkeypatch.setattr(K, "POS_RANK_CAP", 40)
    monkeypatch.setattr(gf, "POS_RANK_CAP", 40)
    src, dst, rng = _mega_row_edges()
    n_pad, b, f = 128, 2, 512
    pg = build_pallas_graph(src, dst, n_pad, rows_per_block=64, positional=True)
    assert pg.fwd.split is not None
    x = rng.integers(0, 4, (n_pad, b, f)).astype(np.float32)
    # the first fold's first 64 features: row 3's maximum at its rank 45,
    # past the cap (its sources ascend: the 46th smallest in-neighbour)
    x[np.sort(src[dst == 3])[45], 0, :64] = 7.0
    if not _JAX_MEGA:
        _JAX_MEGA["out_dx"] = _jax_out_grad(pg, jnp.asarray(x))
    out_j, dx_j = _JAX_MEGA["out_dx"]

    g = build_graph(src, dst, 90, positional=True, row_chunk=row_chunk)
    assert g.rank_cap == 40 and g.n_mega == 2
    np.testing.assert_array_equal(np.flatnonzero(g.mega_of.numpy() >= 0),
                                  np.asarray(pg.fwd.split.rows))
    out_p, dx_p, saved = _port_out_grad(g, x, torch.float32)
    np.testing.assert_array_equal(out_p, out_j)
    np.testing.assert_array_equal(dx_p, dx_j)
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [(torch.int16, (n_pad + 2, b * f))]
    gi = build_graph(src, dst, 90, positional=False, row_chunk=row_chunk)
    xt = torch.from_numpy(x.reshape(n_pad, -1))
    _, arg_p = sk.spmm_max_fwd(g, xt)
    _, arg_i = sk.spmm_max_fwd(gi, xt)
    assert torch.equal(sk._arg_sources(g, arg_p), sk._arg_sources(gi, arg_i))
    assert int(arg_p[:n_pad].max()) < 40
    # row 3 is mega row 0: segment 1, rank 45 - 40 in it
    assert (arg_p[n_pad, :64] == 1).all() and (arg_p[3, :64] == 5).all()


def test_beyond_int16_nodes_matches_jax_xla():
    """(c) At N_pad = 2^15 + 128 the default graph is positional with an
    int16 residual; out and the gradient of sum(out^2) equal the JAX
    package's XLA spmm_max and the port's id-based (int32) graph's."""
    rng = np.random.default_rng(5)
    n_pad = (1 << 15) + 128
    n_real = n_pad - 128
    src, dst = rng.integers(0, n_real, 3000), rng.integers(0, n_real, 3000)
    g = build_graph(src, dst, n_real)
    assert g.n_nodes == n_pad and g.positional
    b, f = 2, 8
    x = rng.integers(0, 4, (n_pad, b, f)).astype(np.float32)
    jg = jax_build_graph(src, dst, n_real, widths=(4, 16, 64))

    def f_j(xx):
        return jax_spmm_max(jg, xx.reshape(n_pad, -1)).reshape(xx.shape)

    out_j = np.asarray(jax.jit(f_j)(jnp.asarray(x)))
    dx_j = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(f_j(xx) ** 2)))(jnp.asarray(x)))
    out_p, dx_p, saved = _port_out_grad(g, x, torch.float32)
    np.testing.assert_array_equal(out_p, out_j)
    np.testing.assert_array_equal(dx_p, dx_j)
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [(torch.int16, (n_pad, b * f))]
    gi = build_graph(src, dst, n_real, positional=False)
    out_i, dx_i, saved_i = _port_out_grad(gi, x, torch.float32)
    assert saved_i[0].dtype == torch.int32
    np.testing.assert_array_equal(out_p, out_i)
    np.testing.assert_array_equal(dx_p, dx_i)


@pytest.mark.parametrize("n_real,positional", [(32766, False), (32767, False),
                                               (32768, True), (40000, True)])
def test_positional_exactly_past_2_15_padded_nodes(n_real, positional):
    """None turns the positional argmax on exactly when N_pad > 2^15;
    ``arg_dtype`` is int16 for it at any size."""
    g = build_graph(np.array([1, 2]), np.array([0, 0]), n_real)
    assert (g.n_nodes > 1 << 15) == positional == g.positional
    assert sk.arg_dtype(g) == torch.int16
    for forced in (True, False):
        h = build_graph(np.array([1, 2]), np.array([0, 0]), n_real, positional=forced)
        assert h.positional == forced and (h.t_rank is not None) == forced
        assert sk.arg_dtype(h) == (torch.int16 if forced or h.n_nodes <= 1 << 15
                                   else torch.int32)


@pytest.mark.parametrize("cap", [3, 40, gf.POS_RANK_CAP])
def test_t_rank_names_each_edge_in_its_forward_row(monkeypatch, cap):
    """Each transpose edge s -> n has rank r in n's forward row, src[indptr[n]
    + r] == s; it is stored as -1 - r exactly where n is a mega row, whose
    index mega_of gives in ascending row order."""
    monkeypatch.setattr(gf, "POS_RANK_CAP", cap)
    src, dst, _ = _mega_row_edges()
    g = build_graph(src, dst, 90, add_self_loops=True, positional=True)
    tr = g.t_rank.numpy().astype(np.int64)
    n = g.t_dst.numpy().astype(np.int64)
    s = np.repeat(np.arange(g.n_nodes), np.diff(g.t_indptr.numpy()))
    deg = g.in_degree.numpy()
    np.testing.assert_array_equal(tr < 0, deg[n] > cap)
    r = np.where(tr < 0, -1 - tr, tr)
    np.testing.assert_array_equal(g.src.numpy()[g.indptr.numpy()[n] + r], s)
    mega = np.flatnonzero(deg > cap)
    assert g.n_mega == len(mega)
    if len(mega):
        np.testing.assert_array_equal(g.mega_of.numpy()[mega], np.arange(len(mega)))
        assert (np.delete(g.mega_of.numpy(), mega) == -1).all()
    else:
        assert g.mega_of is None


def _lane_columns(k, esize, width, arg_size=0):
    """The columns of each (K-slice, lane of a group) at a K-slice of
    ``width`` bytes, as csrc/row_chunks.cuh assigns them (group_lane): a
    group of G lanes, lane s holding J vectors of V elements at k0 + j G V,
    k0 = (slice G J + s) V.  Checks that every column is held exactly once."""
    lanes, per_slice, slices = sk.slice_layout(width, k, esize, arg_size)
    v = sk.vector_width(k, max(esize, arg_size))
    j = per_slice // (lanes * v)
    cols = []
    for y in range(slices):
        for s in range(lanes):
            k0 = (y * lanes * j + s) * v
            c = np.concatenate([np.arange(v) + k0 + jj * lanes * v for jj in range(j)])
            cols.append(c[c < k])
    np.testing.assert_array_equal(np.sort(np.concatenate(cols)), np.arange(k))
    return [c for c in cols if len(c)]


def _replay_pos_fwd(g, xf, width=None):
    """The positional forward's traversal in numpy, as csrc/spmm_max_fwd.cu
    computes it: each chunk walks its edges in ascending order (the first
    taken whatever its value, a later one only where strictly greater) and
    tracks the edge index; a row's only chunk stores e - its first edge
    (the rank), a split row's chunk the rank within the chunk; the combine
    takes a later slot only where strictly greater and adds its chunk's
    first rank, j * chunk_cap.  A mega row stores rank % rank_cap and its
    segment in the side table.  With ``width`` (bytes of float32 x), the
    grouped walk of a narrower K-slice: the chunks in the launch order
    RowChunks.order, each walked by every lane of a group for its own
    columns (_lane_columns)."""
    ch = g.chunks
    row, ptr, slot = ch.row.numpy(), ch.ptr.numpy(), ch.slot.numpy()
    n, k = xf.shape
    src = g.src.numpy()
    mega_of = (g.mega_of.numpy() if g.n_mega else np.full(n, -1))
    cap = g.rank_cap
    out = np.zeros((n, k), np.float32)
    arg = np.full((n + g.n_mega, k), -1, np.int64)
    p_val = np.zeros((ch.n_slots, k), np.float32)
    p_rank = np.zeros((ch.n_slots, k), np.int64)
    launch = range(ch.n_chunks) if width is None else ch.order.numpy()
    lanes = [np.arange(k)] if width is None else _lane_columns(k, 4, width)

    def store(r, cols, best, rank):
        out[r, cols] = best
        if mega_of[r] >= 0:
            arg[n + mega_of[r], cols] = rank // cap
            rank = rank % cap
        arg[r, cols] = rank

    for c in launch:
        for cols in lanes:
            best = np.zeros(len(cols), np.float32)
            e_best = np.full(len(cols), -1, np.int64)
            for e in range(ptr[c], ptr[c + 1]):
                v = xf[src[e], cols]
                take = np.ones(len(cols), bool) if e == ptr[c] else v > best
                best = np.where(take, v, best)
                e_best = np.where(take, e, e_best)
            rank = np.where(e_best < 0, -1, e_best - ptr[c])
            if slot[c] < 0:
                store(row[c], cols, best, rank)
            else:
                p_val[slot[c], cols], p_rank[slot[c], cols] = best, rank
    sp = ch.split_ptr.numpy()
    for i, r in enumerate(ch.split_row.numpy()):
        best, rank = p_val[sp[i]].copy(), p_rank[sp[i]].copy()
        for s in range(sp[i] + 1, sp[i + 1]):
            take = p_val[s] > best
            best = np.where(take, p_val[s], best)
            rank = np.where(take, p_rank[s] + (s - sp[i]) * ch.cap, rank)
        store(r, np.arange(k), best, rank)
    return out, arg


def _replay_pos_bwd(g, arg, gn, width=None):
    """The positional backward's traversal in numpy, as csrc/spmm_max_bwd.cu
    computes it: over the transpose chunks, edge s -> n hits where arg[n]
    equals its t_rank, or for t_rank = -1 - r (a mega row m) where arg[n]
    == r % rank_cap and the side table's seg[m] == r // rank_cap; float32
    sums in ascending edge order, split rows' partials added in chunk
    order.  With ``width`` (bytes of float32 g beside the int16 argmax), the
    grouped walk: the chunks in RowChunks.order, each lane of a group
    summing its own columns (_lane_columns)."""
    ch = g.t_chunks
    row, ptr, slot = ch.row.numpy(), ch.ptr.numpy(), ch.slot.numpy()
    n, k = gn.shape
    t_dst, t_rank = g.t_dst.numpy(), g.t_rank.numpy().astype(np.int64)
    mega_of = g.mega_of.numpy() if g.n_mega else None
    cap = g.rank_cap
    dx = np.zeros((n, k), np.float32)
    partial = np.zeros((ch.n_slots, k), np.float32)
    launch = range(ch.n_chunks) if width is None else ch.order.numpy()
    lanes = [np.arange(k)] if width is None else _lane_columns(k, 4, width, 2)
    for c in launch:
        for cols in lanes:
            acc = np.zeros(len(cols), np.float32)
            for e in range(ptr[c], ptr[c + 1]):
                m, tr = t_dst[e], t_rank[e]
                if tr >= 0:
                    hit = arg[m, cols] == tr
                else:
                    r = -1 - tr
                    hit = (arg[m, cols] == r % cap) & (arg[n + mega_of[m], cols] == r // cap)
                acc += np.where(hit, gn[m, cols], np.float32(0))
            if slot[c] < 0:
                dx[row[c], cols] = acc
            else:
                partial[slot[c], cols] = acc
    sp = ch.split_ptr.numpy()
    for i, r in enumerate(ch.split_row.numpy()):
        acc = np.zeros(k, np.float32)
        for s in range(sp[i], sp[i + 1]):
            acc += partial[s]
        dx[r] = acc
    return dx


@pytest.mark.parametrize("rank_cap,row_chunk", [(40, 256), (40, 8), (40, 40), (3, 5),
                                                (gf.POS_RANK_CAP, 8)])
def test_kernel_replays_match_plain(monkeypatch, rank_cap, row_chunk):
    """The replayed positional forward equals the plain version bit for bit
    (out and the argmax with its side table) on ties, all-equal and -inf
    columns, and a maximum first reached past the rank cap; the replayed
    backward equals the plain one (small integers: exact) and the id-based
    graph's."""
    monkeypatch.setattr(gf, "POS_RANK_CAP", rank_cap)
    src, dst, rng = _mega_row_edges()
    g = build_graph(src, dst, 90, positional=True, row_chunk=row_chunk)
    gi = build_graph(src, dst, 90, positional=False, row_chunk=row_chunk)
    k = 9
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, k)) * 2) / 2, 0)
    x[:, 0] = 1.5
    x[:, 1] = -np.inf
    # column 2: row 3's maximum first reached at its last edge, past the cap
    indptr, srcs = g.indptr.numpy(), g.src.numpy()
    x[:, 2] = np.minimum(x[:, 2], 2.0)
    x[srcs[indptr[4] - 1], 2] = 5.0
    xt = torch.from_numpy(x.astype(np.float32))
    out_r, arg_r = _replay_pos_fwd(g, xt.numpy())
    out_p, arg_p = sk.spmm_max_fwd_plain(g, xt)
    assert torch.equal(torch.from_numpy(out_r), out_p)
    assert torch.equal(torch.from_numpy(arg_r).to(torch.int16), arg_p)
    assert int(sk._arg_sources(g, arg_p)[3, 2]) == srcs[indptr[4] - 1]
    gn = rng.integers(-8, 9, (g.n_nodes, k)).astype(np.float32)
    dx_r = _replay_pos_bwd(g, arg_r, gn)
    dx_p = sk.spmm_max_bwd_plain(g, torch.from_numpy(gn), arg_p)
    assert torch.equal(torch.from_numpy(dx_r), dx_p)
    _, arg_i = sk.spmm_max_fwd_plain(gi, xt)
    assert torch.equal(sk._arg_sources(g, arg_p), sk._arg_sources(gi, arg_i))
    assert torch.equal(dx_p, sk.spmm_max_bwd_plain(gi, torch.from_numpy(gn), arg_i))


@pytest.mark.parametrize("rank_cap,row_chunk", [(40, 256), (40, 8), (3, 5)])
@pytest.mark.parametrize("k,width", [(9, 32), (30, 64), (64, 32), (64, 128), (130, 256)])
def test_grouped_replays_match_plain(monkeypatch, rank_cap, row_chunk, k, width):
    """The grouped walk of a narrow K-slice (groups of fewer lanes, chunks in
    the launch order, longest first), replayed in numpy at a forced width:
    the forward's out and argmax (side table included) and the backward's
    dx bit-equal to the plain versions and to the 32-lane walk's replay, on
    mega rows, ties, all-equal and -inf columns and a maximum first reached
    past the rank cap."""
    monkeypatch.setattr(gf, "POS_RANK_CAP", rank_cap)
    src, dst, rng = _mega_row_edges()
    g = build_graph(src, dst, 90, positional=True, row_chunk=row_chunk)
    assert g.n_mega > 0
    assert not np.array_equal(g.chunks.order.numpy(), np.arange(g.chunks.n_chunks))
    assert sk.slice_layout(width, k, 4, 2)[0] < 32
    x = np.maximum(np.round(rng.standard_normal((g.n_nodes, k)) * 2) / 2, 0)
    x[:, 0] = 1.5
    x[:, 1] = -np.inf
    indptr, srcs = g.indptr.numpy(), g.src.numpy()
    x[:, 2] = np.minimum(x[:, 2], 2.0)
    x[srcs[indptr[4] - 1], 2] = 5.0
    xt = torch.from_numpy(x.astype(np.float32))
    out_r, arg_r = _replay_pos_fwd(g, xt.numpy(), width)
    out_p, arg_p = sk.spmm_max_fwd_plain(g, xt)
    assert torch.equal(torch.from_numpy(out_r), out_p)
    assert torch.equal(torch.from_numpy(arg_r).to(torch.int16), arg_p)
    out_w, arg_w = _replay_pos_fwd(g, xt.numpy())
    np.testing.assert_array_equal(out_r.view(np.int32), out_w.view(np.int32))
    np.testing.assert_array_equal(arg_r, arg_w)
    gn = rng.integers(-8, 9, (g.n_nodes, k)).astype(np.float32)
    dx_r = _replay_pos_bwd(g, arg_r, gn, width)
    assert torch.equal(torch.from_numpy(dx_r), sk.spmm_max_bwd_plain(g, torch.from_numpy(gn),
                                                                      arg_p))
    np.testing.assert_array_equal(dx_r.view(np.int32), _replay_pos_bwd(g, arg_r, gn).view(np.int32))


def test_wrappers_refuse_what_the_positional_argmax_does_not_take():
    src, dst, _ = _mega_row_edges()
    g = build_graph(src, dst, 90, positional=True)
    x = torch.rand(g.n_nodes, 4)
    with pytest.raises(ValueError, match="positional=False"):
        sk.spmm_max_fwd(g, x, empty_value=float("-inf"))
    out, _ = sk.spmm_max_fwd(g, x, with_argmax=False, empty_value=float("-inf"))
    assert out.shape == x.shape
    _, arg = sk.spmm_max_fwd(g, x)
    with pytest.raises(TypeError, match="int16"):
        sk.spmm_max_bwd(g, x, arg.int())
    gi = build_graph(src, dst, 90, positional=False)
    _, arg_i = sk.spmm_max_fwd(gi, x)
    with pytest.raises(TypeError, match="int16/int32"):
        sk.spmm_max_bwd(gi, x, arg_i[:-1].contiguous())


def test_shards_stay_id_based():
    """A graph shard's gather space past 2^15 rows keeps the id-based
    argmax (its passes take empty_value=-inf), as the JAX sharded path."""
    rng = np.random.default_rng(3)
    n = 70000
    src, dst = rng.integers(0, n, 5000), rng.integers(0, n, 5000)
    pg = partition_graph(src, dst, n, 2, add_self_loops=True)
    assert pg.n_local > 1 << 15
    shard = pg.shard(0)
    assert not shard.interior.positional and not shard.boundary.positional


def test_train_big_graph_matches_jax_runner(tmp_path, monkeypatch):
    """(d) train() on a 33,000-node synthetic bundle (N_pad 33,024: the
    positional path) at narrow widths, 2 folds in one batch, 2 epochs,
    from the JAX package's initial params, against the JAX XLA runner run
    one fold at a time (ROADMAP Queue 3): probabilities and losses within
    1e-4.  Every saved argmax is int16."""
    n_nodes = 33000
    ppi, feats, loc, label_list = jax_synth.synthetic_dataset(
        n_nodes=n_nodes, n_edges=80000, seed=70, feature_dims=(3, 6, 6))
    jg = jax_from_scipy_coo(ppi, add_self_loops=True, widths=(4, 16, 64))
    g = from_scipy_coo(ppi, add_self_loops=True)
    n = g.n_nodes
    assert g.positional and n == 33024
    feats_p, labels_p = pad_features(feats, n), pad_features(loc, n)
    hidden = (13, 9, 7, 5)
    fseed = 12
    tr_np, va_np = kfold.fold_node_masks(label_list, n, 2, fseed)
    jcfg = jax_engine.TrainConfig(lr=1e-3, fold_num=2, epoch_num=2, hidden=hidden,
                                  verbose=False)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_engine.init_fold_params(k, jcfg, feats.shape[1], 2))(
            jax.random.PRNGKey(5)))
    run_j, _ = jax_engine.make_fold_runner(
        jg, jnp.asarray(feats_p), jnp.asarray(labels_p),
        losses.weight_cal(loc), jnp.asarray(np.arange(n) < n_nodes), jcfg)
    init_opt = jax.jit(run_j.init_opt)
    per_fold = []
    for i in range(2):
        p_i = jax.tree.map(lambda a: a[i:i + 1], params)
        per_fold.append(run_j(p_i, init_opt(p_i), jnp.asarray(tr_np[i:i + 1]),
                              jnp.asarray(va_np[i:i + 1]), jnp.float32(0.1)))
    probs_j = np.concatenate([np.asarray(r[2]) for r in per_fold])
    hist_j = jax.tree.map(lambda *a: np.concatenate(a),
                          *[jax.device_get(r[3]) for r in per_fold])

    model = BatchedGNN32(2, feats.shape[1], *hidden)
    model.load_state_dict(params_from_jax(params))
    monkeypatch.setattr(engine, "init_fold_model", lambda *a: model)
    got = []
    make_runner = engine.make_batched_fold_runner

    def recording_runner(*a, **kw):
        run = make_runner(*a, **kw)

        def run_and_keep(*ra, **rkw):
            res = run(*ra, **rkw)
            got.append(res)
            return res
        return run_and_keep

    monkeypatch.setattr(engine, "make_batched_fold_runner", recording_runner)
    saved = set()

    def pack(t):
        if not t.is_floating_point():
            saved.add((t.dtype, tuple(t.shape)))
        return t

    cfg = engine.TrainConfig(lr=1e-3, fold_num=2, fold_batch=2, epoch_num=2,
                             hidden=hidden, fold_seeds=(fseed,), verbose=False)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        engine.train(g, feats_p, labels_p, label_list, loc, cfg, str(tmp_path),
                     device_name="cpu")
    assert len(got) == 1
    _, _, probs_p, hist_p, _ = got[0]
    np.testing.assert_allclose(probs_p.numpy(), probs_j, rtol=1e-4, atol=1e-4)
    for split in ("train", "val"):
        np.testing.assert_allclose(hist_p[split]["loss"], hist_j[split]["loss"],
                                   rtol=1e-4, atol=1e-4)
    widths = {2 * w for w in (feats.shape[1], *hidden[:2])}
    assert {s for dt, s in saved if dt != torch.bool} == {(n, w) for w in widths}
    assert {dt for dt, s in saved if dt != torch.bool} == {torch.int16}
    for f in (1, 2):
        lg = np.load(tmp_path / f"1_{f}_loc_logits.npy")
        np.testing.assert_array_equal(lg, probs_p[f - 1, :n_nodes].numpy())
