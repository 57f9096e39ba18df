"""GAT in the port (``models/gnn32.py: GAT``, ``models/batched.py:
BatchedGAT``, ``ops/spmm.py: spmm_gat``) held to the plain reference
``torch_reference.RefGAT`` (DGL 0.8 GATConv semantics, a per-row softmax
written directly), and the edge-softmax op's kernels to its plain version.

CPU: the models in float64 against RefGAT on seeded random weights (the
forward, the loss, every leaf's gradient, three Adam steps; single-model
and fold-batched with different weights a fold; both residual forms and
both merges) on a graph with a row whose only in-edge is its self-loop and
a row that the row chunks split; the plain op's float64 gradcheck; a replay
of ``csrc/spmm_gat.cu``'s traversal in Python; the engine's GAT path and
its refusals.  On a card (tests marked ``cuda``, skipped without one) the
kernels against the plain op:

    python -m pytest tests/test_torch_gat.py -q -m cuda --noconftest
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from plagnn_tpu_torch.models.batched import BatchedGAT, stack_folds
from plagnn_tpu_torch.models.gnn32 import GAT, GAT_HEADS, MODEL_REGISTRY, gat_layers, init_gat
from plagnn_tpu_torch.models.layers import gat_attn_bound
from plagnn_tpu_torch.ops import spmm_kernels as sk
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.train import engine, losses
from plagnn_tpu_torch.utils import precision
from torch_reference import RefGAT, export_gat_params

# float64 throughout the model comparisons: the port and the reference
# differ only in the order of their sums (einsum against an elementwise
# product, the op's index_add_ against a row's sum), a few ulp of float64.
TOL64 = dict(rtol=1e-9, atol=1e-11)

# (in_feats, hidden, heads, classes) and the residual each layer takes:
# the PPI shape in small (identity in the middle, linear last), a linear
# middle layer, an identity last layer.
VARIANTS = {
    "ppi": (10, (6, 6), (2, 2, 3), 5),
    "linear_mid": (10, (6, 5), (2, 2, 2), 4),
    "identity_last": (9, (6,), (2, 2), 6),
}
RESIDUALS = {"ppi": ["none", "identity", "linear"], "linear_mid": ["none", "linear", "linear"],
             "identity_last": ["none", "identity"]}


def _graph(seed=0, n=30, row_chunk=8):
    """Random edges, every real node -> 0 (row 0 splits at row_chunk 8),
    node n - 1 with no in-edge but its self-loop."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 6 * n), np.arange(1, n)])
    dst = np.concatenate([rng.integers(0, n - 1, 6 * n), np.zeros(n - 1, np.int64)])
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    return build_graph(pairs[:, 0], pairs[:, 1], n, add_self_loops=True, row_chunk=row_chunk)


def _adj(graph):
    ip = graph.indptr.tolist()
    src = graph.src.tolist()
    return [src[ip[i]:ip[i + 1]] for i in range(graph.n_real_nodes)]


def _refs(variant, folds, seed=0):
    in_feats, hidden, heads, classes = VARIANTS[variant]
    refs = []
    for b in range(folds):
        torch.manual_seed(seed * 100 + b)
        ref = RefGAT(in_feats, hidden, heads, classes).double()
        for layer in ref.layers:          # DGL's bias is zero at init; make it count
            layer.bias.data.normal_(0, 0.3)
        refs.append(ref)
    return refs


def _port(variant, refs, batched):
    in_feats, hidden, heads, classes = VARIANTS[variant]
    states = [export_gat_params(r) for r in refs]
    if batched:
        m = BatchedGAT(len(refs), in_feats, hidden, heads, classes).double()
        m.load_state_dict({k: torch.stack([s[k] for s in states]) for k in states[0]})
    else:
        m = GAT(in_feats, hidden, heads, classes).double()
        m.load_state_dict(states[0])
    return m


def _inputs(graph, in_feats, classes, seed=1):
    gen = torch.Generator().manual_seed(seed)
    n = graph.n_real_nodes
    x = torch.zeros(graph.n_nodes, in_feats, dtype=torch.float64)
    x[:n] = torch.randn(n, in_feats, generator=gen, dtype=torch.float64)
    labels = torch.zeros(graph.n_nodes, classes, dtype=torch.float64)
    labels[:n] = (torch.rand(n, classes, generator=gen) < 0.4).double()
    mask = torch.zeros(graph.n_nodes, dtype=torch.bool)
    mask[:n] = torch.rand(n, generator=gen) < 0.7
    w = torch.rand(classes, generator=gen, dtype=torch.float64) + 0.5
    return x, labels, mask, w


def test_graph_has_a_split_row_and_a_lone_self_loop():
    g = _graph()
    n = g.n_real_nodes
    assert g.chunks.n_split > 0 and int(g.chunks.split_row[0]) == 0
    assert g.src[g.indptr[n - 1]:g.indptr[n]].tolist() == [n - 1]


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gat_matches_reference(variant, batched):
    """Probabilities, the weighted multi-label loss and every leaf's gradient
    of the port's GAT (one fold, or three folds of different weights in one
    BatchedGAT) equal RefGAT's, fold by fold."""
    g = _graph()
    in_feats, hidden, heads, classes = VARIANTS[variant]
    folds = 3 if batched else 1
    refs = _refs(variant, folds)
    port = _port(variant, refs, batched)
    assert [c.residual for c in (getattr(port, f"conv{l + 1}") for l in range(len(heads)))] \
        == RESIDUALS[variant]
    x, labels, mask, w = _inputs(g, in_feats, classes)
    n = g.n_real_nodes
    probs = port(g, x)
    probs = probs if batched else probs[:, None]            # (N, B, C)
    p_fold = probs.permute(1, 0, 2)
    loss = losses.multi_loss(p_fold, labels, mask.expand(folds, -1), w)
    loss.sum().backward()
    adj = _adj(g)
    for b, ref in enumerate(refs):
        want = ref(adj, x[:n])
        torch.testing.assert_close(p_fold[b, :n].detach(), want.detach(), **TOL64)
        ref_loss = losses.multi_loss(want, labels[:n], mask[:n], w)
        torch.testing.assert_close(loss[b].detach(), ref_loss.detach(), **TOL64)
        ref_loss.backward()
        ref_grads = export_gat_params(ref, grads=True)
        for k, v in port.named_parameters():
            got = v.grad[b] if batched else v.grad
            torch.testing.assert_close(got, ref_grads[k], **TOL64, msg=k)


def test_three_adam_steps_match_reference():
    """Three steps of one Adam over the fold-stacked parameters (the
    runner's ``make_adam``) equal three steps of each fold's own Adam on
    RefGAT."""
    g = _graph(2)
    variant = "ppi"
    in_feats, hidden, heads, classes = VARIANTS[variant]
    refs = _refs(variant, 3, seed=3)
    port = _port(variant, refs, batched=True)
    x, labels, mask, w = _inputs(g, in_feats, classes, seed=4)
    real = torch.arange(g.n_nodes) < g.n_real_nodes
    masks = torch.stack([mask, mask.roll(5), ~mask]) & real     # a training split a fold
    cfg = engine.TrainConfig(lr=1e-2)
    opt = engine.make_adam(port, cfg)
    ref_opts = [torch.optim.Adam(r.parameters(), lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
                for r in refs]
    adj, n = _adj(g), g.n_real_nodes
    for _ in range(3):
        opt.zero_grad()
        loss = losses.multi_loss(port(g, x).permute(1, 0, 2), labels, masks, w)
        loss.sum().backward()
        opt.step()
        for b, (ref, ro) in enumerate(zip(refs, ref_opts)):
            ro.zero_grad()
            losses.multi_loss(ref(adj, x[:n]), labels[:n], masks[b, :n], w).backward()
            ro.step()
    for b, ref in enumerate(refs):
        want = export_gat_params(ref)
        for k, v in port.named_parameters():
            torch.testing.assert_close(v.detach()[b], want[k], rtol=1e-8, atol=1e-10, msg=k)


def test_batched_stack_and_init_laws():
    """stack_folds of per-fold GATs is a BatchedGAT whose folds are theirs;
    the init draws Xavier-uniform bounds of DGL's Xavier-normal variance
    (attn: fan in H*F, fan out F), a zero bias, res_fc only where the
    residual is linear."""
    models = [init_gat(torch.Generator().manual_seed(s), 503, 256, 256, num_classes=12)
              for s in (1, 2)]
    assert models[0].heads == (4, 4, 6)
    batched = stack_folds(models)
    assert isinstance(batched, BatchedGAT)
    shapes = {k: tuple(v.shape) for k, v in batched.named_parameters()}
    assert shapes == {
        "conv1.fc": (2, 503, 1024), "conv1.attn_l": (2, 4, 256), "conv1.attn_r": (2, 4, 256),
        "conv1.bias": (2, 1024),
        "conv2.fc": (2, 1024, 1024), "conv2.attn_l": (2, 4, 256), "conv2.attn_r": (2, 4, 256),
        "conv2.bias": (2, 1024),
        "conv3.fc": (2, 1024, 72), "conv3.attn_l": (2, 6, 12), "conv3.attn_r": (2, 6, 12),
        "conv3.res_fc": (2, 1024, 72), "conv3.bias": (2, 72)}
    for b, m in enumerate(models):
        for k, v in m.named_parameters():
            assert torch.equal(dict(batched.named_parameters())[k][b], v)
    m = models[0].requires_grad_(False)
    gain = math.sqrt(2.0)
    for conv, (i, f, h) in ((m.conv1, (503, 256, 4)), (m.conv3, (1024, 12, 6))):
        assert float(conv.fc.abs().max()) <= gain * math.sqrt(6 / (i + h * f))
        assert float(conv.fc.abs().max()) > 0.9 * gain * math.sqrt(6 / (i + h * f))
        bound = gat_attn_bound(f, h)
        assert math.isclose(bound, gain * math.sqrt(6 / (h * f + f)))
        assert float(conv.attn_l.abs().max()) <= bound and float(conv.attn_r.abs().max()) <= bound
        assert not conv.bias.any()
    assert m.conv1.res_fc is None and m.conv2.res_fc is None and m.conv3.res_fc is not None
    assert [d["num_heads"] for d in gat_layers(503, (256, 256), (4, 4, 6), 12)] == [4, 4, 6]
    with pytest.raises(ValueError, match="head count"):
        gat_layers(503, (256, 256), (4, 6), 12)


# ---------------------------------------------------------------------------
# The op: its plain version, the edge maps, the kernels' traversal replayed.
# ---------------------------------------------------------------------------


def _op_inputs(graph, bh, f, dtype=torch.float32, seed=5, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    n = graph.n_nodes
    wh = torch.randn(n, bh * f, generator=gen, dtype=dtype)
    el = torch.randn(n, bh, generator=gen, dtype=dtype) * 2
    er = torch.randn(n, bh, generator=gen, dtype=dtype) * 2
    gout = torch.randn(n, bh * f, generator=gen, dtype=dtype)
    return [t.to(device) for t in (wh, el, er, gout)]


def _per_row(graph, wh, el, er, f):
    """The op as each row's softmax, row by row (rows without in-edges 0)."""
    bh = el.shape[1]
    out = torch.zeros_like(wh)
    for i, nb in enumerate(_adj(graph) + [[]] * (graph.n_nodes - graph.n_real_nodes)):
        if nb:
            a = torch.softmax(F.leaky_relu(el[nb] + er[i], 0.2), 0)
            out[i] = (a.repeat_interleave(f, 1) * wh[nb]).sum(0).view(bh * f)
    return out


@pytest.mark.parametrize("f,bh", [(3, 4), (12, 6)])
def test_plain_op_is_each_rows_softmax(f, bh):
    g = _graph(6)
    wh, el, er, _ = _op_inputs(g, bh, f, torch.float64)
    out, lse = sk.spmm_gat_fwd_plain(g, wh, el, er, f)
    torch.testing.assert_close(out, _per_row(g, wh, el, er, f), **TOL64)
    n = g.n_real_nodes
    assert torch.isinf(lse[n:]).all() and not out[n:].any()       # padding rows
    s, d = g.src.long(), g.dst.long()
    e = F.leaky_relu(el[s] + er[d], 0.2)
    want = torch.full_like(lse, -math.inf).scatter_reduce(
        0, d[:, None].expand(-1, bh), e, "amax")
    want = want + torch.log(torch.zeros_like(lse).index_add_(0, d, torch.exp(e - want[d])))
    torch.testing.assert_close(lse[:n], want[:n], **TOL64)


def test_plain_op_gradcheck():
    """The op's gradients (wh, el, er) in float64 against finite differences,
    on a graph with split rows and padding rows."""
    g = _graph(7, n=14, row_chunk=4)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    wh, el, er, _ = _op_inputs(g, 3, 2, torch.float64, seed=8)
    args = [t.requires_grad_() for t in (wh, el, er)]
    assert torch.autograd.gradcheck(lambda a, b, c: sk.spmm_gat(g, a, b, c, 2), args)


def test_edge_t_positions_with_repeated_pairs():
    """``Graph.t_pos``, each destination-order edge's transpose position,
    repeated (src, dst) pairs included: a bijection that keeps both ends
    and each edge itself, int32, kept by a copy to a device."""
    src = np.array([0, 1, 1, 2, 1, 3, 0, 1])
    dst = np.array([1, 2, 2, 0, 2, 1, 1, 0])
    val = np.arange(8, dtype=np.float32)            # tells the copies apart
    g = build_graph(src, dst, 4, edge_val=val)
    assert g.t_pos.dtype == torch.int32
    pos = g.t_pos.long()
    assert torch.equal(torch.sort(pos).values, torch.arange(g.n_edges))
    assert torch.equal(g.t_dst[pos], g.dst)
    t_src = torch.repeat_interleave(torch.arange(g.n_nodes), g.t_indptr.long().diff())
    assert torch.equal(t_src[pos], g.src.long())
    assert torch.equal(g.t_val[pos], g.val)         # each copy maps to itself
    assert torch.equal(g.to("cpu").t_pos, g.t_pos)


@pytest.mark.parametrize("f,ok", [(1, True), (3, True), (32, True), (6, True), (64, True),
                                  (128, True), (12, True), (256, True), (36, True),
                                  (33, False), (66, False), (132, False), (512, False)])
def test_gat_layout(f, ok):
    if not ok:
        with pytest.raises(ValueError, match="per-head width"):
            sk.gat_layout(f)
        return
    v, width, span = sk.gat_layout(f)
    assert f % v == 0 and width % v == 0
    assert span == (f == 256)
    assert (width == 32 * v) if span else (width % f == 0 and width <= 32 * v)


def _lane_layout(f, k_width):
    """spmm_gat.cu's lanes: for each K-slice, each lane and vector, (k,
    group, lead) of its first element, or None outside (the Lanes struct)."""
    v, width, span = sk.gat_layout(f)
    j_vec = min(max(32 // (v * 4), 1), 8)
    slices = -(-k_width // (j_vec * width))
    lanes = {}
    for y in range(slices):
        for lane in range(32):
            for j in range(j_vec):
                k = y * j_vec * width + j * width + lane * v
                if lane * v < width and k < k_width:
                    lead = (lane == 0 and j == 0) if span else k % f == 0
                    lanes[y, lane, j] = (k, k // f, lead)
    return v, j_vec, span, lanes


def _replay_fwd(g, wh, el, er, f, slope=0.2):
    """spmm_gat_fwd_kernel and its combine, lane by lane, in float64."""
    n, k_width = wh.shape
    bh = k_width // f
    v, j_vec, span, lanes = _lane_layout(f, k_width)
    ch = g.chunks
    out = np.zeros((n, k_width))
    lse = np.full((n, bh), -np.inf)
    part = np.zeros((ch.n_slots, k_width))
    pm = np.zeros((ch.n_slots, bh))
    ps = np.zeros((ch.n_slots, bh))
    src = g.src.tolist()
    for c in range(ch.n_chunks):
        row, beg, end, slot = (int(ch.row[c]), int(ch.ptr[c]), int(ch.ptr[c + 1]),
                               int(ch.slot[c]))
        for (y, lane, j), (k, grp, lead) in lanes.items():
            if span and j > 0:
                continue               # vector 0's state serves the lane's vectors
            ks = [lanes[y, lane, jj][0] for jj in range(j_vec)
                  if (y, lane, jj) in lanes] if span else [k]
            m, s = -np.inf, 0.0
            acc = np.zeros((len(ks), v))
            for e in range(beg, end):
                z = el[src[e], grp] + er[row, grp]
                lz = z if z > 0 else slope * z
                if lz > m:
                    scale = math.exp(m - lz)
                    s, acc, m = s * scale, acc * scale, lz
                p = math.exp(lz - m)
                s += p
                for a, kk in enumerate(ks):
                    acc[a] += p * wh[src[e], kk:kk + v]
            for a, kk in enumerate(ks):
                if slot < 0:
                    out[row, kk:kk + v] = acc[a] / s if s > 0 else 0.0
                else:
                    part[slot, kk:kk + v] = acc[a]
            if lead and slot < 0:
                lse[row, grp] = m + math.log(s) if s > 0 else -np.inf
            elif lead:
                pm[slot, grp], ps[slot, grp] = m, s
    for i in range(ch.n_split):
        row, s0, s1 = int(ch.split_row[i]), int(ch.split_ptr[i]), int(ch.split_ptr[i + 1])
        for k in range(k_width):
            grp = k // f
            big = max(pm[s, grp] for s in range(s0, s1))
            w = [math.exp(pm[s, grp] - big) for s in range(s0, s1)]
            tot = sum(ps[s, grp] * wi for s, wi in zip(range(s0, s1), w))
            out[row, k] = sum(part[s, k] * wi for s, wi in zip(range(s0, s1), w)) / tot
            if k % f == 0:
                lse[row, grp] = big + math.log(tot)
    return out, lse


def _replay_bwd(g, gout, wh, el, er, lse, f, slope=0.2):
    """spmm_gat_bwd_kernel, the der pass's two phases, the del pass and
    their combines, as the kernels walk them, in float64."""
    n, k_width = wh.shape
    bh = k_width // f
    v, j_vec, span, lanes = _lane_layout(f, k_width)
    c_lanes = 32 if span else f // v
    tc, fc = g.t_chunks, g.chunks
    t_dst = g.t_dst.tolist()
    e_total = g.n_edges
    dwh = np.zeros((n, k_width))
    part = np.zeros((tc.n_slots, k_width))
    buf = np.full((e_total, bh), np.nan)
    leaky = (lambda z: z if z > 0 else slope * z)
    for c in range(tc.n_chunks):
        row, beg, end, slot = (int(tc.row[c]), int(tc.ptr[c]), int(tc.ptr[c + 1]),
                               int(tc.slot[c]))
        for e in range(beg, end):
            i = t_dst[e]
            partials = {}
            for (y, lane, j), (k, grp, lead) in lanes.items():
                a = math.exp(leaky(el[row, grp] + er[i, grp]) - lse[i, grp])
                target = part[slot] if slot >= 0 else dwh[row]
                target[k:k + v] += a * gout[i, k:k + v]
                seg = (y, 0 if span else (j, lane // c_lanes))
                partials.setdefault(seg, [0.0, None])
                partials[seg][0] += float(np.dot(gout[i, k:k + v], wh[row, k:k + v]))
                if lead:
                    partials[seg][1] = grp
            for total, grp in partials.values():
                buf[e, grp] = total
    for i in range(tc.n_split):
        row, s0, s1 = int(tc.split_row[i]), int(tc.split_ptr[i]), int(tc.split_ptr[i + 1])
        dwh[row] = part[s0:s1].sum(0)
    f2t = g.t_pos.tolist()
    src = g.src.tolist()
    der = np.zeros((n, bh))
    pd = np.zeros((fc.n_slots, bh))
    pder = np.zeros((fc.n_slots, bh))
    for phase in (0, 1):
        for c in range(fc.n_chunks):
            row, beg, end, slot = (int(fc.row[c]), int(fc.ptr[c]), int(fc.ptr[c + 1]),
                                   int(fc.slot[c]))
            if phase == 1 and slot < 0:
                continue
            for grp in range(bh):
                def alpha(e):
                    z = el[src[e], grp] + er[row, grp]
                    return z, math.exp(leaky(z) - lse[row, grp])
                if phase == 0:
                    dd = sum(alpha(e)[1] * buf[f2t[e], grp] for e in range(beg, end))
                    if slot >= 0:
                        pd[slot, grp] = dd
                        continue
                else:
                    si = int(np.searchsorted(fc.split_row.numpy(), row))
                    dd = pd[int(fc.split_ptr[si]):int(fc.split_ptr[si + 1]), grp].sum()
                tot = 0.0
                for e in range(beg, end):
                    z, a = alpha(e)
                    de = a * (buf[f2t[e], grp] - dd)
                    dz = de if z > 0 else slope * de
                    buf[f2t[e], grp] = dz
                    tot += dz
                if slot < 0:
                    der[row, grp] = tot
                else:
                    pder[slot, grp] = tot
    for i in range(fc.n_split):
        row, s0, s1 = int(fc.split_row[i]), int(fc.split_ptr[i]), int(fc.split_ptr[i + 1])
        der[row] = pder[s0:s1].sum(0)
    d_el = np.zeros((n, bh))
    for c in range(tc.n_chunks):
        row, beg, end = int(tc.row[c]), int(tc.ptr[c]), int(tc.ptr[c + 1])
        d_el[row] += buf[beg:end].sum(0)     # a split row's parts, summed as its combine
    return dwh, d_el, der


@pytest.mark.parametrize("f,bh", [(12, 5), (256, 2), (6, 3), (3, 4), (40, 3)],
                         ids=["f12", "f256-span", "f6-v2", "f3-v1", "f40-c10"])
def test_kernel_traversal_replay_matches_plain(f, bh):
    """A replay of spmm_gat.cu's walk (lane layout, online softmax and its
    combine, da reduced over each group's lanes, the der pass's two phases
    and the del pass) gives the plain version's results, on a graph whose
    split rows take every combine."""
    g = _graph(9, n=20, row_chunk=6)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    wh, el, er, gout = _op_inputs(g, bh, f, torch.float64, seed=f)
    out, lse = sk.spmm_gat_fwd_plain(g, wh, el, er, f)
    r_out, r_lse = _replay_fwd(g, wh.numpy(), el.numpy(), er.numpy(), f)
    np.testing.assert_allclose(r_out, out.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r_lse, lse.numpy(), rtol=1e-10, atol=1e-12)
    want = sk.spmm_gat_bwd_plain(g, gout, wh, el, er, lse, f)
    got = _replay_bwd(g, gout.numpy(), wh.numpy(), el.numpy(), er.numpy(), lse.numpy(), f)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-9, atol=1e-11)


def test_op_refusals():
    g = _graph()
    wh, el, er, _ = _op_inputs(g, 4, 3)
    with pytest.raises(ValueError, match="multiple"):
        sk.spmm_gat(g, wh[:, :11], el, er, 3)
    with pytest.raises(ValueError, match="el must be"):
        sk.spmm_gat_fwd(g, wh, el[:, :3].contiguous(), er, 3)
    with pytest.raises(TypeError, match="float32"):
        sk.spmm_gat_fwd(g, wh.bfloat16(), el.bfloat16(), er.bfloat16(), 3)


# ---------------------------------------------------------------------------
# The engine's GAT path.
# ---------------------------------------------------------------------------


def _bundle():
    from plagnn_tpu_torch.data.synthetic import synthetic_dataset
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo, pad_features

    ppi, feats, loc, label_list = synthetic_dataset(n_nodes=96, n_edges=500, seed=4,
                                                     feature_dims=(3, 6, 6))
    graph = from_scipy_coo(ppi, add_self_loops=True)
    return (graph, pad_features(feats, graph.n_nodes), pad_features(loc, graph.n_nodes),
            label_list, loc)


GAT_TINY = dict(model="gat", hidden=(4, 4), lr=1e-3, fold_num=2, epoch_num=3,
                fold_batch=2, fold_seeds=(12,), verbose=False)


def test_train_gat_writes_the_artifacts(tmp_path):
    """engine.train(TrainConfig(model='gat')) trains through the fold-batched
    runner and writes the artifact contract; the model it builds is a
    BatchedGAT of the published heads."""
    graph, feats, labels, label_list, loc = _bundle()
    cfg = engine.TrainConfig(**GAT_TINY)
    model = engine.init_fold_model(cfg, feats.shape[1], [1, 2], "cpu")
    assert isinstance(model, BatchedGAT) and model.heads == GAT_HEADS == (4, 4, 6)
    for hub in ("auto", "off"):
        assert engine.resolve_hub(engine.TrainConfig(**dict(GAT_TINY, hub_cache=hub)), graph,
                                  feats.shape[1]) == (0, 0)
    stats = engine.train(graph, feats, labels, label_list, loc, cfg, str(tmp_path) + "/",
                         device_name="cpu")
    assert [s.folds for s in stats] == [2]
    files = set(os.listdir(tmp_path))
    assert {"1_1_loc_logits.npy", "1_2_loc_logits.npy", "log.tsv", "txt_log.txt",
            "fig_data_1.json"} <= files
    logits = np.load(tmp_path / "1_1_loc_logits.npy")
    assert logits.shape == (graph.n_real_nodes, 12) and np.isfinite(logits).all()


@pytest.fixture
def agg_dtype_restored():
    before = precision.aggregation_dtype()
    yield
    precision.set_aggregation_dtype(before)


@pytest.mark.parametrize("change", ["hub", "bf16", "mesh"])
def test_gat_refuses_what_it_lacks(change, agg_dtype_restored):
    """An explicit hub size, bfloat16 messages or a mesh for GAT: a
    ValueError that names it, from init_fold_model and from train."""
    graph, feats, labels, label_list, loc = _bundle()
    kw = dict(GAT_TINY)
    if change == "hub":
        kw["hub_cache"] = "16"
    elif change == "bf16":
        precision.set_aggregation_dtype("bfloat16")
    else:
        kw["mesh_graph"] = 2
    cfg = engine.TrainConfig(**kw)
    match = {"hub": "hub cache", "bf16": "float32 only", "mesh": "one device"}[change]
    with pytest.raises(ValueError, match=match):
        engine.init_fold_model(cfg, feats.shape[1], [1, 2], "cpu")
    with pytest.raises(ValueError, match=match):
        engine.train(graph, feats, labels, label_list, loc, cfg, "/nonexistent/never-made/",
                     device_name="cpu")


def test_checkpoint_records_heads(tmp_path, monkeypatch):
    """The checkpoint's fingerprint holds GAT's heads (its registry entry's),
    so a resume across other heads is refused like one across other widths;
    GNN32's and GCN2's fingerprints are as before (no heads)."""
    cfg = engine.TrainConfig(**GAT_TINY)
    fp = engine._checkpoint_fingerprint(cfg)
    assert fp["heads"] == (4, 4, 6)
    assert "heads" not in engine._checkpoint_fingerprint(engine.TrainConfig())
    assert "heads" not in engine._checkpoint_fingerprint(engine.TrainConfig(model="gcn2"))
    other_heads = dataclasses.replace(MODEL_REGISTRY["gat"], extra={"heads": (2, 2, 2)})
    with monkeypatch.context() as m:
        m.setitem(MODEL_REGISTRY, "gat", other_heads)
        other = engine._checkpoint_fingerprint(cfg)
    with pytest.raises(ValueError, match="heads"):
        engine._check_checkpoint_config("ck.npz", fp, other)
    graph, feats, labels, label_list, loc = _bundle()
    calls = []

    def crash(*_):
        calls.append(1)
        raise RuntimeError("injected crash")

    d = str(tmp_path) + "/"
    with pytest.raises(RuntimeError, match="injected crash"):
        engine.train(graph, feats, labels, label_list, loc,
                     engine.TrainConfig(**dict(GAT_TINY, checkpoint_every=2,
                                               chunk_callback=crash)), d, device_name="cpu")
    monkeypatch.setitem(MODEL_REGISTRY, "gat", other_heads)
    with pytest.raises(ValueError, match="heads"):
        engine.train(graph, feats, labels, label_list, loc,
                     engine.TrainConfig(**dict(GAT_TINY, checkpoint_every=2)),
                     d, device_name="cpu")


# ---------------------------------------------------------------------------
# On the card: the kernels against the plain op.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _card_graph(name):
    if name == "small":
        return _graph(11, n=300, row_chunk=8).to("cuda")
    from plagnn_tpu_torch.data.synthetic import powerlaw_ppi
    from plagnn_tpu_torch.ops.graph_format import from_scipy_coo

    return from_scipy_coo(powerlaw_ppi(24041, 700000, 70), add_self_loops=True).to("cuda")


# float32 on the card against the plain version's float32 on the card: an
# online softmax against exp(e - lse), sums in another order, __expf; the
# outputs are O(1) and the gradients sums of up to ~10^4 terms.
CARD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,bh,f", [
    ("small", 4, 256), ("small", 6, 12), ("small", 5, 3), ("small", 3, 6), ("small", 4, 40),
    ("24k", 8, 256), ("24k", 32 * 6, 12)],
    ids=["small-f256", "small-f12", "small-f3", "small-f6", "small-f40", "24k-f256",
         "24k-k2304"])
def test_card_kernels_match_plain(card, name, bh, f):
    """Forward (out, lse) and backward (dwh, del, der) of the kernels equal
    the plain op on the card within CARD_TOL, on graphs whose split rows
    take every combine; the launches are counted; two runs are bit-equal."""
    g = _card_graph(name)
    assert g.chunks.n_split > 0 and g.t_chunks.n_split > 0
    wh, el, er, gout = _op_inputs(g, bh, f, device=card)
    before = dict(sk.LAUNCHES)
    runs = []
    for _ in range(2):
        out, lse = sk.spmm_gat_fwd(g, wh, el, er, f)
        runs.append((out, lse, *sk.spmm_gat_bwd(g, gout, wh, el, er, lse, f)))
    torch.cuda.synchronize()
    for key in ("fwd", "fwd_combine", "bwd", "bwd_combine", "bwd_der", "bwd_del"):
        assert sk.LAUNCHES[f"spmm_gat_{key}_f32"] == before[f"spmm_gat_{key}_f32"] + 2, key
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    p_out, p_lse = sk.spmm_gat_fwd_plain(g, wh, el, er, f)
    torch.testing.assert_close(runs[0][0], p_out, **CARD_TOL)
    n = g.n_real_nodes
    torch.testing.assert_close(runs[0][1][:n], p_lse[:n], **CARD_TOL)
    want = sk.spmm_gat_bwd_plain(g, gout, wh, el, er, p_lse, f)
    for got, w, name_ in zip(runs[0][2:], want, ("dwh", "del", "der")):
        scale = float(w.abs().max())
        torch.testing.assert_close(got, w, rtol=CARD_TOL["rtol"],
                                   atol=CARD_TOL["atol"] * max(scale, 1.0), msg=name_)


@pytest.mark.cuda
def test_card_gat_model_launches_only_gat_kernels(card):
    """A BatchedGAT step on the card launches the GAT pair once a layer each
    way and no other aggregation kernel, and its probabilities and gradients
    match the same model's CPU (plain) step."""
    g = _graph(12, n=200, row_chunk=8)
    in_feats, hidden, heads, classes = VARIANTS["ppi"]
    refs = _refs("ppi", 3, seed=13)
    x, labels, mask, w = _inputs(g, in_feats, classes, seed=14)
    results = []
    for dev in ("cpu", "cuda"):
        port = _port("ppi", refs, batched=True).float().to(dev)
        gd = g.to(dev)
        before = dict(sk.LAUNCHES)
        loss = losses.multi_loss(port(gd, x.float().to(dev)).permute(1, 0, 2),
                                 labels.float().to(dev), mask.expand(3, -1).to(dev),
                                 w.float().to(dev))
        loss.sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in sk.LAUNCHES.items() if v != before[k]}
            assert set(delta) <= {f"spmm_gat_{k}_f32" for k in
                                  ("fwd", "fwd_combine", "bwd", "bwd_combine", "bwd_der",
                                   "bwd_del")}
            assert delta["spmm_gat_fwd_f32"] == 3 and delta["spmm_gat_bwd_f32"] == 3
        results.append([loss.detach().cpu()] + [p.grad.cpu() for p in port.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_card_refuses_a_width_the_kernels_take_not(card):
    g = _graph().to("cuda")
    wh, el, er, _ = _op_inputs(g, 2, 33, device=card)
    with pytest.raises(ValueError, match="per-head width"):
        sk.spmm_gat_fwd(g, wh, el, er, 33)
