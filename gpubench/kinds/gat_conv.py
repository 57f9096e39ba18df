"""GATConv (DGL 0.8; Velickovic et al., arXiv:1710.10903), ``heads`` heads
of ``out`` columns each:

    Wh     = h fc                                   (no bias)
    el, er = <Wh, attn_l>, <Wh, attn_r>             per head
    a_ij   = softmax over i's in-edges j of leaky_relu(el_j + er_i, 0.2)
    out_i  = sum_j a_ij Wh_j + residual_i + bias    per head

then ELU where ``elu`` is true (DGL applies a GATConv's activation inside
the layer), and the heads concatenated (``merge`` "concat") or averaged
("mean").  ``residual``: "none", "identity" (the input itself; in = heads x
out) or "linear" (``h res_fc``, no bias).  The softmax runs over the graph's
edges in blocks (``_EdgeSoftmax``), float32, so the (edges, K) temporaries
stay bounded; the row's log-sum-exp is kept and the weights recomputed in
the backward.

Init laws: DGL's Xavier-normal at gain sqrt(2) as Xavier-uniform bounds of
the same variance (the benchmark draws uniform): ``fc`` and ``res_fc`` (in,
heads x out) fans in and heads x out; ``attn_l`` and ``attn_r`` (heads, out)
the fans torch takes of DGL's (1, heads, out): heads x out and out; a zero
bias.  The aggregation runs in float32 whatever the configuration's
``agg_dtype``, as the port's does.
"""
import math

import torch
import torch.nn.functional as F

FLOAT32 = 4
SLOPE = 0.2          # GATConv's negative_slope, the paper's
RESIDUALS = ("none", "identity", "linear")


def xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))


def _shape(layer):
    i, h, f = layer["in"], layer["heads"], layer["out"]
    if layer["residual"] not in RESIDUALS or (layer["residual"] == "identity" and i != h * f):
        raise ValueError(f"layer {layer['name']}: residual {layer['residual']!r} takes one of "
                         f"{RESIDUALS}, 'identity' only where in = heads x out")
    return i, h, f


def leaves(layer):
    """(leaf, shape of one fold's leaf, bound) in draw order."""
    i, h, f = _shape(layer)
    out = [("fc", (i, h * f), xavier(i, h * f)),
           ("attn_l", (h, f), xavier(h * f, f)),
           ("attn_r", (h, f), xavier(h * f, f))]
    if layer["residual"] == "linear":
        out.append(("res_fc", (i, h * f), xavier(i, h * f)))
    return out + [("bias", (h * f,), 0.0)]


class _EdgeSoftmax(torch.autograd.Function):
    """out[i] = sum over in-edges j -> i of a_ij wh[j], per head of f columns,
    a the softmax over i's in-edges of leaky_relu(el[j] + er[i])."""

    @staticmethod
    def forward(ctx, wh, el, er, graph, f):
        n, k = wh.shape
        h = k // f
        big = torch.full((n, h), -math.inf, device=wh.device)
        for _, _, s, d in graph.blocks(h):
            big.scatter_reduce_(0, d[:, None].expand(-1, h),
                                F.leaky_relu(el[s] + er[d], SLOPE), "amax")
        total = torch.zeros((n, h), device=wh.device)
        for _, _, s, d in graph.blocks(h):
            total.index_add_(0, d, torch.exp(F.leaky_relu(el[s] + er[d], SLOPE) - big[d]))
        lse = big + torch.log(total)
        out = torch.zeros((n, k), device=wh.device)
        for _, _, s, d in graph.blocks(k):
            a = torch.exp(F.leaky_relu(el[s] + er[d], SLOPE) - lse[d])
            out.index_add_(0, d, (wh[s].view(-1, h, f) * a[..., None]).view(-1, k))
        ctx.graph, ctx.f = graph, f
        ctx.save_for_backward(wh, el, er, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        wh, el, er, lse = ctx.saved_tensors
        graph, f = ctx.graph, ctx.f
        n, k = wh.shape
        h = k // f

        def edge_terms(s, d):
            z = el[s] + er[d]
            a = torch.exp(F.leaky_relu(z, SLOPE) - lse[d])
            gd = g[d].view(-1, h, f)
            return z, a, gd, (gd * wh[s].view(-1, h, f)).sum(-1)

        dot = torch.zeros((n, h), device=g.device)          # D_i = sum_j a_ij da_ij
        for _, _, s, d in graph.blocks(k):
            _, a, _, da = edge_terms(s, d)
            dot.index_add_(0, d, a * da)
        dwh = torch.zeros_like(wh)
        d_el = torch.zeros((n, h), device=g.device)
        d_er = torch.zeros((n, h), device=g.device)
        for _, _, s, d in graph.blocks(k):
            z, a, gd, da = edge_terms(s, d)
            de = a * (da - dot[d])
            dz = torch.where(z > 0, de, SLOPE * de)
            d_el.index_add_(0, s, dz)
            d_er.index_add_(0, d, dz)
            dwh.index_add_(0, s, (gd * a[..., None]).view(-1, k))
        return dwh, d_el, d_er, None, None


def forward(layer, config, graph, h, p):
    _, heads, f = _shape(layer)
    wh = h @ p["fc"]
    whv = wh.view(-1, heads, f)
    el = (whv * p["attn_l"]).sum(-1)
    er = (whv * p["attn_r"]).sum(-1)
    out = _EdgeSoftmax.apply(wh.contiguous(), el.contiguous(), er.contiguous(), graph, f)
    if layer["residual"] == "identity":
        out = out + h
    elif layer["residual"] == "linear":
        out = out + h @ p["res_fc"]
    out = out + p["bias"]
    if layer["elu"]:
        out = F.elu(out)
    return out.view(-1, heads, f).mean(1) if layer["merge"] == "mean" else out


def matmuls(layer, first: bool):
    """(multiply-adds a node, whether the input takes a gradient): fc and
    res_fc read the layer input; el and er, heads x out each, read Wh,
    which takes a gradient."""
    i, h, f = _shape(layer)
    mm = [(i * h * f, not first)]
    if layer["residual"] == "linear":
        mm.append((i * h * f, not first))
    return mm + [(h * f, True), (h * f, True)]


def fwd_bytes(g, k: int, groups: int) -> int:
    """The forward's compulsory bytes at K = folds x heads x out and
    ``groups`` = folds x heads: wh, el, er and the index (indptr, src) read,
    out and the rows' log-sum-exp written."""
    return (2 * g.n_pad * k + 3 * g.n_pad * groups) * FLOAT32 + 4 * (g.n_pad + 1 + g.edges)


def bwd_bytes(g, k: int, groups: int) -> int:
    """The backward's: the gradient, wh, el, er, lse, both indices and each
    edge's transpose position read; dwh, del and der written."""
    return ((3 * g.n_pad * k + 5 * g.n_pad * groups) * FLOAT32
            + 2 * 4 * (g.n_pad + 1 + g.edges) + 4 * g.edges)


def aggregation_bytes(layer, g, folds: int, esize: int) -> int:
    """The edge-softmax pair at K = folds x heads x out, in float32."""
    _, h, f = _shape(layer)
    return fwd_bytes(g, folds * h * f, folds * h) + bwd_bytes(g, folds * h * f, folds * h)
