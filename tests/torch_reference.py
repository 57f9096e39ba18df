"""Torch reference implementation of the layer semantics the reference repo
gets from DGL 0.8.2 (dgl.nn.pytorch.SAGEConv('pool')) — used to generate
golden activations for parity tests (SURVEY.md §4(b)).

DGL itself is not installable in this environment, so this re-states the
documented 0.8.x semantics directly (see SURVEY.md §2.2):
    h_pool_j = relu(fc_pool(h_j))
    m_i      = elementwise max over in-neighbors j of i (0 if none)
    out_i    = fc_self(h_i) + fc_neigh(m_i) + bias
with fc_self/fc_neigh bias-free and one shared zero-init output bias.
"""
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class RefSagePool(nn.Module):
    def __init__(self, in_feats, out_feats):
        super().__init__()
        self.fc_pool = nn.Linear(in_feats, in_feats)
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_feats))
        gain = nn.init.calculate_gain("relu")
        nn.init.xavier_uniform_(self.fc_pool.weight, gain=gain)
        nn.init.xavier_uniform_(self.fc_self.weight, gain=gain)
        nn.init.xavier_uniform_(self.fc_neigh.weight, gain=gain)

    def forward(self, adj_lists, x):
        pooled = F.relu(self.fc_pool(x))
        m = torch.zeros_like(pooled)
        for i, nb in enumerate(adj_lists):
            if len(nb):
                m[i] = pooled[nb].max(dim=0).values
        m = self.fc_neigh(m)
        return self.fc_self(x) + m + self.bias


class RefGNN32(nn.Module):
    """Mirror of /root/reference/code/model.py:10-31 (GNN32)."""

    def __init__(self, in_feats, h1, h2, h3, h4, num_classes):
        super().__init__()
        self.conv1 = RefSagePool(in_feats, h1)
        self.conv2 = RefSagePool(h1, h2)
        self.conv3 = RefSagePool(h2, h3)
        self.liner1 = nn.Linear(h3, h4)
        self.liner2 = nn.Linear(h4, num_classes)

    def forward(self, adj_lists, x, return_acts=False):
        acts = {}
        h = self.conv1(adj_lists, x)
        acts["conv1"] = h
        h = F.leaky_relu(h)
        h = self.conv2(adj_lists, h)
        acts["conv2"] = h
        h = F.leaky_relu(h)
        h = self.conv3(adj_lists, h)
        acts["conv3"] = h
        h = F.leaky_relu(h)
        h = self.liner1(h)
        acts["liner1"] = h
        h = F.leaky_relu(h)
        h = self.liner2(h)
        acts["liner2"] = h
        out = torch.sigmoid(h)
        acts["out"] = out
        if return_acts:
            return acts
        return out


def adj_lists_from_edges(src, dst, n, self_loops=True):
    """In-neighbor lists including explicit self-loops (dgl.add_self_loop)."""
    lists = [[] for _ in range(n)]
    for s, d in zip(src, dst):
        lists[int(d)].append(int(s))
    if self_loops:
        for i in range(n):
            lists[i].append(i)
    return lists


def export_sage_params(conv: RefSagePool):
    """Torch (out,in) weights → JAX (in,out) param dict."""
    return {
        "w_pool": conv.fc_pool.weight.detach().numpy().T.copy(),
        "b_pool": conv.fc_pool.bias.detach().numpy().copy(),
        "w_self": conv.fc_self.weight.detach().numpy().T.copy(),
        "w_neigh": conv.fc_neigh.weight.detach().numpy().T.copy(),
        "bias": conv.bias.detach().numpy().copy(),
    }


def export_linear_params(lin: nn.Linear):
    return {
        "weight": lin.weight.detach().numpy().T.copy(),
        "bias": lin.bias.detach().numpy().copy(),
    }


def export_gnn32_params(model: RefGNN32):
    return {
        "conv1": export_sage_params(model.conv1),
        "conv2": export_sage_params(model.conv2),
        "conv3": export_sage_params(model.conv3),
        "liner1": export_linear_params(model.liner1),
        "liner2": export_linear_params(model.liner2),
    }


class RefGATConv(nn.Module):
    """DGL 0.8 ``GATConv`` (Velickovic et al., arXiv:1710.10903) in plain
    torch, a per-row softmax over each row's in-edges written directly:
        h = fc(x) (no bias), el = <h, attn_l>, er = <h, attn_r>   per head
        a_ij = softmax over i's in-neighbours j of leaky_relu(el_j + er_i, 0.2)
        out_i = sum_j a_ij h_j + res_fc(x_i) + bias               per head
    then ``activation``.  ``residual``: res_fc is the identity where the
    input is as wide as the heads' output, else a Linear with no bias.
    DGL's init: Xavier-normal at gain sqrt(2), zero bias."""

    def __init__(self, in_feats, out_feats, num_heads, residual=False, activation=None):
        super().__init__()
        self.h, self.f = num_heads, out_feats
        self.fc = nn.Linear(in_feats, out_feats * num_heads, bias=False)
        self.attn_l = nn.Parameter(torch.empty(1, num_heads, out_feats))
        self.attn_r = nn.Parameter(torch.empty(1, num_heads, out_feats))
        self.res_fc = None
        if residual:
            self.res_fc = (nn.Identity() if in_feats == out_feats * num_heads
                           else nn.Linear(in_feats, out_feats * num_heads, bias=False))
        self.bias = nn.Parameter(torch.zeros(out_feats * num_heads))
        self.activation = activation
        gain = nn.init.calculate_gain("relu")
        nn.init.xavier_normal_(self.fc.weight, gain=gain)
        nn.init.xavier_normal_(self.attn_l, gain=gain)
        nn.init.xavier_normal_(self.attn_r, gain=gain)
        if isinstance(self.res_fc, nn.Linear):
            nn.init.xavier_normal_(self.res_fc.weight, gain=gain)

    def forward(self, adj_lists, x):
        """(N, heads, out_feats)."""
        h = self.fc(x).view(-1, self.h, self.f)
        el = (h * self.attn_l).sum(-1)
        er = (h * self.attn_r).sum(-1)
        rows = []
        for i, nb in enumerate(adj_lists):
            if not nb:
                rows.append(torch.zeros(self.h, self.f, dtype=x.dtype))
                continue
            a = torch.softmax(F.leaky_relu(el[nb] + er[i], 0.2), dim=0)
            rows.append((a[..., None] * h[nb]).sum(0))
        out = torch.stack(rows)
        if self.res_fc is not None:
            out = out + self.res_fc(x).view(-1, self.h, self.f)
        out = out + self.bias.view(1, self.h, self.f)
        return out if self.activation is None else self.activation(out)


class RefGAT(nn.Module):
    """DGL's ``examples/pytorch/gat/train_ppi.py`` model: GATConv layers of
    heads[l] x hidden[l] with ELU, concatenated (residuals past the first),
    a last GATConv of heads[-1] x num_classes with a residual, its heads
    averaged; sigmoid probabilities (PLA-GNN's multi-label output)."""

    def __init__(self, in_feats, hidden, heads, num_classes):
        super().__init__()
        ins = [in_feats] + [f * h for f, h in zip(hidden, heads)]
        self.layers = nn.ModuleList(
            [RefGATConv(ins[l], f, heads[l], residual=l > 0, activation=F.elu)
             for l, f in enumerate(hidden)]
            + [RefGATConv(ins[-1], num_classes, heads[-1], residual=True)])

    def forward(self, adj_lists, x):
        h = x
        for layer in self.layers[:-1]:
            h = layer(adj_lists, h).flatten(1)
        return torch.sigmoid(self.layers[-1](adj_lists, h).mean(1))


def export_gat_params(model: RefGAT, grads: bool = False):
    """{'conv1.fc': (in, H*F), 'conv1.attn_l': (H, F), ...}: the port's
    GAT names and layouts (weights stored (in, out)); with ``grads`` the
    parameters' gradients in the same layout."""
    def get(t):
        return (t.grad if grads else t).detach().clone()

    out = {}
    for l, layer in enumerate(model.layers):
        p = f"conv{l + 1}."
        out[p + "fc"] = get(layer.fc.weight).T
        out[p + "attn_l"] = get(layer.attn_l)[0]
        out[p + "attn_r"] = get(layer.attn_r)[0]
        if isinstance(layer.res_fc, nn.Linear):
            out[p + "res_fc"] = get(layer.res_fc.weight).T
        out[p + "bias"] = get(layer.bias)
    return out
