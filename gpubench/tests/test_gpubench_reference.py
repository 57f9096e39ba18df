"""The plain reference against the port on tiny graphs (CPU: the port's
kernels run their plain versions there)."""
import torch

from gpubench.inputs import make_inputs
from gpubench.reference.model import PlainGraph, first_max, gcn_both
from gpubench.tests.tiny import tiny_cell
from plagnn_tpu_torch.ops.graph_format import build_graph
from plagnn_tpu_torch.ops.spmm import gcn_propagate, spmm_max


def _graph(self_loops):
    # rows 5 and 6 have no in-edge; row 0 many (a tie-heavy row); no self
    # pair and no duplicate, as the benchmark's graphs
    src = torch.tensor([1, 2, 3, 4, 7, 0, 2, 3, 1, 0, 2, 7, 2, 1])
    dst = torch.tensor([0, 0, 0, 0, 0, 1, 1, 2, 3, 3, 4, 4, 7, 7])
    n = 8
    port = build_graph(src.numpy(), dst.numpy(), n, add_self_loops=self_loops)
    return src, dst, n, port, PlainGraph.build(src, dst, n, self_loops)


def _both(port, n, x, fn_port, fn_ref, ref_graph, gen):
    x_p = torch.zeros((port.n_nodes, x.shape[1]))
    x_p[:n] = x
    x_p.requires_grad_(True)
    x_r = x.clone().requires_grad_(True)
    out_p = fn_port(port, x_p)
    out_r = fn_ref(ref_graph, x_r)
    g = torch.randn(out_r.shape, generator=gen)
    g_p = torch.zeros_like(out_p)
    g_p[:n] = g
    (out_p * g_p).sum().backward()
    (out_r * g).sum().backward()
    return out_p[:n].detach(), out_r.detach(), x_p.grad[:n], x_r.grad


def test_first_max_matches_port_with_ties_and_empty_rows():
    gen = torch.Generator().manual_seed(3)
    for self_loops in (False, True):
        src, dst, n, port, ref = _graph(self_loops)
        # small integers through a relu: most entries tie at 0 or at a value
        x = torch.relu(torch.randint(-2, 3, (n, 7), generator=gen).float())
        out_p, out_r, dx_p, dx_r = _both(port, n, x, spmm_max, first_max, ref, gen)
        assert torch.equal(out_p, out_r)
        assert torch.allclose(dx_p, dx_r, atol=1e-6)
        if not self_loops:
            assert torch.equal(out_r[5], torch.zeros(7)) and torch.equal(out_r[6], torch.zeros(7))


def test_first_max_routes_to_the_first_maximum():
    src, dst, n, port, ref = _graph(False)
    x = torch.ones((n, 2))                      # every in-edge of row 0 ties
    x.requires_grad_(True)
    first_max(ref, x)[0].sum().backward()
    # row 0's in-edges in (dst, src) order: 1, 2, 3, 4, 7 -> all to source 1
    assert torch.equal(x.grad[1], torch.ones(2))
    assert float(x.grad[2:5].abs().sum()) == 0.0


def test_gcn_both_matches_port():
    gen = torch.Generator().manual_seed(4)
    for self_loops in (False, True):
        src, dst, n, port, ref = _graph(self_loops)
        x = torch.randn((n, 5), generator=gen)
        out_p, out_r, dx_p, dx_r = _both(
            port, n, x, lambda g, v: gcn_propagate(g, v, "both"), gcn_both, ref, gen)
        assert torch.allclose(out_p, out_r, atol=1e-6)
        assert torch.allclose(dx_p, dx_r, atol=1e-6)


def test_inputs_repeat_from_the_seed_and_keep_their_sizes():
    cell = tiny_cell()
    a = make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = make_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = make_inputs(cell.config, cell.traffic, 7, "cpu")
    assert torch.equal(a.src, b.src) and torch.equal(a.feats, b.feats)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert a.src.numel() == c.src.numel() == cell.traffic["edges"]
    assert not torch.equal(a.src, c.src)
    pairs = set(zip(a.src.tolist(), a.dst.tolist()))
    assert len(pairs) == a.src.numel() and all(s != d for s, d in pairs)
    assert all((d, s) in pairs for s, d in pairs)
    # folds: disjoint validation sets, training = labelled minus validation
    lab = torch.zeros(a.n_pad, dtype=torch.bool)
    lab[a.label_idx] = True
    assert not (a.val_masks.sum(0) > 1).any()
    assert torch.equal(a.train_masks | a.val_masks, lab.expand_as(a.train_masks))
    assert bool(a.labels[: a.n].sum(0).min() > 0)
