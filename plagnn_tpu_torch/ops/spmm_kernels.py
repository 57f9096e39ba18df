"""Fold-batched segment max and sum, with their backwards.

Port of ``pallas_spmm_max`` and ``pallas_spmm_sum``
(``plagnn_tpu/ops/pallas/spmm_kernels.py``) and their custom VJPs.
Features are (N_pad, K) with K = B*F, the fold batch packed next to the
features, so one pass over the edges serves every fold.

Four kernel files, six wrappers, each with a plain PyTorch version beside it:

* ``spmm_max_fwd``: ``csrc/spmm_max_fwd.cu`` (float32 or bfloat16, with or
  without the argmax; ``empty_value`` is what an empty row stores: 0 on one
  device, -inf for a graph shard's partial maxima).  Plain version:
  ``spmm_max_fwd_plain``.
* ``spmm_max_bwd``: ``csrc/spmm_max_bwd.cu`` (``spmm_max_bwd_f32`` and
  ``spmm_max_bwd_bf16``).  Plain version: ``spmm_max_bwd_plain``.

The argmax takes one of two forms, as the graph says (``Graph.positional``,
on by default past 2^15 padded nodes): the source id of the first maximum
(int16 up to 2^15 padded nodes, else int32), or its rank within the row,
int16 at any size (the JAX package's positional argmax).  A positional
argmax has ``Graph.n_mega`` more rows than the graph: a mega row stores its
rank modulo ``Graph.rank_cap`` and its side-table row the segment, ``rank //
rank_cap``; without mega rows it is (N_pad, K) int16.  The training path
never decodes it; ``_arg_sources`` does, for the checks only.
* ``spmm_sum_rows``: ``csrc/spmm_sum.cu``, one kernel over the
  destination-sorted CSR (forward) or its transpose (the VJP), float32 or
  bfloat16 with a float32 sum, each term optionally weighted by its edge
  value (``use_val``: ``Graph.val`` / ``t_val``).  Plain version:
  ``spmm_sum_plain``.
* ``spmm_sum_gcn_rows``: the same file's scaled instantiation, GraphConv's
  norm='both' propagation and bias in one pass (``gcn_scales``: each
  source's out-degree^-1/2 on its gathered terms, each row's
  in-degree^-1/2 and the bias at the store; its VJP the same kernel over
  the transpose, the scales swapped, no bias).  Plain version:
  ``spmm_sum_gcn_plain``, the composition of separate passes whose bits
  the kernel keeps.
* ``spmm_gat_fwd`` / ``spmm_gat_bwd``: ``csrc/spmm_gat.cu``, GAT's
  edge-softmax aggregation (float32): for each row and (fold, head) group
  of F columns, the softmax over the row's in-edges of ``leaky_relu(el[src]
  + er[dst])`` weighting the sum of ``wh[src]``, as an online softmax in one
  walk of the row chunks (no per-edge weight stored; the row's log-sum-exp
  kept for the backward), and its backward (``dwh`` over the transpose, the
  logits' gradients ``del`` / ``der`` by two narrow passes).  Plain
  versions: ``spmm_gat_fwd_plain``, ``spmm_gat_bwd_plain``.

All of them walk the graph's row chunks (``Graph.chunks`` / ``t_chunks``,
``csrc/row_chunks.cuh``): their wrappers pass the direction's chunk table
and a float32 scratch for the partials of split rows (the max forward also
an int32 scratch for the partials' sources).

The K-slice of the two max kernels: a block walks one slice of the rows'
columns for its chunks, and the grid runs the chunks fastest, so the blocks
in flight share the slice's rows.  ``slice_bytes`` picks the width: 1 KB,
32 lanes of 32 bytes, up to a working set (N_pad rows of the 1 KB slice)
past which the card's sweeps measured narrower slices faster
(``WIDE_SLICE_FROM``; every 24k-node shape and the mesh path's shards stay
below it), and past it the width measured fastest on the 165 k- and 330
k-node graphs for that direction and dtype (``WIDE_SLICE``), where groups
of fewer lanes walk several chunks a warp.  The sum and the hub instantiations keep
the 1 KB slice.

The hub cache (``Graph.hub`` / ``t_hub``, ``graph_format.HubTable``;
``Graph.with_hub``): where the graph carries a direction's hub table, the
wrapper launches that kernel's hub instantiation, which reads the hub
edges' rows from a shared-memory arena of the k most-fetched rows
(counted as ``*_hub_*``): the max forward that records the argmax, the max
backward, and the unweighted sum in either direction.  The forward without
the argmax and the weighted sum (``use_val``; an XLA sum with no hub in the
JAX package) run the kernels without the hub on any graph.  Each plain
version reads the same arena, ``x[ids]``, in place of ``x[src]`` for the
hub edges, so the CPU tests run the hub's tables; its result is the one
without the hub, bit for bit.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches, so a run can show that its path went through the kernels, and
``LAUNCH_SHAPES`` the same launches by shape.  They count in Python at the
launch, so a CUDA graph's replay counts nothing: the runner captures into
emptied registries (``take_launches``) and credits what they then hold on
each replay (``credit_launches``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .graph_format import Graph, HubTable

# spmm_max_fwd_* count forwards that record the argmax (the training
# path), spmm_max_fwd_noarg_* those that do not; *_empty_* those whose
# empty_value is not 0 (a graph shard's interior and boundary passes).
LAUNCHES: Dict[str, int] = {
    "spmm_max_fwd_f32": 0,
    "spmm_max_fwd_bf16": 0,
    "spmm_max_fwd_noarg_f32": 0,
    "spmm_max_fwd_noarg_bf16": 0,
    "spmm_max_fwd_empty_f32": 0,
    "spmm_max_fwd_empty_bf16": 0,
    "spmm_max_fwd_noarg_empty_f32": 0,
    "spmm_max_fwd_noarg_empty_bf16": 0,
    "spmm_max_bwd_f32": 0,
    "spmm_max_bwd_bf16": 0,
    # the positional argmax (a graph past 2^15 padded nodes)
    "spmm_max_fwd_pos_f32": 0,
    "spmm_max_fwd_pos_bf16": 0,
    "spmm_max_bwd_pos_f32": 0,
    "spmm_max_bwd_pos_bf16": 0,
    "spmm_sum_fwd_f32": 0,
    "spmm_sum_fwd_bf16": 0,
    "spmm_sum_bwd_f32": 0,
    "spmm_sum_bwd_bf16": 0,
    "spmm_sum_val_fwd_f32": 0,
    "spmm_sum_val_fwd_bf16": 0,
    "spmm_sum_val_bwd_f32": 0,
    "spmm_sum_val_bwd_bf16": 0,
    # GCN's scaled sum (GraphConv norm='both' with its bias)
    "spmm_sum_gcn_fwd_f32": 0,
    "spmm_sum_gcn_fwd_bf16": 0,
    "spmm_sum_gcn_bwd_f32": 0,
    "spmm_sum_gcn_bwd_bf16": 0,
    # the hub cache (a graph with Graph.hub / t_hub)
    "spmm_max_fwd_hub_f32": 0,
    "spmm_max_fwd_hub_bf16": 0,
    "spmm_max_bwd_hub_f32": 0,
    "spmm_max_bwd_hub_bf16": 0,
    "spmm_sum_fwd_hub_f32": 0,
    "spmm_sum_fwd_hub_bf16": 0,
    "spmm_sum_bwd_hub_f32": 0,
    "spmm_sum_bwd_hub_bf16": 0,
    # GAT's edge-softmax aggregation (csrc/spmm_gat.cu): the forward and its
    # combine of split rows; the backward's K-wide pass over the transpose,
    # its combine, the der pass and the del pass (their combines inside)
    "spmm_gat_fwd_f32": 0,
    "spmm_gat_fwd_combine_f32": 0,
    "spmm_gat_bwd_f32": 0,
    "spmm_gat_bwd_combine_f32": 0,
    "spmm_gat_bwd_der_f32": 0,
    "spmm_gat_bwd_del_f32": 0,
}

# LAUNCHES by (counter, graph rows, graph edges, K): which shapes a run
# launched each kernel at (a graph shard's interior or boundary pass).
LAUNCH_SHAPES: Dict[Tuple[str, int, int, int], int] = {}
# The K-slice width (bytes of the gathered operand a row) of the last launch
# by (counter, graph rows, K): the width a max wrapper passed to its kernel,
# the fixed 1 KB of the sum and the hub kernels.
LAUNCH_SLICES: Dict[Tuple[str, int, int], int] = {}

_DTYPE_CODE = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}
_ARG_BITS = {torch.int16: 16, torch.int32: 32}
# Elements of the (edges, K) temporaries the plain versions materialize at
# once, so they run at the slice's full width on the card too.
_PLAIN_CHUNK = 1 << 26


# Slice widths the max kernels take, in bytes of the gathered operand a row
# (x forward, g backward): 32 lanes' 32 bytes down to one lane's.
SLICE_WIDTHS = (1024, 512, 256, 128, 64, 32)
# The working set (N_pad rows x the 1 KB slice's bytes of x, or of g and
# argmax) past which a max kernel leaves the 1 KB slice: a threshold between
# two measured sizes (chip_smoke.py --sweep-slice, NVIDIA H100 80GB HBM3,
# 700 W), not an L2 budget.  At 110 MB and below, 2.1 times the 50 MiB L2
# (the mesh path's shards: 35,936 rows at P = 2), 1 KB ran fastest in every
# form; at 169 MB and above (165,120 and 330,112 rows) WIDE_SLICE's widths
# did.  Sizes between are not measured.
WIDE_SLICE_FROM = 128 * 2**20
# Past WIDE_SLICE_FROM: the width that ran fastest at layer 1 (K = 8 x 503)
# on the 165,120- and 330,112-row graphs (BASELINE.json config 5: E 10.33 M),
# by (bytes of an element of the gathered operand, bytes of an argmax
# element gathered beside it: 0 in the forward).  No byte count alone picks
# these: the f32 and bf16 forwards gather the same bytes and go opposite
# ways.  Layer-1 ms at 330 k rows, 1 KB in brackets (PERF.md, PR 13):
WIDE_SLICE = {
    (4, 0): 256,    # forward f32: 36.41 positional, 35.90 id-based (37.49, 38.33)
    (2, 0): 1024,   # forward bf16: 23.47 at 512 B (20.33)
    (4, 2): 1024,   # positional backward f32: 59.53 at 512 B (58.25)
    (2, 2): 512,    # positional backward bf16: 38.17 (39.96)
    (4, 4): 256,    # id-based int32 backward f32: 70.15 (76.46)
    (2, 4): 256,    # id-based int32 backward bf16: 55.55 (59.99)
}


def slice_bytes(n_rows: int, esize: int, arg_size: int = 0) -> int:
    """The max kernels' K-slice width in bytes of the gathered operand a row
    (x of ``esize`` bytes an element in the forward, ``arg_size`` 0; g in
    the backward, whose argmax of ``arg_size`` bytes an element is gathered
    beside it): 1 KB while ``n_rows`` rows of the 1 KB slice come to at most
    WIDE_SLICE_FROM bytes, else WIDE_SLICE's width."""
    if n_rows * (1024 + 1024 // esize * arg_size) <= WIDE_SLICE_FROM:
        return 1024
    return WIDE_SLICE[esize, arg_size]


def vector_width(k_width: int, max_esize: int) -> int:
    """The lane vector the kernels take at K (row_chunks.cuh: vector_width,
    for pointers aligned as a tensor's own storage is): the widest of 8, 4,
    2 elements dividing K within 16 bytes of the largest element, else 1."""
    for v in (8, 4, 2):
        if k_width % v == 0 and v * max_esize <= 16:
            return v
    return 1


def slice_layout(width: int, k_width: int, esize: int, max_esize: int = 0):
    """(lanes a group, elements a K-slice, K-slices) of a max kernel at this
    width (bytes of the gathered operand, elements of ``esize`` bytes; the
    lane vector also counts ``max_esize``, the backward's argmax): a lane
    holds J vectors of V elements, 32 bytes or 8 vectors
    (row_chunks.cuh: vectors_per_lane), and a group as many lanes, 1 to 32,
    as the width holds (group_log2)."""
    _check_slice(width)
    v = vector_width(k_width, max(esize, max_esize))
    j = min(max(32 // (v * esize), 1), 8)
    g = min(max(width // (j * v * esize), 1), 32)
    return g, g * j * v, -(-k_width // (g * j * v))


def _check_slice(width: Optional[int]) -> None:
    if width is not None and width not in SLICE_WIDTHS:
        raise ValueError(f"K-slice width must be one of {SLICE_WIDTHS} bytes, got {width}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


LaunchCounts = Tuple[Dict[str, int], Dict[Tuple[str, int, int, int], int],
                     Dict[Tuple[str, int, int], int]]


def take_launches() -> LaunchCounts:
    """What the three registries hold, emptied: LAUNCHES' counts to 0,
    LAUNCH_SHAPES and LAUNCH_SLICES cleared."""
    held = dict(LAUNCHES), dict(LAUNCH_SHAPES), dict(LAUNCH_SLICES)
    reset_launches()
    LAUNCH_SLICES.clear()
    return held


def credit_launches(counts: LaunchCounts) -> None:
    """Add ``counts`` (a ``take_launches``) into the registries: LAUNCHES'
    and LAUNCH_SHAPES' counts rise by theirs, LAUNCH_SLICES takes its
    widths.  A CUDA graph's replay runs the launches that its capture
    counted, and the wrappers count nothing then."""
    for reg, add in zip((LAUNCHES, LAUNCH_SHAPES), counts[:2]):
        for k, v in add.items():
            reg[k] = reg.get(k, 0) + v
    LAUNCH_SLICES.update(counts[2])


def _count(name: str, graph: Graph, k: int, width: int = 1024) -> None:
    LAUNCHES[name] += 1
    key = (name, graph.n_nodes, graph.n_edges, k)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    LAUNCH_SLICES[name, graph.n_nodes, k] = width


def argmax_bytes(n_rows: int) -> int:
    """Bytes of an element of the id-based argmax over ``n_rows`` padded
    rows: 2 (int16) while every row id fits, else 4 (int32).  Also sizes a
    hub's backward arena before its graph is built (``ops/hub.py``)."""
    return 2 if n_rows <= (1 << 15) else 4


def arg_dtype(graph: Graph) -> torch.dtype:
    """The saved argmax's type: int16 for ranks (a positional graph), else
    the id-based argmax's (``argmax_bytes``)."""
    if graph.positional or argmax_bytes(graph.n_nodes) == 2:
        return torch.int16
    return torch.int32


def arg_rows(graph: Graph) -> int:
    """Rows of the saved argmax: N_pad, plus the side table's one row per
    mega row of a positional graph."""
    return graph.n_nodes + graph.n_mega


def _fwd_rank(graph: Graph, e0: int, e1: int) -> torch.Tensor:
    """Each forward edge's rank within its row, edges [e0, e1)."""
    e = torch.arange(e0, e1, device=graph.device)
    return e - graph.indptr.long()[graph.dst[e0:e1].long()]


def _arg_sources(graph: Graph, arg: torch.Tensor) -> torch.Tensor:
    """The source id (int64) of each recorded argmax, -1 for an empty row:
    the id-based argmax as it is, a positional one decoded from its rank
    (and a mega row's segment).  Works on any column slice of ``arg``.  For
    the checks (the tests, ``chip_smoke.py``) that hold the two forms to
    the same sources; no code of the package calls it."""
    n = graph.n_nodes
    if not graph.positional:
        return arg.long()
    rank = arg[:n].long()
    if graph.n_mega:
        mega = torch.nonzero(graph.mega_of >= 0).squeeze(1)
        rank[mega] += arg[n:].long() * graph.rank_cap
    start = graph.indptr.long()[:n, None]
    ids = graph.src.long()[(start + rank).clamp(0, max(graph.n_edges - 1, 0))]
    return torch.where(rank >= 0, ids, -1)


def _positional_arg(graph: Graph, rank: torch.Tensor) -> torch.Tensor:
    """The positional argmax of first-max ranks (N_pad, K): a mega row's
    rank modulo the cap, its segment appended as the side table's row."""
    if graph.n_mega:
        mega = torch.nonzero(graph.mega_of >= 0).squeeze(1)  # ascending = index order
        r = rank[mega]
        rank[mega] = r % graph.rank_cap
        rank = torch.cat([rank, r // graph.rank_cap])
    return rank.to(torch.int16)


def _check(graph: Graph, t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.shape[0] != graph.n_nodes:
        raise ValueError(
            f"{what} must be (N_pad={graph.n_nodes}, K), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device != graph.device:
        raise ValueError(f"{what} on {t.device}, graph on {graph.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# C signature of each library's entry point (named after the library);
# pointers and the stream as c_void_p, so ctypes passes them at full width.
#   spmm_max_fwd: dtype, arg_bits, x, <chunk table>, src, split_row,
#                 split_ptr, n_split, out, arg, partial_val, partial_src, k,
#                 empty_value (float), <positional>, chunk_cap (int), order,
#                 slice_bytes (int), stream
#   spmm_max_bwd: dtype, arg_bits, g, arg, <chunk table>, t_dst,
#                 split_row, split_ptr, n_split, dx, partial, k,
#                 <positional>, t_rank, order, slice_bytes (int), stream
#   spmm_sum:     dtype, x, <chunk table>, idx, val, split_row, split_ptr,
#                 n_split, out, partial, k, stream
#   spmm_sum_gcn: dtype, x, <chunk table>, idx, pre, post, bias, split_row,
#                 split_ptr, n_split, out, partial, k, stream
#   spmm_gat_fwd: wh, el, er, <chunk table>, src, split_row, split_ptr,
#                 n_split, out, lse, partial, pm, ps, k, f (int), slope
#                 (float), stream
#   spmm_gat_bwd: g, wh, el, er, lse, <transpose chunk table>, t_dst,
#                 t_split_row, t_split_ptr, t_n_split, <chunk table>, src,
#                 t_pos, split_row, split_ptr, n_split, dwh, del, der, dalpha,
#                 partial, pdel, pd, pder, k, f (int), slope (float), stream
# where <chunk table> is chunk_row, chunk_ptr, chunk_slot, n_chunks, and
# <positional> is positional (int), mega_of, seg (the argmax's side table),
# rank_cap (int).  The hub entries (*_hub) take <hub> = <chunk table>,
# idx (the coded index), ids, hub_k (int) in place of the chunk table and
# index:
#   spmm_max_fwd_hub: dtype, arg_bits, x, <hub>, split_row, split_ptr,
#                     n_split, out, arg, partial_val, partial_src, tickets,
#                     n_tickets, k, empty_value (float), stream
#   spmm_max_bwd_hub: dtype, arg_bits, g, arg, <hub>, split_row, split_ptr,
#                     n_split, dx, partial, tickets, n_tickets, k, stream
#   spmm_sum_hub:     dtype, x, <hub>, split_row, split_ptr, n_split, out,
#                     partial, tickets, n_tickets, k, stream
# (tickets: _hub_tickets) and *_hub_warps (dtype, [arg_bits,] k, hub_k, a
# pointer to five ints) launch nothing: they get the warps an SM holds with
# and without the hub, the arena's stages, hub blocks an SM and fill route.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_CHUNKS = [_P, _P, _P, _LL]
_POS = [_I, _P, _P, _I]
_HUB = [*_CHUNKS, _P, _P, _I]
_SPLIT = [_P, _P, _LL]
_ARGTYPES = {
    "spmm_max_fwd": [_I, _I, _P, *_CHUNKS, _P, _P, _P, _LL, _P, _P, _P, _P, _LL, _F,
                     *_POS, _I, _P, _I, _P],
    "spmm_max_bwd": [_I, _I, _P, _P, *_CHUNKS, _P, _P, _P, _LL, _P, _P, _LL, *_POS, _P,
                     _P, _I, _P],
    "spmm_sum": [_I, _P, *_CHUNKS, _P, _P, _P, _P, _LL, _P, _P, _LL, _P],
    "spmm_sum_gcn": [_I, _P, *_CHUNKS, _P, _P, _P, _P, *_SPLIT, _P, _P, _LL, _P],
    "spmm_gat_fwd": [_P, _P, _P, *_CHUNKS, _P, *_SPLIT, _P, _P, _P, _P, _P, _LL, _I, _F, _P],
    "spmm_gat_bwd": [_P, _P, _P, _P, _P, *_CHUNKS, _P, *_SPLIT, *_CHUNKS, _P, _P, *_SPLIT,
                     _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _P],
    "spmm_max_fwd_hub": [_I, _I, _P, *_HUB, *_SPLIT, _P, _P, _P, _P, _P, _LL, _LL, _F, _P],
    "spmm_max_bwd_hub": [_I, _I, _P, _P, *_HUB, *_SPLIT, _P, _P, _P, _LL, _LL, _P],
    "spmm_sum_hub": [_I, _P, *_HUB, *_SPLIT, _P, _P, _P, _LL, _LL, _P],
    "spmm_max_fwd_hub_warps": [_I, _I, _LL, _I, _P],
    "spmm_max_bwd_hub_warps": [_I, _I, _LL, _I, _P],
    "spmm_sum_hub_warps": [_I, _LL, _I, _P],
}


def _fn(lib_name: str, fn_name: Optional[str] = None):
    """An entry point of a kernel library (by default the one named after
    it), its signature declared."""
    fn = getattr(_build.load(lib_name), fn_name or lib_name)
    fn.argtypes = _ARGTYPES[fn_name or lib_name]
    fn.restype = ctypes.c_int
    return fn


def _chunk_args(graph: Graph, transpose: bool, k: int, device):
    """The direction's chunk table as the C entry points take it (row, ptr,
    slot, n_chunks, [idx,] split_row, split_ptr, n_split), and a float32
    scratch of (n_slots, k) for the split rows' partials."""
    ch = graph.t_chunks if transpose else graph.chunks
    if ch is None:
        raise ValueError("graph has no row-chunk tables: build it with build_graph")
    idx = graph.t_dst if transpose else graph.src
    partial = torch.empty((ch.n_slots, k), dtype=torch.float32, device=device)
    args = (ch.row.data_ptr(), ch.ptr.data_ptr(), ch.slot.data_ptr(), ch.n_chunks,
            idx.data_ptr(), ch.split_row.data_ptr(), ch.split_ptr.data_ptr(),
            ch.n_split)
    return args, partial


def _pos_args(graph: Graph, arg: Optional[torch.Tensor]):
    """<positional> of the C entry points: (1, mega_of, seg, rank_cap) for a
    positional argmax, else (0, null, null, 0)."""
    if arg is None or not graph.positional:
        return 0, None, None, 0
    if graph.t_rank is None:
        raise ValueError("positional graph without t_rank: build it with build_graph")
    mega = graph.mega_of.data_ptr() if graph.n_mega else None
    seg = arg[graph.n_nodes:].data_ptr() if graph.n_mega else None
    return 1, mega, seg, graph.rank_cap


def _row_chunks(indptr: np.ndarray, k: int):
    """Row ranges whose edges times K stay under _PLAIN_CHUNK elements (a
    row larger than that gets a range of its own)."""
    n = len(indptr) - 1
    budget = max(_PLAIN_CHUNK // max(k, 1), 1)
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + budget, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        yield r0, r1
        r0 = r1


def _coded_rows(t: torch.Tensor, coded: torch.Tensor, hub: Optional[HubTable]):
    """(rows of t for a run of a direction's neighbour entries, their node
    ids): ``t[nbr]``, where a hub edge (``HubTable.idx``'s -1 - slot) reads
    the arena ``t[ids]`` at its slot."""
    coded = coded.long()
    if hub is None:
        return t[coded], coded
    slot = -1 - coded
    on = slot >= 0
    ids = hub.ids.long()
    rows = t[coded.clamp(min=0)]
    rows[on] = t[ids][slot[on]]
    return rows, torch.where(on, ids[slot.clamp(min=0)], coded)


def _node_rows(t: torch.Tensor, nodes: torch.Tensor, hub: Optional[HubTable]):
    """``t[nodes]``, the hub's rows read from its arena ``t[ids]`` (for a
    plain version that walks the other direction's edge order)."""
    nodes = nodes.long()
    if hub is None:
        return t[nodes]
    slot_of = torch.full((t.shape[0],), -1, dtype=torch.long, device=t.device)
    slot_of[hub.ids[:hub.n_hub].long()] = torch.arange(hub.n_hub, device=t.device)
    slot = slot_of[nodes]
    on = slot >= 0
    rows = t[nodes]
    rows[on] = t[hub.ids.long()][slot[on]]
    return rows


def _hub_args(chunks, hub: HubTable):
    """The hub entries' arguments from ``_chunk_args``'s: the chunk table,
    the direction's coded index in place of its index, the slots' ids and
    k, the split rows."""
    return (*chunks[:4], hub.idx.data_ptr(), hub.ids.data_ptr(), hub.k, *chunks[5:])


# The hub kernels' per-slice chunk tickets by (device, stream): zeros that
# each launch leaves zero (its last draw of a slice's ticket resets it), so
# the launches of a stream, in its order, share one.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _hub_tickets(k: int, device: torch.device) -> torch.Tensor:
    """The tickets of the launches at width ``k`` on ``device``'s current
    stream: one for each K-slice of at least 256 elements
    (``csrc/row_chunks.cuh: hub_pipeline``); zeroed once, when first needed
    or outgrown."""
    n = -(-k // 256)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _hub_info(kind: str, dtype: torch.dtype, k_width: int, hub_k: int,
              arg_type: torch.dtype):
    """The ``*_hub_warps`` entry's five ints for ``kind``."""
    code = _DTYPE_CODE[dtype][0]
    info = (ctypes.c_int * 5)()
    if kind in ("max_fwd", "max_bwd"):
        rc = _fn(f"spmm_{kind}", f"spmm_{kind}_hub_warps")(
            code, _ARG_BITS[arg_type], k_width, int(hub_k), info)
    elif kind == "sum":
        rc = _fn("spmm_sum", "spmm_sum_hub_warps")(code, k_width, int(hub_k), info)
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if rc != 0:
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error {rc}")
    return list(info)


def hub_warps(kind: str, dtype: torch.dtype, k_width: int, hub_k: int,
              arg_type: torch.dtype = torch.int16) -> Tuple[int, int]:
    """(warps an SM holds with the hub, without it) for ``kind``
    ("max_fwd", "max_bwd", "sum") at this dtype, K and arena of ``hub_k``
    rows, as the card's occupancy calculator gives them; launches nothing.
    Needs the card and the built library."""
    info = _hub_info(kind, dtype, k_width, hub_k, arg_type)
    return info[0], info[1]


def hub_layout(kind: str, dtype: torch.dtype, k_width: int, hub_k: int,
               arg_type: torch.dtype = torch.int16) -> Dict[str, object]:
    """The hub kernel's layout for ``kind`` ("max_fwd", "max_bwd", "sum")
    at this dtype, K, k and argmax (the max kernels'): the arena's stages,
    the hub blocks an SM holds and the fill route that K's alignment gives
    ("tma" or "cp.async"; ``csrc/row_chunks.cuh: hub_route``: a launch
    takes it where its tensors are 16-byte aligned, as fresh ones are), as
    its library gives them; launches nothing.  Needs the card and the built
    library."""
    info = _hub_info(kind, dtype, k_width, hub_k, arg_type)
    return {"stages": info[2], "blocks_per_sm": info[3],
            "route": "tma" if info[4] else "cp.async"}


# ---------------------------------------------------------------------------
# Forward: segment max with first-maximum argmax.
# ---------------------------------------------------------------------------


def spmm_max_fwd_plain(
    graph: Graph, x: torch.Tensor, with_argmax: bool = True,
    empty_value: float = 0.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``csrc/spmm_max_fwd.cu``.

    ``scatter_reduce('amax')`` gives out (an empty row keeps
    ``empty_value``, its argmax -1); the argmax is then the smallest
    source among the row's edges whose value equals the max
    (``scatter_reduce('amin')``), which is the first maximum because sources
    ascend inside each row; on a positional graph the smallest rank,
    which is the same edge.  Computed in float32 (exact for bf16 input: the
    max is one of the inputs) over row ranges, so the (edges, K) temporaries
    stay bounded.  With a hub (``graph.hub``) the hub edges' rows and
    sources come from the arena and its ids.
    """
    n, k = x.shape
    out = torch.full((n, k), float(empty_value), dtype=torch.float32, device=x.device)
    arg = (torch.full((n, k), -1, dtype=torch.int32, device=x.device)
           if with_argmax else None)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    big = torch.iinfo(torch.int32).max
    for r0, r1 in _row_chunks(indptr, k):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            continue
        coded = (graph.src if graph.hub is None else graph.hub.idx)[e0:e1]
        vals, s = _coded_rows(x, coded, graph.hub)
        vals = vals.float()
        d = graph.dst[e0:e1].long() - r0
        idx = d[:, None].expand(-1, k)
        blk = out[r0:r1]
        blk.scatter_reduce_(0, idx, vals, "amax", include_self=False)
        if with_argmax:
            key = _fwd_rank(graph, e0, e1) if graph.positional else s
            cand = torch.where(vals == blk[d], key.int()[:, None],
                               torch.full_like(key.int()[:, None], big))
            arg[r0:r1].scatter_reduce_(0, idx, cand, "amin", include_self=False)
    out = out.to(x.dtype)
    if with_argmax:
        arg = (_positional_arg(graph, arg) if graph.positional
               else arg.to(arg_dtype(graph)))
    return out, arg


def spmm_max_fwd(
    graph: Graph, x: torch.Tensor, with_argmax: bool = True,
    empty_value: float = 0.0, *, force_slice: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, arg) for x (N_pad, K); arg is None without ``with_argmax``; an
    empty row stores ``empty_value`` (in x's dtype) and argmax -1.

    On a positional graph the argmax is the rank form (``arg_rows`` rows of
    int16).  CPU tensors take the plain version; CUDA tensors launch the
    kernel at ``slice_bytes``'s K-slice (``force_slice``: that width in
    bytes, for the checks and timings that compare widths), its hub
    instantiation where the graph has a forward hub and the argmax is
    recorded."""
    _check(graph, x, "x")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if with_argmax and graph.positional and empty_value != 0:
        raise ValueError("the positional argmax serves a whole graph (empty_value "
                         "0); a graph shard is id-based: build it with positional=False")
    _check_slice(force_slice)
    use_hub = with_argmax and graph.hub is not None
    if use_hub and force_slice is not None:
        raise ValueError("the hub kernels take the 1 KB K-slice: force_slice applies "
                         "to a graph without a hub")
    if x.device.type == "cpu":
        return spmm_max_fwd_plain(graph, x, with_argmax, empty_value)
    fn = _fn("spmm_max_fwd", "spmm_max_fwd_hub" if use_hub else None)
    code, tag = _DTYPE_CODE[x.dtype]
    n, k = x.shape
    out = torch.empty_like(x)
    chunks, partial_val = _chunk_args(graph, False, k, x.device)
    arg = partial_src = None
    bits = 0
    if with_argmax:
        adt = arg_dtype(graph)
        arg = torch.empty((arg_rows(graph), k), dtype=adt, device=x.device)
        partial_src = torch.empty(partial_val.shape, dtype=torch.int32, device=x.device)
        bits = _ARG_BITS[adt]
    if use_hub:
        tickets = _hub_tickets(k, x.device)
        with torch.cuda.device(x.device):
            rc = fn(
                code, bits, x.data_ptr(), *_hub_args(chunks, graph.hub),
                out.data_ptr(), arg.data_ptr(), partial_val.data_ptr(),
                partial_src.data_ptr(), tickets.data_ptr(), tickets.numel(), k,
                float(empty_value), _stream(x))
        if rc != 0:
            raise RuntimeError(f"spmm_max_fwd_hub launch failed: CUDA error {rc}")
        _count(f"spmm_max_fwd_hub_{tag}", graph, k)
        return out, arg
    pos = _pos_args(graph, arg)
    width = force_slice or slice_bytes(n, x.element_size())
    with torch.cuda.device(x.device):
        rc = fn(
            code, bits, x.data_ptr(), *chunks, out.data_ptr(),
            arg.data_ptr() if arg is not None else None, partial_val.data_ptr(),
            partial_src.data_ptr() if partial_src is not None else None, k,
            float(empty_value), *pos, graph.chunks.cap, graph.chunks.order.data_ptr(),
            width, _stream(x))
    if rc != 0:
        raise RuntimeError(f"spmm_max_fwd launch failed: CUDA error {rc}")
    form = "pos_" if pos[0] else ("" if with_argmax else "noarg_")
    _count(f"spmm_max_fwd_{form}{'empty_' if empty_value != 0 else ''}{tag}", graph, k, width)
    return out, arg


# ---------------------------------------------------------------------------
# Backward: route each gradient element to its recorded argmax source.
# ---------------------------------------------------------------------------


def spmm_max_bwd_plain(graph: Graph, g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_max_bwd.cu``: ``index_add_`` of
    ``g[dst]`` masked by ``arg[dst] == src`` into ``src``, in float32, rounded
    to g's dtype once.  On a positional graph the mask tests the edge's rank
    r instead: ``arg[dst] == r % cap``, and for a mega row also the side
    table's segment ``== r // cap``."""
    n, k = g.shape
    dx = torch.zeros((n, k), dtype=torch.float32, device=g.device)
    step = max(_PLAIN_CHUNK // max(k, 1), 1)
    for e0 in range(0, graph.n_edges, step):
        e1 = min(e0 + step, graph.n_edges)
        s = graph.src[e0:e1].long()
        d = graph.dst[e0:e1].long()
        if graph.t_hub is not None:     # id-based: a positional graph has no hub
            hit = _node_rows(arg, d, graph.t_hub).long() == s[:, None]
            dx.index_add_(0, s, torch.where(hit, _node_rows(g, d, graph.t_hub).float(), 0.0))
            continue
        if not graph.positional:
            hit = arg[d].long() == s[:, None]
        else:
            r = _fwd_rank(graph, e0, e1)
            cap = graph.rank_cap
            hit = arg[d].long() == (r % cap)[:, None]
            if graph.n_mega:
                m = graph.mega_of[d].long()
                seg = arg[n + m.clamp(min=0)].long() == (r // cap)[:, None]
                hit &= (m < 0)[:, None] | seg
        dx.index_add_(0, s, torch.where(hit, g[d].float(), 0.0))
    return dx.to(g.dtype)


def spmm_max_bwd(graph: Graph, g: torch.Tensor, arg: torch.Tensor, *,
                 force_slice: Optional[int] = None) -> torch.Tensor:
    """dx (N_pad, K) in g's dtype, for the argmax ``spmm_max_fwd`` gave on
    this graph.  CPU tensors take the plain version; CUDA tensors launch
    ``spmm_max_bwd_f32`` or ``spmm_max_bwd_bf16`` (``_pos_`` on a
    positional graph, ``_hub_`` where the graph has a transpose hub) at
    ``slice_bytes``'s K-slice (``force_slice``: that width in bytes of g,
    for the checks and timings that compare widths)."""
    _check(graph, g, "g")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    rows = arg_rows(graph)
    want = ("int16" if graph.positional else "int16/int32")
    if (arg.dtype not in _ARG_BITS or (graph.positional and arg.dtype != torch.int16)
            or arg.shape != (rows, g.shape[1])):
        raise TypeError(f"arg must be {want} of shape ({rows}, {g.shape[1]}), got "
                        f"{arg.dtype} {tuple(arg.shape)}")
    _check(graph, arg[:graph.n_nodes], "arg")
    if arg.dtype == torch.int16 and not graph.positional and graph.n_nodes > (1 << 15):
        raise ValueError("int16 argmax cannot address more than 2^15 nodes")
    _check_slice(force_slice)
    if graph.t_hub is not None and force_slice is not None:
        raise ValueError("the hub kernels take the 1 KB K-slice: force_slice applies to a "
                         "graph without a hub")
    if g.device.type == "cpu":
        return spmm_max_bwd_plain(graph, g, arg)
    fn = _fn("spmm_max_bwd", None if graph.t_hub is None else "spmm_max_bwd_hub")
    code, tag = _DTYPE_CODE[g.dtype]
    k = g.shape[1]
    dx = torch.empty_like(g)
    chunks, partial = _chunk_args(graph, True, k, g.device)
    if graph.t_hub is not None:
        tickets = _hub_tickets(k, g.device)
        with torch.cuda.device(g.device):
            rc = fn(
                code, _ARG_BITS[arg.dtype], g.data_ptr(), arg.data_ptr(),
                *_hub_args(chunks, graph.t_hub), dx.data_ptr(), partial.data_ptr(),
                tickets.data_ptr(), tickets.numel(), k, _stream(g))
        if rc != 0:
            raise RuntimeError(f"spmm_max_bwd_hub launch failed: CUDA error {rc}")
        _count(f"spmm_max_bwd_hub_{tag}", graph, k)
        return dx
    pos = _pos_args(graph, arg)
    width = force_slice or slice_bytes(graph.n_nodes, g.element_size(), arg.element_size())
    with torch.cuda.device(g.device):
        rc = fn(
            code, _ARG_BITS[arg.dtype], g.data_ptr(), arg.data_ptr(), *chunks,
            dx.data_ptr(), partial.data_ptr(), k, *pos,
            graph.t_rank.data_ptr() if pos[0] else None, graph.t_chunks.order.data_ptr(),
            width, _stream(g))
    if rc != 0:
        raise RuntimeError(f"spmm_max_bwd launch failed: CUDA error {rc}")
    _count(f"spmm_max_bwd_{'pos_' if pos[0] else ''}{tag}", graph, k, width)
    return dx


# ---------------------------------------------------------------------------
# The differentiable op.
# ---------------------------------------------------------------------------


class SpmmMax(torch.autograd.Function):
    """``out[i] = max over in-edges j -> i of x[j]``; the gradient goes to the
    first maximum's source only (an empty row's argmax -1 routes nothing).
    The forward saves the argmax for the backward kernel: int16 ranks on a
    positional graph (``build_graph``'s default past 2^15 padded nodes),
    else source ids, int16 up to 2^15 padded nodes and int32 past."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor,
                empty_value: float = 0.0) -> torch.Tensor:
        out, arg = spmm_max_fwd(graph, x, with_argmax=True, empty_value=empty_value)
        ctx.graph = graph
        ctx.save_for_backward(arg)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (arg,) = ctx.saved_tensors
        return None, spmm_max_bwd(ctx.graph, g.contiguous(), arg), None


def spmm_max(graph: Graph, x: torch.Tensor, empty_value: float = 0.0) -> torch.Tensor:
    """Segment max over x (N_pad, ...): the trailing dims are packed into one
    row of K elements (any K; no padding of the fold or feature axes).  An
    empty row gives ``empty_value`` (0, DGL's; -inf for the partial maxima
    of a graph shard, ``plagnn_tpu/ops/spmm.py: spmm_max``'s argument), a
    row whose inputs are all -inf gives -inf.  Records the argmax only when
    a gradient will be taken."""
    shape = x.shape
    x2 = x.reshape(shape[0], -1).contiguous()
    if torch.is_grad_enabled() and x2.requires_grad:
        out = SpmmMax.apply(graph, x2, float(empty_value))
    else:
        out, _ = spmm_max_fwd(graph, x2, with_argmax=False, empty_value=empty_value)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Segment sum: one kernel, forward over the CSR, VJP over its transpose.
# ---------------------------------------------------------------------------


def _edge_values(graph: Graph, transpose: bool) -> torch.Tensor:
    val = graph.t_val if transpose else graph.val
    if val is None:
        raise ValueError("graph has no edge values")
    if val.dtype != torch.float32 or val.shape != (graph.n_edges,):
        raise ValueError(f"edge values must be float32 of shape ({graph.n_edges},), "
                         f"got {val.dtype} {tuple(val.shape)}")
    return val


def spmm_sum_plain(graph: Graph, x: torch.Tensor, transpose: bool = False,
                   use_val: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_sum.cu``: ``index_add_`` of
    ``x[src]`` (with ``use_val``, times the edge's value, rounded to float32
    once) into ``dst`` (``transpose``: of ``x[dst]`` into ``src``), in
    float32 over edge ranges, rounded to x's dtype once.  Unweighted, the
    direction's hub rows come from its arena."""
    n, k = x.shape
    val = _edge_values(graph, False) if use_val else None
    hub = None if use_val else (graph.t_hub if transpose else graph.hub)
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    step = max(_PLAIN_CHUNK // max(k, 1), 1)
    for e0 in range(0, graph.n_edges, step):
        e1 = min(e0 + step, graph.n_edges)
        s = graph.src[e0:e1].long()
        d = graph.dst[e0:e1].long()
        if transpose:
            s, d = d, s
            terms = _node_rows(x, s, hub).float()
        else:
            coded = graph.src if hub is None else hub.idx
            terms = _coded_rows(x, coded[e0:e1], hub)[0].float()
        if val is not None:
            terms = terms * val[e0:e1, None]
        out.index_add_(0, d, terms)
    return out.to(x.dtype)


def spmm_sum_rows(graph: Graph, x: torch.Tensor, transpose: bool = False,
                  use_val: bool = False) -> torch.Tensor:
    """out[i] = sum over in-edges j -> i of x[j], for x (N_pad, K); with
    ``transpose``, dx[s] = sum over out-edges s -> n of x[n] (the VJP), the
    same kernel over the transpose CSR; with ``use_val`` each term is
    weighted by its edge's value (``ValueError`` if the graph has none).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted as spmm_sum[_val]_fwd_* / _bwd_*), unweighted its hub
    instantiation where the direction has a hub (``spmm_sum_*_hub_*``; the
    weighted sum takes none, as the JAX package's XLA one has none)."""
    _check(graph, x, "x")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    val = _edge_values(graph, transpose) if use_val else None
    if x.device.type == "cpu":
        return spmm_sum_plain(graph, x, transpose, use_val)
    hub = None if use_val else (graph.t_hub if transpose else graph.hub)
    fn = _fn("spmm_sum", None if hub is None else "spmm_sum_hub")
    code, tag = _DTYPE_CODE[x.dtype]
    k = x.shape[1]
    out = torch.empty_like(x)
    chunks, partial = _chunk_args(graph, transpose, k, x.device)
    direction = "bwd" if transpose else "fwd"
    if hub is not None:
        tickets = _hub_tickets(k, x.device)
        with torch.cuda.device(x.device):
            rc = fn(code, x.data_ptr(), *_hub_args(chunks, hub), out.data_ptr(),
                    partial.data_ptr(), tickets.data_ptr(), tickets.numel(), k, _stream(x))
        if rc != 0:
            raise RuntimeError(f"spmm_sum_hub launch failed: CUDA error {rc}")
        _count(f"spmm_sum_{direction}_hub_{tag}", graph, k)
        return out
    val_ptr = None if val is None else val.data_ptr()
    with torch.cuda.device(x.device):
        rc = fn(code, x.data_ptr(), *chunks[:5], val_ptr, *chunks[5:],
                out.data_ptr(), partial.data_ptr(), k, _stream(x))
    if rc != 0:
        raise RuntimeError(f"spmm_sum launch failed: CUDA error {rc}")
    _count(f"spmm_sum_{'val_' if use_val else ''}{direction}_{tag}", graph, k)
    return out


class SpmmSum(torch.autograd.Function):
    """``out[i] = sum over in-edges j -> i of (v_ji *) x[j]``; the gradient
    is the same sum over the transpose.  Edge values get no gradient."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor, use_val: bool) -> torch.Tensor:
        ctx.graph = graph
        ctx.use_val = use_val
        return spmm_sum_rows(graph, x, use_val=use_val)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, spmm_sum_rows(ctx.graph, g.contiguous(), transpose=True,
                                   use_val=ctx.use_val), None


def spmm_sum(graph: Graph, x: torch.Tensor, use_val: bool = False) -> torch.Tensor:
    """Segment sum over x (N_pad, ...): the trailing dims are packed into one
    row of K elements, as ``spmm_max`` does; ``use_val`` weights each term
    by its edge's value (``plagnn_tpu/ops/spmm.py: spmm_sum``)."""
    shape = x.shape
    return SpmmSum.apply(graph, x.reshape(shape[0], -1).contiguous(),
                         use_val).reshape(shape)


# ---------------------------------------------------------------------------
# GCN's scaled sum: D_in^-1/2 A D_out^-1/2 x + bias in one kernel.
# ---------------------------------------------------------------------------


def gcn_scales(graph: Graph, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out-degree^-1/2, in-degree^-1/2) of every node, the degrees clamped
    at 1, computed in ``dtype`` as ``ops/spmm.py``'s composition computes
    them (``torch.rsqrt`` on the graph's device) and held as float32 (N_pad,)
    vectors; cached on the graph (``Graph.norm_scales``) at first use."""
    scales = graph.norm_scales.get(dtype)
    if scales is None:
        scales = graph.norm_scales[dtype] = tuple(
            torch.rsqrt(deg.clamp(min=1).to(dtype)).float().contiguous()
            for deg in (graph.out_degree, graph.in_degree))
    return scales


def spmm_sum_gcn_plain(graph: Graph, x: torch.Tensor, pre: torch.Tensor,
                       post: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_sum.cu``'s scaled instantiation:
    the passes it fuses, each rounded to x's dtype -- x scaled by ``pre``
    (a row's scale), ``spmm_sum_plain``, the result scaled by ``post``, plus
    ``bias`` (float32 (K,), or None)."""
    dt = x.dtype
    s = spmm_sum_plain(graph, (x.float() * pre[:, None]).to(dt), transpose)
    out = (s.float() * post[:, None]).to(dt)
    return out if bias is None else (out.float() + bias).to(dt)


def spmm_sum_gcn_rows(graph: Graph, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      transpose: bool = False) -> torch.Tensor:
    """out[i] = in_deg[i]^-1/2 * sum over in-edges j -> i of out_deg[j]^-1/2
    * x[j] + bias, for x (N_pad, K) and bias float32 (K,) or None (the
    degrees clamped at 1, ``gcn_scales``); with ``transpose`` the VJP, the
    same sum over the transpose CSR with the two scales swapped.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    as ``spmm_sum_gcn_{fwd,bwd}_*``), which walks the plain index on any
    graph (the hub's arena serves only the unscaled sum)."""
    _check(graph, x, "x")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    k = x.shape[1]
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (k,)
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be contiguous float32 of shape ({k},) on {x.device}, "
                         f"got {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    pre, post = gcn_scales(graph, x.dtype)
    if transpose:
        pre, post = post, pre
    if x.device.type == "cpu":
        return spmm_sum_gcn_plain(graph, x, pre, post, bias, transpose)
    code, tag = _DTYPE_CODE[x.dtype]
    out = torch.empty_like(x)
    chunks, partial = _chunk_args(graph, transpose, k, x.device)
    with torch.cuda.device(x.device):
        rc = _fn("spmm_sum", "spmm_sum_gcn")(
            code, x.data_ptr(), *chunks[:5], pre.data_ptr(), post.data_ptr(),
            None if bias is None else bias.data_ptr(), *chunks[5:], out.data_ptr(),
            partial.data_ptr(), k, _stream(x))
    if rc != 0:
        raise RuntimeError(f"spmm_sum_gcn launch failed: CUDA error {rc}")
    _count(f"spmm_sum_gcn_{'bwd' if transpose else 'fwd'}_{tag}", graph, k)
    return out


class SpmmSumGcn(torch.autograd.Function):
    """``out = D_in^-1/2 A D_out^-1/2 x + bias``; the gradient of x is the
    scaled sum over the transpose, that of the bias the column sums of g
    (autograd's reduction of a broadcast add, on the same g)."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.graph = graph
        ctx.bias_shape = None if bias is None else bias.shape
        b = None if bias is None else bias.reshape(-1).float().contiguous()
        return spmm_sum_gcn_rows(graph, x, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dx = db = None
        if ctx.needs_input_grad[1]:
            dx = spmm_sum_gcn_rows(ctx.graph, g.contiguous(), transpose=True)
        if ctx.needs_input_grad[2]:
            db = g.reshape(g.shape[0], *ctx.bias_shape).sum(0)
        return None, dx, db


def spmm_sum_gcn(graph: Graph, x: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GCN's norm='both' propagation plus bias over x (N_pad, ...), the
    trailing dims packed into one row as ``spmm_sum`` packs them; ``bias``
    has x's trailing shape and dtype (``ops/spmm.py: gcn_propagate`` checks
    it)."""
    shape = x.shape
    return SpmmSumGcn.apply(graph, x.reshape(shape[0], -1).contiguous(),
                            bias).reshape(shape)


# ---------------------------------------------------------------------------
# GAT's edge-softmax aggregation: out = sum over in-edges of softmax(leaky_relu(
# el[src] + er[dst])) * wh[src], per (fold, head) group of F columns.
# ---------------------------------------------------------------------------

# The slope of leaky_relu on the attention logits: DGL GATConv's
# negative_slope, the paper's 0.2 (the kernels take it as an argument).
GAT_SLOPE = 0.2


def gat_layout(f: int) -> Tuple[int, int, bool]:
    """(V, block width, span) of ``csrc/spmm_gat.cu``'s lanes at per-group
    width ``f``, for tensors aligned as fresh ones are: V the widest of 4,
    2, 1 dividing f; a warp's vector covers ``(32 V / f) f`` elements of
    whole groups where f <= 32 V, or the 1 KB K-slice is one group where f
    = 256 ("span").  ``ValueError`` for any other width, which the kernels
    do not take (the plain versions take any)."""
    v = next(v for v in (4, 2, 1) if f % v == 0)
    if f <= 32 * v:
        return v, (32 * v // f) * f, False
    if f == 256:
        return v, 32 * v, True
    raise ValueError(f"the GAT kernels take a per-head width of at most {32 * v} (a multiple "
                     f"of {v}) or 256, got {f}")


def _check_gat(graph: Graph, wh: torch.Tensor, logits, f: int) -> int:
    """The groups a row (K / f) of the op's operands, checked."""
    _check(graph, wh, "wh")
    if wh.dtype != torch.float32 and not (wh.dtype == torch.float64 and wh.device.type == "cpu"):
        raise TypeError(f"the GAT aggregation runs in float32 (float64 on the CPU, the plain "
                        f"version's checks), got {wh.dtype}")
    k = wh.shape[1]
    if f < 1 or k % f:
        raise ValueError(f"K = {k} is no multiple of the per-head width {f}")
    for name, t in logits.items():
        _check(graph, t, name)
        if t.dtype != wh.dtype or t.shape[1] != k // f:
            raise ValueError(f"{name} must be {wh.dtype} (N_pad, {k // f}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    return k // f


def _gat_edges(graph: Graph, el, er, lse, r0: int, e0: int, e1: int):
    """(src, local dst, z, softmax weight or None) of edges [e0, e1), whose
    rows start at r0."""
    s = graph.src[e0:e1].long()
    d = graph.dst[e0:e1].long()
    z = el[s] + er[d]
    alpha = None if lse is None else torch.exp(torch.nn.functional.leaky_relu(z, GAT_SLOPE)
                                               - lse[d])
    return s, d - r0, z, alpha


def spmm_gat_fwd_plain(graph: Graph, wh: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                       f: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/spmm_gat.cu``'s forward: over row
    ranges (whole rows, (edges, K) temporaries bounded), each row's maximum
    logit (``scatter_reduce`` amax), its log-sum-exp ``lse`` and the weights
    ``exp(e - lse)``, then ``index_add_`` of the weighted rows.  A row without
    in-edges gives 0 and lse -inf."""
    n, k = wh.shape
    bh = k // f
    out = torch.zeros((n, k), dtype=wh.dtype, device=wh.device)
    lse = torch.full((n, bh), -math.inf, dtype=wh.dtype, device=wh.device)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    for r0, r1 in _row_chunks(indptr, k):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            continue
        s, d, z, _ = _gat_edges(graph, el, er, None, r0, e0, e1)
        e = torch.nn.functional.leaky_relu(z, GAT_SLOPE)
        m = torch.full((r1 - r0, bh), -math.inf, dtype=wh.dtype, device=wh.device
                       ).scatter_reduce_(0, d[:, None].expand(-1, bh), e, "amax")
        total = torch.zeros_like(m).index_add_(0, d, torch.exp(e - m[d]))
        blk = torch.where(total > 0, m + torch.log(total), -math.inf)
        lse[r0:r1] = blk
        alpha = torch.exp(e - blk[d])
        out[r0:r1].index_add_(0, d, (wh[s].view(-1, bh, f) * alpha[..., None]).view(-1, k))
    return out, lse


def spmm_gat_bwd_plain(graph: Graph, g: torch.Tensor, wh: torch.Tensor, el: torch.Tensor,
                       er: torch.Tensor, lse: torch.Tensor, f: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/spmm_gat.cu``'s backward: over row
    ranges, the weights a = exp(leaky_relu(z) - lse) again, da = g[dst] .
    wh[src] per group, D = the row's sum of a * da, dz = leaky_relu'(z) *
    a * (da - D); ``index_add_`` gives dwh (a * g[dst] into src), der (dz
    into dst) and del (dz into src)."""
    n, k = g.shape
    bh = k // f
    dwh = torch.zeros_like(g)
    d_el = torch.zeros((n, bh), dtype=g.dtype, device=g.device)
    d_er = torch.zeros_like(d_el)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    for r0, r1 in _row_chunks(indptr, k):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            continue
        s, d, z, alpha = _gat_edges(graph, el, er, lse, r0, e0, e1)
        gd = g[d + r0].view(-1, bh, f)
        da = (gd * wh[s].view(-1, bh, f)).sum(-1)
        row_d = torch.zeros((r1 - r0, bh), dtype=g.dtype, device=g.device
                            ).index_add_(0, d, alpha * da)
        de = alpha * (da - row_d[d])
        dz = torch.where(z > 0, de, GAT_SLOPE * de)
        d_er[r0:r1].index_add_(0, d, dz)
        d_el.index_add_(0, s, dz)
        dwh.index_add_(0, s, (gd * alpha[..., None]).view(-1, k))
    return dwh, d_el, d_er


def spmm_gat_fwd(graph: Graph, wh: torch.Tensor, el: torch.Tensor, er: torch.Tensor, f: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (N_pad, K), lse (N_pad, K / f)) for wh (N_pad, K) and the
    logits' halves el, er (N_pad, K / f), float32.  CPU tensors take the
    plain version; CUDA tensors launch ``spmm_gat_fwd`` (counted as
    ``spmm_gat_fwd_f32``, its split rows' combine as
    ``spmm_gat_fwd_combine_f32``), which walks the plain index on any graph
    (no hub form)."""
    bh = _check_gat(graph, wh, {"el": el, "er": er}, f)
    if wh.device.type == "cpu":
        return spmm_gat_fwd_plain(graph, wh, el, er, f)
    gat_layout(f)
    k = wh.shape[1]
    out = torch.empty_like(wh)
    lse = torch.empty((graph.n_nodes, bh), dtype=torch.float32, device=wh.device)
    chunks, partial = _chunk_args(graph, False, k, wh.device)
    pm = torch.empty((partial.shape[0], bh), dtype=torch.float32, device=wh.device)
    ps = torch.empty_like(pm)
    with torch.cuda.device(wh.device):
        rc = _fn("spmm_gat", "spmm_gat_fwd")(
            wh.data_ptr(), el.data_ptr(), er.data_ptr(), *chunks, out.data_ptr(),
            lse.data_ptr(), partial.data_ptr(), pm.data_ptr(), ps.data_ptr(), k, int(f),
            GAT_SLOPE, _stream(wh))
    if rc != 0:
        raise RuntimeError(f"spmm_gat_fwd launch failed: CUDA error {rc}")
    _count("spmm_gat_fwd_f32", graph, k)
    if graph.chunks.n_split:
        _count("spmm_gat_fwd_combine_f32", graph, k)
    return out, lse


def spmm_gat_bwd(graph: Graph, g: torch.Tensor, wh: torch.Tensor, el: torch.Tensor,
                 er: torch.Tensor, lse: torch.Tensor, f: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dwh, del, der) for the gradient g of ``spmm_gat_fwd``'s out.  CPU
    tensors take the plain version; CUDA tensors launch ``spmm_gat_bwd``:
    its pass over the transpose (``spmm_gat_bwd_f32``; the combine of split
    rows ``spmm_gat_bwd_combine_f32``), the der pass
    (``spmm_gat_bwd_der_f32``) and the del pass (``spmm_gat_bwd_del_f32``),
    with an (E, K / f) float32 scratch for the per-edge gradients."""
    bh = _check_gat(graph, g, {"el": el, "er": er, "lse": lse}, f)
    _check(graph, wh, "wh")
    if wh.shape != g.shape or wh.dtype != g.dtype:
        raise ValueError(f"wh must be {g.dtype} {tuple(g.shape)}, got {wh.dtype} "
                         f"{tuple(wh.shape)}")
    if g.device.type == "cpu":
        return spmm_gat_bwd_plain(graph, g, wh, el, er, lse, f)
    gat_layout(f)
    k = g.shape[1]
    dev = g.device
    dwh = torch.empty_like(g)
    d_el = torch.empty((graph.n_nodes, bh), dtype=torch.float32, device=dev)
    d_er = torch.empty_like(d_el)
    t_chunks, partial = _chunk_args(graph, True, k, dev)
    f_chunks, pd = _chunk_args(graph, False, bh, dev)
    pder = torch.empty_like(pd)
    pdel = torch.empty((partial.shape[0], bh), dtype=torch.float32, device=dev)
    dalpha = torch.empty((graph.n_edges, bh), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _fn("spmm_gat", "spmm_gat_bwd")(
            g.data_ptr(), wh.data_ptr(), el.data_ptr(), er.data_ptr(), lse.data_ptr(),
            *t_chunks, *f_chunks[:5], graph.t_pos.data_ptr(), *f_chunks[5:], dwh.data_ptr(),
            d_el.data_ptr(), d_er.data_ptr(), dalpha.data_ptr(), partial.data_ptr(),
            pdel.data_ptr(), pd.data_ptr(), pder.data_ptr(), k, int(f), GAT_SLOPE,
            _stream(g))
    if rc != 0:
        raise RuntimeError(f"spmm_gat_bwd launch failed: CUDA error {rc}")
    _count("spmm_gat_bwd_f32", graph, k)
    if graph.t_chunks.n_split:
        _count("spmm_gat_bwd_combine_f32", graph, k)
    _count("spmm_gat_bwd_der_f32", graph, bh)
    _count("spmm_gat_bwd_del_f32", graph, bh)
    return dwh, d_el, d_er


class SpmmGat(torch.autograd.Function):
    """GAT's edge-softmax aggregation of wh (N_pad, K) under the logits' halves
    el, er (N_pad, K / f); saves wh, el, er and the rows' log-sum-exp, and
    recomputes the weights in the backward."""

    @staticmethod
    def forward(ctx, graph: Graph, wh: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                f: int) -> torch.Tensor:
        out, lse = spmm_gat_fwd(graph, wh, el, er, f)
        ctx.graph, ctx.f = graph, f
        ctx.save_for_backward(wh, el, er, lse)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        wh, el, er, lse = ctx.saved_tensors
        dwh, d_el, d_er = spmm_gat_bwd(ctx.graph, g.contiguous(), wh, el, er, lse, ctx.f)
        return None, dwh, d_el, d_er, None


def spmm_gat(graph: Graph, wh: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
             f: int) -> torch.Tensor:
    """GAT's aggregation over wh (N_pad, ...) with per-head width ``f``:
    the trailing dims packed into one row of K elements, as ``spmm_sum``
    packs them, and el, er (N_pad, ...) into K / f logits a row, one per
    (fold, head) group of f consecutive columns."""
    shape = wh.shape
    n = shape[0]
    return SpmmGat.apply(graph, wh.reshape(n, -1).contiguous(), el.reshape(n, -1).contiguous(),
                         er.reshape(n, -1).contiguous(), int(f)).reshape(shape)
