"""Fold-batched segment max and sum, with their backwards.

Port of ``pallas_spmm_max`` and ``pallas_spmm_sum``
(``plagnn_tpu/ops/pallas/spmm_kernels.py``) and their custom VJPs.
Features are (N_pad, K) with K = B*F, the fold batch packed next to the
features, so one pass over the edges serves every fold.

Three kernels, each with a plain PyTorch version beside it:

* ``spmm_max_fwd``: ``csrc/spmm_max_fwd.cu`` (float32 or bfloat16, with or
  without the argmax).  Plain version: ``spmm_max_fwd_plain``.
* ``spmm_max_bwd``: ``csrc/spmm_max_bwd.cu`` (``spmm_max_bwd_f32`` and
  ``spmm_max_bwd_bf16``).  Plain version: ``spmm_max_bwd_plain``.
* ``spmm_sum_rows``: ``csrc/spmm_sum.cu``, one kernel over the
  destination-sorted CSR (forward) or its transpose (the VJP), float32 or
  bfloat16 with a float32 sum.  Plain version: ``spmm_sum_plain``.

All three walk the graph's row chunks (``Graph.chunks`` / ``t_chunks``,
``csrc/row_chunks.cuh``): their wrappers pass the direction's chunk table
and a float32 scratch for the partials of split rows (the max forward also
an int32 scratch for the partials' sources).

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build
from .graph_format import Graph

# spmm_max_fwd_* count forwards that record the argmax (the training
# path), spmm_max_fwd_noarg_* those that do not.
LAUNCHES: Dict[str, int] = {
    "spmm_max_fwd_f32": 0,
    "spmm_max_fwd_bf16": 0,
    "spmm_max_fwd_noarg_f32": 0,
    "spmm_max_fwd_noarg_bf16": 0,
    "spmm_max_bwd_f32": 0,
    "spmm_max_bwd_bf16": 0,
    "spmm_sum_fwd_f32": 0,
    "spmm_sum_fwd_bf16": 0,
    "spmm_sum_bwd_f32": 0,
    "spmm_sum_bwd_bf16": 0,
}

_DTYPE_CODE = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}
_ARG_BITS = {torch.int16: 16, torch.int32: 32}
# Elements of the (edges, K) temporaries the plain versions materialize at
# once, so they run at the slice's full width on the card too.
_PLAIN_CHUNK = 1 << 26


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def arg_dtype(n_pad_nodes: int) -> torch.dtype:
    """int16 while every node id fits (N_pad <= 2^15), else int32."""
    return torch.int16 if n_pad_nodes <= (1 << 15) else torch.int32


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
#                 stream
#   spmm_max_bwd: dtype, arg_bits, g, arg, <chunk table>, t_dst,
#                 split_row, split_ptr, n_split, dx, partial, k, stream
#   spmm_sum:     dtype, x, <chunk table>, idx, split_row, split_ptr,
#                 n_split, out, partial, k, stream
# where <chunk table> is chunk_row, chunk_ptr, chunk_slot, n_chunks.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CHUNKS = [_P, _P, _P, _LL]
_ARGTYPES = {
    "spmm_max_fwd": [_I, _I, _P, *_CHUNKS, _P, _P, _P, _LL, _P, _P, _P, _P, _LL, _P],
    "spmm_max_bwd": [_I, _I, _P, _P, *_CHUNKS, _P, _P, _P, _LL, _P, _P, _LL, _P],
    "spmm_sum": [_I, _P, *_CHUNKS, _P, _P, _P, _LL, _P, _P, _LL, _P],
}


def _lib(name: str) -> ctypes.CDLL:
    """The kernel library, its entry point's signature declared."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


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


# ---------------------------------------------------------------------------
# Forward: segment max with first-maximum argmax.
# ---------------------------------------------------------------------------


def spmm_max_fwd_plain(
    graph: Graph, x: torch.Tensor, with_argmax: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``csrc/spmm_max_fwd.cu``.

    ``scatter_reduce('amax')`` gives out; the argmax is then the smallest
    source among the row's edges whose value equals the max
    (``scatter_reduce('amin')``), which is the first maximum because sources
    ascend inside each row.  Computed in float32 (exact for bf16 input: the
    max is one of the inputs) over row ranges, so the (edges, K) temporaries
    stay bounded.
    """
    n, k = x.shape
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    arg = (torch.full((n, k), -1, dtype=torch.int32, device=x.device)
           if with_argmax else None)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    big = torch.iinfo(torch.int32).max
    for r0, r1 in _row_chunks(indptr, k):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            continue
        s = graph.src[e0:e1].long()
        d = graph.dst[e0:e1].long() - r0
        vals = x[s].float()
        idx = d[:, None].expand(-1, k)
        blk = out[r0:r1]
        blk.scatter_reduce_(0, idx, vals, "amax", include_self=False)
        if with_argmax:
            cand = torch.where(vals == blk[d], s.int()[:, None],
                               torch.full_like(s.int()[:, None], big))
            arg[r0:r1].scatter_reduce_(0, idx, cand, "amin", include_self=False)
    out = out.to(x.dtype)
    if with_argmax:
        arg = arg.to(arg_dtype(graph.n_nodes))
    return out, arg


def spmm_max_fwd(
    graph: Graph, x: torch.Tensor, with_argmax: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, arg) for x (N_pad, K); arg is None without ``with_argmax``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(graph, x, "x")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return spmm_max_fwd_plain(graph, x, with_argmax)
    lib = _lib("spmm_max_fwd")
    code, tag = _DTYPE_CODE[x.dtype]
    n, k = x.shape
    out = torch.empty_like(x)
    chunks, partial_val = _chunk_args(graph, False, k, x.device)
    arg = partial_src = None
    bits = 0
    if with_argmax:
        adt = arg_dtype(graph.n_nodes)
        arg = torch.empty((n, k), dtype=adt, device=x.device)
        partial_src = torch.empty(partial_val.shape, dtype=torch.int32, device=x.device)
        bits = _ARG_BITS[adt]
    with torch.cuda.device(x.device):
        rc = lib.spmm_max_fwd(
            code, bits, x.data_ptr(), *chunks, out.data_ptr(),
            arg.data_ptr() if arg is not None else None, partial_val.data_ptr(),
            partial_src.data_ptr() if partial_src is not None else None, k,
            _stream(x))
    if rc != 0:
        raise RuntimeError(f"spmm_max_fwd launch failed: CUDA error {rc}")
    LAUNCHES[f"spmm_max_fwd_{'' if with_argmax else 'noarg_'}{tag}"] += 1
    return out, arg


# ---------------------------------------------------------------------------
# Backward: route each gradient element to its recorded argmax source.
# ---------------------------------------------------------------------------


def spmm_max_bwd_plain(graph: Graph, g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_max_bwd.cu``: ``index_add_`` of
    ``g[dst]`` masked by ``arg[dst] == src`` into ``src``, in float32, rounded
    to g's dtype once."""
    n, k = g.shape
    dx = torch.zeros((n, k), dtype=torch.float32, device=g.device)
    step = max(_PLAIN_CHUNK // max(k, 1), 1)
    for e0 in range(0, graph.n_edges, step):
        e1 = min(e0 + step, graph.n_edges)
        s = graph.src[e0:e1].long()
        d = graph.dst[e0:e1].long()
        hit = arg[d].long() == s[:, None]
        dx.index_add_(0, s, torch.where(hit, g[d].float(), 0.0))
    return dx.to(g.dtype)


def spmm_max_bwd(graph: Graph, g: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """dx (N_pad, K) in g's dtype.  CPU tensors take the plain version; CUDA
    tensors launch ``spmm_max_bwd_f32`` or ``spmm_max_bwd_bf16``."""
    _check(graph, g, "g")
    _check(graph, arg, "arg")
    if g.dtype not in _DTYPE_CODE:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if arg.dtype not in _ARG_BITS or arg.shape != g.shape:
        raise TypeError(f"arg must be int16/int32 of g's shape, got "
                        f"{arg.dtype} {tuple(arg.shape)}")
    if arg.dtype == torch.int16 and graph.n_nodes > (1 << 15):
        raise ValueError("int16 argmax cannot address more than 2^15 nodes")
    if g.device.type == "cpu":
        return spmm_max_bwd_plain(graph, g, arg)
    lib = _lib("spmm_max_bwd")
    code, tag = _DTYPE_CODE[g.dtype]
    k = g.shape[1]
    dx = torch.empty_like(g)
    chunks, partial = _chunk_args(graph, True, k, g.device)
    with torch.cuda.device(g.device):
        rc = lib.spmm_max_bwd(
            code, _ARG_BITS[arg.dtype], g.data_ptr(), arg.data_ptr(), *chunks,
            dx.data_ptr(), partial.data_ptr(), k, _stream(g))
    if rc != 0:
        raise RuntimeError(f"spmm_max_bwd launch failed: CUDA error {rc}")
    LAUNCHES[f"spmm_max_bwd_{tag}"] += 1
    return dx


# ---------------------------------------------------------------------------
# The differentiable op.
# ---------------------------------------------------------------------------


class SpmmMax(torch.autograd.Function):
    """``out[i] = max over in-edges j -> i of x[j]``; the gradient goes to the
    first maximum's source only.  The forward saves the argmax (int16 up to
    2^15 padded nodes, else int32) for the backward kernel."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        out, arg = spmm_max_fwd(graph, x, with_argmax=True)
        ctx.graph = graph
        ctx.save_for_backward(arg)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (arg,) = ctx.saved_tensors
        return None, spmm_max_bwd(ctx.graph, g.contiguous(), arg)


def spmm_max(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Segment max over x (N_pad, ...): the trailing dims are packed into one
    row of K elements (any K; no padding of the fold or feature axes).
    Records the argmax only when a gradient will be taken."""
    shape = x.shape
    x2 = x.reshape(shape[0], -1).contiguous()
    if torch.is_grad_enabled() and x2.requires_grad:
        out = SpmmMax.apply(graph, x2)
    else:
        out, _ = spmm_max_fwd(graph, x2, with_argmax=False)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Segment sum: one kernel, forward over the CSR, VJP over its transpose.
# ---------------------------------------------------------------------------


def spmm_sum_plain(graph: Graph, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/spmm_sum.cu``: ``index_add_`` of
    ``x[src]`` into ``dst`` (``transpose``: of ``x[dst]`` into ``src``), in
    float32 over edge ranges, rounded to x's dtype once."""
    n, k = x.shape
    out = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    step = max(_PLAIN_CHUNK // max(k, 1), 1)
    for e0 in range(0, graph.n_edges, step):
        e1 = min(e0 + step, graph.n_edges)
        s = graph.src[e0:e1].long()
        d = graph.dst[e0:e1].long()
        if transpose:
            s, d = d, s
        out.index_add_(0, d, x[s].float())
    return out.to(x.dtype)


def spmm_sum_rows(graph: Graph, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """out[i] = sum over in-edges j -> i of x[j], for x (N_pad, K); with
    ``transpose``, dx[s] = sum over out-edges s -> n of x[n] (the VJP), the
    same kernel over the transpose CSR.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted as spmm_sum_fwd_* / _bwd_*)."""
    _check(graph, x, "x")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return spmm_sum_plain(graph, x, transpose)
    lib = _lib("spmm_sum")
    code, tag = _DTYPE_CODE[x.dtype]
    k = x.shape[1]
    out = torch.empty_like(x)
    chunks, partial = _chunk_args(graph, transpose, k, x.device)
    with torch.cuda.device(x.device):
        rc = lib.spmm_sum(code, x.data_ptr(), *chunks, out.data_ptr(),
                          partial.data_ptr(), k, _stream(x))
    if rc != 0:
        raise RuntimeError(f"spmm_sum launch failed: CUDA error {rc}")
    LAUNCHES[f"spmm_sum_{'bwd' if transpose else 'fwd'}_{tag}"] += 1
    return out


class SpmmSum(torch.autograd.Function):
    """``out[i] = sum over in-edges j -> i of x[j]``; the gradient is the
    same sum over the transpose."""

    @staticmethod
    def forward(ctx, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        return spmm_sum_rows(graph, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, spmm_sum_rows(ctx.graph, g.contiguous(), transpose=True)


def spmm_sum(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Segment sum over x (N_pad, ...): the trailing dims are packed into one
    row of K elements, as ``spmm_max`` does."""
    shape = x.shape
    return SpmmSum.apply(graph, x.reshape(shape[0], -1).contiguous()).reshape(shape)
