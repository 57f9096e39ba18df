"""Common-neighbour counts of query pairs: the ECC's triangle counts.

``common_neighbors(csr, rows, cols) -> counts`` gives, for each query q,
|N(rows[q]) ∩ N(cols[q])| (int32) over a CSR = (indptr int64 (N + 1),
indices int32) whose rows hold strictly ascending column ids, as
``pcc_scan.csr_tensors`` builds it.  The JAX package counts with a sorted
merge per query on the host (``native/plagnn_native.cpp:
common_neighbors``) or the scipy product A·A; here CUDA tensors launch
``csrc/common_neighbors.cu`` (the queries grouped by their longer row in
slices of at most ``slice_queries``; one block a slice tests each element
of its queries' shorter rows against a shared-memory bitmap of the longer
row) and CPU tensors take the plain version, ``common_neighbors_plain``.
Counts are integers, so both agree exactly.  The wrapper reads the device
once, for all its input checks.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .pcc_scan import _csr_flag, _csr_message, _raise_flags

SLICE_QUERIES = 256  # queries of one longer row a block takes (at most 256)
# The most 32-bit words of a block's bitmap (227 KB of shared memory: ids
# 0 .. 1,859,583 in one window); the wrapper takes min(ceil(N / 32),
# WINDOW_WORDS), read at each call.
WINDOW_WORDS = 232448 // 4
LAUNCHES: Dict[str, int] = {"ecc_common_neighbors_i32": 0}

# Elements of the shorter rows the plain version expands at once.
_PLAIN_BLOCK = 1 << 24

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# indptr, indices, rows, cols, order, row_q, slice_end, n, n_queries,
# slice_queries, window_words, out, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("common_neighbors")
    lib.ecc_common_neighbors_i32.argtypes = _ARGTYPES
    lib.ecc_common_neighbors_i32.restype = ctypes.c_int
    return lib


def _query_flag(rows: torch.Tensor, cols: torch.Tensor, n: int, device) -> torch.Tensor:
    """Raises on the queries' type, shape and device; returns a bool tensor
    on ``device``, true where an id lies outside [0, n) (read by the
    caller, with its other checks)."""
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"rows and cols must be int32, got {rows.dtype}, {cols.dtype}")
    if rows.dim() != 1 or rows.shape != cols.shape:
        raise ValueError(f"rows and cols must be 1-D of one length, got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    if rows.device != device or cols.device != device:
        raise ValueError(f"rows on {rows.device}, cols on {cols.device}, csr on {device}")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("rows and cols must be contiguous")
    if not rows.numel():
        return torch.zeros((), dtype=torch.bool, device=device)
    return (torch.minimum(rows.min(), cols.min()) < 0) | (torch.maximum(rows.max(),
                                                                        cols.max()) >= n)


def _degrees(indptr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    deg = indptr[1:] - indptr[:-1]
    return deg[rows.long()], deg[cols.long()]


def common_neighbors_plain(csr, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: every element of each query's shorter row
    looked up by ``torch.searchsorted`` among the CSR's (row, column) keys
    row·N + column (sorted, since the CSR is), exact matches counted per
    query with ``index_add_``; queries in blocks of at most 2^24 lookups."""
    indptr, indices = csr
    n = indptr.numel() - 1
    dev = indptr.device
    keys = torch.repeat_interleave(torch.arange(n, device=dev), indptr[1:] - indptr[:-1])
    keys = keys * n + indices.long()
    r, c = rows.long(), cols.long()
    deg_r, deg_c = _degrees(indptr, rows, cols)
    short = torch.where(deg_r <= deg_c, r, c)
    long_ = torch.where(deg_r <= deg_c, c, r)
    length = torch.minimum(deg_r, deg_c)
    out = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    ends = torch.cumsum(length, 0).cpu()
    q0 = 0
    while q0 < rows.numel():
        base = int(ends[q0 - 1]) if q0 else 0
        q1 = int(torch.searchsorted(ends, base + _PLAIN_BLOCK, right=True))
        q1 = max(q1, q0 + 1)
        qs = torch.arange(q0, q1, device=dev)
        ln = length[q0:q1]
        owner = torch.repeat_interleave(qs, ln)
        first = torch.cumsum(ln, 0) - ln
        pos = torch.arange(owner.numel(), device=dev) - torch.repeat_interleave(first, ln)
        elem = indices[(indptr[short[owner]] + pos)].long()
        want = long_[owner] * n + elem
        at = torch.searchsorted(keys, want).clamp_(max=max(keys.numel() - 1, 0))
        out.index_add_(0, owner, (keys[at] == want).int())
        q0 = q1
    return out


def longer_rows(indptr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Each query's longer row, int32 (``cols[q]`` where the degrees tie):
    the key the kernel's queries are sorted by."""
    deg_r, deg_c = _degrees(indptr, rows, cols)
    return torch.where(deg_r > deg_c, rows, cols)


def _slices(longer: torch.Tensor, n: int,
            slice_queries: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's tables from each query's longer row, built on its
    device without a host sync: (order int64, the queries sorted stably by
    their longer row; row_q int64 (N + 1), row L's queries are [row_q[L],
    row_q[L + 1]) of that order; slice_end int64 (N), the inclusive scan of
    each row's ceil(queries / slice_queries) slices)."""
    long_sorted, order = torch.sort(longer, stable=True)
    row_q = torch.searchsorted(long_sorted, torch.arange(n + 1, dtype=longer.dtype,
                                                         device=longer.device))
    slices = (row_q[1:] - row_q[:-1] + slice_queries - 1) // slice_queries
    return order, row_q, torch.cumsum(slices, 0)


def common_neighbors(csr, rows: torch.Tensor, cols: torch.Tensor,
                     slice_queries: int = SLICE_QUERIES) -> torch.Tensor:
    """|N(rows[q]) ∩ N(cols[q])| for each query, int32, over ``csr`` =
    (indptr int64 (N + 1), indices int32, strictly ascending in each row).
    CPU tensors take the plain version; CUDA tensors launch the kernel, one
    block per slice of at most ``slice_queries`` (<= 256) queries of one
    longer row."""
    indptr = csr[0]
    n = indptr.numel() - 1
    dev = indptr.device
    if not 1 <= slice_queries <= 256:
        raise ValueError(f"slice_queries must lie in 1 .. 256, got {slice_queries}")
    indptr, indices, csr_bad = _csr_flag(csr, n, dev, strict=True)
    _raise_flags([(csr_bad, _csr_message(strict=True)),
                  (_query_flag(rows, cols, n, dev), f"query ids must lie in [0, {n})")])
    if dev.type == "cpu":
        return common_neighbors_plain((indptr, indices), rows, cols)
    lib = _lib()
    out = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    if rows.numel() == 0:
        return out
    order, row_q, slice_end = _slices(longer_rows(indptr, rows, cols), n, slice_queries)
    words = max(min((n + 31) // 32, WINDOW_WORDS), 1)
    with torch.cuda.device(dev):
        rc = lib.ecc_common_neighbors_i32(
            indptr.data_ptr(), indices.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            order.data_ptr(), row_q.data_ptr(), slice_end.data_ptr(), n, rows.numel(),
            int(slice_queries), int(words), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"ecc_common_neighbors_i32 launch failed: CUDA error {rc}")
    LAUNCHES["ecc_common_neighbors_i32"] += 1
    return out
