"""Common-neighbour counts of query pairs: the ECC's triangle counts.

``common_neighbors(csr, rows, cols) -> counts`` gives, for each query q,
|N(rows[q]) ∩ N(cols[q])| (int32) over a CSR = (indptr int64 (N + 1),
indices int32) whose rows hold strictly ascending column ids, as
``pcc_scan.csr_tensors`` builds it.  The JAX package counts with a sorted
merge per query on the host (``native/plagnn_native.cpp:
common_neighbors``) or the scipy product A·A; here CUDA tensors launch
``csrc/common_neighbors.cu`` (work items of one query and at most
``row_chunk`` elements of its shorter row, one warp each) and CPU tensors
take the plain version, ``common_neighbors_plain``.  Counts are integers,
so both agree exactly.  ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .pcc_scan import _check_csr

ROW_CHUNK = 256
LAUNCHES: Dict[str, int] = {"ecc_common_neighbors_i32": 0}

# Elements of the shorter rows the plain version expands at once.
_PLAIN_BLOCK = 1 << 24

_P = ctypes.c_void_p
# indptr, indices, rows, cols, item_query, item_offset, n_items, row_chunk,
# out, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("common_neighbors")
    lib.ecc_common_neighbors_i32.argtypes = _ARGTYPES
    lib.ecc_common_neighbors_i32.restype = ctypes.c_int
    return lib


def _check_queries(rows: torch.Tensor, cols: torch.Tensor, n: int, device) -> None:
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"rows and cols must be int32, got {rows.dtype}, {cols.dtype}")
    if rows.dim() != 1 or rows.shape != cols.shape:
        raise ValueError(f"rows and cols must be 1-D of one length, got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    if rows.device != device or cols.device != device:
        raise ValueError(f"rows on {rows.device}, cols on {cols.device}, csr on {device}")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("rows and cols must be contiguous")
    if rows.numel() and bool((torch.minimum(rows.min(), cols.min()) < 0)
                             | (torch.maximum(rows.max(), cols.max()) >= n)):
        raise ValueError(f"query ids must lie in [0, {n})")


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


def _items(indptr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           row_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(item_query, item_offset), int32: one item per query and chunk of
    at most ``row_chunk`` elements of its shorter row (none for a query
    with an empty row)."""
    deg_r, deg_c = _degrees(indptr, rows, cols)
    chunks = (torch.minimum(deg_r, deg_c) + row_chunk - 1) // row_chunk
    query = torch.repeat_interleave(torch.arange(rows.numel(), device=rows.device), chunks)
    first = torch.cumsum(chunks, 0) - chunks
    offset = (torch.arange(query.numel(), device=rows.device) - first[query]) * row_chunk
    return query.int(), offset.int()


def common_neighbors(csr, rows: torch.Tensor, cols: torch.Tensor,
                     row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """|N(rows[q]) ∩ N(cols[q])| for each query, int32, over ``csr`` =
    (indptr int64 (N + 1), indices int32, strictly ascending in each row).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    indptr = csr[0]
    n = indptr.numel() - 1
    dev = indptr.device
    indptr, indices = _check_csr(csr, n, dev, strict=True)
    _check_queries(rows, cols, n, dev)
    if dev.type == "cpu":
        return common_neighbors_plain((indptr, indices), rows, cols)
    if row_chunk <= 0:
        raise ValueError(f"row_chunk must be positive, got {row_chunk}")
    lib = _lib()
    out = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    item_query, item_offset = _items(indptr, rows, cols, row_chunk)
    if item_query.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.ecc_common_neighbors_i32(
            indptr.data_ptr(), indices.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            item_query.data_ptr(), item_offset.data_ptr(), item_query.numel(),
            int(row_chunk), out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"ecc_common_neighbors_i32 launch failed: CUDA error {rc}")
    LAUNCHES["ecc_common_neighbors_i32"] += 1
    return out
