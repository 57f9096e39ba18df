"""Dense ΔPCC scans over every protein pair.

The perturbation-topology step and the topology statistics compare
d(i, j) = z_i[i]·z_i[j] - z_n[i]·z_n[j] (the change of the Pearson
correlation between the two conditions, from the (N, k) float64 factors of
``data/expression.py``) with thresholds, over all N² pairs, the diagonal
taken as d = 0.  The JAX package scans on the host (numpy GEMM blocks in
``analysis/statistics.py: threshold_counts`` and
``data/topology.py: modify_network_topology``, or the C++ loop
``native/plagnn_native.cpp: diff_threshold_scan``); here one CUDA source,
``csrc/pcc_diff_scan.cu``, does it without any N² buffer:

* ``pcc_diff_counts(z_i, z_n, lo, hi) -> (n_lo, n_hi)``: the pairs with
  d < lo and with d > hi.  Plain version: ``pcc_diff_counts_plain``.
* ``pcc_diff_hits(z_i, z_n, hi, csr) -> (rows, cols)``: the pairs with
  d > hi that are not edges of ``csr``, in row-major order (two passes: a
  count per row, then writes at the scanned offsets).  Plain version:
  ``pcc_diff_hits_plain``.

Both forms compute d with one rounding per product and per sum, t
ascending, and compare strictly, so kernel and plain version agree exactly.
A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises.  ``LAUNCHES`` counts the kernel
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

MAX_K = 16
LAUNCHES: Dict[str, int] = {"pcc_diff_count_f64": 0, "pcc_diff_hits_f64": 0}

# Elements of the (rows, N) float64 blocks the plain versions hold at once.
_PLAIN_BLOCK = 1 << 25

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# k, n, z_i, z_n, then per entry point:
#   pcc_diff_counts:     lo, hi, counts, stream
#   pcc_diff_hit_counts: hi, indptr, indices, row_count, stream
#   pcc_diff_hit_write:  hi, indptr, indices, row_start, out_row, out_col, stream
_ARGTYPES = {
    "pcc_diff_counts": [_I, _LL, _P, _P, _D, _D, _P, _P],
    "pcc_diff_hit_counts": [_I, _LL, _P, _P, _D, _P, _P, _P, _P],
    "pcc_diff_hit_write": [_I, _LL, _P, _P, _D, _P, _P, _P, _P, _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pcc_diff_scan")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _check_z(z_i: torch.Tensor, z_n: torch.Tensor) -> None:
    if z_i.dim() != 2 or z_i.shape != z_n.shape:
        raise ValueError(f"z_i and z_n must be (N, k) of one shape, got "
                         f"{tuple(z_i.shape)} and {tuple(z_n.shape)}")
    if z_i.dtype != torch.float64 or z_n.dtype != torch.float64:
        raise TypeError(f"z_i and z_n must be float64, got {z_i.dtype}, {z_n.dtype}")
    if not (1 <= z_i.shape[1] <= MAX_K):
        raise ValueError(f"k = {z_i.shape[1]} columns: the scan takes 1 <= k <= {MAX_K}")
    if z_i.device != z_n.device or z_i.device.type not in ("cpu", "cuda"):
        raise ValueError(f"z_i on {z_i.device}, z_n on {z_n.device}")
    if not (z_i.is_contiguous() and z_n.is_contiguous()):
        raise ValueError("z_i and z_n must be contiguous")
    if z_i.shape[0] >= 2**31:
        raise ValueError("the scan takes fewer than 2^31 rows")


def _check_csr(csr, n: int, device, strict: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indptr int64 (n + 1), indices int32), on z's device, with each row's
    column ids in [0, n) and ascending (the kernel's merge pointer needs
    that; repeats are harmless), or strictly ascending with ``strict``."""
    indptr, indices = csr
    if indptr.dtype != torch.int64 or indptr.shape != (n + 1,):
        raise ValueError(f"indptr must be int64 of shape ({n + 1},)")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise ValueError("indices must be a 1-D int32 tensor")
    if indptr.device != device or indices.device != device:
        raise ValueError(f"csr on {indptr.device} / {indices.device}, z on {device}")
    if not (indptr.is_contiguous() and indices.is_contiguous()):
        raise ValueError("indptr and indices must be contiguous")
    # one host sync for every check; the row of each entry comes from a
    # search, so a malformed indptr indexes nothing out of range
    m = indices.numel()
    bad = (indptr[0] != 0) | (indptr[-1] != m) | (indptr[1:] < indptr[:-1]).any()
    if m:
        row = torch.searchsorted(indptr, torch.arange(m, device=device), right=True)
        bad = bad | (indices.min() < 0) | (indices.max() >= n)
        down = indices[1:] <= indices[:-1] if strict else indices[1:] < indices[:-1]
        bad = bad | (down & (row[1:] == row[:-1])).any()
    if bool(bad):
        raise ValueError("csr must have an indptr rising from 0 to len(indices) and "
                         "column ids in [0, n), "
                         f"{'strictly ' if strict else ''}ascending in each row")
    return indptr, indices


def csr_tensors(ppi, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indptr, indices) of a scipy sparse matrix's entries with a nonzero
    value, duplicates summed, column ids sorted in each row: the pairs the
    hit scan excludes, and the adjacency of the ECC counts."""
    m = ppi.tocsr(copy=True)
    m.sum_duplicates()
    m.eliminate_zeros()
    m.sort_indices()
    return (torch.as_tensor(m.indptr.astype(np.int64), device=device),
            torch.as_tensor(m.indices.astype(np.int32), device=device))


# ---------------------------------------------------------------------------
# Plain PyTorch versions: row blocks of the dense d, in the kernel's order.
# ---------------------------------------------------------------------------


def _dot_block(z: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """(r1 - r0, N) of z[r]·z[j], one product and one sum per op, t ascending."""
    acc = z[r0:r1, 0:1] * z[:, 0]
    for t in range(1, z.shape[1]):
        acc = acc + z[r0:r1, t:t + 1] * z[:, t]
    return acc


def _diff_block(z_i: torch.Tensor, z_n: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    d = _dot_block(z_i, r0, r1) - _dot_block(z_n, r0, r1)
    rr = torch.arange(r0, r1, device=d.device)
    d[rr - r0, rr] = 0.0
    return d


def _row_blocks(n: int):
    step = max(_PLAIN_BLOCK // max(n, 1), 1)
    for r0 in range(0, n, step):
        yield r0, min(r0 + step, n)


def pcc_diff_counts_plain(z_i: torch.Tensor, z_n: torch.Tensor, lo: float,
                          hi: float) -> Tuple[int, int]:
    """Plain PyTorch version of ``pcc_diff_counts``."""
    n_lo = torch.zeros((), dtype=torch.int64, device=z_i.device)
    n_hi = torch.zeros((), dtype=torch.int64, device=z_i.device)
    for r0, r1 in _row_blocks(z_i.shape[0]):
        d = _diff_block(z_i, z_n, r0, r1)
        n_lo += (d < lo).sum()
        n_hi += (d > hi).sum()
    return int(n_lo), int(n_hi)


def pcc_diff_hits_plain(z_i: torch.Tensor, z_n: torch.Tensor, hi: float,
                        csr) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pcc_diff_hits``: each row block's dense
    d > hi with the block's edges cleared, ``torch.nonzero`` (row-major)."""
    indptr, indices = csr
    ptr = indptr.cpu().numpy()
    rows, cols = [], []
    for r0, r1 in _row_blocks(z_i.shape[0]):
        hit = _diff_block(z_i, z_n, r0, r1) > hi
        e0, e1 = int(ptr[r0]), int(ptr[r1])
        if e1 > e0:
            deg = indptr[r0 + 1:r1 + 1] - indptr[r0:r1]
            er = torch.repeat_interleave(
                torch.arange(r1 - r0, device=hit.device), deg)
            hit[er, indices[e0:e1].long()] = False
        nz = torch.nonzero(hit)
        rows.append((nz[:, 0] + r0).int())
        cols.append(nz[:, 1].int())
    if not rows:
        empty = torch.empty(0, dtype=torch.int32, device=z_i.device)
        return empty, empty.clone()
    return torch.cat(rows), torch.cat(cols)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def pcc_diff_counts(z_i: torch.Tensor, z_n: torch.Tensor, lo: float,
                    hi: float) -> Tuple[int, int]:
    """(#pairs with d < lo, #pairs with d > hi) over all N² pairs of the
    (N, k) float64 factors, the diagonal counted as d = 0.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check_z(z_i, z_n)
    if z_i.device.type == "cpu":
        return pcc_diff_counts_plain(z_i, z_n, lo, hi)
    n, k = z_i.shape
    if n == 0:
        return 0, 0
    lib = _lib()
    counts = torch.zeros(2, dtype=torch.int64, device=z_i.device)
    with torch.cuda.device(z_i.device):
        rc = lib.pcc_diff_counts(k, n, z_i.data_ptr(), z_n.data_ptr(), float(lo),
                                 float(hi), counts.data_ptr(), _stream(z_i))
    _raise_on(rc, "pcc_diff_counts")
    LAUNCHES["pcc_diff_count_f64"] += 1
    n_lo, n_hi = counts.tolist()
    return n_lo, n_hi


def pcc_diff_hits(z_i: torch.Tensor, z_n: torch.Tensor, hi: float,
                  csr) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols), int32, of the pairs with d > hi that are not in ``csr``
    = (indptr int64 (N + 1), indices int32, ascending in each row; see
    ``csr_tensors``), in row-major order, the diagonal taken as d = 0.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_z(z_i, z_n)
    n, k = z_i.shape
    indptr, indices = _check_csr(csr, n, z_i.device)
    if z_i.device.type == "cpu":
        return pcc_diff_hits_plain(z_i, z_n, hi, (indptr, indices))
    dev = z_i.device
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    lib = _lib()
    row_count = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.pcc_diff_hit_counts(k, n, z_i.data_ptr(), z_n.data_ptr(), float(hi),
                                     indptr.data_ptr(), indices.data_ptr(),
                                     row_count.data_ptr(), _stream(z_i))
    _raise_on(rc, "pcc_diff_hit_counts")
    ends = torch.cumsum(row_count, 0, dtype=torch.int64)
    total = int(ends[-1])
    rows = torch.empty(total, dtype=torch.int32, device=dev)
    cols = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        row_start = ends - row_count
        with torch.cuda.device(dev):
            rc = lib.pcc_diff_hit_write(k, n, z_i.data_ptr(), z_n.data_ptr(), float(hi),
                                        indptr.data_ptr(), indices.data_ptr(),
                                        row_start.data_ptr(), rows.data_ptr(),
                                        cols.data_ptr(), _stream(z_i))
        _raise_on(rc, "pcc_diff_hit_write")
    LAUNCHES["pcc_diff_hits_f64"] += 1
    return rows, cols
