"""PCA features without sklearn, the float64 products on the device.

The JAX package calls ``PCA(n_components, random_state=42).fit_transform``
(``plagnn_tpu/data/preprocess.py:67-69``) on dense N x N matrices.  ``pca``
reproduces what the installed sklearn (1.9.0) does there:

* the solver of ``svd_solver="auto"`` on dense input: ``covariance_eigh``
  for tall narrow inputs (not ported: never true for the square inputs
  here, and refused), ``full`` where max(shape) <= 500, ``randomized``
  where 1 <= n < 0.8·min(shape), else ``full``;
* ``full``: center by the column mean, thin SVD;
* ``randomized`` (Halko et al., sklearn's ``_randomized_svd``): Q drawn on
  the host from ``np.random.RandomState(42).normal`` with n + 10 columns;
  n_iter rounds (7 where n < 0.1·min(shape), else 4) of Q = P·L of an LU
  with partial pivoting of A·Q, then of Aᵀ·Q; Q = qr(A·Q); B = Qᵀ·A;
  U = Q·svd(B).U;
* ``svd_flip`` on the rows of Vᵀ (each row's largest-magnitude entry made
  positive), and the output U[:, :n]·S[:n] in sklearn's memory order
  (Fortran from ``full``, C from ``randomized``), so ``np.save`` writes
  the same header.

The dense input is built on ``device`` and every product is a float64
``torch.matmul`` there (a plain product, as XLA would have it; no kernel
of the JAX package's).  Outputs agree with sklearn to rounding, amplified
where singular values lie close together (tests/test_torch_preprocess.py
states the tolerance).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

RANDOM_STATE = 42
N_OVERSAMPLES = 10


def choose_solver(shape, n_components: int) -> str:
    """sklearn 1.9.0's ``svd_solver="auto"`` choice for a dense input."""
    n_samples, n_features = shape
    if n_features <= 1_000 and n_samples >= 10 * n_features:
        raise NotImplementedError(
            f"PCA of a {shape} input takes sklearn's covariance_eigh solver, "
            "which is not ported")
    if max(shape) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(shape):
        return "randomized"
    return "full"


def dense_on(mat, device) -> torch.Tensor:
    """A float64 dense copy of ``mat`` (numpy or scipy sparse) on
    ``device``; a sparse matrix is scattered there from its COO entries
    (duplicates summed on the host first)."""
    if sp.issparse(mat):
        coo = sp.coo_matrix(mat, dtype=np.float64, copy=True)
        coo.sum_duplicates()
        out = torch.zeros(coo.shape, dtype=torch.float64, device=device)
        rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
        cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
        out[rows, cols] = torch.as_tensor(coo.data, device=device)
        return out
    return torch.as_tensor(np.asarray(mat, np.float64), device=device).clone()


@contextlib.contextmanager
def _cusolver(device):
    """cuSOLVER for the factorizations on a card, restoring the caller's
    choice after: PyTorch's heuristic sends the tall LU to MAGMA's batched
    routine, which warns on every call at this size."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _lu_pl(y: torch.Tensor) -> torch.Tensor:
    """P·L of y = P·L·U (partial pivoting), as scipy's ``lu(y,
    permute_l=True)``; P is applied as a row permutation from the pivots,
    never formed."""
    lu, pivots = torch.linalg.lu_factor(y)
    m, k = y.shape
    ell = torch.tril(lu[:, :k], -1)
    ell.diagonal().fill_(1.0)
    perm = np.arange(m)
    for i, p in enumerate(pivots.cpu().numpy() - 1):  # LAPACK's row swaps
        perm[i], perm[p] = perm[p], perm[i]
    out = torch.empty_like(ell)
    out[torch.as_tensor(perm, device=y.device)] = ell
    return out


def _flip_rows(vt: torch.Tensor) -> torch.Tensor:
    """sklearn's ``svd_flip(u_based_decision=False)`` signs: the sign of
    each row's first largest-magnitude entry (0 for a zero row)."""
    at = torch.argmax(vt.abs(), dim=1)
    return torch.sign(vt.gather(1, at[:, None])[:, 0])


def pca(mat, components: int, *, device="cuda",
        timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """``PCA(components, random_state=42).fit_transform(mat)`` on ``device``
    (float64), returned as a host array.  ``timings``, where given, gets
    the wall seconds of building the dense input (``dense``), the range
    finder's products and factorizations (``power``) and the last SVD, flip
    and copy out (``svd``)."""
    with _cusolver(device):
        return _pca(mat, components, device, timings)


def _pca(mat, components: int, device, timings: Optional[Dict[str, float]]) -> np.ndarray:
    t0 = time.perf_counter()
    x = dense_on(mat, device)
    n_samples, n_features = x.shape
    solver = choose_solver(x.shape, components)
    x -= x.mean(dim=0)
    _sync(device)
    t1 = time.perf_counter()
    if solver == "full":
        if not 0 <= components <= min(x.shape):
            raise ValueError(f"n_components={components} outside [0, {min(x.shape)}]")
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        t2 = t1
        order = "F"
    else:
        if not 1 <= components <= min(x.shape):
            raise ValueError(f"n_components={components} outside [1, {min(x.shape)}]")
        if n_samples < n_features:
            raise NotImplementedError("the randomized solver's transposed case "
                                      "(n_samples < n_features) is not ported")
        n_iter = 7 if components < 0.1 * min(x.shape) else 4
        rs = np.random.RandomState(RANDOM_STATE)
        q = torch.as_tensor(rs.normal(size=(n_features, components + N_OVERSAMPLES)),
                            device=device)
        for _ in range(n_iter):
            q = _lu_pl(x @ q)
            q = _lu_pl(x.T @ q)
        q, _ = torch.linalg.qr(x @ q, mode="reduced")
        b = q.T @ x
        _sync(device)
        t2 = time.perf_counter()
        u_hat, s, vt = torch.linalg.svd(b, full_matrices=False)
        u = q @ u_hat
        order = "C"
    del x
    signs = _flip_rows(vt[:components])
    out = (u[:, :components] * signs) * s[:components]
    result = out.cpu().numpy()
    result = np.asfortranarray(result) if order == "F" else np.ascontiguousarray(result)
    if timings is not None:
        t3 = time.perf_counter()
        timings.update(dense=t1 - t0, power=t2 - t1, svd=t3 - t2)
    return result


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
