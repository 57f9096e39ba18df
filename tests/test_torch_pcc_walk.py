"""numpy replays of the ΔPCC kernels' walk (``csrc/pcc_diff_scan.cu``).

The kernels evaluate d once per unordered pair: tile pairs (I, J), J >= I,
numbered row by row, one thread a row, the columns j > i of a diagonal
tile; the diagonal apart.  These replays take the same tiles (at small tile
sizes, so that n is no multiple of them) and the same epilogues, with d
from the plain version's arithmetic, and hold what they give against the
plain versions on the inputs of the card tests:

* counts: 2 x the upper pairs plus the diagonal;
* hits: bits (i, j) and (j, i) set in an n x n mask for d > hi, the
  diagonal's where hi < 0, then each row's CSR entries cleared and its bits
  counted, then each row's words read 32 a step and the step's set bits
  written in order at the row's offset, lane l taking the l-th, found by a
  search of the popcounts' inclusive scan;
* histogram: each direction of a pair counted, linked by its own entry:
  (i, j) by the CSR's bitmask, (j, i) by its transpose's.
"""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from plagnn_tpu_torch.ops import pcc_scan


def tile_pair(p, t):
    """The kernel's tile_pair: the (I, J) of upper tile pair p of t x t."""
    b = 2.0 * t + 1.0
    i = min(max(int((b - math.sqrt(b * b - 8.0 * p)) * 0.5), 0), t - 1)

    def start(r):
        return r * t - r * (r - 1) // 2

    while i > 0 and start(i) > p:
        i -= 1
    while i + 1 < t and start(i + 1) <= p:
        i += 1
    return i, i + p - start(i)


def walk(n, tb, blocks):
    """(i, j, diag) of each row's tile in the order a persistent grid of
    ``blocks`` blocks takes them (block by block), j the tile's columns
    that row i visits."""
    t = -(-n // tb)
    pairs = t * (t + 1) // 2
    for b in range(blocks):
        for p in range(b, pairs, blocks):
            ti, tj = tile_pair(p, t)
            j0 = tj * tb
            for i in range(ti * tb, min(ti * tb + tb, n)):
                first = i + 1 if ti == tj else j0
                yield i, np.arange(first, min(j0 + tb, n)), ti == tj


def factors(n, k, seed):
    """The card tests' factors: random, an eighth of the rows zero."""
    rng = np.random.default_rng(seed + 7 * n + k)
    z = rng.standard_normal((2, n, k))
    for c in range(2):
        z[c, rng.choice(n, n // 8, replace=False)] = 0.0
    return torch.from_numpy(z[0]), torch.from_numpy(z[1])


def one_way_csr(n, seed, repeat=True):
    """Hub rows 0 and 1 (joined to every node, self-loops included), random
    one-way pairs and, with ``repeat``, a repeated entry in each of a few
    rows (ascending, not strictly)."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.zeros(n, np.int64), np.ones(n, np.int64) % max(n, 1),
                        rng.integers(0, n, 3 * n)])
    c = np.concatenate([np.arange(n), np.arange(n), rng.integers(0, n, 3 * n)])
    indptr, indices = pcc_scan.csr_tensors(sp.coo_matrix((np.ones(len(r)), (r, c)),
                                                         shape=(n, n)), "cpu")
    if not repeat or indices.numel() == 0:
        return indptr, indices
    ptr, idx = indptr.numpy(), indices.numpy()
    rows = [list(idx[ptr[i]:ptr[i + 1]]) for i in range(n)]
    for i in range(2, n, 5):
        if rows[i]:
            rows[i].insert(0, rows[i][0])
    new_ptr = np.concatenate([[0], np.cumsum([len(x) for x in rows])]).astype(np.int64)
    new_idx = np.array([v for x in rows for v in x], np.int32)
    return torch.from_numpy(new_ptr), torch.from_numpy(new_idx)


def edge_set(csr):
    indptr, indices = (t.numpy() for t in csr)
    n = len(indptr) - 1
    a = np.zeros((n, n), bool)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    a[rows, indices] = True
    return a


def thresholds(d):
    """hi values: a quantile, a value some d takes exactly, 0, and one
    below 0 (the diagonal's d = 0 is then a hit)."""
    off = d[~np.eye(len(d), dtype=bool)]
    if off.size == 0:
        return [0.0, -0.5]
    exact = off[np.argmin(np.abs(off - np.quantile(off, 0.9)))]
    return [float(np.quantile(off, 0.95)), float(exact), 0.0, float(np.quantile(off, 0.3))]


SHAPES = [(1, 8), (37, 8), (61, 16), (100, 32)]


@pytest.mark.parametrize("n,tb", SHAPES)
def test_walk_visits_each_unordered_pair_once(n, tb):
    seen = np.zeros((n, n), np.int64)
    for i, js, _ in walk(n, tb, blocks=3):
        seen[i, js] += 1
    assert np.array_equal(seen, np.triu(np.ones((n, n), np.int64), 1))


@pytest.mark.parametrize("n,k", [(37, 1), (61, 3), (100, 16)])
def test_d_is_the_same_bits_both_ways(n, k):
    z_i, z_n = factors(n, k, 0)
    d = pcc_scan._diff_block(z_i, z_n, 0, n).numpy()
    assert np.array_equal(d.view(np.int64), d.T.view(np.int64))


def replay_hits(d, hi, csr, tb, blocks=3):
    """The mark pass over the walk, the unmark and count pass, then the
    write pass: (rows, cols)."""
    n = len(d)
    words = -(-n // 32)
    mask = np.zeros((n, 32 * words), bool)
    for i, js, diag in walk(n, tb, blocks):
        if diag and 0.0 > hi:
            mask[i, i] = True
        hit = js[d[i, js] > hi]
        mask[i, hit] = True
        mask[hit, i] = True
    indptr, indices = (t.numpy() for t in csr)
    for row in range(n):
        mask[row, indices[indptr[row]:indptr[row + 1]]] = False
    row_count = mask.sum(axis=1)
    ends = np.cumsum(row_count)
    out_r = np.full(int(ends[-1]) if n else 0, -1, np.int64)
    out_c = out_r.copy()
    bits = mask.reshape(n, words, 32)
    for row in range(n):
        pos, stop = ends[row] - row_count[row], ends[row]
        for w0 in range(0, words, 32):
            if pos >= stop:
                break
            lane_words = np.zeros((32, 32), bool)
            got = bits[row, w0:w0 + 32]
            lane_words[:len(got)] = got
            pc = lane_words.sum(axis=1)
            incl = np.cumsum(pc)
            total = int(incl[-1])
            for k0 in range(0, total, 32):
                for lane in range(32):
                    k = k0 + lane
                    src = 0
                    for o in (16, 8, 4, 2, 1):
                        if incl[src + o - 1] <= k:
                            src += o
                    if k < total:
                        rank = k - (incl[src] - pc[src])
                        out_r[pos + k] = row
                        out_c[pos + k] = 32 * (w0 + src) + np.flatnonzero(lane_words[src])[rank]
            pos += total
    assert (out_r >= 0).all()
    return out_r, out_c


@pytest.mark.parametrize("n,tb", SHAPES)
def test_walk_replay_counts_and_hits_match_plain(n, tb):
    z_i, z_n = factors(n, 3, 1)
    d = pcc_scan._diff_block(z_i, z_n, 0, n).numpy()
    csr = one_way_csr(n, n + 1)
    no_edges = (torch.zeros(n + 1, dtype=torch.int64), torch.zeros(0, dtype=torch.int32))
    for hi in thresholds(d):
        lo = -hi
        upper_lo = upper_hi = 0
        for i, js, _ in walk(n, tb, blocks=2):
            upper_lo += int((d[i, js] < lo).sum())
            upper_hi += int((d[i, js] > hi).sum())
        got = (2 * upper_lo + n * (0.0 < lo), 2 * upper_hi + n * (0.0 > hi))
        assert got == pcc_scan.pcc_diff_counts_plain(z_i, z_n, lo, hi)
        for edges in (no_edges, csr):
            rows, cols = replay_hits(d, hi, edges, tb)
            want_r, want_c = pcc_scan.pcc_diff_hits_plain(z_i, z_n, hi, edges)
            assert np.array_equal(rows, want_r.numpy()) and np.array_equal(cols, want_c.numpy())
            if hi < 0 and n > 1:
                assert (rows == cols).any()  # the diagonal's hits


def bin_of(d, edges, inv_width):
    """The kernel's bin_of: a guess from the mean width, then the edges."""
    nb = len(edges) - 1
    if not (edges[0] <= d <= edges[nb]):
        return -1
    guess = (d - edges[0]) * inv_width
    b = int(guess) if guess < nb - 1 else nb - 1
    while b > 0 and d < edges[b]:
        b -= 1
    while b < nb - 1 and d >= edges[b + 1]:
        b += 1
    return b


def replay_hist(d, edges, csr, tb):
    """The histogram walk: each pair binned once and counted for each
    direction by its own entry.  Returns (linked, unlinked, the pairs whose
    two directions differ)."""
    n, nb = len(d), len(edges) - 1
    inv_width = nb / (edges[-1] - edges[0])
    adj = edge_set(csr)
    counts = np.zeros(2 * nb, np.int64)
    split = 0
    for i, js, _ in walk(n, tb, blocks=2):
        for j in js:
            b = bin_of(d[i, j], edges, inv_width)
            if b < 0:
                continue
            if adj[i, j] == adj[j, i]:
                counts[(0 if adj[i, j] else nb) + b] += 2
            else:
                counts[b] += 1
                counts[nb + b] += 1
                split += 1
    return counts[:nb], counts[nb:], split


@pytest.mark.parametrize("n,tb", SHAPES)
def test_walk_replay_histogram_matches_plain(n, tb):
    z_i, z_n = factors(n, 3, 2)
    d = pcc_scan._diff_block(z_i, z_n, 0, n).numpy()
    csr = one_way_csr(n, n + 3)
    off = d[~np.eye(n, dtype=bool)]
    vals = np.unique(off)
    custom = (np.unique(np.concatenate([vals[np.linspace(len(vals) // 10, 9 * len(vals) // 10,
                                                         12).astype(int)], [0.0]]))
              if len(vals) >= 4 else np.array([-1.0, 0.0, 1.0]))
    for edges in (np.arange(-2.0, 2.0 + 1e-9, 0.02), custom):
        linked, unlinked, split = replay_hist(d, edges, csr, tb)
        want_l, want_u = pcc_scan.pcc_diff_histogram_plain(z_i, z_n, torch.from_numpy(edges),
                                                           csr)
        assert np.array_equal(linked, want_l.numpy())
        assert np.array_equal(unlinked, want_u.numpy())
        if n > 8:
            assert split > 0  # pairs linked one way only


def _csr_ok(indptr, indices, n, strict):
    """The CSR rule, row by row."""
    if indptr[0] != 0 or indptr[-1] != len(indices) or (np.diff(indptr) < 0).any():
        return False
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        return False
    for r in range(n):
        d = np.diff(indices[indptr[r]:indptr[r + 1]])
        if (d <= 0).any() if strict else (d < 0).any():
            return False
    return True


CSR_CASES = [
    ([0, 1, 1, 2], [3, 1]),        # a step down where a row starts after an empty row
    ([0, 0, 2, 2], [3, 1]),        # a step down inside a row after an empty row
    ([0, 2, 3, 3], [1, 1, 0]),     # a repeat inside a row
    ([0, 2, 4, 4], [0, 2, 2, 3]),  # a repeat across a row start
    ([0, 3, 2, 4], [0, 1, 2, 3]),  # indptr falls
    ([0, 1, 2, 9], [0, 1, 2, 3]),  # indptr past the entries
    ([0, 0, 0, 0], []),
]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("case", range(len(CSR_CASES)))
def test_csr_flag_allows_steps_down_only_where_rows_start(case, strict):
    """The wrappers' one-sync CSR check against the rule written row by row."""
    indptr, indices = (np.array(v, dtype) for v, dtype in zip(CSR_CASES[case],
                                                               (np.int64, np.int32)))
    n = len(indptr) - 1
    csr = (torch.from_numpy(indptr), torch.from_numpy(indices))
    _, _, bad = pcc_scan._csr_flag(csr, n, torch.device("cpu"), strict)
    assert bool(bad) == (not _csr_ok(indptr, indices, n, strict))
