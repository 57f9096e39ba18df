// Dense ΔPCC scans over every protein pair, for Hopper (sm_90a).
//
// Replaces the JAX package's host scans, which are not Pallas kernels:
// * plagnn_tpu/analysis/statistics.py: threshold_counts (numpy GEMM blocks)
//   -> pcc_diff_counts;
// * plagnn_tpu/data/topology.py: modify_network_topology's blocked scan
//   (numpy GEMM blocks, or native/plagnn_native.cpp: diff_threshold_scan)
//   -> pcc_diff_hit_mark + pcc_diff_hit_write;
// * plagnn_tpu/analysis/figures.py: diff_histogram (numpy GEMM blocks and
//   np.histogram) -> pcc_diff_hist.
//
// For rows z_i[r], z_n[r] of k float64 values (the standardized expression
// factors, PCC = Z·Zᵀ; 1 <= k <= 16):
//   d(i, j) = (sum_t z_i[i,t]·z_i[j,t]) - (sum_t z_n[i,t]·z_n[j,t])
// with d(i, i) taken as 0, as the reference's dense path zeroes the
// diagonal.  The counts are the pairs with d < lo and with d > hi over all
// n² pairs; the hit list is, in row-major order over all n² ordered pairs,
// the pairs with d > hi that are not edges of a CSR whose rows hold
// ascending column ids; the histogram bins the pairs i != j, apart for
// those that are edges.
//
// Rounding rule: no FMA contraction.  Each product and each sum is rounded
// on its own (__dmul_rn, __dadd_rn, __dsub_rn), t ascending, the first
// product starting each sum (0.0 + p would change only the sign of a zero,
// which no comparison sees).  The plain PyTorch versions in
// ops/pcc_scan.py do the same operations in the same order, so kernel and
// plain version agree bit for bit.  Comparisons are strict.  The float64
// tensor cores are not used: they fuse the multiply and the add.
//
// What bounds it on this card: float64 operations.  Per unordered pair 2k
// multiplies, 2(k-1) adds and 1 subtract (11 at k = 3) plus the compares
// (2 for the counts, 1 for the hits; the histogram 2 for the range and 2
// with the bin's edges); the inputs are 2·n·k·8 bytes (1.2 MB at n =
// 24,041, k = 3), read once.  The H100 SXM data sheet gives 34 TFLOP/s of
// float64 outside the tensor cores, counting an FMA as two operations:
// 17e12 float64 instructions a second.  d(i, j) and d(j, i) are the same
// bits (the products commute and are summed in the same t order), so the
// work is d once per unordered pair: over the 289 M pairs at k = 3 the
// count takes at least 289e6 x 13 / 17e12 = 0.22 ms, the hits 0.20 ms and
// the histogram 0.26 ms.
//
// Design: one walk of the upper triangle, three epilogues.  The pairs are
// cut into square tiles of TB rows by TB columns; tile pair (I, J) with
// J >= I is numbered row by row, and a persistent grid (the blocks the card
// holds at once) strides over the numbers.  A block stages the tile's TB
// columns (z_i's k values, then z_n's) in shared memory and keeps its
// thread's row's 2k values in registers: one row per thread, all threads
// reading the same column at once (a broadcast).  Inside a diagonal tile a
// thread takes only the columns j > i, so d is evaluated once per
// unordered pair.  The diagonal, d = 0, is handled apart.
// * Counts: per-thread 64-bit counts of the upper pairs, reduced by warp
//   shuffles and per block, one integer atomicAdd each; the wrapper gives
//   n_lo = 2 upper_lo + n [0 < lo] and n_hi = 2 upper_hi + n [0 > hi].
// * Hits, pass 1 (mark): a pair with d > hi sets bits (i, j) and (j, i) of
//   an n x n bitmask (72 MB at n = 24,041, zeroed by the wrapper); a thread
//   gathers its row's bits 32 columns at a time and sets them with one
//   atomicOr, a mirror bit (~1.3% of the pairs on a perturbed PPI) takes one
//   atomicOr of its own.  The diagonal's bits are set where 0 > hi.  Then
//   one warp a row clears the bits of the row's CSR entries and counts the
//   row's bits.  The wrapper scans the counts into row offsets (one host
//   sync reads the total); pass 2 (write) gives each row a warp that reads
//   the row's words in order and writes each set bit's pair at the row's
//   offset plus the popcounts before it, staged in shared memory and copied
//   out coalesced.  No d is evaluated twice, no membership test waits in the
//   walk, and no output position depends on an atomic's order.
// * Histogram: each unordered pair is binned once, by np.histogram's rule
//   for an array of edges (bin b where edges[b] <= d < edges[b+1], the last
//   bin closed on the right, values outside [edges[0], edges[nb]]
//   dropped): a guess from the mean bin width, corrected by comparing d
//   with the edges.  The pair counts once for (i, j) and once for (j, i),
//   each linked where it is a CSR entry, so the CSR need not be symmetric:
//   the CSR and its transpose are first written as n x n bitmasks (one
//   warp a row; 2 x 72 MB at n = 24,041), and a thread reads its row's
//   word of each for the step's 32 columns a step ahead.  The block's
//   shared histogram has C copies (8 where they fit), word bin * C +
//   thread % C, so a warp's 32 shared atomics on one of the few hot central
//   bins fall on 8 words, 4 to a word, and 8 blocks of 256 threads fit an
//   SM (32 copies, one a lane, took more shared memory and ran slower); the
//   block adds each nonzero bin's copies into the global int64 counts with
//   one integer atomicAdd.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Rows and columns of a tile, one thread a row: the counts and the hit
// marks (smaller tiles: less waiting on the last wave of tiles); the
// histogram, whose larger blocks share one block histogram among more
// threads.
constexpr int kTile = 128;
constexpr int kHistTile = 256;
// The most tile pairs one block walks: keeps a histogram block's 32-bit
// shared counters (at most 2 x kHistTile² a tile) from overflowing.
constexpr long long kMaxTilesPerBlock = 8192;
constexpr int kRowWarps = 8;  // the row kernels' warps a block, one a row
constexpr int kHistCopies = 8;
constexpr size_t kHistSmemTarget = 112 * 1024;
constexpr size_t kSmemMax = 232448;

// Doubles per staged column: z_i's K values, z_n's K values, and 2 of
// padding for even K, so a column starts on a 16-byte boundary.
template <int K>
__host__ __device__ constexpr int col_stride() {
  return 2 * K + (K % 2 == 0 ? 2 : 0);
}

// Columns [c0, c0 + TC) of z_i and z_n into the tile, by the block's TC
// threads; columns past n are zero (the walk never visits them).
template <int K, int TC>
__device__ __forceinline__ void load_tile(const double* __restrict__ zi,
                                          const double* __restrict__ zn, int64_t n,
                                          int64_t c0, double* tile) {
  constexpr int S = col_stride<K>();
  const int64_t cols = n - c0 < TC ? n - c0 : TC;
  for (int f = threadIdx.x; f < TC * K; f += TC) {
    const int c = f / K;
    const int t = f - c * K;
    double a = 0.0, b = 0.0;
    if (c < cols) {
      a = zi[(c0 + c) * K + t];
      b = zn[(c0 + c) * K + t];
    }
    tile[c * S + t] = a;
    tile[c * S + K + t] = b;
  }
}

// One staged column's 2K values, as K 16-byte loads.
template <int K>
__device__ __forceinline__ void load_col(const double* col, double (&v)[2 * K]) {
  const double2* p = reinterpret_cast<const double2*>(col);
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const double2 w = p[u];
    v[2 * u] = w.x;
    v[2 * u + 1] = w.y;
  }
}

template <int K>
__device__ __forceinline__ void load_row(const double* __restrict__ zi,
                                         const double* __restrict__ zn, int64_t row,
                                         bool live, double (&ri)[K], double (&rn)[K]) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    ri[t] = live ? zi[row * K + t] : 0.0;
    rn[t] = live ? zn[row * K + t] : 0.0;
  }
}

// d for one pair, each product and sum rounded on its own, t ascending.
template <int K>
__device__ __forceinline__ double pair_diff(const double (&ri)[K], const double (&rn)[K],
                                            const double (&v)[2 * K]) {
  double a = __dmul_rn(ri[0], v[0]);
  double b = __dmul_rn(rn[0], v[K]);
#pragma unroll
  for (int t = 1; t < K; ++t) {
    a = __dadd_rn(a, __dmul_rn(ri[t], v[t]));
    b = __dadd_rn(b, __dmul_rn(rn[t], v[K + t]));
  }
  return __dsub_rn(a, b);
}

// Tile pair p of the upper triangle of T x T tiles, numbered row by row:
// row I starts at I T - I (I - 1) / 2 and holds T - I pairs.
__device__ __forceinline__ void tile_pair(int p, int T, int& I, int& J) {
  const double b = 2.0 * T + 1.0;
  long long i = static_cast<long long>((b - sqrt(b * b - 8.0 * p)) * 0.5);
  i = i < 0 ? 0 : (i > T - 1 ? T - 1 : i);
  auto start = [T](long long r) { return r * T - r * (r - 1) / 2; };
  while (i > 0 && start(i) > p) --i;
  while (i + 1 < T && start(i + 1) <= p) ++i;
  I = static_cast<int>(i);
  J = static_cast<int>(i + (p - start(i)));
}

// The walk: every tile pair (I, J), J >= I, of the block's stride, tiles
// of TB rows and TB columns.  Thread t takes row i = I TB + t against the
// tile's columns, j > i in a diagonal tile.  op.row(i, diag, jb) starts the
// row's tile, whose first visited column lies in the 32 from jb;
// op.visit(j, u, d) takes pair (i, j); op.end() closes the tile.  An op
// whose kStepped is true walks the columns in steps of the 32 of a bitmask
// word (TB is a multiple of 32), op.step(jb) starting each, u the pair's
// bit in the step's word.
template <int K, int TB, class Op>
__device__ __forceinline__ void walk_upper(const double* __restrict__ zi,
                                           const double* __restrict__ zn, int n,
                                           double* tile, Op& op) {
  constexpr int S = col_stride<K>();
  const int T = (n + TB - 1) / TB;
  const int pairs = static_cast<int>(static_cast<long long>(T) * (T + 1) / 2);
  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    int I, J;
    tile_pair(p, T, I, J);
    const int i = I * TB + static_cast<int>(threadIdx.x);
    const int j0 = J * TB;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<K, TB>(zi, zn, n, j0, tile);
    double ri[K], rn[K];
    load_row<K>(zi, zn, i, i < n, ri, rn);
    __syncthreads();
    if (i >= n) continue;
    const int cols = n - j0 < TB ? n - j0 : TB;
    const int c_lo = I == J ? static_cast<int>(threadIdx.x) + 1 : 0;
    op.row(i, I == J, j0 + (c_lo & ~31));
    if constexpr (Op::kStepped) {
      for (int cb = c_lo & ~31; cb < cols; cb += 32) {
        op.step(j0 + cb);
        const int ce = cb + 32 < cols ? cb + 32 : cols;
        for (int c = cb < c_lo ? c_lo : cb; c < ce; ++c) {
          double v[2 * K];
          load_col<K>(tile + c * S, v);
          op.visit(j0 + c, c - cb, pair_diff<K>(ri, rn, v));
        }
      }
    } else {
      for (int c = c_lo; c < cols; ++c) {
        double v[2 * K];
        load_col<K>(tile + c * S, v);
        op.visit(j0 + c, 0, pair_diff<K>(ri, rn, v));
      }
    }
    op.end();
  }
}

struct CountOp {
  static constexpr bool kStepped = false;
  double lo, hi;
  long long n_lo = 0, n_hi = 0;
  __device__ void row(int, bool, int) {}
  __device__ void visit(int, int, double d) {
    n_lo += d < lo;
    n_hi += d > hi;
  }
  __device__ void end() {}
};

template <int K>
__global__ void __launch_bounds__(kTile)
pcc_diff_count_kernel(const double* __restrict__ zi, const double* __restrict__ zn, int n,
                      double lo, double hi, unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) double tile[kTile * col_stride<K>()];
  __shared__ long long warp_lo[kTile / 32];
  __shared__ long long warp_hi[kTile / 32];
  CountOp op{lo, hi};
  walk_upper<K, kTile>(zi, zn, n, tile, op);
  long long s_lo = op.n_lo, s_hi = op.n_hi;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_lo += __shfl_down_sync(kFull, s_lo, o);
    s_hi += __shfl_down_sync(kFull, s_hi, o);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = s_lo;
    warp_hi[threadIdx.x >> 5] = s_hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t_lo = 0, t_hi = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) {
      t_lo += warp_lo[w];
      t_hi += warp_hi[w];
    }
    if (t_lo) atomicAdd(&counts[0], t_lo);
    if (t_hi) atomicAdd(&counts[1], t_hi);
  }
}

// Pass 1 of the hits: the bits of the pairs with d > hi, both directions
// (the diagonal's where 0 > hi), row r's at mask[r * words ...], column j at
// bit j % 32 of word j / 32.  The CSR's entries are cleared afterwards.
struct MarkOp {
  static constexpr bool kStepped = true;
  double hi;
  unsigned* mask;
  int words;
  int i = 0;
  int at = 0;  // the word of the open step
  unsigned word = 0u;
  __device__ void row(int row, bool diag, int jb) {
    i = row;
    at = jb >> 5;
    word = 0u;
    if (diag && 0.0 > hi) {  // d(i, i) = 0
      atomicOr(mask + static_cast<int64_t>(i) * words + (i >> 5), 1u << (i & 31));
    }
  }
  __device__ void flush() {
    if (word) atomicOr(mask + static_cast<int64_t>(i) * words + at, word);
    word = 0u;
  }
  __device__ void step(int jb) {
    flush();
    at = jb >> 5;
  }
  __device__ void visit(int j, int u, double d) {
    if (d > hi) {
      word |= 1u << u;
      atomicOr(mask + static_cast<int64_t>(j) * words + (i >> 5), 1u << (i & 31));
    }
  }
  __device__ void end() { flush(); }
};

template <int K>
__global__ void __launch_bounds__(kTile)
pcc_diff_mark_kernel(const double* __restrict__ zi, const double* __restrict__ zn, int n,
                     double hi, unsigned* __restrict__ mask, int words) {
  __shared__ __align__(16) double tile[kTile * col_stride<K>()];
  MarkOp op{hi, mask, words};
  walk_upper<K, kTile>(zi, zn, n, tile, op);
}

// Between the passes, one warp a row: clears the bits of the row's CSR
// entries (only this warp touches the row's words), then counts the row's
// bits into row_count.
__global__ void __launch_bounds__(kRowWarps * 32)
pcc_diff_unmark_kernel(int n, int words, const int64_t* __restrict__ indptr,
                       const int* __restrict__ indices, unsigned* __restrict__ mask,
                       int* __restrict__ row_count) {
  const int row = blockIdx.x * kRowWarps + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  unsigned* m = mask + static_cast<int64_t>(row) * words;
  for (int64_t e = indptr[row] + lane; e < indptr[row + 1]; e += 32) {
    const int c = indices[e];
    atomicAnd(m + (c >> 5), ~(1u << (c & 31)));
  }
  __syncwarp();
  int count = 0;
  for (int w = lane; w < words; w += 32) count += __popc(m[w]);
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) row_count[row] = count;
}

// Pass 2 of the hits: one warp a row, 32 of the row's words a step (one a
// lane, an inclusive scan of their popcounts by shuffles).  Each lane
// writes its word's columns in order into the warp's stage in shared
// memory at the scan's offset; then the warp copies the step's pairs out
// at the row's offset, lane l taking every 32nd from l (coalesced).
__global__ void __launch_bounds__(kRowWarps * 32)
pcc_diff_write_kernel(int n, int words, const unsigned* __restrict__ mask,
                      const int* __restrict__ row_count, const int64_t* __restrict__ row_start,
                      int* __restrict__ out_row, int* __restrict__ out_col) {
  __shared__ int stage[kRowWarps][32 * 32];
  const int row = blockIdx.x * kRowWarps + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  int* st = stage[threadIdx.x >> 5];
  int64_t pos = row_start[row];
  const int64_t stop = pos + row_count[row];
  const unsigned* m = mask + static_cast<int64_t>(row) * words;
  for (int w0 = 0; w0 < words && pos < stop; w0 += 32) {
    unsigned bits = w0 + lane < words ? m[w0 + lane] : 0u;
    const int pc = __popc(bits);
    int incl = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    for (int at = incl - pc; bits; bits &= bits - 1u) {
      st[at++] = 32 * (w0 + lane) + __ffs(bits) - 1;
    }
    __syncwarp();
    const int total = __shfl_sync(kFull, incl, 31);
    for (int k = lane; k < total; k += 32) {
      out_row[pos + k] = row;
      out_col[pos + k] = st[k];
    }
    __syncwarp();  // the stage is read before the next step writes it
    pos += total;
  }
}

// The CSR's entries as n x n bitmasks, adj (row r: the entries (r, c)) and
// adj_t (row c: the entries (r, c)), both zeroed by the caller; one warp a
// row.  The histogram's linked tests, in both directions.
__global__ void __launch_bounds__(kRowWarps * 32)
pcc_diff_adjacency_kernel(int n, int words, const int64_t* __restrict__ indptr,
                          const int* __restrict__ indices, unsigned* __restrict__ adj,
                          unsigned* __restrict__ adj_t) {
  const int row = blockIdx.x * kRowWarps + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  unsigned* m = adj + static_cast<int64_t>(row) * words;
  for (int64_t e = indptr[row] + lane; e < indptr[row + 1]; e += 32) {
    const int c = indices[e];
    atomicOr(m + (c >> 5), 1u << (c & 31));
    atomicOr(adj_t + static_cast<int64_t>(c) * words + (row >> 5), 1u << (row & 31));
  }
}

// The bin of d by comparisons with the edges, -1 outside [e_lo, e_hi].
__device__ __forceinline__ int bin_of(double d, const double* edge, double e_lo,
                                      double e_hi, int n_bins, double inv_width) {
  if (!(d >= e_lo && d <= e_hi)) return -1;
  // the guess (past the end: the last bin), then the edges decide
  const double guess = (d - e_lo) * inv_width;
  int b = guess < n_bins - 1 ? static_cast<int>(guess) : n_bins - 1;
  while (b > 0 && d < edge[b]) --b;
  while (b < n_bins - 1 && d >= edge[b + 1]) ++b;
  return b;
}

// A block's histogram: word ((linked ? 0 : n_bins) + bin) * copies plus the
// thread's copy.  A pair counts once for (i, j) and once for (j, i), each
// linked by its own CSR entry: row i's words of adj and adj_t for the
// step's 32 columns, read from global memory a step ahead.
struct HistOp {
  static constexpr bool kStepped = true;
  const double* edge;
  int n_bins;
  double inv_width;
  unsigned* hist;
  int copies;
  const unsigned* adj;
  const unsigned* adj_t;
  int words;
  double e_lo, e_hi;
  int64_t base = 0;  // row i's first word in adj and adj_t
  unsigned fwd = 0u, bwd = 0u, next_fwd = 0u, next_bwd = 0u;
  __device__ void fetch(int jb) {
    const int w = jb >> 5;
    next_fwd = w < words ? adj[base + w] : 0u;
    next_bwd = w < words ? adj_t[base + w] : 0u;
  }
  __device__ void row(int i, bool, int jb) {
    base = static_cast<int64_t>(i) * words;
    fetch(jb);
  }
  __device__ void step(int jb) {  // this step's words; the next step's, a step ahead
    fwd = next_fwd;
    bwd = next_bwd;
    fetch(jb + 32);
  }
  __device__ void visit(int, int u, double d) {
    const int b = bin_of(d, edge, e_lo, e_hi, n_bins, inv_width);
    if (b < 0) return;
    const int mine = static_cast<int>(threadIdx.x) & (copies - 1);
    const unsigned ij = (fwd >> u) & 1u;
    const unsigned ji = (bwd >> u) & 1u;
    if (ij == ji) {
      atomicAdd(hist + ((ij ? 0 : n_bins) + b) * copies + mine, 2u);
    } else {
      atomicAdd(hist + b * copies + mine, 1u);
      atomicAdd(hist + (n_bins + b) * copies + mine, 1u);
    }
  }
  __device__ void end() {}
};

template <int K>
__global__ void __launch_bounds__(kHistTile)
pcc_diff_hist_kernel(const double* __restrict__ zi, const double* __restrict__ zn, int n,
                     const double* __restrict__ edges, int n_bins, double inv_width,
                     int copies, const unsigned* __restrict__ adj,
                     const unsigned* __restrict__ adj_t,
                     unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) double smem[];
  double* tile = smem;
  double* edge = tile + kHistTile * col_stride<K>();
  unsigned* hist = reinterpret_cast<unsigned*>(edge + n_bins + 1);
  for (int i = threadIdx.x; i < 2 * n_bins * copies; i += kHistTile) hist[i] = 0u;
  for (int i = threadIdx.x; i <= n_bins; i += kHistTile) edge[i] = edges[i];
  // the walk's first __syncthreads makes the zeros and the edges visible
  HistOp op{edge, n_bins, inv_width, hist, copies, adj, adj_t, (n + 31) / 32,
            edges[0], edges[n_bins]};
  walk_upper<K, kHistTile>(zi, zn, n, tile, op);
  __syncthreads();
  // each bin's copies summed; one global atomic per nonzero bin
  for (int bin = threadIdx.x; bin < 2 * n_bins; bin += kHistTile) {
    unsigned long long s = 0;
    for (int c = 0; c < copies; ++c) s += hist[bin * copies + c];
    if (s) atomicAdd(counts + bin, s);
  }
}

// Blocks for a walk: those the card holds at once, at least enough that no
// block walks more than kMaxTilesPerBlock tile pairs, at most one a pair.
// Refuses (0) a triangle of more tile pairs than an int numbers.
template <class Kernel>
long long walk_blocks(Kernel kernel, int threads, size_t smem, long long n, int tb) {
  const long long t = (n + tb - 1) / tb;
  const long long pairs = t * (t + 1) / 2;
  if (n > INT_MAX - 1024 || pairs > INT_MAX) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess) {
    return 0;
  }
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long least = (pairs + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  if (blocks < least) blocks = least;
  return blocks < pairs ? blocks : pairs;
}

template <int K>
int launch_counts(int64_t n, const double* zi, const double* zn, double lo, double hi,
                  unsigned long long* counts, cudaStream_t stream) {
  const long long blocks =
      walk_blocks(pcc_diff_count_kernel<K>, kTile, 0, n, kTile);
  if (blocks == 0) return cudaErrorInvalidValue;
  pcc_diff_count_kernel<K><<<static_cast<unsigned>(blocks), kTile, 0, stream>>>(
      zi, zn, static_cast<int>(n), lo, hi, counts);
  return cudaGetLastError();
}

template <int K>
int launch_mark(int64_t n, const double* zi, const double* zn, double hi,
                const int64_t* indptr, const int* indices, unsigned* mask, int* row_count,
                cudaStream_t stream) {
  const long long blocks =
      walk_blocks(pcc_diff_mark_kernel<K>, kTile, 0, n, kTile);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int words = static_cast<int>((n + 31) / 32);
  pcc_diff_mark_kernel<K><<<static_cast<unsigned>(blocks), kTile, 0, stream>>>(
      zi, zn, static_cast<int>(n), hi, mask, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long row_blocks = (n + kRowWarps - 1) / kRowWarps;
  pcc_diff_unmark_kernel<<<static_cast<unsigned>(row_blocks), kRowWarps * 32, 0, stream>>>(
      static_cast<int>(n), words, indptr, indices, mask, row_count);
  return cudaGetLastError();
}

template <int K>
int launch_hist(int64_t n, const double* zi, const double* zn, const double* edges,
                int n_bins, double inv_width, const int64_t* indptr, const int* indices,
                unsigned* adj, unsigned long long* counts, cudaStream_t stream) {
  if (n_bins < 1 || n > INT_MAX - 1024) return cudaErrorInvalidValue;
  // copies: the largest power of two up to kHistCopies whose block fits
  // kHistSmemTarget, else 1 if that fits the most a block may take
  const size_t fixed =
      sizeof(double) * (kHistTile * col_stride<K>() + n_bins + 1);
  int copies = 0;
  for (int c = kHistCopies; c >= 1 && copies == 0; c /= 2) {
    if (fixed + sizeof(unsigned) * 2 * n_bins * c <= kHistSmemTarget) copies = c;
  }
  if (copies == 0 && fixed + sizeof(unsigned) * 2 * n_bins <= kSmemMax) copies = 1;
  if (copies == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + sizeof(unsigned) * 2 * n_bins * copies;
  const cudaError_t attr = cudaFuncSetAttribute(
      pcc_diff_hist_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = walk_blocks(pcc_diff_hist_kernel<K>, kHistTile, smem, n, kHistTile);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int words = static_cast<int>((n + 31) / 32);
  unsigned* adj_t = adj + static_cast<int64_t>(n) * words;
  const long long row_blocks = (n + kRowWarps - 1) / kRowWarps;
  pcc_diff_adjacency_kernel<<<static_cast<unsigned>(row_blocks), kRowWarps * 32, 0, stream>>>(
      static_cast<int>(n), words, indptr, indices, adj, adj_t);
  pcc_diff_hist_kernel<K><<<static_cast<unsigned>(blocks), kHistTile, smem, stream>>>(
      zi, zn, static_cast<int>(n), edges, n_bins, inv_width, copies, adj, adj_t, counts);
  return cudaGetLastError();
}

#define PCC_FOR_EACH_K(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

// z_i, z_n: (n, k) float64, row-major.  counts: 2 unsigned long long,
// zeroed by the caller; gets the pairs i < j with d < lo and with d > hi
// (the wrapper doubles them and adds the diagonal).  Returns the CUDA error
// code of the launch (0 = launched); cudaErrorInvalidValue for k outside
// 1..16 or more tile pairs than an int numbers (n > 65,535 x 128).
extern "C" int pcc_diff_counts(int k, long long n, const void* z_i, const void* z_n,
                               double lo, double hi, void* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  auto* c = static_cast<unsigned long long*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_counts<K>(n, zi, zn, lo, hi, c, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Pass 1 of the hits: mask (n x ceil(n / 32) uint32, zeroed by the caller)
// gets the pairs with d > hi that are not in the CSR (indptr: n + 1 int64;
// indices: int32, ascending within each row), row_count (n int32) each
// row's number of them.
extern "C" int pcc_diff_hit_mark(int k, long long n, const void* z_i, const void* z_n,
                                 double hi, const void* indptr, const void* indices,
                                 void* mask, void* row_count, void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  auto* mk = static_cast<unsigned*>(mask);
  auto* rc = static_cast<int*>(row_count);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_mark<K>(n, zi, zn, hi, ip, ix, mk, rc, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Pass 2: the marked pairs, each row's in ascending column order at
// out_row/out_col[row_start[row] ...] (row_start: n int64, the exclusive
// scan of row_count).
extern "C" int pcc_diff_hit_write(long long n, const void* mask, const void* row_count,
                                  const void* row_start, void* out_row, void* out_col,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n > INT_MAX - 1024) return cudaErrorInvalidValue;
  const long long blocks = (n + kRowWarps - 1) / kRowWarps;
  pcc_diff_write_kernel<<<static_cast<unsigned>(blocks), kRowWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int>(n), static_cast<int>((n + 31) / 32),
      static_cast<const unsigned*>(mask), static_cast<const int*>(row_count),
      static_cast<const int64_t*>(row_start), static_cast<int*>(out_row),
      static_cast<int*>(out_col));
  return cudaGetLastError();
}

// The ΔPCC histogram of the pairs i != j: counts (2 * n_bins unsigned long
// long, zeroed by the caller) gets the linked pairs (in the CSR: indptr n + 1
// int64, indices int32 ascending within each row) by bin, then the others.
// adj: 2 x n x ceil(n / 32) uint32, zeroed by the caller (the CSR and its
// transpose as bitmasks).  edges: n_bins + 1 float64, strictly ascending and finite;
// inv_width: a guess's scale, n_bins / (edges[n_bins] - edges[0]) (0 if that
// is not finite; the bins come from comparisons with the edges either way).
extern "C" int pcc_diff_hist(int k, long long n, const void* z_i, const void* z_n,
                             const void* edges, int n_bins, double inv_width,
                             const void* indptr, const void* indices, void* adj,
                             void* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  const auto* e = static_cast<const double*>(edges);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  auto* a = static_cast<unsigned*>(adj);
  auto* c = static_cast<unsigned long long*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_hist<K>(n, zi, zn, e, n_bins, inv_width, ip, ix, a, c, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
