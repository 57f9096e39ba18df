// Dense ΔPCC scans over every protein pair, for Hopper (sm_90a).
//
// Replaces the JAX package's host scans, which are not Pallas kernels:
// * plagnn_tpu/analysis/statistics.py: threshold_counts (numpy GEMM blocks)
//   -> pcc_diff_counts;
// * plagnn_tpu/data/topology.py: modify_network_topology's blocked scan
//   (numpy GEMM blocks, or native/plagnn_native.cpp: diff_threshold_scan)
//   -> pcc_diff_hit_counts + pcc_diff_hit_write;
// * plagnn_tpu/analysis/figures.py: diff_histogram (numpy GEMM blocks and
//   np.histogram) -> pcc_diff_hist.
//
// For rows z_i[r], z_n[r] of k float64 values (the standardized expression
// factors, PCC = Z·Zᵀ; 1 <= k <= 16):
//   d(i, j) = (sum_t z_i[i,t]·z_i[j,t]) - (sum_t z_n[i,t]·z_n[j,t])
// with d(i, i) taken as 0, as the reference's dense path zeroes the
// diagonal.  pcc_diff_counts counts the pairs with d < lo and with d > hi
// over all n² pairs; the hit kernels list, in row-major order, the pairs
// with d > hi that are not edges of a CSR whose rows hold ascending column
// ids.
//
// Rounding rule: no FMA contraction.  Each product and each sum is rounded
// on its own (__dmul_rn, __dadd_rn, __dsub_rn), t ascending, the first
// product starting each sum (0.0 + p would change only the sign of a zero,
// which no comparison sees).  The plain PyTorch versions in
// ops/pcc_scan.py do the same operations in the same order, so kernel and
// plain version agree bit for bit.  Comparisons are strict.
//
// What bounds it on this card: float64 operations.  Per pair 2k multiplies,
// 2(k-1) adds and 1 subtract (11 at k = 3) plus the compares (2 for the
// counts, 1 for the hits); the inputs are 2·n·k·8 bytes (1.2 MB at n =
// 24,041, k = 3), read once.  The H100 SXM data sheet gives 34 TFLOP/s of
// float64 outside the tensor cores, counting an FMA as two operations: 17e12
// float64 instructions a second.  With no contraction each multiply, add,
// subtract and compare is one instruction.  d(i, j) and d(j, i) are the
// same bits (the products commute and are summed in the same t order), so
// the work needs d, its compares and its bin once per unordered pair; these
// kernels evaluate every ordered pair, twice that.  So the count over the
// 289 M unordered pairs at k = 3 takes at least 289e6 x 13 / 17e12 = 0.22
// ms, and the hits 289e6 x 12 / 17e12 = 0.20 ms; the hit kernels take two
// passes over the ordered pairs (count, then write at scanned offsets).
// The histogram adds 2 compares for the range and 2 with the bin's edges a
// pair: 4k + 3 = 15 at k = 3, 0.26 ms.
//
// Design.  Each block stages a tile of kTileCols columns (z_i's k values,
// then z_n's) in shared memory, loaded once and used by all the block's
// rows, and keeps each row's 2k values in registers.  No n² buffer exists.
// * Counts: one row per thread, a 2-D grid of (column tile, 256-row tile);
//   all threads read the same column (a broadcast).  Per-thread int counts
//   are reduced by warp shuffles and per block, and each block adds its two
//   sums with one integer atomicAdd each: the count is exact and the same
//   run to run.
// * Hits: each warp takes R rows (4 at k <= 4) over all column tiles, 32
//   consecutive columns a step, one per lane; a lane's read of its column
//   serves all R rows (the column stride in shared memory is padded so the
//   32 lanes' reads hit distinct banks).  Each row's CSR neighbours are
//   excluded with a merge pointer, which only moves forward since columns
//   ascend: a window of the next 32 neighbours in the lanes' registers,
//   passed with shuffles, so the walk reads the CSR once per 32.  The first pass writes each row's hit count; the wrapper scans
//   them (torch.cumsum) into row offsets; the second pass recomputes d and
//   writes each step's hits at offset + popcount(ballot below the lane),
//   so positions follow from the scan and the ballots, never from atomics.
// * Histogram: the count kernel's layout (one row per thread, a column
//   tile staged in shared memory and read by all threads at once), each
//   block over kHistCols columns, with a per-thread merge pointer into the
//   row's CSR neighbours for "linked" (columns ascend along a thread's
//   walk, so the pointer only moves forward).  The pairs i != j are
//   binned by np.histogram's rule for an array of edges: bin b where
//   edges[b] <= d < edges[b+1], the last bin closed on the right, values
//   outside [edges[0], edges[nb]] dropped.  A guess from the mean bin
//   width is corrected by comparing d with the edges, so the bin is what
//   the comparisons say.  d is concentrated in a few central bins, so the
//   block's shared histogram has C copies (32 where they fit), word
//   bin * C + lane % C: lanes never share a word and, with C = 32, never
//   a bank, so a warp's 32 shared atomics do not serialise on a hot bin.
//   The block adds each nonzero bin's copies and adds the sum into the
//   global int64 counts with one integer atomicAdd, exact in any order.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileCols = 128;
constexpr int kCountThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The hit kernels' blocks: kHitWarps warps, each over hit_rows<K>() rows
// at once, so one shared-memory read of a column serves that many pairs;
// fewer rows above k = 4 and k = 8, where a thread's registers hold its
// rows' 2k values each and one column's 2k.  A hit block walks all n
// columns, hit_tile_cols<K>() at a time (under 48 KB of shared memory).
constexpr int kHitWarps = 8;
constexpr int kHitThreads = 32 * kHitWarps;

template <int K>
__host__ __device__ constexpr int hit_rows() {
  return K <= 4 ? 4 : (K <= 8 ? 2 : 1);
}

template <int K>
__host__ __device__ constexpr int hit_tile_cols() {
  return K <= 8 ? 256 : 128;
}

// Doubles per staged column: z_i's K values, z_n's K values, and 2 of
// padding for even K, so the stride is 2 (mod 4) doubles and 32 lanes
// reading 16-byte pairs of 32 consecutive columns hit distinct banks.
template <int K>
__host__ __device__ constexpr int col_stride() {
  return 2 * K + (K % 2 == 0 ? 2 : 0);
}

// Columns [c0, c0 + TC) of z_i and z_n into the tile; columns past n are
// zero (the kernels never count them).
template <int K, int TC>
__device__ __forceinline__ void load_tile(const double* __restrict__ zi,
                                          const double* __restrict__ zn, int64_t n,
                                          int64_t c0, double* tile, int nthreads) {
  constexpr int S = col_stride<K>();
  const int64_t cols = n - c0 < TC ? n - c0 : TC;
  for (int f = threadIdx.x; f < TC * K; f += nthreads) {
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

// One staged column's 2K values, as K 16-byte loads (the column starts on a
// 16-byte boundary since its stride is even).
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

template <int K>
__global__ void __launch_bounds__(kCountThreads)
pcc_diff_count_kernel(const double* __restrict__ zi, const double* __restrict__ zn,
                      int64_t n, double lo, double hi,
                      unsigned long long* __restrict__ counts) {
  constexpr int S = col_stride<K>();
  __shared__ __align__(16) double tile[kTileCols * S];
  __shared__ int warp_lo[kCountThreads / 32];
  __shared__ int warp_hi[kCountThreads / 32];

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTileCols;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * kCountThreads + threadIdx.x;
  const bool live = row < n;
  load_tile<K, kTileCols>(zi, zn, n, c0, tile, kCountThreads);
  double ri[K], rn[K];
  load_row<K>(zi, zn, row, live, ri, rn);
  __syncthreads();

  int n_lo = 0, n_hi = 0;
  if (live) {
    const int cols = static_cast<int>(n - c0 < kTileCols ? n - c0 : kTileCols);
    for (int c = 0; c < cols; ++c) {
      double v[2 * K];
      load_col<K>(tile + c * S, v);
      double d = pair_diff<K>(ri, rn, v);
      if (c0 + c == row) d = 0.0;
      n_lo += d < lo;
      n_hi += d > hi;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_lo += __shfl_down_sync(kFull, n_lo, o);
    n_hi += __shfl_down_sync(kFull, n_hi, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_lo[warp] = n_lo;
    warp_hi[warp] = n_hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s_lo = 0, s_hi = 0;
#pragma unroll
    for (int w = 0; w < kCountThreads / 32; ++w) {
      s_lo += warp_lo[w];
      s_hi += warp_hi[w];
    }
    if (s_lo) atomicAdd(&counts[0], s_lo);
    if (s_hi) atomicAdd(&counts[1], s_hi);
  }
}

// kWrite false: row_count[row] = the row's hits.  kWrite true: the row's
// hits, ascending, at out_row/out_col[row_start[row] ...].  Warp w of block
// b takes rows (b * kHitWarps + w) * R ... + R - 1.  Row and column ids are
// int: the launcher takes n <= INT_MAX - 1024.
template <int K, bool kWrite>
__global__ void __launch_bounds__(kHitThreads)
pcc_diff_hit_kernel(const double* __restrict__ zi, const double* __restrict__ zn,
                    int n, double hi, const int64_t* __restrict__ indptr,
                    const int* __restrict__ indices, int* __restrict__ row_count,
                    const int64_t* __restrict__ row_start, int* __restrict__ out_row,
                    int* __restrict__ out_col) {
  constexpr int S = col_stride<K>();
  constexpr int R = hit_rows<K>();
  constexpr int TC = hit_tile_cols<K>();
  __shared__ __align__(16) double tile[TC * S];

  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kHitWarps + (threadIdx.x >> 5)) * R;
  // Per row: its values; a window of its next 32 neighbours, one per lane
  // (INT_MAX past the row's end), of which the first wo are passed, and
  // next_nb, the first not passed (the same in every lane), so the column
  // walk excludes edges with shuffles and reads the CSR once per 32
  // neighbours; and its count or its next output position.
  double ri[R][K], rn[R][K];
  int64_t wp[R], p_end[R], pos[R];
  int nbw[R], wo[R], next_nb[R], count[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = row0 + q;
    const bool live = row < n;
    load_row<K>(zi, zn, row, live, ri[q], rn[q]);
    wp[q] = live ? indptr[row] : 0;
    p_end[q] = live ? indptr[row + 1] : 0;
    nbw[q] = wp[q] + lane < p_end[q] ? indices[wp[q] + lane] : INT_MAX;
    wo[q] = 0;
    next_nb[q] = __shfl_sync(kFull, nbw[q], 0);
    pos[q] = (kWrite && live) ? row_start[row] : 0;
    count[q] = 0;
  }

  for (int c0 = 0; c0 < n; c0 += TC) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<K, TC>(zi, zn, n, c0, tile, kHitThreads);
    __syncthreads();
    if (row0 >= n) continue;
    for (int s = 0; s < TC; s += 32) {
      const int j0 = c0 + s;
      if (j0 >= n) break;
      const int j = j0 + lane;
      double v[2 * K];
      load_col<K>(tile + (s + lane) * S, v);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int row = row0 + q;
        // row q's edges in [j0, j0 + 32), as a mask: a run of the window's
        // lanes from wo on (every earlier neighbour was passed before j0)
        unsigned edge = 0;
        while (next_nb[q] < j0 + 32) {
          const bool in = lane >= wo[q] && nbw[q] < j0 + 32;
          edge |= __reduce_or_sync(kFull, in ? 1u << (nbw[q] - j0) : 0u);
          wo[q] += __popc(__ballot_sync(kFull, in));
          if (wo[q] == 32) {  // window passed: the next 32 neighbours
            wp[q] += 32;
            nbw[q] = wp[q] + lane < p_end[q] ? indices[wp[q] + lane] : INT_MAX;
            wo[q] = 0;
          }
          next_nb[q] = __shfl_sync(kFull, nbw[q], wo[q]);
        }
        double d = pair_diff<K>(ri[q], rn[q], v);
        if (j == row) d = 0.0;
        const bool hit = row < n && j < n && !((edge >> lane) & 1u) && d > hi;
        const unsigned mask = __ballot_sync(kFull, hit);
        if constexpr (kWrite) {
          if (hit) {
            const int64_t at = pos[q] + __popc(mask & ((1u << lane) - 1u));
            out_row[at] = row;
            out_col[at] = j;
          }
          pos[q] += __popc(mask);
        } else {
          count[q] += __popc(mask);
        }
      }
    }
  }
  if constexpr (!kWrite) {
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (row0 + q < n) row_count[row0 + q] = count[q];
      }
    }
  }
}

// Histogram blocks: kCountThreads rows (one a thread) by kHistCols columns.
// Dynamic shared memory: the column tile, the n_bins + 1 edges and the
// 2 * n_bins * copies counters; copies is the largest power of two up to
// kHistCopies whose block fits kHistSmemTarget (two blocks an SM), else 1
// if that fits the most a block may take.
constexpr int kHistCols = 1024;
constexpr int kHistCopies = 32;
constexpr size_t kHistSmemTarget = 112 * 1024;
constexpr size_t kSmemMax = 232448;

// counts[0 .. n_bins): linked pairs by bin; counts[n_bins .. 2 n_bins):
// the other pairs i != j.  Row and column ids are int (n <= INT_MAX - 1024).
template <int K>
__global__ void __launch_bounds__(kCountThreads)
pcc_diff_hist_kernel(const double* __restrict__ zi, const double* __restrict__ zn,
                     int n, const double* __restrict__ edges, int n_bins,
                     double inv_width, int copies, const int64_t* __restrict__ indptr,
                     const int* __restrict__ indices,
                     unsigned long long* __restrict__ counts) {
  constexpr int S = col_stride<K>();
  extern __shared__ __align__(16) double smem[];
  double* tile = smem;
  double* edge = tile + kTileCols * S;
  unsigned* hist = reinterpret_cast<unsigned*>(edge + n_bins + 1);
  for (int i = threadIdx.x; i < 2 * n_bins * copies; i += kCountThreads) hist[i] = 0u;
  for (int i = threadIdx.x; i <= n_bins; i += kCountThreads) edge[i] = edges[i];

  const int row = static_cast<int>(blockIdx.y) * kCountThreads + static_cast<int>(threadIdx.x);
  const bool live = row < n;
  const int g0 = static_cast<int>(blockIdx.x) * kHistCols;
  const int g1 = n - g0 < kHistCols ? n : g0 + kHistCols;
  double ri[K], rn[K];
  load_row<K>(zi, zn, row, live, ri, rn);
  // the merge pointer: the row's first neighbour >= g0 (a lower bound) and
  // its column id (INT_MAX past the row's end)
  int64_t p = 0, p_end = 0;
  if (live) {
    p = indptr[row];
    p_end = indptr[row + 1];
    int64_t top = p_end;
    while (p < top) {
      const int64_t mid = p + (top - p) / 2;
      if (indices[mid] < g0) {
        p = mid + 1;
      } else {
        top = mid;
      }
    }
  }
  int nb = p < p_end ? indices[p] : INT_MAX;
  const int mine = static_cast<int>(threadIdx.x) & (copies - 1);

  for (int c0 = g0; c0 < g1; c0 += kTileCols) {
    __syncthreads();  // the previous tile is done (and, at first, the edges and zeros are in)
    load_tile<K, kTileCols>(zi, zn, n, c0, tile, kCountThreads);
    __syncthreads();
    if (!live) continue;
    const double e_lo = edge[0];
    const double e_hi = edge[n_bins];
    const int cols = g1 - c0 < kTileCols ? g1 - c0 : kTileCols;
    for (int c = 0; c < cols; ++c) {
      const int j = c0 + c;
      double v[2 * K];
      load_col<K>(tile + c * S, v);
      const double d = pair_diff<K>(ri, rn, v);
      while (nb < j) {
        ++p;
        nb = p < p_end ? indices[p] : INT_MAX;
      }
      if (j == row || !(d >= e_lo && d <= e_hi)) continue;
      // the guess (NaN or past the end: the last bin), then the edges decide
      const double guess = (d - e_lo) * inv_width;
      int b = guess < n_bins - 1 ? static_cast<int>(guess) : n_bins - 1;
      while (b > 0 && d < edge[b]) --b;
      while (b < n_bins - 1 && d >= edge[b + 1]) ++b;
      const int bin = (nb == j ? 0 : n_bins) + b;
      atomicAdd(hist + bin * copies + mine, 1u);
    }
  }
  __syncthreads();
  // each bin's copies, read from a rotated start so a warp's 32 bins hit 32
  // banks; one global atomic per nonzero bin
  for (int bin = threadIdx.x; bin < 2 * n_bins; bin += kCountThreads) {
    unsigned long long s = 0;
    for (int c = 0; c < copies; ++c) s += hist[bin * copies + ((c + bin) & (copies - 1))];
    if (s) atomicAdd(counts + bin, s);
  }
}

template <int K>
int launch_counts(int64_t n, const double* zi, const double* zn, double lo, double hi,
                  unsigned long long* counts, cudaStream_t stream) {
  const int64_t col_tiles = (n + kTileCols - 1) / kTileCols;
  const int64_t row_tiles = (n + kCountThreads - 1) / kCountThreads;
  if (col_tiles > INT_MAX || row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
  pcc_diff_count_kernel<K><<<grid, kCountThreads, 0, stream>>>(zi, zn, n, lo, hi, counts);
  return cudaGetLastError();
}

template <int K, bool kWrite>
int launch_hits(int64_t n, const double* zi, const double* zn, double hi,
                const int64_t* indptr, const int* indices, int* row_count,
                const int64_t* row_start, int* out_row, int* out_col,
                cudaStream_t stream) {
  constexpr int kRows = kHitWarps * hit_rows<K>();
  if (n > INT_MAX - 1024) return cudaErrorInvalidValue;
  const int64_t blocks = (n + kRows - 1) / kRows;
  pcc_diff_hit_kernel<K, kWrite><<<static_cast<unsigned>(blocks), kHitThreads, 0, stream>>>(
      zi, zn, static_cast<int>(n), hi, indptr, indices, row_count, row_start, out_row,
      out_col);
  return cudaGetLastError();
}

template <int K>
int launch_hist(int64_t n, const double* zi, const double* zn, const double* edges,
                int n_bins, double inv_width, const int64_t* indptr, const int* indices,
                unsigned long long* counts, cudaStream_t stream) {
  if (n > INT_MAX - 1024 || n_bins < 1) return cudaErrorInvalidValue;
  const int64_t col_blocks = (n + kHistCols - 1) / kHistCols;
  const int64_t row_tiles = (n + kCountThreads - 1) / kCountThreads;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  const size_t fixed = sizeof(double) * (kTileCols * col_stride<K>() + n_bins + 1);
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
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_tiles));
  pcc_diff_hist_kernel<K><<<grid, kCountThreads, smem, stream>>>(
      zi, zn, static_cast<int>(n), edges, n_bins, inv_width, copies, indptr, indices,
      counts);
  return cudaGetLastError();
}

#define PCC_FOR_EACH_K(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

// z_i, z_n: (n, k) float64, row-major.  counts: 2 unsigned long long,
// zeroed by the caller; gets (#pairs with d < lo, #pairs with d > hi).
// Returns the CUDA error code of the launch (0 = launched);
// cudaErrorInvalidValue for k outside 1..16 or a grid that would not fit.
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

// First pass of the hits: row_count (n int32) gets each row's pairs with
// d > hi that are not in the CSR (indptr: n + 1 int64; indices: int32,
// ascending within each row).
extern "C" int pcc_diff_hit_counts(int k, long long n, const void* z_i, const void* z_n,
                                   double hi, const void* indptr, const void* indices,
                                   void* row_count, void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  auto* rc = static_cast<int*>(row_count);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_hits<K, false>(n, zi, zn, hi, ip, ix, rc, nullptr, nullptr, nullptr, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Second pass: the same pairs, each row's in ascending column order at
// out_row/out_col[row_start[row] ...] (row_start: n int64, the exclusive
// scan of the first pass's counts).
extern "C" int pcc_diff_hit_write(int k, long long n, const void* z_i, const void* z_n,
                                  double hi, const void* indptr, const void* indices,
                                  const void* row_start, void* out_row, void* out_col,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  const auto* rs = static_cast<const int64_t*>(row_start);
  auto* orow = static_cast<int*>(out_row);
  auto* ocol = static_cast<int*>(out_col);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_hits<K, true>(n, zi, zn, hi, ip, ix, nullptr, rs, orow, ocol, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The ΔPCC histogram of the pairs i != j: counts (2 * n_bins unsigned long
// long, zeroed by the caller) gets the linked pairs (in the CSR: indptr n + 1
// int64, indices int32 ascending within each row) by bin, then the others.
// edges: n_bins + 1 float64, strictly ascending and finite; inv_width: a
// guess's scale, n_bins / (edges[n_bins] - edges[0]) (0 if that is not
// finite; the bins come from comparisons with the edges either way).
extern "C" int pcc_diff_hist(int k, long long n, const void* z_i, const void* z_n,
                             const void* edges, int n_bins, double inv_width,
                             const void* indptr, const void* indices, void* counts,
                             void* stream) {
  if (n <= 0) return cudaSuccess;
  const auto* zi = static_cast<const double*>(z_i);
  const auto* zn = static_cast<const double*>(z_n);
  const auto* e = static_cast<const double*>(edges);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int*>(indices);
  auto* c = static_cast<unsigned long long*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define PCC_CASE(K) \
  case K:           \
    return launch_hist<K>(n, zi, zn, e, n_bins, inv_width, ip, ix, c, st);
    PCC_FOR_EACH_K(PCC_CASE)
#undef PCC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
