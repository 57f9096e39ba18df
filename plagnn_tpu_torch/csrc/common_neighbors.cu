// Common-neighbour counts of query pairs over a sorted CSR, for Hopper
// (sm_90a): the triangle counts of the edge clustering coefficients.
//
// Replaces the JAX package's host loops, which are not Pallas kernels:
// native/plagnn_native.cpp: common_neighbors (a sorted merge of the two
// rows per query, OpenMP over queries) and its scipy fallback
// plagnn_tpu/data/ecc.py:36-38 (the sparse product A·A at the queries).
//
// For each query q = (i, j): out[q] = |N(i) ∩ N(j)|, where N(r) is row r of
// a CSR whose rows hold strictly ascending column ids (indptr int64 n + 1,
// indices int32).  A self-loop counts as the merge counts it: i ∈ N(i) is
// a common neighbour where i ∈ N(j).  The counts are integers, exact in any
// order of addition, so the result is the same run to run.
//
// What bounds it on this card.  The compulsory bytes are the CSR and the
// queries read once and the counts written once (7.2 MB at the synthetic
// PPI's 350,000 pairs: 0.002 ms at 3.35 TB/s).  The work is one membership
// test per element of each query's shorter row, Σ_q min(deg_i, deg_j)
// (20.3 M there, 1.10e9 on a PPI_inter whose hubs are joined to each
// other): one int32 operation each at 33.5e12 a second, 0.033 ms on
// PPI_inter, where operations bound it.
//
// Design.  The wrapper sorts the queries by their longer row L (the ties:
// cols[q]'s) on the device (torch.sort, stable) and cuts each row's
// queries into slices of at most
// slice_queries, with a table of slice ends per row, so the grid's size,
// n + ceil(n_queries / slice_queries), comes from shapes alone and the
// blocks past the last slice leave at once.  A block finds its slice by a
// binary search of the table and builds a bitmap of N(L) in shared memory
// (one bit per column id, 3 KB at 24,064 nodes).  Warp w takes queries w, w + 8, ... of the slice, lane t reading
// query t's id and shorter row's range, all at once; then for each query
// the warp walks its shorter row 32 consecutive elements a step
// (coalesced, four steps' loads in flight at once), one shared-memory bit
// test per element, in place of a dependent binary search through L2.  The hits are summed by
// __reduce_add_sync and added to the query's count by one lane: a query
// lies in one slice, so one warp owns its count and no atomic is needed.
// Where n is larger than a window of window_words * 32 ids (1.86 M at the
// most shared memory a block takes), the block walks L's ids in windows,
// skipping those that hold none of them, and each query's shorter row is
// searched once per window for its first id in it.  A hub row's queries
// spread over many slices, each of which rebuilds the bitmap.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;
constexpr int kUnroll = 4;  // steps of 32 elements a shorter row's walk loads at once

// The first position in [lo, hi) whose id is >= x.
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ a, int64_t lo,
                                               int64_t hi, long long x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// order: the queries sorted stably by their longer row; row_q (n + 1):
// row L's queries are [row_q[L], row_q[L + 1]) of that order; slice_end
// (n): the inclusive scan of each row's ceil(queries / slice_queries)
// slices (slice_queries <= 256).
__global__ void __launch_bounds__(kThreads)
common_neighbors_kernel(const int64_t* __restrict__ indptr,
                        const int* __restrict__ indices, const int* __restrict__ rows,
                        const int* __restrict__ cols, const int64_t* __restrict__ order,
                        const int64_t* __restrict__ row_q,
                        const int64_t* __restrict__ slice_end, int n, int slice_queries,
                        int window_words, int* __restrict__ out) {
  extern __shared__ unsigned bits[];
  const long long b = blockIdx.x;
  // the block's row: the first L with slice_end[L] > b
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (slice_end[mid] > b) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo == n) return;  // past the last slice
  const int row = lo;
  const int64_t l0 = indptr[row], l1 = indptr[row + 1];
  if (l0 == l1) return;  // N(L) is empty: the counts stay 0
  const long long first_slice = row ? slice_end[row - 1] : 0;
  const int64_t q0 = row_q[row] + (b - first_slice) * slice_queries;
  const int64_t q_end = row_q[row + 1];
  const int64_t q1 = q0 + slice_queries < q_end ? q0 + slice_queries : q_end;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's queries are q0 + warp + kWarps t; lane t holds query t's id
  // and its shorter row's range
  const int count = q0 + warp < q1 ? static_cast<int>((q1 - q0 - warp - 1) / kWarps + 1) : 0;
  int64_t q = 0, s0 = 0, s1 = 0;
  if (lane < count) {
    q = order[q0 + warp + static_cast<int64_t>(kWarps) * lane];
    const int a = rows[q];
    const int s = a == row ? cols[q] : a;
    s0 = indptr[s];
    s1 = indptr[s + 1];
  }
  const long long span = 32LL * window_words;
  const int last = indices[l1 - 1];
  int64_t lp = l0;  // L's first element in the window
  long long w0 = indices[l0] & ~31;
  for (bool first = true;; first = false) {
    const long long w1 = w0 + span;
    for (int w = threadIdx.x; w < window_words; w += kThreads) bits[w] = 0u;
    __syncthreads();
    for (int64_t e = lp + threadIdx.x; e < l1; e += kThreads) {
      const long long x = indices[e] - w0;
      if (x >= span) break;
      atomicOr(bits + (x >> 5), 1u << (x & 31));
    }
    __syncthreads();
    for (int t = 0; t < count; ++t) {
      const int64_t b1 = __shfl_sync(kFull, s1, t);
      // in the first window an element below w0 fails the range test;
      // later windows start at the row's first element in the window
      int64_t e0 = __shfl_sync(kFull, s0, t);
      if (!first) e0 = lower_bound(indices, e0, b1, w0);
      int hits = 0;
      for (; e0 < b1; e0 += 32 * kUnroll) {  // kUnroll loads in flight a lane
        long long x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t e = e0 + 32 * u + lane;
          x[u] = (e < b1 ? static_cast<long long>(indices[e]) : LLONG_MAX / 2) - w0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (x[u] >= 0 && x[u] < span) hits += (bits[x[u] >> 5] >> (x[u] & 31)) & 1u;
        }
        // the row's ids ascend: once its last loaded one has left the
        // window, the rest of the row lies past it
        if (!__all_sync(kFull, x[kUnroll - 1] < span)) break;
      }
      hits = __reduce_add_sync(kFull, hits);
      if (lane == t && hits) out[q] += hits;
    }
    if (w1 > last) break;
    lp = lower_bound(indices, lp, l1, w1);
    w0 = indices[lp] & ~31;  // the next window that holds an element of L
    __syncthreads();  // every warp is done with the bitmap
  }
}

}  // namespace

// out (n_queries int32) must hold zeros; order, row_q and slice_end as
// ops/common_neighbors.py: _slices builds them;
// slice_queries: 1 .. 256; window_words: the bitmap's 32-bit words (1 ..
// 58,112), ceil(n / 32) where that fits.  Returns the launch's CUDA error (cudaErrorInvalidValue for
// arguments out of range or a grid that would not fit).
extern "C" int ecc_common_neighbors_i32(const void* indptr, const void* indices,
                                        const void* rows, const void* cols,
                                        const void* order, const void* row_q,
                                        const void* slice_end, long long n,
                                        long long n_queries, int slice_queries,
                                        int window_words, void* out, void* stream) {
  if (n <= 0 || n_queries <= 0) return cudaSuccess;
  if (n > INT_MAX - 1 || slice_queries <= 0 || slice_queries > 32 * kWarps ||
      window_words <= 0 || 4LL * window_words > kSmemMax) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = n + (n_queries + slice_queries - 1) / slice_queries;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int smem = 4 * window_words;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        common_neighbors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  common_neighbors_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int*>(indices),
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(row_q),
      static_cast<const int64_t*>(slice_end), static_cast<int>(n), slice_queries,
      window_words, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
