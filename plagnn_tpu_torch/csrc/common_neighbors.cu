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
// What bounds it on this card: memory traffic.  The compulsory bytes are
// the CSR and the queries read once and the counts written once (2.8 MB of
// indices, 4 MB of queries and counts at the synthetic PPI's 350,000
// pairs; 0.003 ms at 3.35 TB/s).  The work is Σ_q min(deg_i, deg_j)
// lookups of about log2(max deg) probes each into the longer row (20.3 M
// lookups there), dependent loads that L2 serves: the indices fit in the
// 50 MB L2.
//
// Design (simple first).  A work item is a (query, chunk of at most
// row_chunk elements of the query's shorter row); the wrapper builds the
// item table on the device from a cumsum of ceil(min_deg / row_chunk), so
// a hub row's queries spread over many warps.  One warp per item: each
// lane takes every 32nd element of the chunk and binary-searches the
// longer row for it; __reduce_add_sync sums the warp's hits and lane 0
// adds them to the query's count with one integer atomicAdd.  Later work:
// a shared-memory bitmap of a hub row, and grouping the queries by row.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
common_neighbors_kernel(const int64_t* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const int* __restrict__ rows, const int* __restrict__ cols,
                        const int* __restrict__ item_query,
                        const int* __restrict__ item_offset, long long n_items,
                        int row_chunk, int* __restrict__ out) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;  // whole warps leave together
  const int q = item_query[item];
  const int r = rows[q], c = cols[q];
  int64_t a0 = indptr[r], a1 = indptr[r + 1];
  int64_t b0 = indptr[c], b1 = indptr[c + 1];
  if (a1 - a0 > b1 - b0) {  // walk the shorter row, search the longer
    const int64_t t0 = a0, t1 = a1;
    a0 = b0;
    a1 = b1;
    b0 = t0;
    b1 = t1;
  }
  const int64_t start = a0 + item_offset[item];
  const int64_t chunk_end = start + row_chunk;
  const int64_t stop = chunk_end < a1 ? chunk_end : a1;
  int hits = 0;
  for (int64_t e = start + lane; e < stop; e += 32) {
    const int x = indices[e];
    int64_t lo = b0, hi = b1;  // first position in [b0, b1) with value >= x
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (indices[mid] < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    hits += (lo < b1 && indices[lo] == x);
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0 && hits) atomicAdd(out + q, hits);
}

}  // namespace

// out (n_queries int32) must hold zeros; item_query / item_offset (n_items
// int32): each item's query and the offset of its chunk in the query's
// shorter row (a multiple of row_chunk).  Returns the launch's CUDA error.
extern "C" int ecc_common_neighbors_i32(const void* indptr, const void* indices,
                                        const void* rows, const void* cols,
                                        const void* item_query, const void* item_offset,
                                        long long n_items, int row_chunk, void* out,
                                        void* stream) {
  if (n_items <= 0) return cudaSuccess;
  if (row_chunk <= 0) return cudaErrorInvalidValue;
  const long long blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  common_neighbors_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int*>(indices),
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const int*>(item_query), static_cast<const int*>(item_offset), n_items,
      row_chunk, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
