// Fold-batched segment sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel plagnn_tpu/ops/pallas/spmm_kernels.py:
// _spmm_fwd_kernel with reduce="sum" (driven by _run_spmm, reached from
// pallas_spmm_sum's forward and from its VJP over the transpose stream),
// together with its mega-row post-combine _split_combine.
//
// Computes, for a CSR (indptr, idx) and x of shape (M, K) with K = B*F
// (fold batch times features, any K):
//   out[r, k] = sum over e in [indptr[r], indptr[r+1]) of x[idx[e], k]
// with 0 for empty rows.  The same kernels serve both directions of the
// segment sum: the forward over the destination-sorted CSR (indptr, src),
// and the VJP over the transpose CSR (t_indptr, t_dst), where
// dx[s] = sum over edges s -> n of g[n].  Each direction comes with its
// chunk table (row_chunks.cuh), which cuts every row into chunks of at most
// ROW_CHUNK edges.
//
// Types: x/out float32 or bfloat16.  The sum is kept in float32 and
// rounded once at the store, as the TPU kernel's f32 accumulator does.  A
// row of at most ROW_CHUNK edges is summed in ascending edge order; a
// longer row in ascending order within each chunk, its chunks' float32
// partials then added in ascending chunk order by the second kernel.  No
// atomics: the result is bit-identical run to run.
//
// What bounds it on this card: memory.  Without reuse each launch gathers
// E*K*esize bytes (one source row per edge) and writes M*K*esize.  At GCN2's
// layer-1 shape (E ~ 724k, M 24,064, K = 10*400, f32) that is ~11.6 GB,
// ~3.5 ms at 3.35 TB/s from device memory; the compulsory traffic (x read
// once, out written once) is ~15x less.  The design serves the re-reads from
// L2 (chunk-fastest grid, one K-slice's rows resident), so the rate at which
// L2 serves that gather is what bounds it, and it attacks the three things
// that held the one-thread-per-(row, k) design back:
// * the hub tail: the top in-degree is 10,505; its rows now run as chunks
//   of <= ROW_CHUNK edges on many warps at once;
// * narrow K: one warp per (chunk, K-slice), so at K = 120 f32 a warp
//   covers the row (30 lanes of 16 bytes) and a block holds 4 chunks
//   instead of 136 idle threads of 256;
// * loads in flight: 16-byte lane vectors where K and the pointers allow,
//   32 bytes of x a lane per edge, indices loaded 32 at a time and
//   shuffled, and kUnroll (4) source rows' loads issued before they are
//   added.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// out[row] += x[src] for each edge, J vectors of V elements a lane.
template <typename T, int V, int J>
struct SumOp {
  const T* x;
  int64_t k_width;
  int64_t k0;
  int nvec;
  rc::Vec<T, V> val[rc::kUnroll][J];

  __device__ __forceinline__ void begin(int, int64_t k, int n) {
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int src) {
    const T* p = x + static_cast<int64_t>(src) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < nvec) val[u][j] = rc::load_vec<T, V>(p + j * 32 * V);
    }
  }
  __device__ __forceinline__ void add(int u, float (&acc)[V * J]) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j * V + i] += rc::get(val[u][j], i);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(rc::kThreads)
spmm_sum_kernel(const T* __restrict__ x, rc::Table table,
                const int* __restrict__ idx, T* __restrict__ out,
                float* __restrict__ partial, int64_t k_width) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  SumOp<T, V, J> op{x, k_width, 0, 0};
  rc::chunk_pass<T, V, J>(table, idx, k_width, out, partial, op);
}

template <typename T>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_sum_combine_kernel(const int* __restrict__ split_row,
                        const int* __restrict__ split_ptr,
                        const float* __restrict__ partial, T* __restrict__ out,
                        int64_t k_width) {
  rc::combine_pass<T>(split_row, split_ptr, partial, out, k_width);
}

template <typename T, int V>
int launch_v(const void* x, const rc::Table& table, const int* idx,
             const int* split_row, const int* split_ptr, int64_t n_split,
             void* out, void* partial, int64_t k_width, cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(table.n_chunks, n_split, k_width,
                                  32 * V * rc::vectors_per_lane<T, V>(), &grid,
                                  &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_sum_kernel<T, V><<<grid, rc::kThreads, 0, stream>>>(
        static_cast<const T*>(x), table, idx, static_cast<T*>(out),
        static_cast<float*>(partial), k_width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_sum_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(out), k_width);
    return cudaGetLastError();
  }
}

template <typename T>
int launch(const void* x, const rc::Table& table, const int* idx,
           const int* split_row, const int* split_ptr, int64_t n_split,
           void* out, void* partial, int64_t k_width, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const int v = rc::vector_width(k_width, es, {{x, es}, {out, es}, {partial, 4}});
  switch (v) {
    case 8:
      return launch_v<T, 8>(x, table, idx, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    case 4:
      return launch_v<T, 4>(x, table, idx, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    case 2:
      return launch_v<T, 2>(x, table, idx, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    default:
      return launch_v<T, 1>(x, table, idx, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (chunk_row, chunk_ptr, chunk_slot,
// n_chunks, split_row, split_ptr, n_split) is the chunk table of the CSR
// whose column ids are idx: (indptr, src) forward, (t_indptr, t_dst)
// transpose.  partial is float32 scratch of (n_slots, k_width), unused when
// n_split is 0.  Returns the CUDA error code of the launches (0 = launched);
// cudaErrorInvalidValue for a grid that would not fit.
extern "C" int spmm_sum(int dtype, const void* x, const void* chunk_row,
                        const void* chunk_ptr, const void* chunk_slot,
                        long long n_chunks, const void* idx,
                        const void* split_row, const void* split_ptr,
                        long long n_split, void* out, void* partial,
                        long long k_width, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  const auto* ix = static_cast<const int*>(idx);
  const auto* sr = static_cast<const int*>(split_row);
  const auto* sp = static_cast<const int*>(split_ptr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, table, ix, sr, sp, n_split, out, partial, k_width, st);
    case 1:
      return launch<__nv_bfloat16>(x, table, ix, sr, sp, n_split, out, partial,
                                   k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
