// Argmax-routed backward of the segment max, for Hopper (sm_90a).
//
// Replaces the TPU kernels plagnn_tpu/ops/pallas/spmm_kernels.py:
// _masked_bwd_kernel (float32 gradients, driven by _run_masked_bwd) and
// _masked_bwd16_kernel (bfloat16 gradients, driven by _run_masked_bwd16),
// both reached from pallas_spmm_max's backward.
//
// Computes, over the transpose CSR (t_indptr, t_dst; edges sorted by
// (src, dst)) with g and arg of shape (N, K):
//   dx[s, k] = sum over edges s -> n of [arg[n, k] == s] * g[n, k]
// accumulated in float32; the bf16 variant upcasts each hit and rounds dx
// to bf16 once at the store.  arg is int16 (padded node count <= 2^15) or
// int32; empty arg rows hold -1 and never hit.  A source row of at most
// ROW_CHUNK out-edges sums its hits in ascending n; a longer row in
// ascending n within each chunk of the transpose chunk table
// (row_chunks.cuh), its chunks' float32 partials then added in ascending
// chunk order by the second kernel.  No atomics: dx is bit-identical run to
// run.
//
// What bounds it on this card: memory.  The compulsory traffic (g and arg
// read once, dx written once) is ~0.36 ms at 3.35 TB/s at the slice's
// layer-1 shape (E ~ 724k, N 24,064, K = 10*503, f32 g, int16 arg).  A
// gather reads arg and g of every out-neighbour, E*K*(esize + argsize)
// bytes (21.9 GB there), and serves the re-reads from L2: the grid runs
// chunks fastest, so one K-slice's rows stay resident.
//
// Design: a gather, not a scatter, over the row-chunked traversal of
// row_chunks.cuh: one warp per (chunk, K-slice), J vectors of V elements a
// lane, 32 bytes of g in all (at K = 5,030 the f32 g rows are only 8-byte
// and the int16 arg rows 4-byte aligned, so V = 2 and J = 4 there; 16-byte
// g vectors where K % 4 == 0), the chunk's destinations loaded 32 at a time
// and shuffled, and kUnroll (4) edges' arg and g vectors loaded together
// before the adds, each add taken only where arg names the row.  g is
// loaded beside arg, not after it: loading g only where arg shows a hit
// reads fewer bytes, but puts a second dependent L2 round trip into every
// batch, and that variant ran slower on the card at K = 5,030, 4,000 and
// 3,000 in f32 and bf16.  Hub rows (out-degree 10,505) run as chunks of
// <= ROW_CHUNK edges on many warps at once instead of one thread's serial
// walk.  Narrow K does not occur on this path (K = 3,000 to 5,030); where it
// would, the warp-per-chunk layout keeps a block's 4 warps on 4 chunks
// rather than idle threads.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// dx[row] += g[n] where arg[n] == row, for each out-edge row -> n; J
// vectors of V elements a lane.
template <typename T, typename ArgT, int V, int J>
struct MaxBwdOp {
  const T* g;
  const ArgT* arg;
  int64_t k_width;
  int64_t k0;
  int nvec;
  int row;
  rc::Vec<ArgT, V> a[rc::kUnroll][J];
  rc::Vec<T, V> gv[rc::kUnroll][J];

  __device__ __forceinline__ void begin(int r, int64_t k, int n) {
    row = r;
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int n) {
    const int64_t off = static_cast<int64_t>(n) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
      a[u][j] = rc::load_vec<ArgT, V>(arg + off + j * 32 * V);
      gv[u][j] = rc::load_vec<T, V>(g + off + j * 32 * V);
    }
  }
  __device__ __forceinline__ void add(int u, float (&acc)[V * J]) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (rc::get(a[u][j], i) == row) acc[j * V + i] += rc::get(gv[u][j], i);
      }
    }
  }
};

template <typename T, typename ArgT, int V>
__global__ void __launch_bounds__(rc::kThreads)
spmm_max_bwd_kernel(const T* __restrict__ g, const ArgT* __restrict__ arg,
                    rc::Table table, const int* __restrict__ t_dst,
                    T* __restrict__ dx, float* __restrict__ partial,
                    int64_t k_width) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  MaxBwdOp<T, ArgT, V, J> op{g, arg, k_width, 0, 0, 0};
  rc::chunk_pass<T, V, J>(table, t_dst, k_width, dx, partial, op);
}

template <typename T>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_max_bwd_combine_kernel(const int* __restrict__ split_row,
                            const int* __restrict__ split_ptr,
                            const float* __restrict__ partial,
                            T* __restrict__ dx, int64_t k_width) {
  rc::combine_pass<T>(split_row, split_ptr, partial, dx, k_width);
}

template <typename T, typename ArgT, int V>
int launch_v(const void* g, const void* arg, const rc::Table& table,
             const int* t_dst, const int* split_row, const int* split_ptr,
             int64_t n_split, void* dx, void* partial, int64_t k_width,
             cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16 || V * sizeof(ArgT) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(table.n_chunks, n_split, k_width,
                                  32 * V * rc::vectors_per_lane<T, V>(), &grid,
                                  &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_max_bwd_kernel<T, ArgT, V><<<grid, rc::kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const ArgT*>(arg), table, t_dst,
        static_cast<T*>(dx), static_cast<float*>(partial), k_width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_max_bwd_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(dx), k_width);
    return cudaGetLastError();
  }
}

template <typename T, typename ArgT>
int launch(const void* g, const void* arg, const rc::Table& table,
           const int* t_dst, const int* split_row, const int* split_ptr,
           int64_t n_split, void* dx, void* partial, int64_t k_width,
           cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int as = sizeof(ArgT);
  const int v = rc::vector_width(k_width, es > as ? es : as,
                                 {{g, es}, {arg, as}, {dx, es}, {partial, 4}});
  switch (v) {
    case 8:
      return launch_v<T, ArgT, 8>(g, arg, table, t_dst, split_row, split_ptr,
                                  n_split, dx, partial, k_width, stream);
    case 4:
      return launch_v<T, ArgT, 4>(g, arg, table, t_dst, split_row, split_ptr,
                                  n_split, dx, partial, k_width, stream);
    case 2:
      return launch_v<T, ArgT, 2>(g, arg, table, t_dst, split_row, split_ptr,
                                  n_split, dx, partial, k_width, stream);
    default:
      return launch_v<T, ArgT, 1>(g, arg, table, t_dst, split_row, split_ptr,
                                  n_split, dx, partial, k_width, stream);
  }
}

template <typename T>
int launch_arg(int arg_bits, const void* g, const void* arg,
               const rc::Table& table, const int* t_dst, const int* split_row,
               const int* split_ptr, int64_t n_split, void* dx, void* partial,
               int64_t k_width, cudaStream_t stream) {
  switch (arg_bits) {
    case 16:
      return launch<T, int16_t>(g, arg, table, t_dst, split_row, split_ptr,
                                n_split, dx, partial, k_width, stream);
    case 32:
      return launch<T, int32_t>(g, arg, table, t_dst, split_row, split_ptr,
                                n_split, dx, partial, k_width, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (spmm_max_bwd_f32), 1 = bfloat16 (spmm_max_bwd_bf16).
// arg_bits: 16 or 32.  (chunk_row, chunk_ptr, chunk_slot, n_chunks,
// split_row, split_ptr, n_split) is the chunk table of the transpose CSR
// (t_indptr, t_dst).  partial is float32 scratch of (n_slots, k_width),
// unused when n_split is 0.  Returns the CUDA error code of the launches;
// cudaErrorInvalidValue for a grid that would not fit.
extern "C" int spmm_max_bwd(int dtype, int arg_bits, const void* g,
                            const void* arg, const void* chunk_row,
                            const void* chunk_ptr, const void* chunk_slot,
                            long long n_chunks, const void* t_dst,
                            const void* split_row, const void* split_ptr,
                            long long n_split, void* dx, void* partial,
                            long long k_width, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  const auto* dp = static_cast<const int*>(t_dst);
  const auto* sr = static_cast<const int*>(split_row);
  const auto* sp = static_cast<const int*>(split_ptr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_arg<float>(arg_bits, g, arg, table, dp, sr, sp, n_split, dx,
                               partial, k_width, st);
    case 1:
      return launch_arg<__nv_bfloat16>(arg_bits, g, arg, table, dp, sr, sp,
                                       n_split, dx, partial, k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
