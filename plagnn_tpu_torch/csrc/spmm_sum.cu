// Fold-batched segment sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel plagnn_tpu/ops/pallas/spmm_kernels.py:
// _spmm_fwd_kernel with reduce="sum" (driven by _run_spmm, reached from
// pallas_spmm_sum's forward and from its VJP over the transpose stream),
// together with its mega-row post-combine _split_combine.
//
// Computes, for a CSR (indptr, idx) and x of shape (M, K) with K = B*F
// (fold batch times features, any K):
//   out[r, k] = sum over e in [indptr[r], indptr[r+1]) of w[e] * x[idx[e], k]
// with 0 for empty rows, where w is 1 (val null) or the CSR's float32 edge
// values: the counterpart of plagnn_tpu/ops/spmm.py: spmm_sum(use_val=True)
// (ell_reduce_sum, an XLA gather-reduce in the JAX package, no Pallas
// kernel).  A weighted edge's term is the gathered element, in float32,
// times its value, rounded once (__fmul_rn, no contraction into the add),
// as the plain version computes it.  Without values the unweighted
// instantiation runs: it reads no value and multiplies nothing.  The scaled
// instantiation (spmm_sum_gcn, the GCN2 path) is GraphConv's norm='both'
// propagation and bias in one pass: each term scaled by its source's
// out-degree^-1/2 as it is gathered, each row by its in-degree^-1/2 and the
// bias added at the store, the same multiplies and adds, rounded in the same
// places, as the separate passes of ops/spmm.py's composition.  The same
// kernels serve both directions of the segment sum: the forward over the
// destination-sorted CSR (indptr, src), and the VJP over the transpose CSR
// (t_indptr, t_dst), where
// dx[s] = sum over edges s -> n of w * g[n] (the transpose's values in its
// own edge order: Graph.t_val).  Each direction comes with its
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
//
// The hub instantiation (spmm_sum_hub: unweighted, either direction) is
// the max kernels' hub design (row_chunks.cuh: hub_pipeline): one block an
// SM walks every K-slice, per-slice chunk tickets in device memory, a
// two-stage arena of the k most-fetched rows filled by TMA or cp.async on
// mbarriers, the carveout sized to the arena.  A lane's slice, walk and
// adds are spmm_sum_kernel's, in the same order, so out is bit-identical to
// the kernel without the hub.  Its blocks hold 4 warps fewer than an SM
// holds of the kernel without the hub (28 in float32, 24 in bfloat16): at
// 32 / 28, 64 / 72 registers a thread, ptxas spilled 20-40 bytes in every
// form; at 28 / 24 it takes 72 (float32) and 77-79 (bfloat16) registers
// and spills nothing.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// out[row] += (w[e] *) x[src] for each edge e, J vectors of V elements a
// lane; kWeighted reads w (one float32 an edge, the same for the warp).
template <typename T, int V, int J, bool kWeighted>
struct SumOp {
  const T* x;
  const float* weight;
  int64_t k_width;
  int64_t k0;
  int nvec;
  rc::Vec<T, V> val[rc::kUnroll][J];
  float w[rc::kUnroll];

  __device__ __forceinline__ void begin(int, int64_t k, int n) {
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int src, int e) {
    if constexpr (kWeighted) w[u] = __ldg(weight + e);
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
      for (int i = 0; i < V; ++i) {
        if constexpr (kWeighted) {
          acc[j * V + i] += __fmul_rn(w[u], rc::get(val[u][j], i));
        } else {
          acc[j * V + i] += rc::get(val[u][j], i);
        }
      }
    }
  }
};

template <typename T, int V, bool kWeighted>
__global__ void __launch_bounds__(rc::kThreads)
spmm_sum_kernel(const T* __restrict__ x, rc::Table table,
                const int* __restrict__ idx, const float* __restrict__ weight,
                T* __restrict__ out, float* __restrict__ partial, int64_t k_width) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  SumOp<T, V, J, kWeighted> op{x, weight, k_width, 0, 0};
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

// v rounded to T and back: where GCN's composition stores an intermediate
// in x's dtype (bfloat16), the scaled sum rounds it there too.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16(v));
  }
}

// The scaled sum's store of one element (kScaled): the row's sum rounded to
// T, times post[row], then plus bias[k] where there is a bias, each step
// rounded once as the composition's separate passes round it.
template <typename T>
__device__ __forceinline__ float scaled_store(float acc, float post,
                                              const float* __restrict__ bias, int64_t k) {
  const float v = __fmul_rn(round_to<T>(acc), post);
  return bias == nullptr ? v : __fadd_rn(round_to<T>(v), __ldg(bias + k));
}

// kScaled, GCN's degree-normalised sum with its bias:
//   out[row, k] = post[row] * sum over edges of (pre[src] * x[src, k]) + bias[k],
// pre and post one float32 a node (the scales in x's dtype), each term
// rounded once to T (__fmul_rn, no contraction into the add) and added in
// SumOp's order; finish applies post and bias at the store.
template <typename T, int V, int J>
struct SumScaledOp {
  const T* x;
  const float* pre;
  const float* post;
  const float* bias;
  int64_t k_width;
  int64_t k0;
  int nvec;
  rc::Vec<T, V> val[rc::kUnroll][J];
  float w[rc::kUnroll];

  __device__ __forceinline__ void begin(int, int64_t k, int n) {
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int src, int) {
    w[u] = __ldg(pre + src);
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
      for (int i = 0; i < V; ++i) {
        acc[j * V + i] += round_to<T>(__fmul_rn(w[u], rc::get(val[u][j], i)));
      }
    }
  }
  __device__ __forceinline__ void finish(int row, int64_t k, float* acc) {
    const float p = __ldg(post + row);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = scaled_store<T>(acc[i], p, bias, k + i);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(rc::kThreads)
spmm_sum_gcn_kernel(const T* __restrict__ x, rc::Table table, const int* __restrict__ idx,
                    const float* __restrict__ pre, const float* __restrict__ post,
                    const float* __restrict__ bias, T* __restrict__ out,
                    float* __restrict__ partial, int64_t k_width) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  SumScaledOp<T, V, J> op{x, pre, post, bias, k_width, 0, 0};
  rc::chunk_pass<T, V, J>(table, idx, k_width, out, partial, op);
}

// A split row of the scaled sum: its partials combined, then post and bias.
template <typename T>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_sum_gcn_combine_kernel(const int* __restrict__ split_row,
                            const int* __restrict__ split_ptr,
                            const float* __restrict__ partial,
                            const float* __restrict__ post, const float* __restrict__ bias,
                            T* __restrict__ out, int64_t k_width) {
  rc::combine_pass<T>(split_row, split_ptr, partial, out, k_width,
                      [=](int row, int64_t k, float* acc) {
                        *acc = scaled_store<T>(*acc, __ldg(post + row), bias, k);
                      });
}

// out[row] += x[src] for each edge, the hub edges' rows from a stage of
// the arena (SumOp's walk and adds, unweighted).
template <typename T, int V, int J>
struct SumHubOp {
  const T* x;
  const T* arena;  // the slice's stage, at this lane's first element
  int pitch;
  const int* ids;
  int64_t k_width;
  int64_t k0;
  int nvec;
  rc::Vec<T, V> val[rc::kUnroll][J];

  __device__ __forceinline__ void begin(int, int64_t k, int n) {
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int nbr, int) {
    rc::load_pipe_row<T, V, J>(val[u], x, arena, ids, nbr, k_width, k0, pitch, nvec);
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

// Warps an SM holds of the hub kernel, in its one block: 4 fewer than the
// kernel without the hub (32 in float32, 28 in bfloat16; chip_smoke.py
// phase 3h prints both), the most at which ptxas spills nothing (the
// header note above).
template <typename T>
constexpr int kHubWarps = sizeof(T) == 4 ? 28 : 24;
template <typename T>
constexpr int kHubThreads = 32 * kHubWarps<T>;

// Bytes of one stage: hub_k rows of x's K-slice.
template <typename T, int V>
__host__ __device__ inline size_t hub_stage_bytes(int64_t k_width, int hub_k) {
  return rc::hub_stage_part<T, V>(hub_k, rc::hub_stride(k_width, 32 * V *
                                                        rc::vectors_per_lane<T, V>()));
}

// The pipelined hub sum (row_chunks.cuh: hub_pipeline), the max forward's
// structure: every K-slice in turn, each slice's hub rows in a stage of the
// arena filled by the fill warp (`walk.tma`: bulk copies, else cp.async), the
// slice's chunks walked by chunk_body as spmm_sum_kernel walks them.
template <typename T, int V>
__global__ void __launch_bounds__(kHubThreads<T>, 1)
spmm_sum_hub_kernel(const T* __restrict__ x, rc::Table table, const int* __restrict__ idx,
                    const int* __restrict__ ids, int hub_k, T* __restrict__ out,
                    float* __restrict__ partial, int* __restrict__ tickets, int64_t k_width,
                    rc::HubWalk walk) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  __shared__ rc::HubPipe pipe;
  const int stride = rc::hub_stride(k_width, 32 * V * J);
  const int pitch = rc::hub_pitch<T, V>(stride);
  const size_t stage_bytes = hub_stage_bytes<T, V>(k_width, hub_k);
  const int lane = threadIdx.x & 31;
  auto stage = [&](int st) {
    return reinterpret_cast<T*>(rc::hub_smem() + st * stage_bytes);
  };
  auto fill = [&](int s, int st) {
    rc::hub_fill_stage<T, V>(stage(st), x, ids, hub_k, pitch, stride, s, k_width, walk.tma != 0,
                             &pipe.full[st], lane);
  };
  SumHubOp<T, V, J> op{x, nullptr, pitch, ids, k_width, 0, 0};
  rc::hub_pipeline(table, pipe, tickets, walk, fill,
                   [&](int s, int st, int c) {
    const int64_t k0 = static_cast<int64_t>(s) * stride + lane * V;
    op.arena = stage(st) + lane * V;
    rc::chunk_body<T, V, J>(table, c, idx, lane, k0, rc::lane_vectors<V, J>(k0, k_width),
                            k_width, out, partial, op);
  });
}

template <typename T, int V>
int launch_v(const void* x, const rc::Table& table, const int* idx, const float* weight,
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
    if (weight != nullptr) {
      spmm_sum_kernel<T, V, true><<<grid, rc::kThreads, 0, stream>>>(
          static_cast<const T*>(x), table, idx, weight, static_cast<T*>(out),
          static_cast<float*>(partial), k_width);
    } else {
      spmm_sum_kernel<T, V, false><<<grid, rc::kThreads, 0, stream>>>(
          static_cast<const T*>(x), table, idx, nullptr, static_cast<T*>(out),
          static_cast<float*>(partial), k_width);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_sum_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(out), k_width);
    return cudaGetLastError();
  }
}

template <typename T>
int launch(const void* x, const rc::Table& table, const int* idx, const float* weight,
           const int* split_row, const int* split_ptr, int64_t n_split,
           void* out, void* partial, int64_t k_width, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const int v = rc::vector_width(k_width, es, {{x, es}, {out, es}, {partial, 4}});
  switch (v) {
    case 8:
      return launch_v<T, 8>(x, table, idx, weight, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    case 4:
      return launch_v<T, 4>(x, table, idx, weight, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    case 2:
      return launch_v<T, 2>(x, table, idx, weight, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
    default:
      return launch_v<T, 1>(x, table, idx, weight, split_row, split_ptr, n_split, out,
                            partial, k_width, stream);
  }
}

template <typename T, int V>
int launch_gcn_v(const void* x, const rc::Table& table, const int* idx, const float* pre,
                 const float* post, const float* bias, const int* split_row,
                 const int* split_ptr, int64_t n_split, void* out, void* partial,
                 int64_t k_width, cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(table.n_chunks, n_split, k_width,
                                  32 * V * rc::vectors_per_lane<T, V>(), &grid,
                                  &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_sum_gcn_kernel<T, V><<<grid, rc::kThreads, 0, stream>>>(
        static_cast<const T*>(x), table, idx, pre, post, bias, static_cast<T*>(out),
        static_cast<float*>(partial), k_width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_sum_gcn_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial), post, bias,
        static_cast<T*>(out), k_width);
    return cudaGetLastError();
  }
}

template <typename T, int V>
int launch_hub_v(const void* x, const rc::Table& table, const int* idx, const int* ids,
                 int hub_k, const int* split_row, const int* split_ptr, int64_t n_split,
                 void* out, void* partial, int* tickets, int64_t n_tickets, int64_t k_width,
                 cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    constexpr int J = rc::vectors_per_lane<T, V>();
    if (rc::hub_shifted<T, V>() && reinterpret_cast<uintptr_t>(x) % 4 != 0) {
      return cudaErrorInvalidValue;  // the shifted rows' words need 4-byte rows
    }
    auto kernel = spmm_sum_hub_kernel<T, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, V>(k_width, hub_k);
    dim3 grid, combine_grid;
    rc::HubWalk walk{};
    const int rc_setup =
        rc::hub_pipe_setup(kernel, smem, kHubWarps<T>, table.n_chunks, n_split, k_width,
                           32 * V * J, n_tickets, &grid, &combine_grid, &walk);
    if (rc_setup != cudaSuccess) return rc_setup;
    walk.tma = rc::hub_route<T, V>(k_width, x) ? 1 : 0;
    kernel<<<grid, kHubThreads<T>, smem, stream>>>(
        static_cast<const T*>(x), table, idx, ids, hub_k, static_cast<T*>(out),
        static_cast<float*>(partial), tickets, k_width, walk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_sum_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(out), k_width);
    return cudaGetLastError();
  }
}

// info[0], info[1]: the warps an SM holds of the hub kernel and of the
// kernel without the hub; info[2] the arena's stages, info[3] the hub
// blocks an SM holds, info[4] 1 where the fill takes the TMA route at this
// K (rows 16-byte multiples), 0 for cp.async: the route K gives 16-byte
// aligned tensors (a launch also checks its own).
template <typename T, int V>
int hub_warps_v(int64_t k_width, int hub_k, int* info) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;
  } else {
    auto kernel = spmm_sum_hub_kernel<T, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, V>(k_width, hub_k);
    const int blocks = rc::pipe_blocks_per_sm(kernel, kHubThreads<T>, smem);
    info[0] = blocks < 0 ? -1 : blocks * kHubThreads<T> / 32;
    info[1] = rc::warps_per_sm(spmm_sum_kernel<T, V, false>, rc::kThreads);
    info[2] = rc::kHubStages;
    info[3] = blocks;
    info[4] = rc::hub_route<T, V>(k_width, nullptr) ? 1 : 0;
    return cudaSuccess;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (chunk_row, chunk_ptr, chunk_slot,
// n_chunks, split_row, split_ptr, n_split) is the chunk table of the CSR
// whose column ids are idx: (indptr, src) forward, (t_indptr, t_dst)
// transpose.  val: null (every weight 1) or the CSR's float32 edge values,
// one per entry of idx (Graph.val forward, Graph.t_val transpose).  partial is float32 scratch of (n_slots, k_width), unused when
// n_split is 0.  Returns the CUDA error code of the launches (0 = launched);
// cudaErrorInvalidValue for a grid that would not fit.
extern "C" int spmm_sum(int dtype, const void* x, const void* chunk_row,
                        const void* chunk_ptr, const void* chunk_slot,
                        long long n_chunks, const void* idx, const void* val,
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
  const auto* w = static_cast<const float*>(val);
  const auto* sr = static_cast<const int*>(split_row);
  const auto* sp = static_cast<const int*>(split_ptr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, table, ix, w, sr, sp, n_split, out, partial, k_width, st);
    case 1:
      return launch<__nv_bfloat16>(x, table, ix, w, sr, sp, n_split, out, partial,
                                   k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The scaled instantiation (kScaled, GCN's norm='both' with its bias): the
// chunk table, idx and split rows as spmm_sum's; pre and post float32, one a
// node (forward: out-degree^-1/2 of the sources, in-degree^-1/2 of the rows;
// transpose: the two swapped); bias null or K float32 values, added to every
// row at its column k.  Returns the CUDA error code of the launches.
extern "C" int spmm_sum_gcn(int dtype, const void* x, const void* chunk_row,
                            const void* chunk_ptr, const void* chunk_slot,
                            long long n_chunks, const void* idx, const void* pre,
                            const void* post, const void* bias, const void* split_row,
                            const void* split_ptr, long long n_split, void* out,
                            void* partial, long long k_width, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    constexpr int es = sizeof(T);
    const int v = rc::vector_width(k_width, es, {{x, es}, {out, es}, {partial, 4}});
    return rc::with_vector_width(v, [&](auto vw) {
      return launch_gcn_v<T, decltype(vw)::value>(
          x, table, static_cast<const int*>(idx), static_cast<const float*>(pre),
          static_cast<const float*>(post), static_cast<const float*>(bias),
          static_cast<const int*>(split_row), static_cast<const int*>(split_ptr), n_split,
          out, partial, k_width, static_cast<cudaStream_t>(stream));
    });
  });
}

// The hub instantiation of spmm_sum (unweighted): the chunk table and
// split rows as spmm_sum's, idx the direction's coded neighbour index and
// ids its k slots' node ids (graph_format.HubTable); tickets: n_tickets
// int32 zeros, at least one a K-slice, left zero (one buffer serves a
// stream's launches, the max kernels' hub launches included).  Returns the
// CUDA error code of the launches.
extern "C" int spmm_sum_hub(int dtype, const void* x, const void* chunk_row,
                            const void* chunk_ptr, const void* chunk_slot,
                            long long n_chunks, const void* idx, const void* ids, int hub_k,
                            const void* split_row, const void* split_ptr, long long n_split,
                            void* out, void* partial, void* tickets, long long n_tickets,
                            long long k_width, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL || hub_k < 0) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    constexpr int es = sizeof(T);
    const int v = rc::vector_width(k_width, es, {{x, es}, {out, es}, {partial, 4}});
    return rc::with_vector_width(v, [&](auto vw) {
      return launch_hub_v<T, decltype(vw)::value>(
          x, table, static_cast<const int*>(idx), static_cast<const int*>(ids), hub_k,
          static_cast<const int*>(split_row), static_cast<const int*>(split_ptr), n_split,
          out, partial, static_cast<int*>(tickets), n_tickets, k_width,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// The warps an SM holds of spmm_sum_hub's kernel (info[0]) and of the
// kernel without the hub (info[1]) at this dtype, K and k, as the card's
// occupancy calculator gives them, then the arena's stages, the hub blocks
// an SM holds and the fill route at this K (1 TMA, 0 cp.async; info holds
// 5 ints); launches nothing.
extern "C" int spmm_sum_hub_warps(int dtype, long long k_width, int hub_k, int* info) {
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return rc::with_vector_width(rc::vector_width(k_width, sizeof(T), {}), [&](auto vw) {
      return hub_warps_v<T, decltype(vw)::value>(k_width, hub_k, info);
    });
  });
}
