// Fold-batched segment max with first-maximum argmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel plagnn_tpu/ops/pallas/spmm_kernels.py:
// _spmm_fwd_kernel with reduce="max" (driven by _run_spmm, reached from
// pallas_spmm_max's forward), together with its mega-row post-combine
// _split_combine (jnp.argmax over a split row's ascending sub-rows).
//
// Computes, for a destination-sorted CSR (indptr, src; sources ascending
// inside each row) and x of shape (N, K) with K = B*F (fold batch times
// features, any K):
//   out[i, k] = max over in-edges j -> i of x[j, k]        (0 for empty rows)
//   arg[i, k] = the source of the FIRST maximum in (dst, src) order: the
//               update is on strict '>' over ascending sources    (-1 empty)
// Ties are common (relu gives many zeros), and the backward routes the
// gradient to arg only, so the tie rule is part of the contract.
//
// Types: x/out float32 or bfloat16 (values compare as float; the value kept
// is an input's, so out is exact in either type); arg int16 when the padded
// node count is <= 2^15, else int32, or not written at all (kWithArg =
// false, the primal of the custom VJP, which also drops the source
// tracking).
//
// What bounds it on this card: memory.  The compulsory traffic (x read
// once, out and arg written once) is ~0.36 ms at 3.35 TB/s at the slice's
// layer-1 shape (E ~ 724k, N 24,064, K = 10*503, f32 x, int16 arg).  A
// gather reads one source row per edge, E*K*esize bytes (~14.6 GB there),
// and serves the re-reads from L2: the grid runs chunks fastest, so the
// blocks in flight share one K-slice, whose rows (24,064 x 1 KB) stay in
// the 50 MB L2.
//
// Design: the row-chunked traversal of row_chunks.cuh over the forward
// chunk table (graph_format.RowChunks: every row cut into chunks of at most
// ROW_CHUNK edges).  Two kernels:
// 1. spmm_max_fwd_kernel: one warp per (chunk, K-slice); a lane owns J
//    vectors of V elements (32 bytes of x: V = 2, J = 4 in f32 at K =
//    5,030), the chunk's sources are loaded 32 at a time and shuffled, and
//    kUnroll (4) edges' loads are issued before any compare.  Each element
//    keeps a running maximum (float) and its source; the chunk's first edge
//    is always taken, every later one only where it is strictly greater, in
//    ascending edge order -- so a chunk's (value, source) is its first
//    maximum, a value of -inf included.  A chunk that is its row's only one
//    stores out and arg directly (an empty row's empty chunk stores 0 and
//    -1); a chunk of a split row stores a float32 value and an int32 source
//    in its slot of two (n_slots, K) scratch buffers.
// 2. spmm_max_fwd_combine_kernel: one thread per (split row, k) starts from
//    the row's first slot and takes a later slot only where its value is
//    strictly greater.  Slots run in ascending chunk order, and a lower
//    chunk holds lower sources, so a tie goes to the lower chunk and arg
//    stays the first maximum in (dst, src) order.
// No atomics: every element is written by one thread in a fixed order, so
// out and arg are bit-identical run to run.  The design it replaces, one
// thread per (row, k) walking the whole row with 4-byte loads, walked the
// hub row (in-degree 10,505) serially in each of its blocks.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// Stores V ints at p as ArgT (int16 or int32), in pieces of at most 16
// bytes.
template <typename ArgT, int V>
__device__ __forceinline__ void store_ints(ArgT* p, const int* v) {
  constexpr int kEs = static_cast<int>(sizeof(ArgT));
  constexpr int kPiece = V * kEs > 16 ? 16 / kEs : V;  // elements per store
#pragma unroll
  for (int i0 = 0; i0 < V; i0 += kPiece) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPiece; ++i) {
      const uint32_t b = static_cast<uint32_t>(v[i0 + i]);
      if constexpr (kEs == 4) {
        w[i] = b;
      } else {
        w[i >> 1] |= (i & 1) ? (b << 16) : (b & 0xffffu);
      }
    }
    void* q = p + i0;
    if constexpr (kPiece * kEs == 16) {
      *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kPiece * kEs == 8) {
      *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
    } else if constexpr (kPiece * kEs == 4) {
      *reinterpret_cast<unsigned int*>(q) = w[0];
    } else {
      *reinterpret_cast<unsigned short*>(q) = static_cast<unsigned short>(w[0]);
    }
  }
}

// The running first maximum of x[src] over a chunk's edges, J vectors of V
// elements a lane: walk_chunk's `acc` holds the values, `src` the sources.
template <typename T, int V, int J, bool kWithArg>
struct MaxFwdOp {
  const T* x;
  int64_t k_width;
  int64_t k0;
  int nvec;
  bool first;  // no edge taken yet: the next one is taken whatever its value
  rc::Vec<T, V> val[rc::kUnroll][J];
  int nbr[rc::kUnroll];
  int src[V * J];

  __device__ __forceinline__ void begin(int64_t k, int n) {
    k0 = k;
    nvec = n;
    first = true;
#pragma unroll
    for (int i = 0; i < V * J; ++i) src[i] = -1;
  }
  __device__ __forceinline__ void load(int u, int s) {
    nbr[u] = s;
    const T* p = x + static_cast<int64_t>(s) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < nvec) val[u][j] = rc::load_vec<T, V>(p + j * 32 * V);
    }
  }
  __device__ __forceinline__ void add(int u, float (&best)[V * J]) {
    const bool take_all = first;
    first = false;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = rc::get(val[u][j], i);
        if (take_all || v > best[j * V + i]) {
          best[j * V + i] = v;
          if (kWithArg) src[j * V + i] = nbr[u];
        }
      }
    }
  }
};

// At least kMinBlocks blocks an SM (at most 128 registers a thread) binds
// none of the instantiations (92 at most); without the hint ptxas squeezes
// the bf16 16-byte form without the argmax into 64 registers and spills.
constexpr int kMinBlocks = 4;

template <typename T, typename ArgT, int V, bool kWithArg>
__global__ void __launch_bounds__(rc::kThreads, kMinBlocks)
spmm_max_fwd_kernel(const T* __restrict__ x, rc::Table t,
                    const int* __restrict__ src, T* __restrict__ out,
                    ArgT* __restrict__ arg, float* __restrict__ partial_val,
                    int* __restrict__ partial_src, int64_t k_width) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * rc::kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;  // the whole warp
  const int64_t k0 = (static_cast<int64_t>(blockIdx.y) * 32 * J + lane) * V;
  const int64_t left = k_width > k0 ? (k_width - k0 + 32 * V - 1) / (32 * V) : 0;
  const int nvec = left < J ? static_cast<int>(left) : J;
  const int row = __ldg(t.row + chunk);
  MaxFwdOp<T, V, J, kWithArg> op{x, k_width};
  op.begin(k0, nvec);
  float best[V * J];  // an empty chunk (empty row) keeps 0 and source -1
#pragma unroll
  for (int i = 0; i < V * J; ++i) best[i] = 0.0f;
  rc::walk_chunk(src, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane,
                 nvec > 0, op, best);
  const int slot = __ldg(t.slot + chunk);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j >= nvec) break;
    const int64_t k = k0 + j * 32 * V;
    if (slot < 0) {
      const int64_t o = static_cast<int64_t>(row) * k_width + k;
      rc::store_vec<T, V>(out + o, best + j * V);
      if (kWithArg) store_ints<ArgT, V>(arg + o, op.src + j * V);
    } else {
      const int64_t o = static_cast<int64_t>(slot) * k_width + k;
      rc::store_vec<float, V>(partial_val + o, best + j * V);
      if (kWithArg) store_ints<int32_t, V>(partial_src + o, op.src + j * V);
    }
  }
}

// Split row blockIdx.x, one k per thread: the first maximum over the row's
// slots in ascending chunk order (a later slot only where strictly greater).
template <typename T, typename ArgT, bool kWithArg>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_max_fwd_combine_kernel(const int* __restrict__ split_row,
                            const int* __restrict__ split_ptr,
                            const float* __restrict__ partial_val,
                            const int* __restrict__ partial_src,
                            T* __restrict__ out, ArgT* __restrict__ arg,
                            int64_t k_width) {
  const int i = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * rc::kCombineThreads + threadIdx.x;
  if (k >= k_width) return;
  int s = __ldg(split_ptr + i);
  const int s_end = __ldg(split_ptr + i + 1);
  int64_t o = static_cast<int64_t>(s) * k_width + k;
  float best = __ldg(partial_val + o);
  int best_src = kWithArg ? __ldg(partial_src + o) : 0;
  for (++s; s < s_end; ++s) {
    o = static_cast<int64_t>(s) * k_width + k;
    const float v = __ldg(partial_val + o);
    if (v > best) {
      best = v;
      if (kWithArg) best_src = __ldg(partial_src + o);
    }
  }
  const int64_t r = static_cast<int64_t>(__ldg(split_row + i)) * k_width + k;
  rc::store_vec<T, 1>(out + r, &best);
  if (kWithArg) arg[r] = static_cast<ArgT>(best_src);
}

template <typename T, typename ArgT, int V, bool kWithArg>
int launch_v(const void* x, const rc::Table& table, const int* src,
             const int* split_row, const int* split_ptr, int64_t n_split,
             void* out, void* arg, void* partial_val, void* partial_src,
             int64_t k_width, cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(table.n_chunks, n_split, k_width,
                                  32 * V * rc::vectors_per_lane<T, V>(), &grid,
                                  &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_max_fwd_kernel<T, ArgT, V, kWithArg><<<grid, rc::kThreads, 0, stream>>>(
        static_cast<const T*>(x), table, src, static_cast<T*>(out),
        static_cast<ArgT*>(arg), static_cast<float*>(partial_val),
        static_cast<int*>(partial_src), k_width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_max_fwd_combine_kernel<T, ArgT, kWithArg>
        <<<combine_grid, rc::kCombineThreads, 0, stream>>>(
            split_row, split_ptr, static_cast<const float*>(partial_val),
            static_cast<const int*>(partial_src), static_cast<T*>(out),
            static_cast<ArgT*>(arg), k_width);
    return cudaGetLastError();
  }
}

template <typename T, typename ArgT, bool kWithArg>
int launch(const void* x, const rc::Table& table, const int* src,
           const int* split_row, const int* split_ptr, int64_t n_split,
           void* out, void* arg, void* partial_val, void* partial_src,
           int64_t k_width, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int as = sizeof(ArgT);
  const int v = rc::vector_width(
      k_width, es,
      {{x, es}, {out, es}, {arg, as}, {partial_val, 4}, {partial_src, 4}});
  switch (v) {
    case 8:
      return launch_v<T, ArgT, 8, kWithArg>(x, table, src, split_row, split_ptr,
                                            n_split, out, arg, partial_val,
                                            partial_src, k_width, stream);
    case 4:
      return launch_v<T, ArgT, 4, kWithArg>(x, table, src, split_row, split_ptr,
                                            n_split, out, arg, partial_val,
                                            partial_src, k_width, stream);
    case 2:
      return launch_v<T, ArgT, 2, kWithArg>(x, table, src, split_row, split_ptr,
                                            n_split, out, arg, partial_val,
                                            partial_src, k_width, stream);
    default:
      return launch_v<T, ArgT, 1, kWithArg>(x, table, src, split_row, split_ptr,
                                            n_split, out, arg, partial_val,
                                            partial_src, k_width, stream);
  }
}

template <typename T>
int launch_arg(int arg_bits, const void* x, const rc::Table& table,
               const int* src, const int* split_row, const int* split_ptr,
               int64_t n_split, void* out, void* arg, void* partial_val,
               void* partial_src, int64_t k_width, cudaStream_t stream) {
  switch (arg_bits) {
    case 0:
      return launch<T, int16_t, false>(x, table, src, split_row, split_ptr,
                                       n_split, out, nullptr, partial_val,
                                       nullptr, k_width, stream);
    case 16:
      return launch<T, int16_t, true>(x, table, src, split_row, split_ptr,
                                      n_split, out, arg, partial_val,
                                      partial_src, k_width, stream);
    case 32:
      return launch<T, int32_t, true>(x, table, src, split_row, split_ptr,
                                      n_split, out, arg, partial_val,
                                      partial_src, k_width, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  arg_bits: 0 (no argmax; arg and
// partial_src unused), 16 or 32.  (chunk_row, chunk_ptr, chunk_slot,
// n_chunks, split_row, split_ptr, n_split) is the chunk table of the
// destination-sorted CSR (indptr, src).  partial_val (float32) and
// partial_src (int32) are scratch of (n_slots, k_width), unused when
// n_split is 0.  Returns the CUDA error code of the launches (0 =
// launched); cudaErrorInvalidValue for a grid that would not fit.
extern "C" int spmm_max_fwd(int dtype, int arg_bits, const void* x,
                            const void* chunk_row, const void* chunk_ptr,
                            const void* chunk_slot, long long n_chunks,
                            const void* src, const void* split_row,
                            const void* split_ptr, long long n_split, void* out,
                            void* arg, void* partial_val, void* partial_src,
                            long long k_width, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  const auto* sp = static_cast<const int*>(src);
  const auto* srow = static_cast<const int*>(split_row);
  const auto* sptr = static_cast<const int*>(split_ptr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_arg<float>(arg_bits, x, table, sp, srow, sptr, n_split, out,
                               arg, partial_val, partial_src, k_width, st);
    case 1:
      return launch_arg<__nv_bfloat16>(arg_bits, x, table, sp, srow, sptr,
                                       n_split, out, arg, partial_val,
                                       partial_src, k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
