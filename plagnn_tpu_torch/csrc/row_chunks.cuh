// Row-chunked CSR traversal for Hopper (sm_90a), shared by spmm_sum.cu,
// spmm_max_bwd.cu and spmm_max_fwd.cu.  The first two use chunk_pass and
// combine_pass below; the max forward walks chunks with walk_chunk too, but
// keeps a running first maximum and its source, so it has its own chunk
// pass and combine (spmm_max_fwd.cu).
//
// The graph cuts every CSR row into chunks of at most ROW_CHUNK edges
// (plagnn_tpu_torch/ops/graph_format.py: RowChunks), the Hopper counterpart
// of the JAX mega-row split (build_pallas_graph's `rank // cap`, and
// _split_combine in plagnn_tpu/ops/pallas/spmm_kernels.py).  Two kernels
// per operation:
//
// 1. chunk_pass: one warp per (chunk, K-slice).  A lane owns J vectors of V
//    consecutive k (V*esize = 16, 8, 4 or 2 bytes, or one element), 32*V
//    apart so that each of the warp's loads is one coalesced run, and J*V
//    = 32 bytes of the gathered operand in all (vectors_per_lane).  It
//    walks the chunk's edges -- never more than ROW_CHUNK of them -- in
//    ascending edge order, adding into float32 accumulators.  The chunk's
//    neighbour ids are loaded 32 at a time, coalesced, and handed out with
//    __shfl_sync; kUnroll edges' loads (kUnroll * J vectors a lane) are
//    issued before any of them is added.  A chunk that is its row's only
//    one rounds once and stores the row; a chunk of a split row stores its
//    float32 partial in its slot of the scratch buffer.
// 2. combine_pass: one thread per (split row, k) adds the row's partials in
//    ascending chunk order, rounds once and stores the row.
//
// No atomics: every output element is written by one thread, and every sum
// is taken in a fixed order, so the result is bit-identical run to run.
//
// The grid puts chunks on x (fastest) and K-slices on y, so the blocks that
// run together share one K-slice and its working set (N_pad x slice bytes:
// 25 MB at 24,064 rows x 1 KB) stays in the 50 MB L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

namespace row_chunks {

constexpr int kWarps = 4;              // warps (chunks) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;             // edges in flight before their adds
constexpr int kCombineThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// One direction's chunk table (graph_format.RowChunks), device pointers.
struct Table {
  const int* row;   // (C,)   row of each chunk
  const int* ptr;   // (C+1,) edge range of each chunk
  const int* slot;  // (C,)   -1 for a whole row, else its partial slot
  int n_chunks;
};

// V consecutive elements of T as the 32-bit words one load brings (a
// 2-byte vector sits in the low half of one word).  Elements are taken out
// of the words with shifts and masks, never through memory, so vectors of
// 16-bit types stay in registers.
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  Vec<T, V> out;
  if constexpr (Vec<T, V>::kBytes == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    out.w[0] = r.x;
    out.w[1] = r.y;
    out.w[2] = r.z;
    out.w[3] = r.w;
  } else if constexpr (Vec<T, V>::kBytes == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    out.w[0] = r.x;
    out.w[1] = r.y;
  } else if constexpr (Vec<T, V>::kBytes == 4) {
    out.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(Vec<T, V>::kBytes == 2, "vectors are 2, 4, 8 or 16 bytes");
    out.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return out;
}

// Element i of a vector, as float (float, bf16) or int (int16, int32).
__device__ __forceinline__ float elem(const uint32_t* w, int i, float) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float elem(const uint32_t* w, int i, __nv_bfloat16) {
  const uint32_t h = w[i >> 1];  // bf16 is the high half of a float32
  return __uint_as_float((i & 1) ? (h & 0xffff0000u) : (h << 16));
}
__device__ __forceinline__ int elem(const uint32_t* w, int i, int16_t) {
  const int h = static_cast<int>(w[i >> 1]);
  return (i & 1) ? (h >> 16) : static_cast<int>(static_cast<int16_t>(h & 0xffff));
}
__device__ __forceinline__ int elem(const uint32_t* w, int i, int32_t) {
  return static_cast<int>(w[i]);
}

template <typename T, int V>
__device__ __forceinline__ auto get(const Vec<T, V>& v, int i) {
  return elem(v.w, i, T{});
}

__device__ __forceinline__ uint32_t bits_of(float v, float) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(float v, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// Rounds acc[0..V) to T once and stores the V elements at p, in pieces of
// at most 16 bytes (a float32 partial of 8 elements is two).
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* acc) {
  constexpr int kEs = static_cast<int>(sizeof(T));
  constexpr int kPiece = V * kEs > 16 ? 16 / kEs : V;  // elements per store
#pragma unroll
  for (int i0 = 0; i0 < V; i0 += kPiece) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPiece; ++i) {
      const uint32_t b = bits_of(acc[i0 + i], T{});
      if constexpr (kEs == 4) {
        w[i] = b;
      } else {
        w[i >> 1] |= (i & 1) ? (b << 16) : b;
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

// J, the vectors of V elements of T a lane owns: 32 bytes of T in all
// (fewer per-edge instructions and more bytes in flight than one vector),
// at most 8 vectors.
template <typename T, int V>
__host__ __device__ constexpr int vectors_per_lane() {
  constexpr int j = 32 / (V * static_cast<int>(sizeof(T)));
  return j < 1 ? 1 : (j > 8 ? 8 : j);
}

// Walks edges [beg, end) of one chunk for this lane's elements.  `Op`
// holds a kernel's per-edge work, in two steps run for kUnroll edges at a
// time, each step for all kUnroll before the next:
//   op.load(u, nbr)  issue the loads of edge u, whose other end is nbr;
//   op.add(u, acc)   add edge u into acc -- in ascending edge order.
// Every lane of the warp runs the loop (the shuffles need all 32); lanes
// without k (`active` false) issue no load and add nothing.
template <int N, typename Op>
__device__ __forceinline__ void walk_chunk(const int* __restrict__ idx, int beg,
                                           int end, int lane, bool active,
                                           Op& op, float (&acc)[N]) {
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    const int mine = lane < n ? __ldg(idx + base + lane) : 0;
    for (int j = 0; j < n; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int nbr = __shfl_sync(kFullMask, mine, j + u);
        if (active && j + u < n) op.load(u, nbr);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && j + u < n) op.add(u, acc);
      }
    }
  }
}

// Kernel 1's body: this warp's (chunk, K-slice), a K-slice being 32*V*J
// elements.  Lane l's vector j starts at k0 + j*32*V; the first `nvec` of
// them lie inside K (K % V == 0, so a vector is wholly in or out).
// `op.begin(row, k0, nvec)` tells the op its row and its elements.
template <typename OutT, int V, int J, typename Op>
__device__ __forceinline__ void chunk_pass(const Table& t, const int* __restrict__ idx,
                                           int64_t k_width, OutT* __restrict__ out,
                                           float* __restrict__ partial, Op& op) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;  // the whole warp
  const int64_t k0 = (static_cast<int64_t>(blockIdx.y) * 32 * J + lane) * V;
  const int64_t left = k_width > k0 ? (k_width - k0 + 32 * V - 1) / (32 * V) : 0;
  const int nvec = left < J ? static_cast<int>(left) : J;
  const int row = __ldg(t.row + chunk);
  op.begin(row, k0, nvec);
  float acc[V * J];
#pragma unroll
  for (int i = 0; i < V * J; ++i) acc[i] = 0.0f;
  walk_chunk(idx, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane,
             nvec > 0, op, acc);
  const int slot = __ldg(t.slot + chunk);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j >= nvec) break;
    const int64_t k = k0 + j * 32 * V;
    if (slot < 0) {
      store_vec<OutT, V>(out + static_cast<int64_t>(row) * k_width + k, acc + j * V);
    } else {
      store_vec<float, V>(partial + static_cast<int64_t>(slot) * k_width + k, acc + j * V);
    }
  }
}

// Kernel 2's body: split row blockIdx.x, one k per thread; the row's
// partials added in ascending chunk order (the order of its slots), then
// rounded once.
template <typename OutT>
__device__ __forceinline__ void combine_pass(const int* __restrict__ split_row,
                                             const int* __restrict__ split_ptr,
                                             const float* __restrict__ partial,
                                             OutT* __restrict__ out,
                                             int64_t k_width) {
  const int i = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * kCombineThreads + threadIdx.x;
  if (k >= k_width) return;
  const int s_end = __ldg(split_ptr + i + 1);
  float acc = 0.0f;
  for (int s = __ldg(split_ptr + i); s < s_end; ++s) {
    acc += __ldg(partial + static_cast<int64_t>(s) * k_width + k);
  }
  store_vec<OutT, 1>(out + static_cast<int64_t>(__ldg(split_row + i)) * k_width + k, &acc);
}

// Host side.  The widest lane vector, in elements, that divides K, keeps
// the loaded operands' vectors within 16 bytes (`max_esize`: the largest
// element size among them), and that every pointer's alignment allows: a
// pointer of element size e is accessed in pieces of min(v*e, 16) bytes.
inline int vector_width(int64_t k_width, int max_esize,
                        std::initializer_list<std::pair<const void*, int>> ptrs) {
  for (int v = 8; v > 1; v /= 2) {
    if (k_width % v != 0 || v * max_esize > 16) continue;
    bool ok = true;
    for (const auto& pe : ptrs) {
      const int piece = v * pe.second < 16 ? v * pe.second : 16;
      ok = ok && reinterpret_cast<uintptr_t>(pe.first) % piece == 0;
    }
    if (ok) return v;
  }
  return 1;
}

// Grids of the two kernels; cudaErrorInvalidValue where a dimension would
// not fit (the launch is refused, never cut).
inline int grids(int64_t n_chunks, int64_t n_split, int64_t k_width,
                 int slice_width, dim3* chunk_grid, dim3* combine_grid) {
  const int64_t blocks = (n_chunks + kWarps - 1) / kWarps;  // n_chunks < 2^31
  const int64_t slices = (k_width + slice_width - 1) / slice_width;
  const int64_t tiles = (k_width + kCombineThreads - 1) / kCombineThreads;
  if (slices > 65535 || tiles > 65535 || n_split > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  *chunk_grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  *combine_grid = dim3(static_cast<unsigned>(n_split), static_cast<unsigned>(tiles));
  return cudaSuccess;
}

}  // namespace row_chunks
