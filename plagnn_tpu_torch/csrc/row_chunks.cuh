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
//    ascending chunk order, rounds once and stores the row.  An op that
//    rewrites a row's sums before the store (HasFinish: the GCN sum's scale
//    and bias) does so for a whole row in chunk_body, for a split row after
//    its combine.
//
// No atomics: every output element is written by one thread, and every sum
// is taken in a fixed order, so the result is bit-identical run to run.
//
// The grid puts chunks on x (fastest) and K-slices on y, so the blocks that
// run together share one K-slice and its working set (N_pad x slice bytes).
// That working set fits the 50 MB L2 only while N_pad is small: 25 MB at
// 24,064 rows x 1 KB, but 338 MB at 330,112 rows, where almost every
// gathered row comes from HBM.  So the two max kernels also take narrower
// K-slices (the grouped walk below): a group of G lanes (G = 16, 8, 4, 2 or
// 1) owns one (chunk, K-slice), a warp 32 / G of them, and the slice is G
// lanes' 32 bytes.  A narrower slice cuts the L2 misses but issues more
// requests a byte, so which width wins is measured, not derived: the
// wrapper keeps 1 KB up to a working set the card's sweeps set (1 KB won at
// 2.1 L2s, on the mesh path's shards) and past it takes the width measured
// fastest on the 165 k- and 330 k-row graphs (ops/spmm_kernels.py:
// slice_bytes).  The sum kernel and the hub instantiations keep the 1 KB
// slice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>
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
//   op.load(u, nbr, e)  issue the loads of edge u, whose other end is nbr
//                       and whose index in the CSR is e;
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
        if (active && j + u < n) op.load(u, nbr, base + j + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && j + u < n) op.add(u, acc);
      }
    }
  }
}

// The grouped walk of edges [beg, end) of one chunk by a group of 1 << lg
// lanes (the narrow K-slices' walk; `mask` names the group's lanes, `s` is
// this lane's place in it): walk_chunk with the group's width for the
// warp's.  The group loads 1 << lg neighbour ids at a time, lane s the s-th,
// the next window's before this one's edges, with a streaming load (the
// index is read once per K-slice, so it should not push the slice's rows
// out of L2), and hands them out with __shfl_sync over the group's lanes.
// An op whose edges carry a second index (op.aux_index(), the positional
// backward's t_rank; null for none) has it loaded and handed out beside the
// ids: op.load(u, nbr, e, aux).  The groups of a warp walk chunks of any
// lengths: every shuffle names only its group's lanes, which walk the same
// chunk; lanes without k (`active` false) still take part in them.  (A
// lane loading every id itself, one L2 request a lane an edge, ran the
// kernels up to 2x slower on the card.)
template <int N, typename Op>
__device__ __forceinline__ void walk_group(const int* __restrict__ idx, int beg, int end,
                                           int s, int lg, unsigned mask, bool active,
                                           Op& op, float (&acc)[N]) {
  const int g = 1 << lg;
  const int* __restrict__ aux = op.aux_index();
  int mine = beg + s < end ? __ldcs(idx + beg + s) : 0;
  int mine_aux = aux != nullptr && beg + s < end ? __ldcs(aux + beg + s) : 0;
  for (int base = beg; base < end; base += g) {
    const int n = min(g, end - base);
    const int f = base + g + s;
    const int next = f < end ? __ldcs(idx + f) : 0;
    const int next_aux = aux != nullptr && f < end ? __ldcs(aux + f) : 0;
    for (int j = 0; j < n; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int nbr = __shfl_sync(mask, mine, j + u, g);
        const int ax = aux != nullptr ? __shfl_sync(mask, mine_aux, j + u, g) : 0;
        if (active && j + u < n) op.load(u, nbr, base + j + u, ax);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && j + u < n) op.add(u, acc);
      }
    }
    mine = next;
    mine_aux = next_aux;
  }
}

// A grouped lane's place: its group's chunk (the table's chunks taken in
// the launch order `order`, -1 past the last), its lane within the group,
// its first element k0 and the first `nvec` of its J vectors inside K.  A
// group is 1 << lg lanes; its K-slice is (1 << lg) * V * J elements, lane s
// holding vectors k0 + j * (1 << lg) * V with k0 = slice0 + s * V, so each
// load of the group is one run of whole 32-byte sectors.  Groups run
// fastest within a warp, then warps within the block, then blocks on x.
struct GroupLane {
  int64_t chunk;
  int lane;
  unsigned mask;  // the group's lanes of the warp
  int64_t k0;
  int nvec;
};

template <int V, int J>
__device__ __forceinline__ GroupLane group_lane(const Table& t, const int* __restrict__ order,
                                                int lg, int64_t k_width) {
  const int lane = threadIdx.x & 31;
  const int g = 1 << lg;
  const int64_t gi =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * (32 >> lg) +
      (lane >> lg);
  GroupLane h;
  h.lane = lane & (g - 1);
  h.mask = lg == 5 ? kFullMask : ((1u << g) - 1) << (lane & ~(g - 1));
  h.chunk = gi < t.n_chunks ? __ldg(order + gi) : -1;
  h.k0 = (static_cast<int64_t>(blockIdx.y) * g * J + h.lane) * V;
  const int64_t step = static_cast<int64_t>(g) * V;
  const int64_t left = k_width > h.k0 ? (k_width - h.k0 + step - 1) / step : 0;
  h.nvec = left < J ? static_cast<int>(left) : J;
  return h;
}

// The lanes of a group for a K-slice of `slice_bytes` bytes of T at vector
// width V, as a log2: G = slice_bytes / a lane's bytes (J*V*sizeof(T),
// vectors_per_lane), 1 to 32; -1 for a width that is not a power of two
// from 32 to 1,024.
template <typename T, int V>
inline int group_log2(int slice_bytes) {
  if (slice_bytes < 32 || slice_bytes > 1024 || (slice_bytes & (slice_bytes - 1)) != 0) {
    return -1;
  }
  const int lane_bytes = vectors_per_lane<T, V>() * V * static_cast<int>(sizeof(T));
  int lg = 0;
  while (lg < 5 && (lane_bytes << (lg + 1)) <= slice_bytes) ++lg;
  return lg;
}

// An op that rewrites a whole row's sums before they are stored (the GCN
// sum's scale and bias) has op.finish(row, k, acc), acc the V sums of
// elements [k, k + V); a split row's partials are stored as they are, and
// its combine finishes the row.
template <typename Op, typename = void>
struct HasFinish : std::false_type {};
template <typename Op>
struct HasFinish<Op, std::void_t<decltype(&Op::finish)>> : std::true_type {};

// One chunk's walk (chunk_pass's), for a lane whose first element is k0 and
// whose first `nvec` vectors lie inside K, `vstride` elements apart (also
// the hub kernels' walk of a chunk their block's ticket handed out, and with
// kGrouped the grouped walk of the max backward's narrow K-slices by the
// group of 1 << lg lanes `mask`, `lane` the lane's place in it).
template <typename OutT, int V, int J, typename Op, bool kGrouped = false>
__device__ __forceinline__ void chunk_body(const Table& t, int64_t chunk,
                                           const int* __restrict__ idx, int lane,
                                           int64_t k0, int nvec, int64_t k_width,
                                           OutT* __restrict__ out,
                                           float* __restrict__ partial, Op& op,
                                           int vstride = 32 * V, int lg = 5,
                                           unsigned mask = kFullMask) {
  const int row = __ldg(t.row + chunk);
  op.begin(row, k0, nvec);
  float acc[V * J];
#pragma unroll
  for (int i = 0; i < V * J; ++i) acc[i] = 0.0f;
  if constexpr (kGrouped) {
    walk_group(idx, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane, lg, mask,
               nvec > 0, op, acc);
  } else {
    walk_chunk(idx, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane,
               nvec > 0, op, acc);
  }
  const int slot = __ldg(t.slot + chunk);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j >= nvec) break;
    const int64_t k = k0 + j * vstride;
    if (slot < 0) {
      if constexpr (HasFinish<Op>::value) op.finish(row, k, acc + j * V);
      store_vec<OutT, V>(out + static_cast<int64_t>(row) * k_width + k, acc + j * V);
    } else {
      store_vec<float, V>(partial + static_cast<int64_t>(slot) * k_width + k, acc + j * V);
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
  chunk_body<OutT, V, J>(t, chunk, idx, lane, k0, nvec, k_width, out, partial, op);
}

struct NoFinish {
  __device__ __forceinline__ void operator()(int, int64_t, float*) const {}
};

// Kernel 2's body: split row blockIdx.x, one k per thread; the row's
// partials added in ascending chunk order (the order of its slots), then
// finished (`finish(row, k, &acc)`, an op's finish for one element) and
// rounded once.
template <typename OutT, typename Finish = NoFinish>
__device__ __forceinline__ void combine_pass(const int* __restrict__ split_row,
                                             const int* __restrict__ split_ptr,
                                             const float* __restrict__ partial,
                                             OutT* __restrict__ out,
                                             int64_t k_width, Finish finish = {}) {
  const int i = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * kCombineThreads + threadIdx.x;
  if (k >= k_width) return;
  const int s_end = __ldg(split_ptr + i + 1);
  float acc = 0.0f;
  for (int s = __ldg(split_ptr + i); s < s_end; ++s) {
    acc += __ldg(partial + static_cast<int64_t>(s) * k_width + k);
  }
  const int row = __ldg(split_row + i);
  finish(row, k, &acc);
  store_vec<OutT, 1>(out + static_cast<int64_t>(row) * k_width + k, &acc);
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

// Grids of the two kernels (`per_warp` chunks a warp: 32 / G for the
// grouped walk); cudaErrorInvalidValue where a dimension would not fit (the
// launch is refused, never cut).
inline int grids(int64_t n_chunks, int64_t n_split, int64_t k_width,
                 int slice_width, dim3* chunk_grid, dim3* combine_grid,
                 int per_warp = 1) {
  const int64_t per_block = static_cast<int64_t>(kWarps) * per_warp;
  const int64_t blocks = (n_chunks + per_block - 1) / per_block;  // n_chunks < 2^31
  const int64_t slices = (k_width + slice_width - 1) / slice_width;
  const int64_t tiles = (k_width + kCombineThreads - 1) / kCombineThreads;
  if (slices > 65535 || tiles > 65535 || n_split > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  *chunk_grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  *combine_grid = dim3(static_cast<unsigned>(n_split), static_cast<unsigned>(tiles));
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The hub cache: the hub instantiations of the three kernels
// (spmm_max_fwd.cu, spmm_max_bwd.cu, spmm_sum.cu), all of one design.
//
// Replaces the TPU kernels' hub path (plagnn_tpu/ops/pallas/spmm_kernels.py:
// HubStream, the `with_hub` branches of _spmm_fwd_kernel, _masked_bwd_kernel
// and _masked_bwd16_kernel, the VMEM arenas of _run_spmm, _run_masked_bwd and
// _run_masked_bwd16).  There, the edges whose source is one of the k
// most-fetched rows form a second stream, served from a VMEM arena and
// merged into the forward's result by a (value, then smaller id) tie rule.
// Here they stay where they are in the one (dst, src)-ordered edge stream:
// graph_format.HubTable codes a hub edge's neighbour index as -1 - slot,
// and the warp reads that edge's row from its block's shared-memory arena
// instead of device memory (load_pipe_row).  One edge at a time is the same
// for the whole warp, so the branch does not diverge, and a lane's slice,
// walk, compares and adds are the kernels' own, in the same order: the
// forward is bit-exact and the sums bit-identical to the kernels without
// the hub.  Split rows go through the chunk slots and combine kernels
// without the hub, as they are.
//
// What bounds it: the kernels without the hub serve their gather (E*K*esize
// bytes, ~15x the compulsory traffic) from L2.  The arena takes the hub
// edges' share of it (12-20% of the edges at k = 32-113 on the PPI-scale
// graph) off L2, for k rows of each K-slice read once a block.  What bounded
// an earlier design, by the card's records (PERF.md), was not the arena but
// the structure: a block a K-slice filled its arena with register-staged
// loads, met every warp at __syncthreads, walked ~190 chunks with its warps
// and had to drain before the next slice's block could take the SM, 132 x 20
// blocks a layer-1 launch, so every fill and every tail (one 256-edge chunk
// gathers 256 KB, as long as a block's whole share spread over its warps)
// sat on the critical path.
//
// What this design does about it:
// * Persistent over the K-slices.  The grid is one block an SM, with no
//   slice dimension.  Each block walks K-slices 0..S-1 in order; each slice
//   has a ticket of its own in device memory, which hands the slice's
//   chunks, in the table's order, to the warps of every block one claim at
//   a time (one chunk, or a few where the chunks are many and short:
//   hub_claim), so the grid walks one slice at a time as the grid of the
//   kernels without the hub does (one slice's rows in L2).  A warp that
//   finds the slice's chunks gone goes straight on to slice s + 1.  No
//   __syncthreads separates two slices: only the last drains.  (Per-block
//   tickets let the blocks drift apart over the slices, and the L2 then has
//   to hold several slices' rows: on the card that ran far slower.)
// * A two-stage arena.  Stage s % 2 holds slice s's hub rows (in the max
//   backward the gradient's and the argmax's).  Each stage has two
//   mbarriers: "full" completes when the stage's fill has landed, "empty"
//   when every warp of the block has arrived on it after slice s, a warp
//   that drew no chunk of that slice included.  The fill of slice s + 2
//   into the stage starts once "empty" has completed; the fill warp (warp
//   0, which walks chunks too) tests it between its chunks of slice s + 1
//   and issues the fill as soon as it has, so the fill overlaps the walk
//   and no warp waits on a fill but the first two.
// * Asynchronous fills, never register-staged.  Where every filled row's
//   byte stride and the slice's start are multiples of 16 (the TMA route),
//   the fill warp's lanes issue one
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes per
//   hub row of the slice's bytes (the ragged last slice copies the elements
//   left), and lane 0 raises the barrier's expected bytes.  Elsewhere (the
//   cp.async route; layer 1's K = 5,030: f32 rows of 20,120 B, 8 mod 16) the
//   lanes issue cp.async of the lane vector's size (4, 8 or 16 bytes; a
//   2-byte vector as the 4-byte words that cover the row, the row kept at
//   the source's parity, hub_shift) and each arrives on the same "full"
//   barrier by cp.async.mbarrier.arrive.noinc.  The route follows K's
//   alignment (hub_route); both are on the main path.
// * Each stage takes half of the budget, so k halves (ops/hub.py:
//   pick_hub_sizes): 1 KB rows (the max forward, the sum both ways), k <=
//   113; 1.5 KB in the max backward in f32 with an int16 argmax, k <= 75;
//   2 KB (bf16, or an int32 argmax) k <= 56.
// * The carveout is what the arena needs (hub_fit_attributes), not the
//   SM's whole 228 KB: the rest stays L1, which serves the kernels without
//   the hub their hottest rows (the hub rows among them).  The arena's rows
//   come out of that L1; an arena can only win where serving them from
//   shared memory beats the L1 it displaces.
// * Warps a block (hub_warps): the max kernels' float32 blocks hold 4 warps
//   fewer than the kernels without the hub (24 forward, 20 backward): at
//   28 / 24 the pipeline's state spills more (ptxas: 72 / 80 registers a
//   thread), and the card ran the 24 / 20 forms faster (the forward on
//   config 5's shard too); their bfloat16 blocks hold as many (4
//   fewer ran slower).  ptxas: the forward 80 registers in float32, 90-96
//   in bfloat16, the backward 96 and 119-128; 4-8 bytes of spill in some
//   forward forms (not float32's 8-byte vectors, the 24k graph's layer 1),
//   84-160 bytes only in the backward's odd-K and int32-argmax forms.
//   The sum's blocks hold 4 warps fewer in both types (spmm_sum.cu).  One
//   block an SM: two ran within 2% of it, and a fill warp of its own that
//   walks no chunk no faster (PERF.md's hub findings).
// ---------------------------------------------------------------------------

constexpr size_t kSmemBlockMax = 232448;  // shared memory a block may take

// Elements of an arena row: the K-slice, or K where K is narrower.
__host__ __device__ inline int hub_stride(int64_t k_width, int slice_width) {
  return static_cast<int>(k_width < slice_width ? k_width : slice_width);
}

// Bytes of an arena of k rows of `stride` elements of size es, rounded up
// to 16 (a second arena follows it in the backward).
__host__ __device__ inline size_t arena_bytes(int k, int stride, int es) {
  return (static_cast<size_t>(k) * stride * es + 15) / 16 * 16;
}

// The hub entry points' dispatch, each level written once for all its
// cases: f(T{}) for dtype 0 (float) or 1 (bfloat16), f(ArgT{}) for an
// argmax of 16 or 32 bits, f(integral_constant<int, V>) for a vector
// width of 8, 4, 2 or 1 (vector_width's).
template <typename F>
inline int with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(float{});
    case 1:
      return f(__nv_bfloat16{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
inline int with_arg_bits(int arg_bits, F&& f) {
  switch (arg_bits) {
    case 16:
      return f(int16_t{});
    case 32:
      return f(int32_t{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename F>
inline int with_vector_width(int v, F&& f) {
  switch (v) {
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return f(std::integral_constant<int, 1>{});
  }
}

// The block's dynamic shared memory, 16-byte aligned.
__device__ __forceinline__ unsigned char* hub_smem() {
  extern __shared__ uint4 hub_smem_words[];
  return reinterpret_cast<unsigned char*>(hub_smem_words);
}

// V elements of T from shared memory, as the words load_vec gives.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec_shared(const T* p) {
  Vec<T, V> out;
  if constexpr (Vec<T, V>::kBytes == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    out.w[0] = r.x;
    out.w[1] = r.y;
    out.w[2] = r.z;
    out.w[3] = r.w;
  } else if constexpr (Vec<T, V>::kBytes == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    out.w[0] = r.x;
    out.w[1] = r.y;
  } else if constexpr (Vec<T, V>::kBytes == 4) {
    out.w[0] = *reinterpret_cast<const unsigned int*>(p);
  } else {
    out.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  return out;
}

// Warps an SM holds of a kernel without the hub at `threads` a block (-1
// if the card will not say).
template <typename Kernel>
inline int warps_per_sm(Kernel kernel, int threads) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0) !=
      cudaSuccess) {
    return -1;
  }
  return blocks * threads / 32;
}

// Warps an SM holds of a hub kernel (one block) whose kernel without the
// hub holds `without` (float32) or `without_bf16` of them.
template <typename T>
__host__ __device__ constexpr int hub_warps(int without, int without_bf16) {
  return sizeof(T) == 4 ? without - 4 : without_bf16;
}
constexpr int kHubStages = 2;

// A pipelined block's static shared memory.
struct HubPipe {
  uint64_t full[kHubStages];
  uint64_t empty[kHubStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also raises the barrier's expected bytes of this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the barrier's phase of parity `parity` has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// cp.async of kBytes (4, 8 or 16; both ends aligned to it).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async takes 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src),
               "n"(kBytes)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.asyncs have landed; the
// barrier's count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// A 2-byte element at vector width 1 (K odd) is copied as the 4-byte words
// that cover its row, the row kept at the source's parity: hub_shift.
template <typename E, int V>
__host__ __device__ constexpr bool hub_shifted() {
  return sizeof(E) == 2 && V == 1;
}

// Elements between two arena rows of E: the slice's (stride), or for a
// shifted row the stride and the words' spill, rounded to a word.
template <typename E, int V>
__host__ __device__ inline int hub_pitch(int stride) {
  return hub_shifted<E, V>() ? (stride + 3) & ~1 : stride;
}

// Where a shifted row's slice starts in its arena row: the parity of its
// first element in device memory (the slices start at even elements).
template <typename E, int V>
__device__ __forceinline__ int hub_shift(const int* __restrict__ ids, int slot,
                                         int64_t k_width) {
  if constexpr (hub_shifted<E, V>()) {
    return __ldg(ids + slot) & static_cast<int>(k_width & 1);
  } else {
    return 0;
  }
}

// Bytes of one stage's arena of hub_k rows of E, rounded up to 16.
template <typename E, int V>
__host__ __device__ inline size_t hub_stage_part(int hub_k, int stride) {
  return arena_bytes(hub_k, hub_pitch<E, V>(stride), sizeof(E));
}

// The TMA route for rows of E: each row's byte stride a multiple of 16 at a
// 16-byte aligned base, and no shifted rows.
template <typename E, int V>
inline bool hub_route(int64_t k_width, const void* p) {
  return !hub_shifted<E, V>() && (k_width * static_cast<int64_t>(sizeof(E))) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The fill warp's part of a stage's fill for one array: rows 0..n) of the
// K-slice at slice0 of rows ids[...] of src (rows of k_width elements of
// E) into the arena at `pitch` elements a row, reported to `full`.  TMA:
// one bulk copy a row, lane l the rows l, l + 32, ...; the caller raised the
// expected bytes (hub_fill_bytes).  cp.async: lane l the row's vectors l,
// l + 32, ..., and the caller's lanes arrive once after all arrays'.
template <typename E, int V>
__device__ __forceinline__ void hub_fill_rows(E* arena, const E* __restrict__ src,
                                              const int* __restrict__ ids, int n, int pitch,
                                              int len, int64_t slice0, int64_t k_width,
                                              bool tma, uint64_t* full, int lane) {
  if (tma) {
    for (int i = lane; i < n; i += 32) {
      bulk_copy(arena + static_cast<int64_t>(i) * pitch,
                src + static_cast<int64_t>(__ldg(ids + i)) * k_width + slice0,
                static_cast<uint32_t>(len * sizeof(E)), full);
    }
    return;
  }
  for (int i = 0; i < n; ++i) {
    const int64_t a = static_cast<int64_t>(__ldg(ids + i)) * k_width + slice0;
    E* row = arena + static_cast<int64_t>(i) * pitch;
    if constexpr (hub_shifted<E, V>()) {
      const int sh = static_cast<int>(a & 1);  // the words start at element a - sh
      const int words = (sh + len + 1) >> 1;
      for (int w = lane; w < words; w += 32) cp_async<4>(row + 2 * w, src + a - sh + 2 * w);
    } else {
      constexpr int kBytes = V * static_cast<int>(sizeof(E));
      for (int v = lane; v < len / V; v += 32) cp_async<kBytes>(row + v * V, src + a + v * V);
    }
  }
}

// Bytes a TMA fill of n rows of `len` elements of E lands.
template <typename E>
__device__ __forceinline__ uint32_t hub_fill_bytes(int n, int len) {
  return static_cast<uint32_t>(n) * len * sizeof(E);
}

// The whole fill of a stage that holds one array (the max forward's and the
// sum's: hub_k rows of x): slice s's rows of src into `arena` at `pitch`
// elements a row, `stride` elements a slice, with the stage's arrivals on
// `full` (lane 0's expect_tx or plain one first; on the cp.async route each
// lane's after its copies).  Every lane of the fill warp calls it.
template <typename T, int V>
__device__ __forceinline__ void hub_fill_stage(T* arena, const T* __restrict__ src,
                                               const int* __restrict__ ids, int hub_k,
                                               int pitch, int stride, int s, int64_t k_width,
                                               bool tma, uint64_t* full, int lane) {
  const int64_t slice0 = static_cast<int64_t>(s) * stride;
  const int len = static_cast<int>(k_width - slice0 < stride ? k_width - slice0 : stride);
  if (lane == 0) {
    if (tma) {
      mbar_arrive_tx(full, hub_fill_bytes<T>(hub_k, len));
    } else {
      mbar_arrive(full);
    }
  }
  __syncwarp();
  hub_fill_rows<T, V>(arena, src, ids, hub_k, pitch, len, slice0, k_width, tma, full, lane);
  if (!tma) cp_async_arrive(full);
}

// The J vectors of this lane for an edge whose coded neighbour is nbr: row
// nbr of x in device memory, or arena slot -1 - nbr of a stage (`arena` is
// already at this lane's first element; rows `pitch` elements apart, a
// shifted row's slice at its shift).
template <typename T, int V, int J>
__device__ __forceinline__ void load_pipe_row(Vec<T, V> (&v)[J], const T* __restrict__ x,
                                              const T* arena, const int* __restrict__ ids,
                                              int nbr, int64_t k_width, int64_t k0, int pitch,
                                              int nvec) {
  if (nbr >= 0) {
    const T* p = x + static_cast<int64_t>(nbr) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < nvec) v[j] = load_vec<T, V>(p + j * 32 * V);
    }
  } else {
    const int slot = -1 - nbr;
    const T* p = arena + static_cast<int64_t>(slot) * pitch + hub_shift<T, V>(ids, slot, k_width);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < nvec) v[j] = load_vec_shared<T, V>(p + j * 32 * V);
    }
  }
}

// The first `nvec` of a lane's J vectors (32 * V elements apart) from its
// first element k0 that lie inside K.
template <int V, int J>
__device__ __forceinline__ int lane_vectors(int64_t k0, int64_t k_width) {
  const int64_t left = k_width > k0 ? (k_width - k0 + 32 * V - 1) / (32 * V) : 0;
  return left < J ? static_cast<int>(left) : J;
}

// A launch's walk: its K-slices, the chunks a warp claims at one draw of a
// slice's ticket (hub_claim) and the fill route (1 TMA, 0 cp.async).
struct HubWalk {
  int n_slices;
  int claim;
  int tma;
};

// A pipelined hub block's walk (the design above).  fill(s, stage) issues
// slice s's fill of `stage` (called by every lane of the fill warp, warp 0;
// it makes the stage's arrivals, lane 0's plain or expect_tx one first);
// body(s, stage, chunk) walks one chunk of slice s from `stage`.  "full"
// takes 1 arrival a phase on the TMA route (lane 0's expect_tx), 33 on the
// cp.async route (lane 0's and each lane's cp.async arrival).  tickets[s]
// (zero at launch, and zero again after it: the launch's last draw resets
// it) hands out slice s's chunks to the warps of every block, walk.claim
// consecutive chunks a draw in the table's order, so the grid walks one
// slice at a time, as the grid of the kernels without the hub does (one
// slice's rows stay in L2), and a block's warps go on to the next slice as
// soon as the slice has no chunk left.
template <typename Fill, typename Body>
__device__ __forceinline__ void hub_pipeline(const Table& t, HubPipe& pipe,
                                             int* __restrict__ tickets, const HubWalk& walk,
                                             Fill&& fill, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const bool filler = threadIdx.x < 32;
  const int n_slices = walk.n_slices;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kHubStages; ++st) {
      mbar_init(&pipe.full[st], walk.tma ? 1u : 33u);
      mbar_init(&pipe.empty[st], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers' init, once a launch
  if (filler) {
    for (int s = 0; s < kHubStages && s < n_slices; ++s) fill(s, s);
  }
  int pending = kHubStages;  // the next slice to fill (the fill warp's)
  // Slice j's fill into stage j % 2, once every walking warp has left slice
  // j - 2 there: its "empty" phase (j - 2) / 2.
  auto refill = [&](int j) {
    if (lane == 0) mbar_wait(&pipe.empty[j & 1], ((j - 2) >> 1) & 1);
    __syncwarp();
    fill(j, j & 1);
  };
  // Every warp of the grid draws each slice's ticket once per claim it
  // walks and once more, in vain: the draw numbered `last` is the launch's
  // last on that ticket, and sets it back to zero for the next launch.
  const int last = (t.n_chunks + walk.claim - 1) / walk.claim +
                   static_cast<int>(gridDim.x) * warps - 1;
  auto draw = [&](int s) {
    int c = 0;
    if (lane == 0) {
      c = atomicAdd(tickets + s, 1);
      if (c == last) atomicExch(tickets + s, 0);
    }
    return c;
  };
  for (int s = 0; s < n_slices; ++s) {
    const int st = s & 1;
    if (filler && pending == s) refill(pending++);
    mbar_wait(&pipe.full[st], (s >> 1) & 1);
    // c walks the claims' chunks in turn; a claim's first chunk draws the
    // next claim (claims start at multiples of walk.claim, a power of two),
    // so the draw overlaps the claim's walk.
    int mine = draw(s);
    int c = __shfl_sync(kFullMask, mine, 0) * walk.claim;
    while (c < t.n_chunks) {
      if ((c & (walk.claim - 1)) == 0) mine = draw(s);
      body(s, st, c);
      if (filler && pending == s + 1 && pending < n_slices) {
        const int j = pending;
        const bool ready =
            lane == 0 ? mbar_test(&pipe.empty[j & 1], ((j - 2) >> 1) & 1) : false;
        if (__shfl_sync(kFullMask, ready, 0)) refill(pending++);
      }
      ++c;
      if ((c & (walk.claim - 1)) == 0) c = __shfl_sync(kFullMask, mine, 0) * walk.claim;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&pipe.empty[st]);
  }
}

// A pipelined hub kernel's shared memory: `smem` bytes of dynamic shared
// memory and a carveout of just what one block needs (static shared
// memory and 1 KB a block of the card's own besides), so the rest of the
// SM's 256 KB stays L1 cache: the kernels without the hub serve their
// hottest rows from an L1 of up to 256 KB, and an arena that took the
// whole carveout would leave 28 KB of it.
template <typename Kernel>
inline cudaError_t hub_fit_attributes(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t need = smem + sizeof(HubPipe) + 1024;
  const int percent = static_cast<int>((need * 100 + kSmemBlockMax - 1) / kSmemBlockMax);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              percent < 100 ? percent : 100);
}

// Blocks an SM holds of a pipelined hub kernel at `threads` a block and
// `smem` bytes of dynamic shared memory, at its launch's carveout (-1 if
// the card will not say).
template <typename Kernel>
inline int pipe_blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int blocks = 0;
  if (hub_fit_attributes(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

// Chunks a warp claims at one draw of a slice's ticket, for n_chunks
// chunks a slice walked by `walkers` warps: 1, doubled (up to kMaxClaim)
// while every warp would still draw at least kClaimsPerWarp times a slice.
// A slice's ticket serves one atomicAdd at a time, grid-wide.  Where the
// chunks are many and short (config 5's P = 2 interior shard: 494,298
// chunks of 5.4 edges a slice, 156 a float32 max forward warp) one draw a
// chunk made the ticket, not the walk, bound the slice: the card ran its
// k = 0 forward at claims of 1 / 2 / 4 / 8 / 16 chunks 1.41 / 1.13 / 1.12 /
// 1.21 / 1.31x the kernel without the hub, the sum 1.47 / 1.14 / 1.06 /
// 1.15 / 1.26x (PERF.md), so 32 draws a warp sits between the best claim (4:
// 39 draws) and the next (8: 20).  Where the chunks are few (the 24k-node
// graph: 24,723 chunks, 7.8 a warp) the claim stays 1: 2 ran 1.38x.
constexpr int kMaxClaim = 16;
constexpr int kClaimsPerWarp = 32;
inline int hub_claim(int64_t n_chunks, int64_t walkers) {
  int claim = 1;
  while (claim < kMaxClaim && n_chunks >= 2 * claim * walkers * kClaimsPerWarp) claim *= 2;
  return claim;
}

// Host side of a pipelined hub launch: the combine's grid as `grids` gives
// it, the chunk grid (one block an SM, fewer where the chunks are fewer;
// no slice dimension), the walk's slices and claim, and the kernel's
// shared memory.  An arena above the card's limit, or fewer tickets than
// slices, is refused (cudaErrorInvalidValue), never cut.
template <typename Kernel>
inline int hub_pipe_setup(Kernel kernel, size_t smem, int warps, int64_t n_chunks,
                          int64_t n_split, int64_t k_width, int slice_width,
                          int64_t n_tickets, dim3* grid, dim3* combine_grid, HubWalk* walk) {
  dim3 chunk_grid;
  const int rc_grid = grids(n_chunks, n_split, k_width, slice_width, &chunk_grid,
                            combine_grid);
  if (rc_grid != cudaSuccess) return rc_grid;
  if (static_cast<int64_t>(chunk_grid.y) > n_tickets) return cudaErrorInvalidValue;
  if (smem > kSmemBlockMax) return cudaErrorInvalidValue;
  cudaError_t err = hub_fit_attributes(kernel, smem);
  int dev = 0, n_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n_chunks + warps - 1) / warps;
  *grid = dim3(static_cast<unsigned>(want < n_sm ? want : n_sm));
  const int64_t walkers = static_cast<int64_t>(grid->x) * warps;
  walk->n_slices = static_cast<int>(chunk_grid.y);
  walk->claim = hub_claim(n_chunks, walkers);
  // every draw's first chunk, the last in vain included, fits an int
  if (n_chunks + (walkers + 1) * walk->claim > 2147483647LL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace row_chunks
