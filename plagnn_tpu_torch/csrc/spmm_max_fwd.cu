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
//   out[i, k] = max over in-edges j -> i of x[j, k]  (empty_value for empty
//               rows: 0 on one device, -inf for the partial maxima of a
//               graph shard, plagnn_tpu/parallel/sharded.py:136-142)
//   arg[i, k] = the source of the FIRST maximum in (dst, src) order: the
//               update is on strict '>' over ascending sources    (-1 empty)
// Ties are common (relu gives many zeros), and the backward routes the
// gradient to arg only, so the tie rule is part of the contract.
//
// Positional argmax (kPos; the JAX package's positional mode of the same
// kernel, build_pallas_graph(positional=True), for graphs past 2^15 padded
// nodes): arg records the first maximum's RANK within its row, e -
// indptr[i], in place of its source, so it is int16 at any node count.  A
// mega row (more than rank_cap in-edges, mega_of[i] = m >= 0) stores the
// rank modulo rank_cap, and seg[m, k] its segment rank / rank_cap: a side
// table of one row per mega row in place of the JAX package's sub-rows in
// spare padding slots (_split_combine).
//
// Types: x/out float32 or bfloat16 (values compare as float; the value kept
// is an input's, so out is exact in either type); arg int16 when the padded
// node count is <= 2^15 or for ranks, else int32, or not written at all
// (kWithArg = false, the primal of the custom VJP, which also drops the
// source tracking).
//
// What bounds it on this card: memory.  The compulsory traffic (x read
// once, out and arg written once) is ~0.36 ms at 3.35 TB/s at the slice's
// layer-1 shape (E ~ 724k, N 24,064, K = 10*503, f32 x, int16 arg).  A
// gather reads one source row per edge, E*K*esize bytes (~14.6 GB there),
// and serves the re-reads from L2 as far as one K-slice's rows fit it: the
// grid runs chunks fastest, so the blocks in flight share one K-slice.  At
// 24,064 rows x 1 KB (25 MB) they fit the 50 MB L2; at 330,112 rows x 1 KB
// (338 MB) they do not, and most gathered rows come from HBM.  Past a
// working set the card's sweeps set (ops/spmm_kernels.py: slice_bytes,
// WIDE_SLICE_FROM) the wrapper takes the K-slice width that ran fastest at
// 165 k and 330 k rows for the dtype (WIDE_SLICE: 256 B in f32, 1 KB in
// bf16), measured, not derived from the L2: a narrow slice cuts the misses
// but issues more requests a byte.  Groups of G < 32 lanes walk a
// narrow slice (kernel 1g); each slice re-reads the chunks' source ids, E x
// 4 bytes.
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
//    stores out and arg directly (an empty row's empty chunk stores
//    empty_value and -1); a chunk of a split row stores a float32 value and
//    an int32 source in its slot of two (n_slots, K) scratch buffers.  The
//    positional form tracks the edge index e in place of the source, the
//    same walk and compares; it stores e less the chunk's first edge, which
//    for a row's only chunk is the rank, and for a split row's chunk the
//    rank within the chunk.
// 2. spmm_max_fwd_combine_kernel: one thread per (split row, k) starts from
//    the row's first slot and takes a later slot only where its value is
//    strictly greater.  Slots run in ascending chunk order, and a lower
//    chunk holds lower sources, so a tie goes to the lower chunk and arg
//    stays the first maximum in (dst, src) order.  Chunk j of a row starts
//    at rank j * chunk_cap (graph_format.RowChunks), so the positional
//    combine adds that to the winning slot's rank.
// 1g. spmm_max_fwd_group_kernel, for K-slices narrower than 32 lanes' (a
//    group of G lanes of 32 bytes, 32 / G chunks a warp): the same walk of
//    each chunk by its group (row_chunks.cuh: walk_group), the group's ids
//    loaded G at a time and shuffled over its lanes only, so the groups of
//    a warp walk chunks of any lengths; the chunks taken longest first
//    (RowChunks.order) so that the groups of a warp end together.  Every
//    element is still computed by one lane over the same edges in the same
//    order, so out and arg are the bits of kernel 1's.
// No atomics: every element is written by one thread in a fixed order, so
// out and arg are bit-identical run to run.  The design it replaces, one
// thread per (row, k) walking the whole row with 4-byte loads, walked the
// hub row (in-degree 10,505) serially in each of its blocks.
// The hub instantiation (spmm_max_fwd_hub_kernel: the id-based argmax, the
// training path's forward) reads the hub sources' rows from a two-stage
// shared-memory arena of the k most-fetched rows, one persistent block an
// SM walking every K-slice while the next slice's stage fills by TMA or
// cp.async (row_chunks.cuh: hub_pipeline, which says what bounds it).  It
// walks each chunk as spmm_max_fwd_kernel does, tracks each maximum's coded
// neighbour (-1 - slot for an arena row) with the same compares, and stores
// the slot's node id (HubTable.ids) as the argmax, so out and arg are
// bit-exact against the kernel without the hub.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// The positional argmax's extra inputs (null mega_of: no mega rows).
struct PosArgs {
  const int* mega_of;  // (N_pad,) mega row index, -1 elsewhere
  int16_t* seg;        // (n_mega, K) segment of each mega row's argmax
  int rank_cap;        // a mega row's rank is cut at this many edges
  int chunk_cap;       // edges a row chunk holds (chunk j starts at j*cap)
};

__device__ __forceinline__ int mega_index(const PosArgs& p, int row) {
  return p.mega_of != nullptr ? __ldg(p.mega_of + row) : -1;
}

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
// elements a lane, kStride elements apart (0: `group_stride`, the grouped
// walk's, set at run time): walk_chunk's `acc` holds the values, `src` the
// sources (kPos: the edge indices).
template <typename T, int V, int J, bool kWithArg, bool kPos, int kStride = 32 * V>
struct MaxFwdOp {
  const T* x;
  int64_t k_width;
  int64_t k0;
  int nvec;
  bool first;  // no edge taken yet: the next one is taken whatever its value
  rc::Vec<T, V> val[rc::kUnroll][J];
  int nbr[rc::kUnroll];
  int src[V * J];
  int group_stride;

  __device__ __forceinline__ int vstride() const {
    return kStride > 0 ? kStride : group_stride;
  }

  __device__ __forceinline__ void begin(int64_t k, int n) {
    k0 = k;
    nvec = n;
    first = true;
#pragma unroll
    for (int i = 0; i < V * J; ++i) src[i] = -1;
  }
  __device__ __forceinline__ void load(int u, int s, int e) {
    nbr[u] = kPos ? e : s;
    const T* p = x + static_cast<int64_t>(s) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < nvec) val[u][j] = rc::load_vec<T, V>(p + j * vstride());
    }
  }
  // the grouped walk's: no second index
  __device__ __forceinline__ const int* aux_index() const { return nullptr; }
  __device__ __forceinline__ void load(int u, int s, int e, int) { load(u, s, e); }
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
  // The sources as the argmax stores them (kPos: edge index -> rank within
  // the chunk starting at edge beg).
  __device__ __forceinline__ void finish(int beg, int) {
    if (kPos) {
#pragma unroll
      for (int i = 0; i < V * J; ++i) src[i] = src[i] < 0 ? -1 : src[i] - beg;
    }
  }
};

// One chunk's first maximum and its store, spmm_max_fwd_kernel's, the
// hub kernel's and (kGrouped: walk_group by the group of 1 << lg lanes
// `mask`, `lane` this lane's place in it) the grouped kernel's: the walk,
// op.finish, then the row's out and arg or the chunk's partial slot.  An
// empty chunk (empty row) keeps empty_value and source -1; a split row's
// chunks are never empty, so the combine never sees it.
template <typename T, typename ArgT, int V, int J, bool kWithArg, bool kPos,
          bool kGrouped = false, typename Op>
__device__ __forceinline__ void max_fwd_chunk(const rc::Table& t, int64_t chunk,
                                              const int* __restrict__ idx, int lane,
                                              int64_t k0, int nvec, Op& op,
                                              T* __restrict__ out, ArgT* __restrict__ arg,
                                              float* __restrict__ partial_val,
                                              int* __restrict__ partial_src,
                                              int64_t k_width, float empty_value,
                                              const PosArgs& pos, int lg = 5,
                                              unsigned mask = rc::kFullMask) {
  const int row = __ldg(t.row + chunk);
  op.begin(k0, nvec);
  float best[V * J];
#pragma unroll
  for (int i = 0; i < V * J; ++i) best[i] = empty_value;
  const int beg = __ldg(t.ptr + chunk);
  const int end = __ldg(t.ptr + chunk + 1);
  if constexpr (kGrouped) {
    rc::walk_group(idx, beg, end, lane, lg, mask, nvec > 0, op, best);
  } else {
    rc::walk_chunk(idx, beg, end, lane, nvec > 0, op, best);
  }
  const int slot = __ldg(t.slot + chunk);
  op.finish(beg, end);
  // a whole mega row (rank_cap below the chunk size): rank -> (segment, rank)
  const int m = kPos && slot < 0 ? mega_index(pos, row) : -1;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j >= nvec) break;
    const int64_t k = k0 + j * op.vstride();
    if (slot < 0) {
      const int64_t o = static_cast<int64_t>(row) * k_width + k;
      rc::store_vec<T, V>(out + o, best + j * V);
      if (kPos && m >= 0) {
        int sg[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          sg[i] = op.src[j * V + i] / pos.rank_cap;
          op.src[j * V + i] -= sg[i] * pos.rank_cap;
        }
        store_ints<int16_t, V>(pos.seg + static_cast<int64_t>(m) * k_width + k, sg);
      }
      if (kWithArg) store_ints<ArgT, V>(arg + o, op.src + j * V);
    } else {
      const int64_t o = static_cast<int64_t>(slot) * k_width + k;
      rc::store_vec<float, V>(partial_val + o, best + j * V);
      if (kWithArg) store_ints<int32_t, V>(partial_src + o, op.src + j * V);
    }
  }
}

// At least kMinBlocks blocks an SM (at most 128 registers a thread) binds
// none of the instantiations (92 at most); without the hint ptxas squeezes
// the bf16 16-byte form without the argmax into 64 registers and spills.
constexpr int kMinBlocks = 4;

template <typename T, typename ArgT, int V, bool kWithArg, bool kPos>
__global__ void __launch_bounds__(rc::kThreads, kMinBlocks)
spmm_max_fwd_kernel(const T* __restrict__ x, rc::Table t,
                    const int* __restrict__ src, T* __restrict__ out,
                    ArgT* __restrict__ arg, float* __restrict__ partial_val,
                    int* __restrict__ partial_src, int64_t k_width,
                    float empty_value, PosArgs pos) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * rc::kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;  // the whole warp
  const int64_t k0 = (static_cast<int64_t>(blockIdx.y) * 32 * J + lane) * V;
  const int64_t left = k_width > k0 ? (k_width - k0 + 32 * V - 1) / (32 * V) : 0;
  const int nvec = left < J ? static_cast<int>(left) : J;
  MaxFwdOp<T, V, J, kWithArg, kPos> op{x, k_width};
  max_fwd_chunk<T, ArgT, V, J, kWithArg, kPos>(t, chunk, src, lane, k0, nvec, op, out, arg,
                                               partial_val, partial_src, k_width,
                                               empty_value, pos);
}

// Kernel 1g, the grouped walk of a K-slice narrower than 32 lanes': each
// group of 1 << lg lanes walks the chunk the launch order `order` gives it,
// exactly as a warp of spmm_max_fwd_kernel walks its chunk -- the same
// edges in the same order, the same compares, the same stores -- so out and
// arg are the same bits.  A group past the last chunk has nothing to do.
template <typename T, typename ArgT, int V, bool kWithArg, bool kPos>
__global__ void __launch_bounds__(rc::kThreads, kMinBlocks)
spmm_max_fwd_group_kernel(const T* __restrict__ x, rc::Table t,
                          const int* __restrict__ order, const int* __restrict__ src,
                          T* __restrict__ out, ArgT* __restrict__ arg,
                          float* __restrict__ partial_val, int* __restrict__ partial_src,
                          int64_t k_width, float empty_value, PosArgs pos, int lg) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  const rc::GroupLane h = rc::group_lane<V, J>(t, order, lg, k_width);
  if (h.chunk < 0) return;  // the whole group
  MaxFwdOp<T, V, J, kWithArg, kPos, 0> op{x, k_width};
  op.group_stride = V << lg;
  max_fwd_chunk<T, ArgT, V, J, kWithArg, kPos, true>(t, h.chunk, src, h.lane, h.k0, h.nvec,
                                                     op, out, arg, partial_val, partial_src,
                                                     k_width, empty_value, pos, lg, h.mask);
}

// MaxFwdOp (id-based argmax) with the hub sources' rows from a stage of the
// arena: `src` holds coded neighbours until `finish` turns them into node
// ids.
template <typename T, int V, int J>
struct MaxFwdHubOp : MaxFwdOp<T, V, J, true, false> {
  const T* arena;  // the slice's stage, at this lane's first element
  int pitch;
  const int* ids;

  __device__ __forceinline__ void load(int u, int s, int) {
    this->nbr[u] = s;
    rc::load_pipe_row<T, V, J>(this->val[u], this->x, arena, ids, s, this->k_width, this->k0,
                               pitch, this->nvec);
  }
  // coded neighbours -> node ids, for a chunk with edges (an empty chunk
  // keeps -1), this lane's vectors inside K only (an arena of k = 0 has no
  // ids to read)
  __device__ __forceinline__ void finish(int beg, int end) {
    if (beg < end) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= this->nvec) break;
#pragma unroll
        for (int i = j * V; i < (j + 1) * V; ++i) {
          if (this->src[i] < 0) this->src[i] = __ldg(ids + (-1 - this->src[i]));
        }
      }
    }
  }
};

// Warps an SM holds of the hub kernel, in its one block: those of the
// kernel without the hub (28 in float32, 20 in bfloat16; chip_smoke.py
// phase 3h prints both) less rc::hub_warps' cut.
template <typename T>
constexpr int kHubWarps = rc::hub_warps<T>(28, 20);
template <typename T>
constexpr int kHubThreads = 32 * kHubWarps<T>;

// Bytes of one stage: hub_k rows of x's K-slice.
template <typename T, int V>
__host__ __device__ inline size_t hub_stage_bytes(int64_t k_width, int hub_k) {
  return rc::hub_stage_part<T, V>(hub_k, rc::hub_stride(k_width, 32 * V *
                                                        rc::vectors_per_lane<T, V>()));
}

// The pipelined hub forward (row_chunks.cuh: hub_pipeline): every K-slice
// in turn, each slice's hub rows in a stage of the arena filled by the fill
// warp (`walk.tma`: bulk copies, else cp.async), the slice's chunks walked by
// max_fwd_chunk as the kernel without the hub walks them.
template <typename T, typename ArgT, int V>
__global__ void __launch_bounds__(kHubThreads<T>, 1)
spmm_max_fwd_hub_kernel(const T* __restrict__ x, rc::Table table,
                        const int* __restrict__ idx, const int* __restrict__ ids,
                        int hub_k, T* __restrict__ out, ArgT* __restrict__ arg,
                        float* __restrict__ partial_val, int* __restrict__ partial_src,
                        int* __restrict__ tickets, int64_t k_width, float empty_value,
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
  MaxFwdHubOp<T, V, J> op{{x, k_width}, nullptr, pitch, ids};
  const PosArgs none{nullptr, nullptr, 0, 0};
  rc::hub_pipeline(table, pipe, tickets, walk, fill,
                   [&](int s, int st, int c) {
    const int64_t k0 = static_cast<int64_t>(s) * stride + lane * V;
    op.arena = stage(st) + lane * V;
    max_fwd_chunk<T, ArgT, V, J, true, false>(
        table, c, idx, lane, k0, rc::lane_vectors<V, J>(k0, k_width), op, out, arg,
        partial_val, partial_src, k_width, empty_value, none);
  });
}

// Split row blockIdx.x, one k per thread: the first maximum over the row's
// slots in ascending chunk order (a later slot only where strictly greater).
template <typename T, typename ArgT, bool kWithArg, bool kPos>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_max_fwd_combine_kernel(const int* __restrict__ split_row,
                            const int* __restrict__ split_ptr,
                            const float* __restrict__ partial_val,
                            const int* __restrict__ partial_src,
                            T* __restrict__ out, ArgT* __restrict__ arg,
                            int64_t k_width, PosArgs pos) {
  const int i = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * rc::kCombineThreads + threadIdx.x;
  if (k >= k_width) return;
  const int s0 = __ldg(split_ptr + i);
  const int s_end = __ldg(split_ptr + i + 1);
  int64_t o = static_cast<int64_t>(s0) * k_width + k;
  float best = __ldg(partial_val + o);
  int best_src = kWithArg ? __ldg(partial_src + o) : 0;
  for (int s = s0 + 1; s < s_end; ++s) {
    o = static_cast<int64_t>(s) * k_width + k;
    const float v = __ldg(partial_val + o);
    if (v > best) {
      best = v;
      // kPos: the slot's rank within its chunk, plus the chunk's first rank
      if (kWithArg) best_src = __ldg(partial_src + o) + (kPos ? (s - s0) * pos.chunk_cap : 0);
    }
  }
  const int row = __ldg(split_row + i);
  const int64_t r = static_cast<int64_t>(row) * k_width + k;
  rc::store_vec<T, 1>(out + r, &best);
  if (kPos) {
    const int m = mega_index(pos, row);
    if (m >= 0) {
      const int sg = best_src / pos.rank_cap;
      pos.seg[static_cast<int64_t>(m) * k_width + k] = static_cast<int16_t>(sg);
      best_src -= sg * pos.rank_cap;
    }
  }
  if (kWithArg) arg[r] = static_cast<ArgT>(best_src);
}

// Kernel 1 where the K-slice of slice_bytes covers 32 lanes, else kernel
// 1g over the launch order `order`; then the combine.
template <typename T, typename ArgT, int V, bool kWithArg, bool kPos>
int launch_v(const void* x, const rc::Table& table, const int* order, const int* src,
             const int* split_row, const int* split_ptr, int64_t n_split,
             void* out, void* arg, void* partial_val, void* partial_src,
             int64_t k_width, float empty_value, const PosArgs& pos, int slice_bytes,
             cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    constexpr int J = rc::vectors_per_lane<T, V>();
    const int lg = rc::group_log2<T, V>(slice_bytes);
    if (lg < 0 || (lg < 5 && order == nullptr)) return cudaErrorInvalidValue;
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(table.n_chunks, n_split, k_width, (V * J) << lg, &grid,
                                  &combine_grid, 32 >> lg);
    if (rc_grid != cudaSuccess) return rc_grid;
    if (lg == 5) {
      spmm_max_fwd_kernel<T, ArgT, V, kWithArg, kPos><<<grid, rc::kThreads, 0, stream>>>(
          static_cast<const T*>(x), table, src, static_cast<T*>(out),
          static_cast<ArgT*>(arg), static_cast<float*>(partial_val),
          static_cast<int*>(partial_src), k_width, empty_value, pos);
    } else {
      spmm_max_fwd_group_kernel<T, ArgT, V, kWithArg, kPos>
          <<<grid, rc::kThreads, 0, stream>>>(
              static_cast<const T*>(x), table, order, src, static_cast<T*>(out),
              static_cast<ArgT*>(arg), static_cast<float*>(partial_val),
              static_cast<int*>(partial_src), k_width, empty_value, pos, lg);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_max_fwd_combine_kernel<T, ArgT, kWithArg, kPos>
        <<<combine_grid, rc::kCombineThreads, 0, stream>>>(
            split_row, split_ptr, static_cast<const float*>(partial_val),
            static_cast<const int*>(partial_src), static_cast<T*>(out),
            static_cast<ArgT*>(arg), k_width, pos);
    return cudaGetLastError();
  }
}

template <typename T, typename ArgT, bool kWithArg, bool kPos>
int launch(const void* x, const rc::Table& table, const int* order, const int* src,
           const int* split_row, const int* split_ptr, int64_t n_split,
           void* out, void* arg, void* partial_val, void* partial_src,
           int64_t k_width, float empty_value, const PosArgs& pos, int slice_bytes,
           cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int as = sizeof(ArgT);
  const int v = rc::vector_width(
      k_width, es,
      {{x, es}, {out, es}, {arg, as}, {pos.seg, 2}, {partial_val, 4}, {partial_src, 4}});
  return rc::with_vector_width(v, [&](auto vw) {
    return launch_v<T, ArgT, decltype(vw)::value, kWithArg, kPos>(
        x, table, order, src, split_row, split_ptr, n_split, out, arg, partial_val,
        partial_src, k_width, empty_value, pos, slice_bytes, stream);
  });
}

template <typename T>
int launch_arg(int arg_bits, bool positional, const void* x, const rc::Table& table,
               const int* order, const int* src, const int* split_row,
               const int* split_ptr, int64_t n_split, void* out, void* arg,
               void* partial_val, void* partial_src, int64_t k_width, float empty_value,
               const PosArgs& pos, int slice_bytes, cudaStream_t stream) {
  if (positional) {
    if (arg_bits != 16 || pos.rank_cap < 1 || pos.chunk_cap < 1) return cudaErrorInvalidValue;
    return launch<T, int16_t, true, true>(x, table, order, src, split_row, split_ptr,
                                          n_split, out, arg, partial_val, partial_src,
                                          k_width, empty_value, pos, slice_bytes, stream);
  }
  switch (arg_bits) {
    case 0:
      return launch<T, int16_t, false, false>(x, table, order, src, split_row, split_ptr,
                                              n_split, out, nullptr, partial_val, nullptr,
                                              k_width, empty_value, pos, slice_bytes,
                                              stream);
    case 16:
      return launch<T, int16_t, true, false>(x, table, order, src, split_row, split_ptr,
                                             n_split, out, arg, partial_val, partial_src,
                                             k_width, empty_value, pos, slice_bytes,
                                             stream);
    case 32:
      return launch<T, int32_t, true, false>(x, table, order, src, split_row, split_ptr,
                                             n_split, out, arg, partial_val, partial_src,
                                             k_width, empty_value, pos, slice_bytes,
                                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename ArgT, int V>
int launch_hub_v(const void* x, const rc::Table& table, const int* idx, const int* ids,
                 int hub_k, const int* split_row, const int* split_ptr, int64_t n_split,
                 void* out, void* arg, void* partial_val, void* partial_src, int* tickets,
                 int64_t n_tickets, int64_t k_width, float empty_value,
                 cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    constexpr int J = rc::vectors_per_lane<T, V>();
    if (rc::hub_shifted<T, V>() && reinterpret_cast<uintptr_t>(x) % 4 != 0) {
      return cudaErrorInvalidValue;  // the shifted rows' words need 4-byte rows
    }
    auto kernel = spmm_max_fwd_hub_kernel<T, ArgT, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, V>(k_width, hub_k);
    dim3 grid, combine_grid;
    rc::HubWalk walk{};
    const int rc_setup =
        rc::hub_pipe_setup(kernel, smem, kHubWarps<T>, table.n_chunks, n_split, k_width, 32 * V * J,
                           n_tickets, &grid, &combine_grid, &walk);
    if (rc_setup != cudaSuccess) return rc_setup;
    walk.tma = rc::hub_route<T, V>(k_width, x) ? 1 : 0;
    kernel<<<grid, kHubThreads<T>, smem, stream>>>(
        static_cast<const T*>(x), table, idx, ids, hub_k, static_cast<T*>(out),
        static_cast<ArgT*>(arg), static_cast<float*>(partial_val),
        static_cast<int*>(partial_src), tickets, k_width, empty_value, walk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    const PosArgs none{nullptr, nullptr, 0, 0};
    spmm_max_fwd_combine_kernel<T, ArgT, true, false>
        <<<combine_grid, rc::kCombineThreads, 0, stream>>>(
            split_row, split_ptr, static_cast<const float*>(partial_val),
            static_cast<const int*>(partial_src), static_cast<T*>(out),
            static_cast<ArgT*>(arg), k_width, none);
    return cudaGetLastError();
  }
}

// info[0], info[1]: the warps an SM holds of the hub kernel and of the
// kernel without the hub; info[2] the arena's stages, info[3] the hub
// blocks an SM holds, info[4] 1 where the fill takes the TMA route at this
// K (rows 16-byte multiples), 0 for cp.async: the route K gives 16-byte
// aligned tensors (a launch also checks its own).
template <typename T, typename ArgT, int V>
int hub_warps_v(int64_t k_width, int hub_k, int* info) {
  if constexpr (V * sizeof(T) > 16) {
    return cudaErrorInvalidValue;
  } else {
    auto kernel = spmm_max_fwd_hub_kernel<T, ArgT, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, V>(k_width, hub_k);
    const int blocks = rc::pipe_blocks_per_sm(kernel, kHubThreads<T>, smem);
    info[0] = blocks < 0 ? -1 : blocks * kHubThreads<T> / 32;
    info[1] = rc::warps_per_sm(spmm_max_fwd_kernel<T, ArgT, V, true, false>, rc::kThreads);
    info[2] = rc::kHubStages;
    info[3] = blocks;
    info[4] = rc::hub_route<T, V>(k_width, nullptr) ? 1 : 0;
    return cudaSuccess;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  arg_bits: 0 (no argmax; arg and
// partial_src unused), 16 or 32.  (chunk_row, chunk_ptr, chunk_slot,
// n_chunks, split_row, split_ptr, n_split) is the chunk table of the
// destination-sorted CSR (indptr, src).  partial_val (float32) and
// partial_src (int32) are scratch of (n_slots, k_width), unused when
// n_split is 0.  empty_value is what an empty row stores (its argmax -1).
// positional (arg_bits 16 only): arg holds ranks; mega_of (N_pad,) int32
// (null: no mega rows), seg (n_mega, k_width) int16 and rank_cap as in
// graph_format.Graph; chunk_cap is the chunk table's edges per chunk.
// order (n_chunks,) int32 is the chunk table's launch order (RowChunks.order)
// and slice_bytes the K-slice's bytes of x (a power of two, 32 to 1,024;
// ops/spmm_kernels.py: slice_bytes): a slice that covers 32 lanes runs
// spmm_max_fwd_kernel, a narrower one spmm_max_fwd_group_kernel.
// Returns the CUDA error code of the launches (0 = launched);
// cudaErrorInvalidValue for a grid that would not fit or a width not taken.
extern "C" int spmm_max_fwd(int dtype, int arg_bits, const void* x,
                            const void* chunk_row, const void* chunk_ptr,
                            const void* chunk_slot, long long n_chunks,
                            const void* src, const void* split_row,
                            const void* split_ptr, long long n_split, void* out,
                            void* arg, void* partial_val, void* partial_src,
                            long long k_width, float empty_value, int positional,
                            const void* mega_of, void* seg, int rank_cap,
                            int chunk_cap, const void* order, int slice_bytes,
                            void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  const PosArgs pos{static_cast<const int*>(mega_of), static_cast<int16_t*>(seg),
                    rank_cap, chunk_cap};
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  const auto* sp = static_cast<const int*>(src);
  const auto* srow = static_cast<const int*>(split_row);
  const auto* sptr = static_cast<const int*>(split_ptr);
  const auto* ord = static_cast<const int*>(order);
  auto st = static_cast<cudaStream_t>(stream);
  return rc::with_dtype(dtype, [&](auto t) {
    return launch_arg<decltype(t)>(arg_bits, positional != 0, x, table, ord, sp, srow, sptr,
                                   n_split, out, arg, partial_val, partial_src, k_width,
                                   empty_value, pos, slice_bytes, st);
  });
}

// The hub instantiation of spmm_max_fwd (with the id-based argmax, 16 or 32
// bits): the chunk table and split rows as spmm_max_fwd's, idx the coded
// src and ids its k slots' node ids (the forward's graph_format.HubTable);
// tickets: n_tickets int32 zeros, at least one a K-slice, left zero (one
// buffer serves a stream's launches).  Returns the CUDA error code of the
// launches.
extern "C" int spmm_max_fwd_hub(int dtype, int arg_bits, const void* x,
                                const void* chunk_row, const void* chunk_ptr,
                                const void* chunk_slot, long long n_chunks,
                                const void* idx, const void* ids, int hub_k,
                                const void* split_row, const void* split_ptr,
                                long long n_split, void* out, void* arg, void* partial_val,
                                void* partial_src, void* tickets, long long n_tickets,
                                long long k_width, float empty_value, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL || hub_k < 0) return cudaErrorInvalidValue;
  const rc::Table table{static_cast<const int*>(chunk_row),
                        static_cast<const int*>(chunk_ptr),
                        static_cast<const int*>(chunk_slot),
                        static_cast<int>(n_chunks)};
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return rc::with_arg_bits(arg_bits, [&](auto a) {
      using ArgT = decltype(a);
      constexpr int es = sizeof(T);
      constexpr int as = sizeof(ArgT);
      const int v = rc::vector_width(
          k_width, es, {{x, es}, {out, es}, {arg, as}, {partial_val, 4}, {partial_src, 4}});
      return rc::with_vector_width(v, [&](auto vw) {
        return launch_hub_v<T, ArgT, decltype(vw)::value>(
            x, table, static_cast<const int*>(idx), static_cast<const int*>(ids), hub_k,
            static_cast<const int*>(split_row), static_cast<const int*>(split_ptr), n_split,
            out, arg, partial_val, partial_src, static_cast<int*>(tickets), n_tickets,
            k_width, empty_value, static_cast<cudaStream_t>(stream));
      });
    });
  });
}

// The warps an SM holds of spmm_max_fwd_hub's kernel (info[0]) and of the
// kernel without the hub (info[1]) at this dtype, argmax, K and k, as the
// card's occupancy calculator gives them, then the arena's stages, the hub
// blocks an SM holds and the fill route at this K (1 TMA, 0 cp.async;
// info holds 5 ints); launches nothing.
extern "C" int spmm_max_fwd_hub_warps(int dtype, int arg_bits, long long k_width, int hub_k,
                                      int* info) {
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return rc::with_arg_bits(arg_bits, [&](auto a) {
      return rc::with_vector_width(rc::vector_width(k_width, sizeof(T), {}), [&](auto vw) {
        return hub_warps_v<T, decltype(a), decltype(vw)::value>(k_width, hub_k, info);
      });
    });
  });
}
