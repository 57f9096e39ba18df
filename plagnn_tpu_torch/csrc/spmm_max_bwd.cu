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
// int32; empty arg rows hold -1 and never hit.
//
// Positional argmax (kPos; the JAX kernels' positional mode, which compare
// ranks, not node ids): arg holds each row's first-maximum RANK (int16 at
// any node count, spmm_max_fwd.cu), and t_rank gives each transpose edge
// s -> n its rank r in n's forward row, so the hit test is
//   arg[n, k] == r                                  (n an ordinary row)
//   arg[n, k] == r % rank_cap && seg[m, k] == r / rank_cap
//                                                   (n mega row m)
// t_rank is read once per edge, beside t_dst (one word for the warp, as the
// weighted sum reads its edge value), and holds -1 - r for an edge into a
// mega row, so the warp-uniform branch to the segment test costs the
// ordinary rows nothing; only a mega row's edges look up mega_of and read
// the side table's vectors.  A source row of at most
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
// bytes (21.9 GB there).  The grid runs chunks fastest, so the blocks in
// flight share one K-slice's rows of g and arg: 37 MB at 24,064 rows x (1 KB
// of f32 g + 512 B of arg), within the 50 MB L2, but 507 MB at 330,112
// rows.  Past a working set the card's sweeps set (ops/spmm_kernels.py:
// slice_bytes, WIDE_SLICE_FROM) the wrapper takes the K-slice width that
// ran fastest at 165 k and 330 k rows for the dtype and argmax
// (WIDE_SLICE), measured, not derived from the L2: a narrow slice cuts the
// misses but issues more requests a byte.  Groups of G < 32 lanes walk a
// narrow slice (spmm_max_bwd_group_kernel); each slice re-reads the chunks'
// destinations (and t_rank), E x 4 bytes each.
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
// rather than idle threads.  K-slices narrower than 32 lanes' run
// spmm_max_bwd_group_kernel: the same walk of each transpose chunk by a
// group of G lanes of 32 bytes of g (row_chunks.cuh: walk_group, t_rank
// handed out beside the destinations), 32 / G chunks a warp, longest chunks
// first (RowChunks.order); the same hit tests and float32 adds in the same
// order, so dx is the same bits as the 32-lane kernel's.
// The hub instantiation (spmm_max_bwd_hub_kernel, id-based argmax) reads
// the g and arg rows of the hub destinations -- the transpose's k
// most-fetched rows -- from a two-stage shared-memory arena of both (the
// JAX kernels' fused grad + arg arena), one persistent block an SM walking
// every K-slice while the next slice's stage fills by TMA or cp.async
// (row_chunks.cuh: hub_pipeline, which says what bounds it); the same hit
// tests and float32 adds in the same order, so dx is bit-identical to the
// kernel without the hub.
#include "row_chunks.cuh"

namespace {

namespace rc = row_chunks;

// The positional argmax's extra inputs.
struct PosArgs {
  const int* t_rank;   // (E,) rank of each transpose edge; -1 - rank: mega row
  const int* mega_of;  // (N_pad,) mega row index, -1 elsewhere
  const int16_t* seg;  // (n_mega, K) segment of each mega row's argmax
  int rank_cap;
};

// dx[row] += g[n] where arg[n] == row (kPos: the edge's rank), for each
// out-edge row -> n; J vectors of V elements a lane, kStride elements apart
// (0: `group_stride`, the grouped walk's, set at run time).
template <typename T, typename ArgT, int V, int J, bool kPos, int kStride = 32 * V>
struct MaxBwdOp {
  const T* g;
  const ArgT* arg;
  int64_t k_width;
  PosArgs pos;
  int64_t k0;
  int nvec;
  int row;
  rc::Vec<ArgT, V> a[rc::kUnroll][J];
  rc::Vec<T, V> gv[rc::kUnroll][J];
  int want[rc::kUnroll];   // kPos: the rank arg must hold
  int mega[rc::kUnroll];   // kPos: n's mega row index, -1 for an ordinary row
  int segw[rc::kUnroll];   // kPos: the segment seg must hold (mega rows)
  int group_stride;

  __device__ __forceinline__ int vstride() const {
    return kStride > 0 ? kStride : group_stride;
  }

  __device__ __forceinline__ void begin(int r, int64_t k, int n) {
    row = r;
    k0 = k;
    nvec = n;
  }
  __device__ __forceinline__ void load(int u, int n, int e) {
    load(u, n, e, kPos ? __ldg(pos.t_rank + e) : 0);
  }
  // The grouped walk hands out t_rank (kPos) beside the destinations.
  __device__ __forceinline__ const int* aux_index() const {
    return kPos ? pos.t_rank : nullptr;
  }
  __device__ __forceinline__ void load(int u, int n, int, int tr) {
    if constexpr (kPos) {
      mega[u] = -1;
      want[u] = tr;
      if (tr < 0) {  // a mega row: uniform over the lanes that walk the chunk
        const int r = -1 - tr;
        segw[u] = r / pos.rank_cap;
        want[u] = r - segw[u] * pos.rank_cap;
        mega[u] = __ldg(pos.mega_of + n);
      }
    }
    const int64_t off = static_cast<int64_t>(n) * k_width + k0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
      a[u][j] = rc::load_vec<ArgT, V>(arg + off + j * vstride());
      gv[u][j] = rc::load_vec<T, V>(g + off + j * vstride());
    }
  }
  __device__ __forceinline__ void add(int u, float (&acc)[V * J]) {
    const int w = kPos ? want[u] : row;
    if (kPos && mega[u] >= 0) {
      // the segment's vectors, loaded here: a mega row's edges are few
      const int16_t* sp = pos.seg + static_cast<int64_t>(mega[u]) * k_width + k0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j >= nvec) break;
        const rc::Vec<int16_t, V> sv = rc::load_vec<int16_t, V>(sp + j * vstride());
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (rc::get(a[u][j], i) == w && rc::get(sv, i) == segw[u]) {
            acc[j * V + i] += rc::get(gv[u][j], i);
          }
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= nvec) break;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (rc::get(a[u][j], i) == w) acc[j * V + i] += rc::get(gv[u][j], i);
      }
    }
  }
};

template <typename T, typename ArgT, int V, bool kPos>
__global__ void __launch_bounds__(rc::kThreads)
spmm_max_bwd_kernel(const T* __restrict__ g, const ArgT* __restrict__ arg,
                    rc::Table table, const int* __restrict__ t_dst,
                    T* __restrict__ dx, float* __restrict__ partial,
                    int64_t k_width, PosArgs pos) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  MaxBwdOp<T, ArgT, V, J, kPos> op{g, arg, k_width, pos};
  rc::chunk_pass<T, V, J>(table, t_dst, k_width, dx, partial, op);
}

// The blocks an SM a grouped kernel's registers are held to: 4 (at most
// 128 registers a thread), 3 for the bfloat16 forms with an int32 argmax,
// which take up to 145 (bound to 4, one spills 84 bytes).  Every form is
// spill-free so.  Measured on the layer-1 backward at 330 k rows on the
// H100: 5 blocks (96 registers) spill in 14 of the 24 forms; 1 or 3 blocks
// leave the float32 positional form at the registers and the time of 4; 6
// blocks spill more and run slower in all.
template <typename T, typename ArgT>
constexpr int kGroupMinBlocks = sizeof(T) == 2 && sizeof(ArgT) == 4 ? 3 : 4;

// The grouped walk of a K-slice narrower than 32 lanes': each group of
// 1 << lg lanes walks the transpose chunk the launch order `order` gives
// it, exactly as a warp of spmm_max_bwd_kernel walks its chunk -- the same
// edges, hit tests and float32 adds in the same order -- so dx is the same
// bits.  A group past the last chunk has nothing to do.
template <typename T, typename ArgT, int V, bool kPos>
__global__ void __launch_bounds__(rc::kThreads, (kGroupMinBlocks<T, ArgT>))
spmm_max_bwd_group_kernel(const T* __restrict__ g, const ArgT* __restrict__ arg,
                          rc::Table table, const int* __restrict__ order,
                          const int* __restrict__ t_dst, T* __restrict__ dx,
                          float* __restrict__ partial, int64_t k_width, PosArgs pos,
                          int lg) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  const rc::GroupLane h = rc::group_lane<V, J>(table, order, lg, k_width);
  if (h.chunk < 0) return;  // the whole group
  MaxBwdOp<T, ArgT, V, J, kPos, 0> op{g, arg, k_width, pos};
  op.group_stride = V << lg;
  rc::chunk_body<T, V, J, decltype(op), true>(table, h.chunk, t_dst, h.lane, h.k0, h.nvec,
                                              k_width, dx, partial, op, V << lg, lg, h.mask);
}

template <typename T>
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_max_bwd_combine_kernel(const int* __restrict__ split_row,
                            const int* __restrict__ split_ptr,
                            const float* __restrict__ partial,
                            T* __restrict__ dx, int64_t k_width) {
  rc::combine_pass<T>(split_row, split_ptr, partial, dx, k_width);
}

// dx[row] += g[n] where arg[n] == row, with the hub destinations' g and arg
// rows from a stage of the arena.
template <typename T, typename ArgT, int V, int J>
struct MaxBwdHubOp {
  const T* g;
  const ArgT* arg;
  const int* ids;
  const T* g_arena;      // the slice's stage, at this lane's first element
  const ArgT* a_arena;   // the slice's stage, at this lane's first element
  int g_pitch;
  int a_pitch;
  int64_t k_width;
  int64_t k0;
  int nvec;
  int row;
  rc::Vec<ArgT, V> a[rc::kUnroll][J];
  rc::Vec<T, V> gv[rc::kUnroll][J];

  __device__ __forceinline__ void begin(int r, int64_t, int) { row = r; }
  __device__ __forceinline__ void load(int u, int n, int) {
    rc::load_pipe_row<ArgT, V, J>(a[u], arg, a_arena, ids, n, k_width, k0, a_pitch, nvec);
    rc::load_pipe_row<T, V, J>(gv[u], g, g_arena, ids, n, k_width, k0, g_pitch, nvec);
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

// Warps an SM holds of the hub kernel, in its one block: those of the
// kernel without the hub (24 in float32, 16 in bfloat16; chip_smoke.py
// phase 3h prints both) less rc::hub_warps' cut.
template <typename T>
constexpr int kHubWarps = rc::hub_warps<T>(24, 16);
template <typename T>
constexpr int kHubThreads = 32 * kHubWarps<T>;

// Bytes of one stage: hub_k rows of g's K-slice, then hub_k of the argmax's.
template <typename T, typename ArgT, int V>
__host__ __device__ inline size_t hub_g_bytes(int64_t k_width, int hub_k) {
  return rc::hub_stage_part<T, V>(hub_k, rc::hub_stride(k_width, 32 * V *
                                                        rc::vectors_per_lane<T, V>()));
}
template <typename T, typename ArgT, int V>
__host__ __device__ inline size_t hub_stage_bytes(int64_t k_width, int hub_k) {
  const int stride = rc::hub_stride(k_width, 32 * V * rc::vectors_per_lane<T, V>());
  return rc::hub_stage_part<T, V>(hub_k, stride) + rc::hub_stage_part<ArgT, V>(hub_k, stride);
}

// The pipelined hub backward (row_chunks.cuh: hub_pipeline): every K-slice
// in turn, each slice's hub rows of g and of the argmax in a stage of the
// arena filled by the fill warp (`walk.tma`: bulk copies, else cp.async), the
// slice's transpose chunks walked by chunk_body as the kernel without the
// hub walks them.
template <typename T, typename ArgT, int V>
__global__ void __launch_bounds__(kHubThreads<T>, 1)
spmm_max_bwd_hub_kernel(const T* __restrict__ g, const ArgT* __restrict__ arg,
                        rc::Table table, const int* __restrict__ idx,
                        const int* __restrict__ ids, int hub_k, T* __restrict__ dx,
                        float* __restrict__ partial, int* __restrict__ tickets,
                        int64_t k_width, rc::HubWalk walk) {
  constexpr int J = rc::vectors_per_lane<T, V>();
  __shared__ rc::HubPipe pipe;
  const int stride = rc::hub_stride(k_width, 32 * V * J);
  const int g_pitch = rc::hub_pitch<T, V>(stride);
  const int a_pitch = rc::hub_pitch<ArgT, V>(stride);
  const size_t stage_bytes = hub_stage_bytes<T, ArgT, V>(k_width, hub_k);
  const size_t g_bytes = hub_g_bytes<T, ArgT, V>(k_width, hub_k);
  const int lane = threadIdx.x & 31;
  auto g_stage = [&](int st) {
    return reinterpret_cast<T*>(rc::hub_smem() + st * stage_bytes);
  };
  auto a_stage = [&](int st) {
    return reinterpret_cast<ArgT*>(rc::hub_smem() + st * stage_bytes + g_bytes);
  };
  auto fill = [&](int s, int st) {
    const int64_t slice0 = static_cast<int64_t>(s) * stride;
    const int len = static_cast<int>(k_width - slice0 < stride ? k_width - slice0 : stride);
    if (lane == 0) {
      if (walk.tma) {
        rc::mbar_arrive_tx(&pipe.full[st], rc::hub_fill_bytes<T>(hub_k, len) +
                                               rc::hub_fill_bytes<ArgT>(hub_k, len));
      } else {
        rc::mbar_arrive(&pipe.full[st]);
      }
    }
    __syncwarp();
    rc::hub_fill_rows<T, V>(g_stage(st), g, ids, hub_k, g_pitch, len, slice0, k_width,
                            walk.tma != 0, &pipe.full[st], lane);
    rc::hub_fill_rows<ArgT, V>(a_stage(st), arg, ids, hub_k, a_pitch, len, slice0, k_width,
                               walk.tma != 0, &pipe.full[st], lane);
    if (!walk.tma) rc::cp_async_arrive(&pipe.full[st]);
  };
  MaxBwdHubOp<T, ArgT, V, J> op{g, arg, ids, nullptr, nullptr, g_pitch, a_pitch, k_width};
  rc::hub_pipeline(table, pipe, tickets, walk, fill,
                   [&](int s, int st, int c) {
    op.k0 = static_cast<int64_t>(s) * stride + lane * V;
    op.nvec = rc::lane_vectors<V, J>(op.k0, k_width);
    op.g_arena = g_stage(st) + lane * V;
    op.a_arena = a_stage(st) + lane * V;
    rc::chunk_body<T, V, J>(table, c, idx, lane, op.k0, op.nvec, k_width, dx, partial, op);
  });
}

// spmm_max_bwd_kernel where the K-slice of slice_bytes covers 32 lanes,
// else spmm_max_bwd_group_kernel over the launch order `order`; then the
// combine.
template <typename T, typename ArgT, int V, bool kPos>
int launch_v(const void* g, const void* arg, const rc::Table& table, const int* order,
             const int* t_dst, const int* split_row, const int* split_ptr,
             int64_t n_split, void* dx, void* partial, int64_t k_width,
             const PosArgs& pos, int slice_bytes, cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16 || V * sizeof(ArgT) > 16) {
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
      spmm_max_bwd_kernel<T, ArgT, V, kPos><<<grid, rc::kThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const ArgT*>(arg), table, t_dst,
          static_cast<T*>(dx), static_cast<float*>(partial), k_width, pos);
    } else {
      spmm_max_bwd_group_kernel<T, ArgT, V, kPos><<<grid, rc::kThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const ArgT*>(arg), table, order, t_dst,
          static_cast<T*>(dx), static_cast<float*>(partial), k_width, pos, lg);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_max_bwd_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(dx), k_width);
    return cudaGetLastError();
  }
}

template <typename T, typename ArgT, bool kPos>
int launch(const void* g, const void* arg, const rc::Table& table, const int* order,
           const int* t_dst, const int* split_row, const int* split_ptr,
           int64_t n_split, void* dx, void* partial, int64_t k_width,
           const PosArgs& pos, int slice_bytes, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int as = sizeof(ArgT);
  const int v = rc::vector_width(k_width, es > as ? es : as,
                                 {{g, es}, {arg, as}, {pos.seg, 2}, {dx, es}, {partial, 4}});
  return rc::with_vector_width(v, [&](auto vw) {
    return launch_v<T, ArgT, decltype(vw)::value, kPos>(g, arg, table, order, t_dst,
                                                        split_row, split_ptr, n_split, dx,
                                                        partial, k_width, pos, slice_bytes,
                                                        stream);
  });
}

template <typename T>
int launch_arg(int arg_bits, bool positional, const void* g, const void* arg,
               const rc::Table& table, const int* order, const int* t_dst,
               const int* split_row, const int* split_ptr, int64_t n_split, void* dx,
               void* partial, int64_t k_width, const PosArgs& pos, int slice_bytes,
               cudaStream_t stream) {
  if (positional) {
    if (arg_bits != 16 || pos.t_rank == nullptr || pos.rank_cap < 1) {
      return cudaErrorInvalidValue;
    }
    return launch<T, int16_t, true>(g, arg, table, order, t_dst, split_row, split_ptr,
                                    n_split, dx, partial, k_width, pos, slice_bytes, stream);
  }
  switch (arg_bits) {
    case 16:
      return launch<T, int16_t, false>(g, arg, table, order, t_dst, split_row, split_ptr,
                                       n_split, dx, partial, k_width, pos, slice_bytes,
                                       stream);
    case 32:
      return launch<T, int32_t, false>(g, arg, table, order, t_dst, split_row, split_ptr,
                                       n_split, dx, partial, k_width, pos, slice_bytes,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename ArgT, int V>
int launch_hub_v(const void* g, const void* arg, const rc::Table& table, const int* idx,
                 const int* ids, int hub_k, const int* split_row, const int* split_ptr,
                 int64_t n_split, void* dx, void* partial, int* tickets, int64_t n_tickets,
                 int64_t k_width, cudaStream_t stream) {
  if constexpr (V * sizeof(T) > 16 || V * sizeof(ArgT) > 16) {
    return cudaErrorInvalidValue;  // never chosen: vector_width caps V
  } else {
    constexpr int J = rc::vectors_per_lane<T, V>();
    if ((rc::hub_shifted<T, V>() && reinterpret_cast<uintptr_t>(g) % 4 != 0) ||
        (rc::hub_shifted<ArgT, V>() && reinterpret_cast<uintptr_t>(arg) % 4 != 0)) {
      return cudaErrorInvalidValue;  // the shifted rows' words need 4-byte rows
    }
    auto kernel = spmm_max_bwd_hub_kernel<T, ArgT, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, ArgT, V>(k_width, hub_k);
    dim3 grid, combine_grid;
    rc::HubWalk walk{};
    const int rc_setup =
        rc::hub_pipe_setup(kernel, smem, kHubWarps<T>, table.n_chunks, n_split, k_width, 32 * V * J,
                           n_tickets, &grid, &combine_grid, &walk);
    if (rc_setup != cudaSuccess) return rc_setup;
    walk.tma =
        rc::hub_route<T, V>(k_width, g) && rc::hub_route<ArgT, V>(k_width, arg) ? 1 : 0;
    kernel<<<grid, kHubThreads<T>, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const ArgT*>(arg), table, idx, ids, hub_k,
        static_cast<T*>(dx), static_cast<float*>(partial), tickets, k_width, walk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return err;
    spmm_max_bwd_combine_kernel<T><<<combine_grid, rc::kCombineThreads, 0, stream>>>(
        split_row, split_ptr, static_cast<const float*>(partial),
        static_cast<T*>(dx), k_width);
    return cudaGetLastError();
  }
}

// info[0], info[1]: the warps an SM holds of the hub kernel and of the
// kernel without the hub; info[2] the arena's stages, info[3] the hub
// blocks an SM holds, info[4] 1 where the fill takes the TMA route at this
// K (g's and the argmax's rows 16-byte multiples), 0 for cp.async: the
// route K gives 16-byte aligned tensors (a launch also checks its own).
template <typename T, typename ArgT, int V>
int hub_warps_v(int64_t k_width, int hub_k, int* info) {
  if constexpr (V * sizeof(T) > 16 || V * sizeof(ArgT) > 16) {
    return cudaErrorInvalidValue;
  } else {
    auto kernel = spmm_max_bwd_hub_kernel<T, ArgT, V>;
    const size_t smem = rc::kHubStages * hub_stage_bytes<T, ArgT, V>(k_width, hub_k);
    const int blocks = rc::pipe_blocks_per_sm(kernel, kHubThreads<T>, smem);
    info[0] = blocks < 0 ? -1 : blocks * kHubThreads<T> / 32;
    info[1] = rc::warps_per_sm(spmm_max_bwd_kernel<T, ArgT, V, false>, rc::kThreads);
    info[2] = rc::kHubStages;
    info[3] = blocks;
    info[4] =
        rc::hub_route<T, V>(k_width, nullptr) && rc::hub_route<ArgT, V>(k_width, nullptr) ? 1
                                                                                            : 0;
    return cudaSuccess;
  }
}

}  // namespace

// dtype: 0 = float32 (spmm_max_bwd_f32), 1 = bfloat16 (spmm_max_bwd_bf16).
// arg_bits: 16 or 32.  (chunk_row, chunk_ptr, chunk_slot, n_chunks,
// split_row, split_ptr, n_split) is the chunk table of the transpose CSR
// (t_indptr, t_dst).  partial is float32 scratch of (n_slots, k_width),
// unused when n_split is 0.  positional (arg_bits 16 only): arg holds
// ranks; mega_of (N_pad,) int32 (null: no mega rows), seg (n_mega,
// k_width) int16, rank_cap and t_rank (E,) int32 as in graph_format.Graph.
// order (n_chunks,) int32 is the transpose chunk table's launch order
// (RowChunks.order) and slice_bytes the K-slice's bytes of g (a power of
// two, 32 to 1,024; ops/spmm_kernels.py: slice_bytes): a slice that covers
// 32 lanes runs spmm_max_bwd_kernel, a narrower one
// spmm_max_bwd_group_kernel.  Returns the CUDA error code of the launches;
// cudaErrorInvalidValue for a grid that would not fit or a width not taken.
extern "C" int spmm_max_bwd(int dtype, int arg_bits, const void* g,
                            const void* arg, const void* chunk_row,
                            const void* chunk_ptr, const void* chunk_slot,
                            long long n_chunks, const void* t_dst,
                            const void* split_row, const void* split_ptr,
                            long long n_split, void* dx, void* partial,
                            long long k_width, int positional,
                            const void* mega_of, const void* seg, int rank_cap,
                            const void* t_rank, const void* order, int slice_bytes,
                            void* stream) {
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
  const PosArgs pos{static_cast<const int*>(t_rank), static_cast<const int*>(mega_of),
                    static_cast<const int16_t*>(seg), rank_cap};
  const auto* ord = static_cast<const int*>(order);
  return rc::with_dtype(dtype, [&](auto t) {
    return launch_arg<decltype(t)>(arg_bits, positional != 0, g, arg, table, ord, dp, sr,
                                   sp, n_split, dx, partial, k_width, pos, slice_bytes, st);
  });
}

// The hub instantiation of spmm_max_bwd (id-based argmax, 16 or 32 bits):
// the transpose chunk table and split rows as spmm_max_bwd's, idx the
// coded t_dst and ids its k slots' node ids (the transpose's
// graph_format.HubTable); tickets: n_tickets int32 zeros, at least one a
// K-slice, left zero (one buffer serves a stream's launches).  Returns the
// CUDA error code of the launches.
extern "C" int spmm_max_bwd_hub(int dtype, int arg_bits, const void* g, const void* arg,
                                const void* chunk_row, const void* chunk_ptr,
                                const void* chunk_slot, long long n_chunks,
                                const void* idx, const void* ids, int hub_k,
                                const void* split_row, const void* split_ptr,
                                long long n_split, void* dx, void* partial, void* tickets,
                                long long n_tickets, long long k_width, void* stream) {
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
      const int v = rc::vector_width(k_width, es > as ? es : as,
                                     {{g, es}, {arg, as}, {dx, es}, {partial, 4}});
      return rc::with_vector_width(v, [&](auto vw) {
        return launch_hub_v<T, ArgT, decltype(vw)::value>(
            g, arg, table, static_cast<const int*>(idx), static_cast<const int*>(ids), hub_k,
            static_cast<const int*>(split_row), static_cast<const int*>(split_ptr), n_split,
            dx, partial, static_cast<int*>(tickets), n_tickets, k_width,
            static_cast<cudaStream_t>(stream));
      });
    });
  });
}

// The warps an SM holds of spmm_max_bwd_hub's kernel (info[0]) and of the
// kernel without the hub (info[1]) at this dtype, argmax, K and k, as the
// card's occupancy calculator gives them, then the arena's stages, the hub
// blocks an SM holds and the fill route at this K (1 TMA, 0 cp.async;
// info holds 5 ints); launches nothing.
extern "C" int spmm_max_bwd_hub_warps(int dtype, int arg_bits, long long k_width, int hub_k,
                                      int* info) {
  return rc::with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return rc::with_arg_bits(arg_bits, [&](auto a) {
      using ArgT = decltype(a);
      constexpr int es = sizeof(T);
      constexpr int as = sizeof(ArgT);
      const int v = rc::vector_width(k_width, es > as ? es : as, {});
      return rc::with_vector_width(v, [&](auto vw) {
        return hub_warps_v<T, ArgT, decltype(vw)::value>(k_width, hub_k, info);
      });
    });
  });
}
