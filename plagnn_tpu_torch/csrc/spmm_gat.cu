// GAT's edge-softmax aggregation and its backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no attention GNN.  It was
// added for GAT (Velickovic et al., arXiv:1710.10903; DGL 0.8's GATConv),
// whose layer aggregates, for every destination row i and every (fold,
// head) group g of F columns,
//   z_ij  = el[j, g] + er[i, g]                    (j -> i an in-edge of i)
//   a_ij  = softmax over the row's in-edges of leaky_relu(z_ij, slope)
//   out[i, gF + f] = sum over in-edges of a_ij * wh[j, gF + f]
// with wh (N, K), K = B*H*F (the fold batch, heads and per-head width packed
// into one row, as the port's other aggregations pack them) and el, er
// (N, B*H).  A composition of PyTorch ops would materialise the (E, B*H)
// logits and an (E, K) gather: about 95 GB a layer at GAT's PPI widths and
// 32 folds.  These kernels keep both out of device memory.
//
// Forward (spmm_gat_fwd_kernel), on row_chunks.cuh's row chunks and
// K-slices: one warp per (chunk, K-slice) walks the chunk's in-edges in
// ascending edge order and keeps, for each group its lanes hold, an online
// softmax (the way FlashAttention walks keys): a running maximum m, a
// running sum s of exp(e - m) and the accumulator of exp(e - m) * wh[j]
// rescaled whenever m grows.  A whole row stores out = acc / s and the
// row's log-sum-exp lse = m + log s per group; a chunk of a split row stores
// its (m, s, acc) and spmm_gat_fwd_combine_kernel merges a row's triples in
// ascending chunk order.  No per-edge weight is stored.
//
// Backward, four steps over the saved (wh, el, er, lse) and the incoming
// gradient g (N, K):
// 1. spmm_gat_bwd_kernel, over the transpose CSR's chunks (row j, edges
//    j -> i): a_ij recomputed from el, er and lse;
//      dwh[j] = sum over out-edges of a_ij * g[i]     (K wide, a gather of g)
//      da_ij  = g[i] . wh[j] over each group's F columns
//    wh[j] is the row's own (loaded once), so da costs a dot product and a
//    reduction over the group's lanes, not a second gather.  da goes to an
//    (E, B*H) buffer in transpose-edge order.  Split rows: partials of dwh,
//    summed by spmm_gat_bwd_combine_kernel (combine_pass).
// 2. spmm_gat_bwd_der_kernel, over the destination CSR's chunks (row i),
//    B*H wide, a lane a group: D_i = sum_j a_ij da_ij (= g[i] . out[i]),
//    then dz_ij = leaky_relu'(z_ij) * a_ij * (da_ij - D_i) into the buffer
//    in place of da, and der[i] = sum_j dz_ij.  A split row takes two
//    launches: its chunks' partial D, then each chunk's dz from the row's
//    D; its der partials are summed by the combine.
// 3. spmm_gat_bwd_del_kernel, over the transpose CSR's chunks (row j):
//    del[j] = sum over out-edges of dz_ij, the buffer's rows in order.
// Every sum is taken in a fixed order and every output written by one
// thread: the results are bit-identical run to run.  (The buffer is the
// one per-edge array: 4 bytes an edge a group, 0.37 GB at 32 folds x 4
// heads on the 24k-node PPI graph.)
//
// What bounds it: the K-wide gathers, wh in the forward and g in step 1,
// E*K*4 bytes each (94.9 GB at K = 32,768 on 724,041 edges), served from
// L2 as the max and sum kernels serve theirs: the grid walks one 1 KB
// K-slice's rows at a time (24.6 MB at 24,064 rows).  The compulsory bytes
// (each input read once, each output written once) are about 12x less.
// The softmax adds a few instructions an edge and two scalar gathers (el,
// or er and lse) that all lanes of a group share.
//
// Lanes and groups.  A lane owns J vectors of V float32 elements (32 bytes,
// vectors_per_lane), V the widest of 4, 2, 1 dividing F.  Where F <= 32*V
// the warp's vector j covers `width` = (32*V / F) * F consecutive elements
// (whole groups; lanes past it idle) and a group is F / V consecutive
// lanes; the K-slice is J such blocks.  Where F = 32*V*J (F = 256 in
// float32: "span") the K-slice is one group.  Other widths are refused
// (ops/spmm_kernels.py: gat_layout says which).  A vector never straddles
// two groups, so each lane keeps one softmax state per vector (one in span).
#include "row_chunks.cuh"

#include <math_constants.h>

namespace {

namespace rc = row_chunks;

constexpr int kWarps = rc::kWarps;
constexpr int kThreads = rc::kThreads;
constexpr int kUnroll = rc::kUnroll;
constexpr unsigned kFull = rc::kFullMask;

__device__ __forceinline__ float leaky(float z, float slope) { return z > 0.0f ? z : slope * z; }

// The sum of v over this lane's segment of c lanes (c <= 32; segments start
// at lanes 0, c, 2c, ...), in the segment's first lane; every lane of the
// warp takes part.
__device__ __forceinline__ float segment_sum(float v, int lane, int c) {
  const int end = (lane / c + 1) * c;
  for (int off = 1; off < c; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += o;
  }
  return v;
}

// A lane's elements in its warp's K-slice: vector j at k[j] (inside K where
// act[j]), in group grp[j]; the group's first lane stores its per-group
// values (lead[j]).
template <int V, int J>
struct Lanes {
  int64_t k[J];
  int grp[J];
  bool act[J];
  bool lead[J];

  __device__ __forceinline__ Lanes(int lane, int64_t k_width, int f, int width, bool span) {
    const int64_t base = static_cast<int64_t>(blockIdx.y) * J * width;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      k[j] = base + j * width + lane * V;
      act[j] = lane * V < width && k[j] < k_width;
      grp[j] = act[j] ? static_cast<int>(k[j] / f) : 0;
      lead[j] = act[j] && (span ? (lane == 0 && j == 0) : (k[j] % f == 0));
    }
  }
};

// The walk of one chunk's edges [beg, end) (walk_chunk's: ids loaded 32 at
// a time and shuffled, kUnroll edges' loads issued before their adds), but
// with load and add called on every lane of the warp, so that add may
// shuffle: `load(u, nbr, e)` and `add(u)` for the kUnroll edges at a time,
// e the edge's index in the CSR.
template <typename Load, typename Add>
__device__ __forceinline__ void walk(const int* __restrict__ idx, int beg, int end, int lane,
                                     Load&& load, Add&& add) {
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    const int mine = lane < n ? __ldg(idx + base + lane) : 0;
    for (int j = 0; j < n; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int nbr = __shfl_sync(kFull, mine, j + u);
        if (j + u < n) load(u, nbr, base + j + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < n) add(u);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

// One warp per (chunk, K-slice); kSpan: the slice is one group (one softmax
// state a lane), else one state a vector.
template <int V, int J, bool kSpan>
__global__ void __launch_bounds__(kThreads)
spmm_gat_fwd_kernel(const float* __restrict__ wh, const float* __restrict__ el,
                    const float* __restrict__ er, rc::Table t, const int* __restrict__ idx,
                    float* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ partial, float* __restrict__ pm,
                    float* __restrict__ ps, int64_t k_width, int f, int bh, int width,
                    float slope) {
  constexpr int NG = kSpan ? 1 : J;  // softmax states a lane
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;  // the whole warp
  const Lanes<V, J> ln(lane, k_width, f, width, kSpan);
  const int row = __ldg(t.row + chunk);
  float er_i[NG], m[NG], s[NG];
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    er_i[q] = ln.act[q] ? __ldg(er + static_cast<int64_t>(row) * bh + ln.grp[q]) : 0.0f;
    m[q] = -CUDART_INF_F;
    s[q] = 0.0f;
  }
  float acc[V * J];
#pragma unroll
  for (int i = 0; i < V * J; ++i) acc[i] = 0.0f;
  rc::Vec<float, V> val[kUnroll][J];
  float el_j[kUnroll][NG];
  walk(idx, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane,
       [&](int u, int src, int) {
         const int64_t r = static_cast<int64_t>(src);
#pragma unroll
         for (int j = 0; j < J; ++j) {
           if (ln.act[j]) val[u][j] = rc::load_vec<float, V>(wh + r * k_width + ln.k[j]);
         }
#pragma unroll
         for (int q = 0; q < NG; ++q) {
           if (ln.act[q]) el_j[u][q] = __ldg(el + r * bh + ln.grp[q]);
         }
       },
       [&](int u) {
         float p[NG];
#pragma unroll
         for (int q = 0; q < NG; ++q) {
           p[q] = 0.0f;
           if (!ln.act[q]) continue;
           const float e = leaky(el_j[u][q] + er_i[q], slope);
           if (e > m[q]) {  // a new maximum: rescale the state's sums
             const float c = __expf(m[q] - e);
             s[q] *= c;
#pragma unroll
             for (int j = 0; j < J; ++j) {
               if (kSpan || j == q) {
#pragma unroll
                 for (int i = 0; i < V; ++i) acc[j * V + i] *= c;
               }
             }
             m[q] = e;
           }
           p[q] = __expf(e - m[q]);
           s[q] += p[q];
         }
#pragma unroll
         for (int j = 0; j < J; ++j) {
           if (!ln.act[j]) continue;
           const float pj = p[kSpan ? 0 : j];
#pragma unroll
           for (int i = 0; i < V; ++i) acc[j * V + i] = fmaf(pj, rc::get(val[u][j], i), acc[j * V + i]);
         }
       });
  const int slot = __ldg(t.slot + chunk);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!ln.act[j]) continue;
    const int q = kSpan ? 0 : j;
    if (slot < 0) {
      float v[V];
      const bool any = s[q] > 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = any ? acc[j * V + i] / s[q] : 0.0f;
      rc::store_vec<float, V>(out + static_cast<int64_t>(row) * k_width + ln.k[j], v);
      if (ln.lead[j]) {
        lse[static_cast<int64_t>(row) * bh + ln.grp[j]] = any ? m[q] + logf(s[q]) : -CUDART_INF_F;
      }
    } else {
      rc::store_vec<float, V>(partial + static_cast<int64_t>(slot) * k_width + ln.k[j],
                              acc + j * V);
      if (ln.lead[j]) {
        pm[static_cast<int64_t>(slot) * bh + ln.grp[j]] = m[q];
        ps[static_cast<int64_t>(slot) * bh + ln.grp[j]] = s[q];
      }
    }
  }
}

// A split row's (m, s, acc) triples merged in ascending chunk order, one
// thread per (split row, k): out = sum acc * exp(m - M) / sum s * exp(m - M),
// M the largest m; the group's first column stores lse = M + log S.
__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_gat_fwd_combine_kernel(const int* __restrict__ split_row, const int* __restrict__ split_ptr,
                            const float* __restrict__ partial, const float* __restrict__ pm,
                            const float* __restrict__ ps, float* __restrict__ out,
                            float* __restrict__ lse, int64_t k_width, int f, int bh) {
  const int i = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * rc::kCombineThreads + threadIdx.x;
  if (k >= k_width) return;
  const int g = static_cast<int>(k / f);
  const int s0 = __ldg(split_ptr + i), s1 = __ldg(split_ptr + i + 1);
  float big = -CUDART_INF_F;
  for (int s = s0; s < s1; ++s) big = fmaxf(big, __ldg(pm + static_cast<int64_t>(s) * bh + g));
  float sum = 0.0f, acc = 0.0f;
  for (int s = s0; s < s1; ++s) {
    const float ms = __ldg(pm + static_cast<int64_t>(s) * bh + g);
    const float w = ms == -CUDART_INF_F ? 0.0f : __expf(ms - big);
    sum = fmaf(__ldg(ps + static_cast<int64_t>(s) * bh + g), w, sum);
    acc = fmaf(__ldg(partial + static_cast<int64_t>(s) * k_width + k), w, acc);
  }
  const int row = __ldg(split_row + i);
  out[static_cast<int64_t>(row) * k_width + k] = sum > 0.0f ? acc / sum : 0.0f;
  if (k % f == 0) lse[static_cast<int64_t>(row) * bh + g] = sum > 0.0f ? big + logf(sum) : -CUDART_INF_F;
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// Step 1: one warp per (transpose chunk, K-slice), row j: dwh[j] and each
// out-edge's da into `dalpha` (E, bh) at the edge's transpose position.
template <int V, int J, bool kSpan>
__global__ void __launch_bounds__(kThreads)
spmm_gat_bwd_kernel(const float* __restrict__ g, const float* __restrict__ wh,
                    const float* __restrict__ el, const float* __restrict__ er,
                    const float* __restrict__ lse, rc::Table t, const int* __restrict__ idx,
                    float* __restrict__ dwh, float* __restrict__ partial,
                    float* __restrict__ dalpha, int64_t k_width, int f, int bh, int width,
                    float slope) {
  constexpr int NG = kSpan ? 1 : J;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;
  const Lanes<V, J> ln(lane, k_width, f, width, kSpan);
  const int c = kSpan ? 32 : f / V;  // lanes a group
  const int row = __ldg(t.row + chunk);
  const int64_t r0 = static_cast<int64_t>(row);
  rc::Vec<float, V> own[J];
  float el_j[NG];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (ln.act[j]) own[j] = rc::load_vec<float, V>(wh + r0 * k_width + ln.k[j]);
  }
#pragma unroll
  for (int q = 0; q < NG; ++q) el_j[q] = ln.act[q] ? __ldg(el + r0 * bh + ln.grp[q]) : 0.0f;
  float acc[V * J];
#pragma unroll
  for (int i = 0; i < V * J; ++i) acc[i] = 0.0f;
  rc::Vec<float, V> val[kUnroll][J];
  float er_i[kUnroll][NG], lse_i[kUnroll][NG];
  int edge[kUnroll];
  walk(idx, __ldg(t.ptr + chunk), __ldg(t.ptr + chunk + 1), lane,
       [&](int u, int dst, int e) {
         const int64_t r = static_cast<int64_t>(dst);
         edge[u] = e;
#pragma unroll
         for (int j = 0; j < J; ++j) {
           if (ln.act[j]) val[u][j] = rc::load_vec<float, V>(g + r * k_width + ln.k[j]);
         }
#pragma unroll
         for (int q = 0; q < NG; ++q) {
           if (ln.act[q]) {
             er_i[u][q] = __ldg(er + r * bh + ln.grp[q]);
             lse_i[u][q] = __ldg(lse + r * bh + ln.grp[q]);
           }
         }
       },
       [&](int u) {
         float a[NG], d[J];
#pragma unroll
         for (int q = 0; q < NG; ++q) {
           a[q] = ln.act[q] ? __expf(leaky(el_j[q] + er_i[u][q], slope) - lse_i[u][q]) : 0.0f;
         }
#pragma unroll
         for (int j = 0; j < J; ++j) {
           d[j] = 0.0f;
           if (!ln.act[j]) continue;
           const float aj = a[kSpan ? 0 : j];
#pragma unroll
           for (int i = 0; i < V; ++i) {
             const float gv = rc::get(val[u][j], i);
             acc[j * V + i] = fmaf(aj, gv, acc[j * V + i]);
             d[j] = fmaf(gv, rc::get(own[j], i), d[j]);
           }
         }
         float* out_e = dalpha + static_cast<int64_t>(edge[u]) * bh;
         if constexpr (kSpan) {
           float sum = 0.0f;
#pragma unroll
           for (int j = 0; j < J; ++j) sum += d[j];
           sum = segment_sum(sum, lane, 32);
           if (ln.lead[0]) out_e[ln.grp[0]] = sum;
         } else {
#pragma unroll
           for (int j = 0; j < J; ++j) {
             const float sum = segment_sum(d[j], lane, c);
             if (ln.lead[j]) out_e[ln.grp[j]] = sum;
           }
         }
       });
  const int slot = __ldg(t.slot + chunk);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!ln.act[j]) continue;
    float* dst = slot < 0 ? dwh + r0 * k_width : partial + static_cast<int64_t>(slot) * k_width;
    rc::store_vec<float, V>(dst + ln.k[j], acc + j * V);
  }
}

__global__ void __launch_bounds__(rc::kCombineThreads)
spmm_gat_bwd_combine_kernel(const int* __restrict__ split_row, const int* __restrict__ split_ptr,
                            const float* __restrict__ partial, float* __restrict__ out,
                            int64_t k_width) {
  rc::combine_pass<float>(split_row, split_ptr, partial, out, k_width);
}

// The edges [beg, end) of a chunk, kUnroll at a time: use(u, nbr, e) after
// load(u, nbr, e) for each, the ids of `idx` and `pos` (null: e itself)
// loaded 32 at a time and shuffled.  Lanes that own no group still take
// part in the shuffles.
template <typename Load, typename Use>
__device__ __forceinline__ void walk_pos(const int* __restrict__ idx, const int* __restrict__ pos,
                                         int beg, int end, int lane, Load&& load, Use&& use) {
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    const int mine = lane < n ? __ldg(idx + base + lane) : 0;
    const int mine_p = lane < n ? (pos != nullptr ? __ldg(pos + base + lane) : base + lane) : 0;
    for (int j = 0; j < n; j += kUnroll) {
      int nbr[kUnroll], p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        nbr[u] = __shfl_sync(kFull, mine, j + u);
        p[u] = __shfl_sync(kFull, mine_p, j + u);
        if (j + u < n) load(u, nbr[u], p[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < n) use(u, nbr[u], p[u]);
      }
    }
  }
}

// Step 2: one warp per (destination chunk, 32 groups), a lane a group.
// phase 0: a whole row's D, dz and der; a split row's chunk only its part
// of D (pd).  phase 1 (split rows' chunks only): D from the row's parts,
// then the chunk's dz and its part of der (pder).
__global__ void __launch_bounds__(kThreads)
spmm_gat_bwd_der_kernel(const float* __restrict__ el, const float* __restrict__ er,
                        const float* __restrict__ lse, rc::Table t, const int* __restrict__ src,
                        const int* __restrict__ f2t, const int* __restrict__ split_row,
                        const int* __restrict__ split_ptr, int n_split,
                        float* __restrict__ buf, float* __restrict__ der,
                        float* __restrict__ pd, float* __restrict__ pder, int bh, float slope,
                        int phase) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;
  const int slot = __ldg(t.slot + chunk);
  if (phase == 1 && slot < 0) return;
  const int grp = blockIdx.y * 32 + lane;
  const bool act = grp < bh;
  const int row = __ldg(t.row + chunk);
  const int64_t ri = static_cast<int64_t>(row) * bh + grp;
  const float er_i = act ? __ldg(er + ri) : 0.0f;
  const float lse_i = act ? __ldg(lse + ri) : 0.0f;
  const int beg = __ldg(t.ptr + chunk), end = __ldg(t.ptr + chunk + 1);
  float z[kUnroll], da[kUnroll];
  auto load = [&](int u, int j, int p) {
    if (!act) return;
    z[u] = __ldg(el + static_cast<int64_t>(j) * bh + grp) + er_i;
    da[u] = buf[static_cast<int64_t>(p) * bh + grp];
  };
  float dd = 0.0f;
  if (phase == 0) {
    walk_pos(src, f2t, beg, end, lane, load, [&](int u, int, int) {
      if (act) dd = fmaf(__expf(leaky(z[u], slope) - lse_i), da[u], dd);
    });
    if (slot >= 0) {
      if (act) pd[static_cast<int64_t>(slot) * bh + grp] = dd;
      return;
    }
  } else {
    int lo = 0, hi = n_split - 1;  // the row's place among the split rows
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (__ldg(split_row + mid) < row) lo = mid + 1; else hi = mid;
    }
    for (int s = __ldg(split_ptr + lo); s < __ldg(split_ptr + lo + 1); ++s) {
      if (act) dd += pd[static_cast<int64_t>(s) * bh + grp];
    }
  }
  float sum = 0.0f;
  walk_pos(src, f2t, beg, end, lane, load, [&](int u, int, int p) {
    if (!act) return;
    const float a = __expf(leaky(z[u], slope) - lse_i);
    const float de = a * (da[u] - dd);
    const float dz = z[u] > 0.0f ? de : slope * de;
    buf[static_cast<int64_t>(p) * bh + grp] = dz;
    sum += dz;
  });
  if (!act) return;
  if (slot < 0) {
    der[ri] = sum;
  } else {
    pder[static_cast<int64_t>(slot) * bh + grp] = sum;
  }
}

// Step 3: one warp per (transpose chunk, 32 groups): del[j] = the sum of the
// buffer's rows of j's out-edges, in order; a split row's parts in pdel.
__global__ void __launch_bounds__(kThreads)
spmm_gat_bwd_del_kernel(rc::Table t, const float* __restrict__ buf, float* __restrict__ del,
                        float* __restrict__ pdel, int bh) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= t.n_chunks) return;
  const int grp = blockIdx.y * 32 + lane;
  if (grp >= bh) return;
  const int beg = __ldg(t.ptr + chunk), end = __ldg(t.ptr + chunk + 1);
  float sum = 0.0f;
  int e = beg;
  for (; e + kUnroll <= end; e += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = buf[static_cast<int64_t>(e + u) * bh + grp];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sum += v[u];
  }
  for (; e < end; ++e) sum += buf[static_cast<int64_t>(e) * bh + grp];
  const int slot = __ldg(t.slot + chunk);
  if (slot < 0) {
    del[static_cast<int64_t>(__ldg(t.row + chunk)) * bh + grp] = sum;
  } else {
    pdel[static_cast<int64_t>(slot) * bh + grp] = sum;
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// The lane layout at per-group width f: (V, block width, span), V the
// widest of 4, 2, 1 dividing f that the pointers' alignment allows; false
// where f takes none (f <= 32*V or f = 32*V*J = 256).
inline bool layout(int64_t k_width, int f, std::initializer_list<std::pair<const void*, int>> ptrs,
                   int* v, int* width, bool* span) {
  if (f < 1 || k_width % f != 0) return false;
  int vv = rc::vector_width(k_width, 4, ptrs);
  while (vv > 1 && f % vv != 0) vv /= 2;
  if (vv > 4) vv = 4;
  const int j = 32 / (vv * 4) > 8 ? 8 : 32 / (vv * 4);
  *v = vv;
  if (f <= 32 * vv) {
    *width = (32 * vv / f) * f;
    *span = false;
    return true;
  }
  *width = 32 * vv;
  *span = true;
  return f == 32 * vv * j;
}

inline rc::Table table(const void* row, const void* ptr, const void* slot, long long n) {
  return rc::Table{static_cast<const int*>(row), static_cast<const int*>(ptr),
                   static_cast<const int*>(slot), static_cast<int>(n)};
}

template <typename F>
inline int with_layout(int v, bool span, F&& fn) {
  return rc::with_vector_width(v, [&](auto vw) {
    constexpr int V = decltype(vw)::value;
    if constexpr (V > 4) {
      return static_cast<int>(cudaErrorInvalidValue);  // never chosen: layout caps V at 4
    } else {
      constexpr int J = rc::vectors_per_lane<float, V>();
      return span ? fn(std::integral_constant<int, V>{}, std::integral_constant<int, J>{},
                       std::true_type{})
                  : fn(std::integral_constant<int, V>{}, std::integral_constant<int, J>{},
                       std::false_type{});
    }
  });
}

}  // namespace

// The forward.  (chunk_row, chunk_ptr, chunk_slot, n_chunks, split_row,
// split_ptr, n_split) is the destination CSR's chunk table and src its
// column ids; wh, out (N, k_width), el, er, lse (N, k_width / f) float32;
// partial float32 (n_slots, k_width), pm and ps (n_slots, k_width / f),
// unused where n_split is 0.  Returns the CUDA error code of the launches
// (0 = launched); cudaErrorInvalidValue for a width f the layout takes not
// or a grid that would not fit.
extern "C" int spmm_gat_fwd(const void* wh, const void* el, const void* er,
                            const void* chunk_row, const void* chunk_ptr, const void* chunk_slot,
                            long long n_chunks, const void* src, const void* split_row,
                            const void* split_ptr, long long n_split, void* out, void* lse,
                            void* partial, void* pm, void* ps, long long k_width, int f,
                            float slope, void* stream) {
  if (n_chunks == 0 || k_width == 0) return cudaSuccess;
  if (n_chunks > 2147483647LL) return cudaErrorInvalidValue;
  int v = 1, width = 0;
  bool span = false;
  if (!layout(k_width, f, {{wh, 4}, {out, 4}, {partial, 4}}, &v, &width, &span)) {
    return cudaErrorInvalidValue;
  }
  const int bh = static_cast<int>(k_width / f);
  const rc::Table t = table(chunk_row, chunk_ptr, chunk_slot, n_chunks);
  auto st = static_cast<cudaStream_t>(stream);
  return with_layout(v, span, [&](auto vw, auto jw, auto sp) {
    constexpr int V = decltype(vw)::value, J = decltype(jw)::value;
    constexpr bool kSpan = decltype(sp)::value;
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(n_chunks, n_split, k_width, J * width, &grid, &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_gat_fwd_kernel<V, J, kSpan><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(wh), static_cast<const float*>(el),
        static_cast<const float*>(er), t, static_cast<const int*>(src),
        static_cast<float*>(out), static_cast<float*>(lse), static_cast<float*>(partial),
        static_cast<float*>(pm), static_cast<float*>(ps), k_width, f, bh, width, slope);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 0) return static_cast<int>(err);
    spmm_gat_fwd_combine_kernel<<<combine_grid, rc::kCombineThreads, 0, st>>>(
        static_cast<const int*>(split_row), static_cast<const int*>(split_ptr),
        static_cast<const float*>(partial), static_cast<const float*>(pm),
        static_cast<const float*>(ps), static_cast<float*>(out), static_cast<float*>(lse),
        k_width, f, bh);
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward's three steps.  The transpose CSR's chunk table (t_*) with
// its column ids t_dst, the destination CSR's (f_*) with src and f2t (each
// destination-order edge's position in transpose order); g, wh, dwh
// (N, k_width), el, er, lse, del, der (N, k_width / f); dalpha (E,
// k_width / f) scratch; partial (t slots, k_width), pdel (t slots, bh), pd
// and pder (f slots, bh) scratch for split rows.  Returns the CUDA error
// code of the launches.
extern "C" int spmm_gat_bwd(const void* g, const void* wh, const void* el, const void* er,
                            const void* lse, const void* t_row, const void* t_ptr,
                            const void* t_slot, long long t_chunks, const void* t_dst,
                            const void* t_split_row, const void* t_split_ptr,
                            long long t_split, const void* f_row, const void* f_ptr,
                            const void* f_slot, long long f_chunks, const void* src,
                            const void* f2t, const void* f_split_row, const void* f_split_ptr,
                            long long f_split, void* dwh, void* del, void* der, void* dalpha,
                            void* partial, void* pdel, void* pd, void* pder, long long k_width,
                            int f, float slope, void* stream) {
  if (t_chunks == 0 || f_chunks == 0 || k_width == 0) return cudaSuccess;
  if (t_chunks > 2147483647LL || f_chunks > 2147483647LL) return cudaErrorInvalidValue;
  int v = 1, width = 0;
  bool span = false;
  if (!layout(k_width, f, {{g, 4}, {wh, 4}, {dwh, 4}, {partial, 4}}, &v, &width, &span)) {
    return cudaErrorInvalidValue;
  }
  const int bh = static_cast<int>(k_width / f);
  const rc::Table tt = table(t_row, t_ptr, t_slot, t_chunks);
  const rc::Table ft = table(f_row, f_ptr, f_slot, f_chunks);
  auto st = static_cast<cudaStream_t>(stream);
  auto* buf = static_cast<float*>(dalpha);
  const int rc1 = with_layout(v, span, [&](auto vw, auto jw, auto sp) {
    constexpr int V = decltype(vw)::value, J = decltype(jw)::value;
    constexpr bool kSpan = decltype(sp)::value;
    dim3 grid, combine_grid;
    const int rc_grid = rc::grids(t_chunks, t_split, k_width, J * width, &grid, &combine_grid);
    if (rc_grid != cudaSuccess) return rc_grid;
    spmm_gat_bwd_kernel<V, J, kSpan><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(wh),
        static_cast<const float*>(el), static_cast<const float*>(er),
        static_cast<const float*>(lse), tt, static_cast<const int*>(t_dst),
        static_cast<float*>(dwh), static_cast<float*>(partial), buf, k_width, f, bh, width,
        slope);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || t_split == 0) return static_cast<int>(err);
    spmm_gat_bwd_combine_kernel<<<combine_grid, rc::kCombineThreads, 0, st>>>(
        static_cast<const int*>(t_split_row), static_cast<const int*>(t_split_ptr),
        static_cast<const float*>(partial), static_cast<float*>(dwh), k_width);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc1 != cudaSuccess) return rc1;
  // Steps 2 and 3, bh wide: (chunks, 32-group tiles); their combines.
  dim3 narrow_f, narrow_t, combine_f, combine_t;
  if (rc::grids(f_chunks, f_split, bh, 32, &narrow_f, &combine_f) != cudaSuccess ||
      rc::grids(t_chunks, t_split, bh, 32, &narrow_t, &combine_t) != cudaSuccess) {
    return cudaErrorInvalidValue;
  }
  const auto* src_i = static_cast<const int*>(src);
  const auto* f2t_i = static_cast<const int*>(f2t);
  const auto* fsr = static_cast<const int*>(f_split_row);
  const auto* fsp = static_cast<const int*>(f_split_ptr);
  for (int phase = 0; phase < (f_split > 0 ? 2 : 1); ++phase) {
    spmm_gat_bwd_der_kernel<<<narrow_f, kThreads, 0, st>>>(
        static_cast<const float*>(el), static_cast<const float*>(er),
        static_cast<const float*>(lse), ft, src_i, f2t_i, fsr, fsp, static_cast<int>(f_split),
        buf, static_cast<float*>(der), static_cast<float*>(pd), static_cast<float*>(pder), bh,
        slope, phase);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (f_split > 0) {
    spmm_gat_bwd_combine_kernel<<<combine_f, rc::kCombineThreads, 0, st>>>(
        fsr, fsp, static_cast<const float*>(pder), static_cast<float*>(der), bh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  spmm_gat_bwd_del_kernel<<<narrow_t, kThreads, 0, st>>>(tt, buf, static_cast<float*>(del),
                                                         static_cast<float*>(pdel), bh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || t_split == 0) return err;
  spmm_gat_bwd_combine_kernel<<<combine_t, rc::kCombineThreads, 0, st>>>(
      static_cast<const int*>(t_split_row), static_cast<const int*>(t_split_ptr),
      static_cast<const float*>(pdel), static_cast<float*>(del), bh);
  return cudaGetLastError();
}
