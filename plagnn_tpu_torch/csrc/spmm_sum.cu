// Fold-batched segment sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel plagnn_tpu/ops/pallas/spmm_kernels.py:
// _spmm_fwd_kernel with reduce="sum" (driven by _run_spmm, reached from
// pallas_spmm_sum's forward and from its VJP over the transpose stream).
//
// Computes, for a CSR (indptr, idx) and x of shape (M, K) with K = B*F
// (fold batch times features, any K):
//   out[r, k] = sum over e in [indptr[r], indptr[r+1]) of x[idx[e], k]
// with 0 for empty rows.  The same kernel serves both directions of the
// segment sum: the forward over the destination-sorted CSR (indptr, src),
// and the VJP over the transpose CSR (t_indptr, t_dst), where
// dx[s] = sum over edges s -> n of g[n].
//
// Types: x/out float32 or bfloat16.  The sum is kept in float32 and
// rounded once at the store, as the TPU kernel's f32 accumulator does, so a
// bf16 result is the f32 sum rounded to bf16 once.  Each thread adds its
// row's edges in ascending edge order with no atomics, so the result is
// bit-identical run to run.
//
// What bounds it on this card: memory.  Without reuse each launch gathers
// E*K*esize bytes (one source row per edge) and writes M*K*esize.  At GCN2's
// layer-1 shape (E ~ 724k, M 24,064, K = 10*400, f32) that is ~11.6 GB
// gathered, ~3.5 ms at 3.35 TB/s; the compulsory traffic (x read once, out
// written once) is ~15x less, and the 50 MB L2 serves the hot (hub) rows.
//
// Design: the PR-1 design of the max kernels.  One thread per (row, k); a
// block is one row times a tile of 256 consecutive k, so a warp's loads of a
// source row are one coalesced 128-byte (f32) line and the row's indices are
// a uniform (broadcast) load.  Known limits of this simple design: a hub row
// (in-degree 10,505 on the synthetic PPI graph) runs serially in its
// blocks, and at narrow K (conv2 aggregates K = 10*12 = 120) a 256-thread
// tile is more than half idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_sum_kernel(const T* __restrict__ x, const int* __restrict__ indptr,
                const int* __restrict__ idx, T* __restrict__ out,
                int64_t k_width) {
  const int64_t row = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (k >= k_width) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    acc += to_f32(x[static_cast<int64_t>(idx[e]) * k_width + k]);
  }
  out[row * k_width + k] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const int* indptr, const int* idx, void* out,
           int64_t n_rows, int64_t k_width, cudaStream_t stream) {
  const int64_t tiles = (k_width + kThreads - 1) / kThreads;
  if (n_rows > 2147483647LL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(tiles));
  spmm_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), indptr, idx, static_cast<T*>(out), k_width);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (indptr, idx) is the CSR of the
// direction wanted: (indptr, src) forward, (t_indptr, t_dst) transpose.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int spmm_sum(int dtype, const void* x, const void* indptr,
                        const void* idx, void* out, long long n_rows,
                        long long k_width, void* stream) {
  if (n_rows == 0 || k_width == 0) return cudaSuccess;
  const auto* ip = static_cast<const int*>(indptr);
  const auto* ix = static_cast<const int*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, ip, ix, out, n_rows, k_width, st);
    case 1:
      return launch<__nv_bfloat16>(x, ip, ix, out, n_rows, k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
