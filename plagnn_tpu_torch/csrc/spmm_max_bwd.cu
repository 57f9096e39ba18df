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
// accumulated in float32 in ascending n; the bf16 variant upcasts each hit
// and rounds dx to bf16 once at the store.  arg is int16 (padded node count
// <= 2^15) or int32; empty arg rows hold -1 and never hit.
//
// What bounds it on this card: memory.  Without reuse each launch reads
// E*K*(esize + argsize) bytes (g and arg of every out-neighbour) and writes
// N*K*esize.  At the slice's layer-1 shape (E ~ 724k, K = 10*503, f32 g,
// int16 arg) that is ~21.9 GB, ~6.5 ms at 3.35 TB/s; the compulsory traffic
// (g and arg read once) is ~30x less.
//
// Design: a gather, not a scatter.  One thread per (source row s, k); a
// block is one row times 256 consecutive k (coalesced loads of g and arg
// rows, broadcast loads of t_dst).  Each thread sums its hits in a fixed
// order, so dx is deterministic run to run and the kernel uses no atomics.
// As in the forward, a row with many out-edges runs serially in its blocks.
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

template <typename T, typename ArgT>
__global__ void __launch_bounds__(kThreads)
spmm_max_bwd_kernel(const T* __restrict__ g, const ArgT* __restrict__ arg,
                    const int* __restrict__ t_indptr,
                    const int* __restrict__ t_dst, T* __restrict__ dx,
                    int64_t k_width) {
  const int s = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (k >= k_width) return;
  const int beg = t_indptr[s];
  const int end = t_indptr[s + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const int64_t o = static_cast<int64_t>(t_dst[e]) * k_width + k;
    if (static_cast<int>(arg[o]) == s) acc += to_f32(g[o]);
  }
  dx[static_cast<int64_t>(s) * k_width + k] = from_f32<T>(acc);
}

template <typename T>
int launch(int arg_bits, const void* g, const void* arg, const int* t_indptr,
           const int* t_dst, void* dx, int64_t n_rows, int64_t k_width,
           cudaStream_t stream) {
  const int64_t tiles = (k_width + kThreads - 1) / kThreads;
  if (n_rows > 2147483647LL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(tiles));
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  switch (arg_bits) {
    case 16:
      spmm_max_bwd_kernel<T, int16_t><<<grid, kThreads, 0, stream>>>(
          gt, static_cast<const int16_t*>(arg), t_indptr, t_dst, dt, k_width);
      break;
    case 32:
      spmm_max_bwd_kernel<T, int32_t><<<grid, kThreads, 0, stream>>>(
          gt, static_cast<const int32_t*>(arg), t_indptr, t_dst, dt, k_width);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (spmm_max_bwd_f32), 1 = bfloat16 (spmm_max_bwd_bf16).
// arg_bits: 16 or 32.  Returns the CUDA error code of the launch.
extern "C" int spmm_max_bwd(int dtype, int arg_bits, const void* g,
                            const void* arg, const void* t_indptr,
                            const void* t_dst, void* dx, long long n_rows,
                            long long k_width, void* stream) {
  if (n_rows == 0 || k_width == 0) return cudaSuccess;
  const auto* ip = static_cast<const int*>(t_indptr);
  const auto* dp = static_cast<const int*>(t_dst);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(arg_bits, g, arg, ip, dp, dx, n_rows, k_width, st);
    case 1:
      return launch<__nv_bfloat16>(arg_bits, g, arg, ip, dp, dx, n_rows,
                                   k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
