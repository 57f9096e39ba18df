// Fold-batched segment max with first-maximum argmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel plagnn_tpu/ops/pallas/spmm_kernels.py:
// _spmm_fwd_kernel with reduce="max" (driven by _run_spmm, reached from
// pallas_spmm_max's forward).
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
// Types: x/out float32 or bfloat16 (the bf16 max compares through
// __bfloat162float and stores the loaded value unchanged, so it is exact);
// arg int16 when the padded node count is <= 2^15, else int32, or not
// written at all (kWithArg = false, the primal of the custom VJP).
//
// What bounds it on this card: memory.  Without reuse each launch gathers
// E*K*esize bytes (one source row per edge) and writes N*K*(esize+argsize).
// At the slice's layer-1 shape (E ~ 724k, N 24,064, K = 10*503, f32) that
// is ~14.6 GB gathered, ~4.4 ms at 3.35 TB/s; the compulsory traffic (x
// read once) is ~30x less, and the 50 MB L2 serves the hot (hub) rows.
//
// Design: one thread per (destination row, k); a block is one row times a
// tile of 256 consecutive k, so a warp's loads of a source row are one
// coalesced 128-byte (f32) line, and the row's indices are a uniform
// (broadcast) load.  The loop over in-edges runs in ascending source order
// in one thread, which gives the first-max tie rule exactly, with no
// atomics and no cross-thread combine.  Limit of this simple design: a hub
// row (in-degree in the thousands on the power-law graph) runs serially in
// its blocks; splitting heavy rows is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

template <typename T, typename ArgT, bool kWithArg>
__global__ void __launch_bounds__(kThreads)
spmm_max_fwd_kernel(const T* __restrict__ x, const int* __restrict__ indptr,
                    const int* __restrict__ src, T* __restrict__ out,
                    ArgT* __restrict__ arg, int64_t k_width) {
  const int64_t row = blockIdx.x;
  const int64_t k = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (k >= k_width) return;
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  const int64_t o = row * k_width + k;
  if (beg == end) {
    out[o] = zero<T>();
    if (kWithArg) arg[o] = static_cast<ArgT>(-1);
    return;
  }
  int best_src = src[beg];
  T best = x[static_cast<int64_t>(best_src) * k_width + k];
  float best_f = to_f32(best);
#pragma unroll 4
  for (int e = beg + 1; e < end; ++e) {
    const int j = src[e];
    const T v = x[static_cast<int64_t>(j) * k_width + k];
    const float vf = to_f32(v);
    if (vf > best_f) {
      best_f = vf;
      best = v;
      best_src = j;
    }
  }
  out[o] = best;
  if (kWithArg) arg[o] = static_cast<ArgT>(best_src);
}

template <typename T>
int launch(int arg_bits, const void* x, const int* indptr, const int* src,
           void* out, void* arg, int64_t n_rows, int64_t k_width,
           cudaStream_t stream) {
  const int64_t tiles = (k_width + kThreads - 1) / kThreads;
  if (n_rows > 2147483647LL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(tiles));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (arg_bits) {
    case 0:
      spmm_max_fwd_kernel<T, int16_t, false><<<grid, kThreads, 0, stream>>>(
          xt, indptr, src, ot, nullptr, k_width);
      break;
    case 16:
      spmm_max_fwd_kernel<T, int16_t, true><<<grid, kThreads, 0, stream>>>(
          xt, indptr, src, ot, static_cast<int16_t*>(arg), k_width);
      break;
    case 32:
      spmm_max_fwd_kernel<T, int32_t, true><<<grid, kThreads, 0, stream>>>(
          xt, indptr, src, ot, static_cast<int32_t*>(arg), k_width);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  arg_bits: 0 (no argmax), 16 or 32.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int spmm_max_fwd(int dtype, int arg_bits, const void* x,
                            const void* indptr, const void* src, void* out,
                            void* arg, long long n_rows, long long k_width,
                            void* stream) {
  if (n_rows == 0 || k_width == 0) return cudaSuccess;
  const auto* ip = static_cast<const int*>(indptr);
  const auto* sp = static_cast<const int*>(src);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(arg_bits, x, ip, sp, out, arg, n_rows, k_width, st);
    case 1:
      return launch<__nv_bfloat16>(arg_bits, x, ip, sp, out, arg, n_rows,
                                   k_width, st);
    default:
      return cudaErrorInvalidValue;
  }
}
