// A compute-free gather probe for Hopper (sm_90a): randomly or sequentially
// addressed f32 rows fetched by TMA into a ring of shared-memory slots, and
// nothing else, so the time it takes is the card's service rate for such
// rows.
//
// Replaces benchmarks/dma_ceiling.py: _dma_kernel (its pallas_call in
// build_bench), the JAX package's DMA-ring probe: windows of T_E = 1,024
// int32 row ids through an SMEM double buffer, groups of G rows on an
// NG-deep ring of VMEM slots with one DMA semaphore a slot, no arithmetic,
// slot 0 written out at the end.
//
// The translation.  make_async_copy + a DMA semaphore a slot become bulk
// copies (cp.async.bulk ... mbarrier::complete_tx::bytes) with one mbarrier
// a slot that expects g x row_bytes bytes; the ids' DMA into SMEM becomes a
// 4 KB bulk copy into one half of a double buffer in shared memory, with
// an mbarrier a half.  The TPU's one sequential grid step becomes many
// blocks that take the windows in grid stride, each with a ring of its own,
// as many blocks an SM as shared memory allows.  Within a window the slot
// rule is the JAX kernel's: group gi (ids gi*g .. gi*g + g - 1) goes to
// slot gi % ng; the ring is warmed with the first ng groups; the block
// waits on a slot's barrier (with the slot's phase bit) before it issues
// into the slot again; every group is waited on before the window ends, so
// every slot is drained when the block leaves.  The block that owns the
// last window writes its slot 0 (g rows) to out.  A TMA copy always runs,
// where plain loads whose values go unused may be dropped by the compiler.
//
// What bounds it on this card.  Bytes: the rows fetched (n_fetch x
// row_bytes) through the memory system, of which the compulsory part is
// the distinct rows read once; a table that fits the 50 MB L2 is served
// from there after its first touch, so the measured rate is a service
// rate, not a share of the HBM's 3.35 TB/s.  Also the TMA units' request
// rate: one request a row, so narrow rows (256 B) may be bound by requests
// and not by bytes.
//
// Design.  One warp a block: lane 0 sets a slot's expected bytes, lanes
// 0 .. g - 1 issue one row each; all lanes wait on the barrier.  Shared
// memory: the ring (ng x g x row_bytes), the id double buffer (8 KB) and
// ng + 2 barriers, at most 227 KB.  g divides T_E; ng <= 64 (the phase bits
// ride one 64-bit register).  A launch runs min(windows, blocks an SM x
// SMs) blocks (dma_ring_blocks); the sweep fetches a whole number of such
// waves of windows, so every block takes as many windows as the others.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTE = 1024;     // ids a window (T_E)
constexpr int kMaxRing = 64;  // ring depth: one phase bit a slot in 64 bits
constexpr int kMaxGroup = 32;  // rows a slot: one lane issues each
constexpr int kThreads = 32;
constexpr int kSmemMax = 232448;
constexpr int kIdBytes = 2 * kTE * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also raises the barrier's expected bytes of this phase.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
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

__global__ void __launch_bounds__(kThreads)
dma_ring_kernel(const unsigned char* __restrict__ x, const int* __restrict__ idx,
                long long pitch, int row_bytes, int n_windows, int ng, int g,
                float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int slot_bytes = g * row_bytes;
  unsigned char* ring = smem;
  int* ids = reinterpret_cast<int*>(smem + static_cast<size_t>(ng) * slot_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ids + 2 * kTE);  // ng slots, then 2 id halves
  uint64_t* id_bars = bars + ng;
  const int lane = threadIdx.x;
  const int n_groups = kTE / g;

  if (lane == 0) {
    for (int s = 0; s < ng + 2; ++s) bar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  int w = blockIdx.x;
  if (w < n_windows && lane == 0) {
    bar_expect(&id_bars[0], kTE * 4);
    bulk_copy(ids, idx + static_cast<size_t>(w) * kTE, kTE * 4, &id_bars[0]);
  }
  uint64_t phase = 0;  // bit s: the parity of slot s's next completion
  for (int k = 0; w < n_windows; w += gridDim.x, ++k) {
    const int b = k & 1;
    bar_wait(&id_bars[b], (k >> 1) & 1);
    const int next = w + gridDim.x;
    if (next < n_windows && lane == 0) {
      // the other half's ids (window k - 1) were read into registers and
      // issued: order those reads before the async proxy rewrites the half
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_expect(&id_bars[b ^ 1], kTE * 4);
      bulk_copy(ids + (b ^ 1) * kTE, idx + static_cast<size_t>(next) * kTE, kTE * 4,
                &id_bars[b ^ 1]);
    }
    const int* win = ids + b * kTE;
    auto start_group = [&](int gi, int slot) {
      if (lane == 0) bar_expect(&bars[slot], static_cast<uint32_t>(slot_bytes));
      __syncwarp();
      if (lane < g) {
        const long long row = win[gi * g + lane];
        bulk_copy(ring + static_cast<size_t>(slot * g + lane) * row_bytes, x + row * pitch,
                  static_cast<uint32_t>(row_bytes), &bars[slot]);
      }
    };
    const int warm = ng < n_groups ? ng : n_groups;
    for (int gi = 0; gi < warm; ++gi) start_group(gi, gi);
    for (int gi = 0; gi < n_groups; ++gi) {
      const int slot = gi % ng;
      bar_wait(&bars[slot], static_cast<uint32_t>((phase >> slot) & 1));
      phase ^= 1ull << slot;
      if (gi + ng < n_groups) start_group(gi + ng, slot);
    }
  }

  // every group was waited on: slot 0 holds the last window's group
  // ((n_groups - 1) / ng) * ng in the block that took that window
  if (n_windows > 0 &&
      static_cast<int>(blockIdx.x) == (n_windows - 1) % static_cast<int>(gridDim.x)) {
    const int4* src = reinterpret_cast<const int4*>(ring);
    int4* dst = reinterpret_cast<int4*>(out);
    for (int i = lane; i < slot_bytes / 16; i += kThreads) dst[i] = src[i];
  }
}

}  // namespace

// The blocks a launch of (row_bytes, ng, g) runs at most: as many an SM as
// its shared memory allows (the occupancy calculator), times the SMs.
// Returns a cudaError_t.
static int ring_blocks(int row_bytes, int ng, int g, long long* blocks, int* smem_out) {
  const long long smem = static_cast<long long>(ng) * g * row_bytes + kIdBytes + 8LL * (ng + 2);
  if (row_bytes <= 0 || row_bytes % 16 || ng < 1 || ng > kMaxRing || g < 1 || g > kMaxGroup ||
      kTE % g || smem > kSmemMax) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dma_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dma_ring_kernel, kThreads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *smem_out = static_cast<int>(smem);
  return cudaSuccess;
}

extern "C" int dma_ring_blocks(int row_bytes, int ng, int g, long long* blocks) {
  int smem = 0;
  return ring_blocks(row_bytes, ng, g, blocks, &smem);
}

// x: f32 rows of row_bytes each, pitch bytes apart (both multiples of 16,
// x 16-byte aligned); idx: n_fetch int32 row ids (a multiple of T_E, 16-byte
// aligned, every id a row of x: the wrapper checks); out: g x row_bytes.
// Returns a cudaError_t: a refused shape, or the launch's own error.
extern "C" int dma_ring_f32(const void* x, const void* idx, long long pitch, int row_bytes,
                            long long n_fetch, int ng, int g, void* out, void* stream) {
  if (pitch < row_bytes || pitch % 16 || n_fetch <= 0 || n_fetch % kTE ||
      n_fetch / kTE > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  long long blocks = 0;
  int smem = 0;
  const int err = ring_blocks(row_bytes, ng, g, &blocks, &smem);
  if (err != cudaSuccess) return err;
  const long long n_windows = n_fetch / kTE;
  if (blocks > n_windows) blocks = n_windows;
  dma_ring_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int*>(idx), pitch, row_bytes,
      static_cast<int>(n_windows), ng, g, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
