// The two CUDA kernels of the detailed-mode path, with a plain C interface
// for ctypes (nice_tpu_torch/ops/cuda_build.py builds this file with nvcc
// for sm_90a; ops/cuda_engine.py wraps it).
//
// K1 detailed_megaloop_kernel replaces the TPU's detailed stats kernel:
// nice_tpu/ops/pallas_engine.py _stats_callable (pallas_call at :181, body
// _make_kernel mode "detailed") under _detailed_megaloop_callable's
// lax.scan. One thread per candidate in a grid-stride loop over the whole
// segment replaces both the scan and the sequential Pallas grid; each block
// builds a histogram of base+2 bins in shared memory and flushes it with one
// global atomic per bin into the caller's accumulator, which is updated in
// place (this replaces JAX's donated buffer). The near-miss count is reduced
// per warp, then per block, then added with one global atomic. Padding
// lanes (the segment's lanes past valid_total) are not computed: their
// count goes into bin 0 once, which is what the JAX megaloop's masked lanes
// add there.
//
// K2 uniques_kernel replaces the TPU's per-lane uniques kernel:
// pallas_engine.py _uniques_callable (pallas_call at :466): num_uniques of
// every lane of a batch, one int32 per lane. The survivor compaction after
// it stays plain tensor code, as it stayed outside the pallas_call in JAX.
//
// What bounds them on an H100: both take no input but a few start limbs and
// write little (K1: base+2 bins; K2: 4 bytes a lane), so they are bound by
// integer operations — wide multiplies for n^2 and n^3 and the
// multiply-high divisions of the digit extraction. The design keeps every
// intermediate of the small tier in registers, replaces each division by a
// multiply-high with a host-computed reciprocal, and keeps atomics off the
// global histogram except for one flush per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nice_kernels.cuh"

namespace nice {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <class L>
__global__ void __launch_bounds__(kThreads)
detailed_megaloop_kernel(const int64_t* __restrict__ start, int64_t valid_total,
                         int64_t pad, Plan p, int32_t* __restrict__ hist,
                         int32_t* __restrict__ nm_out) {
  extern __shared__ int32_t sh[];  // bins 0..base+1, then the near-miss count
  const int nb = (int)p.base + 2;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  int nm = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < valid_total; g += stride) {
    const int u = L::uniques(start, (uint64_t)g, p);
    if (u < nb) atomicAdd(&sh[u], 1);  // bins past base+1 are dropped, as in JAX
    nm += u > p.cutoff;
  }
  nm = __reduce_add_sync(0xffffffffu, nm);
  if ((threadIdx.x & 31) == 0 && nm) atomicAdd(&sh[nb], nm);
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
  }
  if (threadIdx.x == 0) {
    if (sh[nb]) atomicAdd(nm_out, sh[nb]);
    if (blockIdx.x == 0 && pad) atomicAdd(&hist[0], (int32_t)pad);
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads)
uniques_kernel(const int64_t* __restrict__ start, int64_t lanes, Plan p,
               int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < lanes;
       g += stride) {
    out[g] = L::uniques(start, (uint64_t)g, p);
  }
}

// Enough blocks to fill every SM, capped so the grid-stride loop (and not a
// huge grid) covers large segments.
static int grid_for(int64_t lanes) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (lanes + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

template <class L>
static void launch_megaloop(const Plan& p, const int64_t* start,
                            int64_t valid_total, int64_t pad, int32_t* hist,
                            int32_t* nm, cudaStream_t s) {
  const size_t smem = (size_t)(p.base + 3) * sizeof(int32_t);
  detailed_megaloop_kernel<L><<<grid_for(valid_total), kThreads, smem, s>>>(
      start, valid_total, pad, p, hist, nm);
}

template <class L>
static void launch_uniques(const Plan& p, const int64_t* start, int64_t lanes,
                           int32_t* out, cudaStream_t s) {
  uniques_kernel<L><<<grid_for(lanes), kThreads, 0, s>>>(start, lanes, p, out);
}

}  // namespace nice

// Return codes: 0 on success, a cudaError_t from cudaGetLastError() after
// the launch, or -1 when no tier holds the plan.
extern "C" {

int nice_detailed_megaloop(const uint64_t* plan_words, const void* start,
                           long long valid_total, long long pad, void* hist,
                           void* nm, void* stream) {
  using namespace nice;
  const Plan p = plan_from_words(plan_words);
  const int64_t* st = (const int64_t*)start;
  int32_t* h = (int32_t*)hist;
  int32_t* n = (int32_t*)nm;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_tier(p)) {
    case 0: launch_megaloop<SmallTier>(p, st, valid_total, pad, h, n, s); break;
    case 1: launch_megaloop<GenericTier>(p, st, valid_total, pad, h, n, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

int nice_uniques(const uint64_t* plan_words, const void* start,
                 long long lanes, void* out, void* stream) {
  using namespace nice;
  const Plan p = plan_from_words(plan_words);
  const int64_t* st = (const int64_t*)start;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_tier(p)) {
    case 0: launch_uniques<SmallTier>(p, st, lanes, o, s); break;
    case 1: launch_uniques<GenericTier>(p, st, lanes, o, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

const char* nice_error_string(int code) {
  if (code == -1) return "plan exceeds every kernel tier";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
