// The four CUDA kernels of the port, with a plain C interface for ctypes
// (nice_tpu_torch/ops/cuda_build.py builds this file with nvcc for sm_90a;
// ops/cuda_engine.py wraps it): K1 and K2 on the detailed path, K3 on the
// strided niceonly path (bases of at most 4 u32 limbs), K4 on the dense
// niceonly path (b98 and up).
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
// K3 strided_niceonly_kernel replaces the TPU's stride-descriptor niceonly
// kernel: pallas_engine.py _strided_callable (pallas_call at :410, body
// _make_strided_kernel). Each descriptor row (n0, lo, hi as four u32 limbs)
// covers candidates n = n0 + (i / R) * M + residues[i % R], i < periods * R,
// and the kernel counts those with lo <= n < hi and num_uniques(n) == base
// (or, for a check, min_uniques <= num_uniques(n) <= base).
// The TPU expanded the offsets on the host into a VMEM table and walked the
// descriptors as a sequential grid axis, skipping padded rows with
// pl.when(d < n_real); here the grid is (lane chunks, n_real): only real
// rows are launched, each thread derives its candidate's offset from the
// residue table (R u32 words, resident in L1) with one u32 division, and
// each block reduces its count per warp, then across warps, and adds it to
// counts[row] with one atomic.
//
// K4 niceonly_dense_kernel replaces the TPU's dense niceonly kernel in both
// of its modes: pallas_engine.py _stats_callable (pallas_call at :181) with
// _make_kernel modes "niceonly" (:155-158, count of lanes with num_uniques ==
// base) and "niceonly-fused" (:143-154, the residue congruence first, and
// pruned = valid lanes that fail it), and the jnp megaloops the single-device
// JAX engine runs in their place (nice_tpu/ops/vector_engine.py
// niceonly_dense_megaloop :586 and niceonly_filtered_megaloop :608). The TPU
// evaluated the congruence on every lane of the dense batch and masked; at
// b98 it keeps 2 residue classes of 97, so one thread per dense lane would
// leave about half the warps running the full digit work for one or two
// live lanes. Here a thread derives a kept lane by index arithmetic, as K3
// derives its offsets: lane j is class classes[j % R] of period j / R, the
// run offset ((classes[j % R] - start) mod (b - 1)) + (j / R) * (b - 1), so
// the grid covers R * ceil(valid_total / (b - 1)) lanes, each a candidate
// but for the ragged last period (masked by i < valid_total). The unfused
// mode is the same kernel given all b - 1 classes. Each block reduces its
// nice count and its kept count per warp, then across warps, and flushes
// them with one atomic each: out[0] += nice, out[1] += -kept (block 0 adds
// valid_total), so out[1] ends as pruned.
//
// What bounds them on an H100: they take no input but a few start limbs (K3:
// 96 bytes a descriptor and the residue table; K4: the class table) and
// write little (K1: base+2 bins; K2: 4 bytes a lane; K3: 4 bytes a
// descriptor; K4: 8 bytes), so they are bound by integer operations — wide
// multiplies for n^2 and n^3 and the multiply-high divisions of the digit
// extraction. The design keeps every intermediate of the small tier in
// registers, replaces each division by a multiply-high with a host-computed
// reciprocal, keeps atomics off the global outputs except for one flush per
// block, and (K4) spends no lane on a candidate the congruence excludes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nice_kernels.cuh"

namespace nice {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kDescWidth = 12;  // int64 words of a stride descriptor row

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

template <class L>
__global__ void __launch_bounds__(kThreads)
strided_niceonly_kernel(const int64_t* __restrict__ desc,
                        const int64_t* __restrict__ residues, uint32_t num_res,
                        uint32_t modulus, int64_t lanes, int min_u, Plan p,
                        int32_t* __restrict__ counts) {
  __shared__ int32_t warp_sums[kThreads / 32];
  const int64_t* row = desc + (int64_t)blockIdx.y * kDescWidth;
  int c = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    c += L::strided_nice(row, residues, num_res, modulus, (uint32_t)i, min_u,
                         p);
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(&counts[blockIdx.y], s);
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads)
niceonly_dense_kernel(const int64_t* __restrict__ start,
                      const int64_t* __restrict__ classes, uint32_t num_cls,
                      uint32_t lanes, uint32_t valid_total, int min_u, Plan p,
                      int32_t* __restrict__ out) {
  __shared__ int32_t warp_sums[2][kThreads / 32];
  const uint32_t s = L::start_residue(start, p);
  int c = 0, kept = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < lanes;
       j += stride) {
    c += L::dense_nice(start, classes, num_cls, s, j, valid_total, min_u, p,
                       &kept);
  }
  c = __reduce_add_sync(0xffffffffu, c);
  kept = __reduce_add_sync(0xffffffffu, kept);
  if ((threadIdx.x & 31) == 0) {
    warp_sums[0][threadIdx.x >> 5] = c;
    warp_sums[1][threadIdx.x >> 5] = kept;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sc = 0, sk = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      sc += warp_sums[0][w];
      sk += warp_sums[1][w];
    }
    if (blockIdx.x == 0) sk -= (int)valid_total;
    if (sc) atomicAdd(&out[0], sc);
    if (sk) atomicAdd(&out[1], -sk);
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

// One block per kThreads lanes of a descriptor (lanes <= 2^20, so at most
// 4096), times the n_real real descriptors (<= 1024) on the grid's y axis.
template <class L>
static void launch_strided(const Plan& p, const int64_t* desc, int n_real,
                           const int64_t* residues, uint32_t num_res,
                           uint32_t modulus, int64_t lanes, int min_u,
                           int32_t* counts, cudaStream_t s) {
  const dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads), (unsigned)n_real);
  strided_niceonly_kernel<L><<<grid, kThreads, 0, s>>>(
      desc, residues, num_res, modulus, lanes, min_u, p, counts);
}

// num_cls classes times ceil(valid_total / (base - 1)) periods of lanes, in
// a grid-stride loop.
template <class L>
static void launch_dense(const Plan& p, const int64_t* start,
                         const int64_t* classes, uint32_t num_cls,
                         uint32_t valid_total, int min_u, int32_t* out,
                         cudaStream_t s) {
  const uint32_t m = p.base - 1;
  const uint32_t lanes = num_cls * ((valid_total + m - 1) / m);
  niceonly_dense_kernel<L><<<grid_for(lanes), kThreads, 0, s>>>(
      start, classes, num_cls, lanes, valid_total, min_u, p, out);
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

// K3 over desc rows [0, n_real): counts[row] += candidates of the row with
// min_uniques <= num_uniques <= base (the caller zeroes counts; the search
// passes min_uniques = base). periods * num_res lanes per row.
int nice_strided_niceonly(const uint64_t* plan_words, const void* desc,
                          long long n_real, const void* residues,
                          long long num_res, long long modulus,
                          long long periods, int min_uniques, void* counts,
                          void* stream) {
  using namespace nice;
  const Plan p = plan_from_words(plan_words);
  const int64_t* d = (const int64_t*)desc;
  const int64_t* r = (const int64_t*)residues;
  const int64_t lanes = (int64_t)periods * num_res;
  int32_t* c = (int32_t*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_tier(p)) {
    case 0:
      launch_strided<SmallTier>(p, d, (int)n_real, r, (uint32_t)num_res,
                                (uint32_t)modulus, lanes, min_uniques, c, s);
      break;
    case 1:
      launch_strided<GenericTier>(p, d, (int)n_real, r, (uint32_t)num_res,
                                  (uint32_t)modulus, lanes, min_uniques, c, s);
      break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// K4 over the valid_total lanes from start: out[0] += the kept lanes with
// min_uniques <= num_uniques <= base, out[1] += the lanes not kept (the
// caller zeroes out; the search passes min_uniques = base). The caller keeps
// 1 <= num_cls <= base - 1, base >= 3 and valid_total + base < 2^31.
int nice_niceonly_dense(const uint64_t* plan_words, const void* start,
                        const void* classes, long long num_cls,
                        long long valid_total, int min_uniques, void* out,
                        void* stream) {
  using namespace nice;
  const Plan p = plan_from_words(plan_words);
  const int64_t* st = (const int64_t*)start;
  const int64_t* cl = (const int64_t*)classes;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (pick_tier(p)) {
    case 0:
      launch_dense<SmallTier>(p, st, cl, (uint32_t)num_cls,
                              (uint32_t)valid_total, min_uniques, o, s);
      break;
    case 1:
      launch_dense<GenericTier>(p, st, cl, (uint32_t)num_cls,
                                (uint32_t)valid_total, min_uniques, o, s);
      break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

const char* nice_error_string(int code) {
  if (code == -1) return "plan exceeds every kernel tier";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
