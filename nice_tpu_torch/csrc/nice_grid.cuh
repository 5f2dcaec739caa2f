// The grid-stride kernels that both libraries instantiate, and how a launch
// is shaped: K1 (detailed_megaloop_kernel), K2 (uniques_kernel) and K5's
// detailed mode (detailed_megaloop_mma_kernel). The main library
// (nice_kernels.cu) builds them on its generic tier, the per-base library
// (plan_kernels.cu) on the plan tier. nice_kernels.cu's note says what each
// replaces.
//
// A kernel takes its plan from L::plan(p): the runtime plan for the
// runtime tiers, the constant one for PlanTier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "nice_kernels.cuh"

namespace nice {

// Threads a block of a grid-stride launch: a whole number of warps, from the
// kernel's least (kWarp; K5's kMmaMinThreads, as k5_setup gives warp 0 the
// products while the other warps fill T) up to kThreads, the bound every
// kernel is compiled under (__launch_bounds__). The launches take it at run
// time (block_threads); kThreads is the default. The Python rule
// (ops/cuda_engine.py block_threads_ok) and the specs
// (analysis/kernelspec.py) mirror it, and cudalint's C6 holds the three
// together.
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMmaMinThreads = 64;

// 1 when `threads` is a block size that a kernel whose blocks need at least
// `lo` threads takes. The C entries return kBadThreads for any other.
constexpr int block_threads_ok(int threads, int lo) {
  return threads >= lo && threads <= kThreads && threads % kWarp == 0;
}

// K1: each block builds a histogram of base+2 bins in shared memory over its
// lanes of a grid-stride loop and flushes it with one global atomic per bin;
// the near-miss count is reduced per warp, then per block. Padding lanes
// are not computed: their count goes into bin 0 once.
template <class L>
__global__ void __launch_bounds__(kThreads)
detailed_megaloop_kernel(const int64_t* __restrict__ start, int64_t valid_total,
                         int64_t pad, Plan rp, int32_t* __restrict__ hist,
                         int32_t* __restrict__ nm_out) {
  const Plan& p = L::plan(rp);
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

// K2: num_uniques of every lane, one int32 each.
template <class L>
__global__ void __launch_bounds__(kThreads)
uniques_kernel(const int64_t* __restrict__ start, int64_t lanes, Plan rp,
               int32_t* __restrict__ out) {
  const Plan& p = L::plan(rp);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < lanes;
       g += stride) {
    out[g] = L::uniques(start, (uint64_t)g, p);
  }
}

// K5, the detailed mode: K1 with K5's products (nice_kernels.cuh, "K5").
// The grid-stride loop runs per warp (its first lane decides), so every
// thread of a warp reaches the MMAs and shuffles as often as the others;
// lanes past valid_total take part with a zero offset and count nothing. A
// lane's quad offsets are its own neighbours', g0 + 4g + r.
template <class L>
NICE_D void detailed_megaloop_mma(const int64_t* __restrict__ start,
                                  int64_t valid_total, int64_t pad, Plan rp,
                                  int32_t* __restrict__ hist,
                                  int32_t* __restrict__ nm_out) {
  const Plan& p = L::plan(rp);
  extern __shared__ __align__(16) unsigned char k5_smem[];
  int32_t* sh = reinterpret_cast<int32_t*>(k5_smem);  // bins, near misses
  const int nb = (int)p.base + 2;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) sh[i] = 0;
  const K5Smem mm = k5_layout(k5_smem, p.limbs_cu, 4 * (nb + 1));
  k5_setup(start, p, mm);  // syncs the block
  typename L::K5B b;
  L::load_b(b, p, mm);
  int nm = 0;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       g0 < valid_total; g0 += stride) {
    const int64_t gq = g0 + (lane & ~3);
    uint32_t iq[4];
    NICE_UNROLL
    for (int r = 0; r < 4; ++r) {
      iq[r] = gq + r < valid_total ? (uint32_t)(gq + r) : 0u;
    }
    const int64_t g = g0 + lane;
    const bool live = g < valid_total;
    const int u = L::uniques_mma(start, live ? (uint32_t)g : 0u, iq, live, p,
                                 b, mm);
    if (live) {
      if (u < nb) atomicAdd(&sh[u], 1);
      nm += u > p.cutoff;
    }
  }
  nm = __reduce_add_sync(0xffffffffu, nm);
  if (lane == 0 && nm) atomicAdd(&sh[nb], nm);
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
  }
  if (threadIdx.x == 0) {
    if (sh[nb]) atomicAdd(nm_out, sh[nb]);
    if (blockIdx.x == 0 && pad) atomicAdd(&hist[0], (int32_t)pad);
  }
}

// The register and plan tiers leave ptxas its register count; the generic
// tier's kernel (_wide) asks for one block an SM, as under kThreads alone
// ptxas gave it 32 registers and spills.
template <class L>
__global__ void __launch_bounds__(kThreads)
detailed_megaloop_mma_kernel(const int64_t* __restrict__ start,
                             int64_t valid_total, int64_t pad, Plan rp,
                             int32_t* __restrict__ hist,
                             int32_t* __restrict__ nm_out) {
  detailed_megaloop_mma<L>(start, valid_total, pad, rp, hist, nm_out);
}

template <class L>
__global__ void __launch_bounds__(kThreads, 1)
detailed_megaloop_mma_kernel_wide(const int64_t* __restrict__ start,
                                  int64_t valid_total, int64_t pad, Plan rp,
                                  int32_t* __restrict__ hist,
                                  int32_t* __restrict__ nm_out) {
  detailed_megaloop_mma<L>(start, valid_total, pad, rp, hist, nm_out);
}

// A launch's shape: grid blocks of `threads` threads, and the one full wave
// it is capped at (blocks_per_sm resident blocks on each of sms SMs).
struct Shape {
  int grid, threads, blocks_per_sm, sms;
};

// The blocks of `threads` threads (and smem bytes of dynamic shared memory)
// that one SM holds at once for `kernel`, asked of the occupancy API once
// per kernel, block size, shared memory and device; and the SM count.
static void resident(const void* kernel, int threads, size_t smem,
                     int* blocks_per_sm, int* sms) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>,
                  std::pair<int, int>> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *blocks_per_sm = it->second.first;
    *sms = it->second.second;
    return;
  }
  int b = 0, n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, threads,
                                                    smem) == cudaSuccess &&
      b > 0) {
    cache[key] = std::make_pair(b, n);
  }
  // On a failed query the launch that follows reports the error (the
  // runtime's last error); one block keeps its grid valid meanwhile.
  *blocks_per_sm = b > 0 ? b : 1;
  *sms = n > 0 ? n : 1;
}

// One block per `threads` lanes, capped at one full resident wave: the
// grid-stride loops cover the rest with every block resident from the start
// (a larger grid would leave a partial second wave).
static Shape wave_shape(const void* kernel, int64_t lanes, int threads,
                        size_t smem) {
  Shape sh;
  sh.threads = threads;
  resident(kernel, threads, smem, &sh.blocks_per_sm, &sh.sms);
  int64_t want = (lanes + threads - 1) / threads;
  const int64_t cap = (int64_t)sh.blocks_per_sm * sh.sms;
  if (want > cap) want = cap;
  sh.grid = want < 1 ? 1 : (int)want;
  return sh;
}

// K1's launch at `threads` a block. Its shared histogram's loops stride by
// blockDim.x, the near-miss count is reduced per (whole) warp, and block 0
// alone adds the padding, so every admissible block size gives the same
// bins.
template <class L>
static Shape k1_shape(const Plan& p, int64_t valid_total, int threads,
                      size_t* smem) {
  *smem = (size_t)(p.base + 3) * sizeof(int32_t);
  return wave_shape((const void*)detailed_megaloop_kernel<L>, valid_total,
                    threads, *smem);
}

template <class L>
static void launch_k1(const Plan& p, const int64_t* start, int64_t valid_total,
                      int64_t pad, int32_t* hist, int32_t* nm, int threads,
                      cudaStream_t s) {
  size_t smem;
  const Shape sh = k1_shape<L>(p, valid_total, threads, &smem);
  detailed_megaloop_kernel<L><<<sh.grid, sh.threads, smem, s>>>(
      start, valid_total, pad, p, hist, nm);
}

// K5's detailed launch, as K1's with K5's shared memory; returns kNoSmem
// when that passes kMmaSmemMax.
template <class L>
static const void* k5_kernel() {
  if constexpr (L::kUnroll) {
    return (const void*)detailed_megaloop_mma_kernel<L>;
  } else {
    return (const void*)detailed_megaloop_mma_kernel_wide<L>;
  }
}

template <class L>
static int k5_shape(const Plan& p, int64_t valid_total, int threads, Shape* sh,
                    size_t* smem) {
  const int bytes = k5_smem_bytes(p.limbs_sq, p.limbs_cu,
                                  4 * ((int)p.base + 3));
  if (bytes > kMmaSmemMax) return kNoSmem;
  *smem = (size_t)bytes;
  *sh = wave_shape(k5_kernel<L>(), valid_total, threads, *smem);
  return 0;
}

// K5 in the detailed mode over valid_total lanes. mma = 2 times the setup
// apart: the launch's grid for valid_total lanes runs each block's setup and
// no lane. It is a measurement mode (chip_smoke.py, scripts/kernel_ab.py):
// the Python wrappers pass only 0 or 1 (cuda_engine._check_mxu). It rides
// on the launch argument because it must launch the very kernel, grid and
// shared memory that the timed launch takes; a separate build per library
// would add its nvcc to every smoke run.
template <class L>
static int launch_k5(const Plan& p, const int64_t* start, int64_t valid_total,
                     int64_t pad, int32_t* hist, int32_t* nm, int mma,
                     int threads, cudaStream_t s) {
  Shape sh;
  size_t smem;
  const int rc = k5_shape<L>(p, valid_total, threads, &sh, &smem);
  if (rc) return rc;
  const bool setup_only = mma == 2;
  const int64_t lanes = setup_only ? 0 : valid_total;
  if (setup_only) pad = 0;
  if constexpr (L::kUnroll) {
    detailed_megaloop_mma_kernel<L><<<sh.grid, sh.threads, smem, s>>>(
        start, lanes, pad, p, hist, nm);
  } else {
    detailed_megaloop_mma_kernel_wide<L><<<sh.grid, sh.threads, smem, s>>>(
        start, lanes, pad, p, hist, nm);
  }
  return 0;
}

template <class L>
static Shape uniques_shape(int64_t lanes) {
  return wave_shape((const void*)uniques_kernel<L>, lanes, kThreads, 0);
}

template <class L>
static void launch_uniques(const Plan& p, const int64_t* start, int64_t lanes,
                           int32_t* out, cudaStream_t s) {
  const Shape sh = uniques_shape<L>(lanes);
  uniques_kernel<L><<<sh.grid, sh.threads, 0, s>>>(start, lanes, p, out);
}

}  // namespace nice
