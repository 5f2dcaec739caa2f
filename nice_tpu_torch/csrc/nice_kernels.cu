// The CUDA kernels of the port, with a plain C interface for ctypes
// (nice_tpu_torch/ops/cuda_build.py builds this file with nvcc for sm_90a;
// ops/cuda_engine.py wraps it): K1 and K2 above b97 on the detailed path,
// K4 on the dense niceonly path (b98 and up), and K5, the tensor-core arm of
// K1 and K4, where the tuned shape asks for it (use_mxu; its detailed mode
// above b97). K3 (the strided niceonly path, bases of at most 4 u32 limbs)
// and, at those bases, K1, K2 and K5's detailed mode run on the plan tier:
// plan_kernels.cu, built once per base. K1's, K2's and K5's detailed
// kernels are in nice_grid.cuh, shared with that build.
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
// K3 (strided_niceonly_kernel) is described in plan_kernels.cu.
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
// derives its offsets (plan_kernels.cu): lane j is class classes[j % R] of period j / R, the
// run offset ((classes[j % R] - start) mod (b - 1)) + (j / R) * (b - 1), so
// the grid covers R * ceil(valid_total / (b - 1)) lanes, each a candidate
// but for the ragged last period (masked by i < valid_total). The unfused
// mode is the same kernel given all b - 1 classes. Each block reduces its
// nice count and its kept count per warp, then across warps, and flushes
// them with one atomic each: out[0] += nice, out[1] += -kept (block 0 adds
// valid_total), so out[1] ends as pruned.
//
// K5 detailed_megaloop_mma_kernel and niceonly_dense_mma_kernel replace the
// TPU's MXU arm: the same pallas_call at :181 with use_mxu=True, whose body
// (_make_kernel -> vector_engine.num_uniques_lanes) routes n^2 and n^3
// through nice_tpu/ops/mxu.py sqr_limbs_mxu / mul_limbs_mxu (:162-190), a
// banded Toeplitz dot_general of 8-bit digits x 16-bit halves per lane.
// That matrix differs per lane, which on an MMA fills one output column of
// eight; K5 instead splits n = S + i (S the launch's start, i the lane's
// offset), so the lane-dependent limbs of n^2 and n^3 are one GEMM of each
// lane's bytes of i and i^2 against Toeplitz bands of S and S^2 shared by
// the whole launch (nice_kernels.cuh, "K5"), on the tensor cores through
// mma.sync (u8 x u8 -> s32, m16n8k16) with every operand and result in
// registers: a thread loads its T words once, builds D's from its quad's
// offsets and gets its own columns by shuffles. The kernels are K1's and
// K4's with K5's products in place of the schoolbook ones and the
// grid-stride loops run per warp, so every thread reaches each MMA; each
// runs on the tier its K1/K4 counterpart would (the dense mode on K4's
// register tier and block shape), the detailed mode on the plan tier to
// b97. The digit work is K1's; it, not the products, dominates a lane at
// b40, so K5 pays most where the product's share is large (b98, b510).
//
// What bounds them on an H100: they take no input but a few start limbs (K3:
// 96 bytes a descriptor and the residue table; K4: the class table) and
// write little (K1: base+2 bins; K2: 4 bytes a lane; K3: 4 bytes a
// descriptor; K4: 8 bytes), so they are bound by integer operations — wide
// multiplies for n^2 and n^3 and the multiply-high divisions of the digit
// extraction. The design keeps every intermediate of the small tier (and of
// K4's dense tier, sized to b98) in registers, replaces each division by a
// multiply-high with a host-computed reciprocal (32-bit for the single
// digits, which are most of a lane's work), keeps atomics off the global
// outputs except for one flush per block, and (K4) spends no lane on a
// candidate the congruence excludes. Every grid-stride launch is one full
// wave: its grid is the blocks each SM holds at once (the occupancy API,
// per kernel) times the SMs, or fewer for a small launch, and K4 takes
// smaller blocks when a run is too small to give each SM a block of the
// launch's size. That size (block_threads) is a run-time argument of K1, K3,
// K4 and K5, a whole number of warps up to kThreads (nice_grid.cuh
// block_threads_ok), which the engine tunes as the TPU's block_rows; K2 keeps
// kThreads, as the TPU's uniques kernel took no block_rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nice_grid.cuh"

namespace nice {

// K4's block when a run has fewer lanes than SMs x the launch's block size:
// small enough that such a run's lanes spread over every SM.
constexpr int kDenseSmallThreads = 64;

// minBlocksPerMultiprocessor = 1 lets ptxas give a lane the registers its
// limbs need (up to 255); with kThreads alone it trims them to the next
// occupancy step and spills (the dense tier's 5/9/13 limbs did).
template <class L>
__global__ void __launch_bounds__(kThreads, 1)
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
    // The block's warps alone: it may be launched below kThreads (a whole
    // number of warps; see dense_shape).
    int sc = 0, sk = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      sc += warp_sums[0][w];
      sk += warp_sums[1][w];
    }
    if (blockIdx.x == 0) sk -= (int)valid_total;
    if (sc) atomicAdd(&out[0], sc);
    if (sk) atomicAdd(&out[1], -sk);
  }
}

// K5, the dense niceonly mode: K4 with K5's products, its loop run per warp
// (the MMAs and shuffles are the warp's; a lane past the run's lanes or past
// valid_total is not live and takes part with a zero offset). A lane's quad
// offsets come from its neighbours by shuffles. The block shape and
// register bound are K4's.
template <class L>
__global__ void __launch_bounds__(kThreads, 1)
niceonly_dense_mma_kernel(const int64_t* __restrict__ start,
                          const int64_t* __restrict__ classes,
                          uint32_t num_cls, uint32_t lanes,
                          uint32_t valid_total, int min_u, Plan p,
                          int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k5_smem[];
  __shared__ int32_t warp_sums[2][kThreads / 32];
  const uint32_t s = L::start_residue(start, p);
  const K5Smem mm = k5_layout(k5_smem, p.limbs_cu, 0);
  k5_setup(start, p, mm);  // syncs the block
  typename L::K5B b;
  L::load_b(b, p, mm);
  int c = 0, kept = 0;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t j0 = blockIdx.x * blockDim.x + threadIdx.x - lane; j0 < lanes;
       j0 += stride) {
    const uint32_t j = j0 + lane;
    const uint32_t i =
        j < lanes ? L::dense_offset(classes, num_cls, s, j, p) : valid_total;
    const bool live = i < valid_total;
    kept += live;
    const uint32_t il = live ? i : 0u;
    uint32_t iq[4];
    NICE_UNROLL
    for (int r = 0; r < 4; ++r) {
      iq[r] = __shfl_sync(0xffffffffu, il, (lane & ~3u) | r);
    }
    const int u = L::uniques_mma(start, il, iq, live, p, b, mm);
    c += live && u >= min_u && u <= (int)p.base;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  kept = __reduce_add_sync(0xffffffffu, kept);
  if (lane == 0) {
    warp_sums[0][threadIdx.x >> 5] = c;
    warp_sums[1][threadIdx.x >> 5] = kept;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sc = 0, sk = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      sc += warp_sums[0][w];
      sk += warp_sums[1][w];
    }
    if (blockIdx.x == 0) sk -= (int)valid_total;
    if (sc) atomicAdd(&out[0], sc);
    if (sk) atomicAdd(&out[1], -sk);
  }
}

// num_cls classes times ceil(valid_total / (base - 1)) periods of lanes, in
// a grid-stride loop, at `threads` a block. K4 and K5 take blocks of
// kDenseSmallThreads (where that is smaller) when the run has fewer lanes
// than the SMs hold blocks of `threads`, so that its few blocks do not leave
// most SMs idle. K5's blocks carry its shared memory; it returns kNoSmem
// when that passes kMmaSmemMax.
template <class L>
static int dense_shape(const Plan& p, uint32_t num_cls, uint32_t valid_total,
                       int mma, int threads, Shape* sh, size_t* smem,
                       uint32_t* lanes) {
  const uint32_t m = p.base - 1;
  *lanes = num_cls * ((valid_total + m - 1) / m);
  const void* k = (const void*)niceonly_dense_kernel<L>;
  *smem = 0;
  if (mma) {
    const int bytes = k5_smem_bytes(p.limbs_sq, p.limbs_cu, 0);
    if (bytes > kMmaSmemMax) return kNoSmem;
    k = (const void*)niceonly_dense_mma_kernel<L>;
    *smem = (size_t)bytes;
  }
  *sh = wave_shape(k, *lanes, threads, *smem);
  if (kDenseSmallThreads < threads &&
      (int64_t)*lanes < (int64_t)sh->sms * threads) {
    *sh = wave_shape(k, *lanes, kDenseSmallThreads, *smem);
  }
  return 0;
}

// K4 (mma = 0) or K5 in the dense mode (mma = 1; mma = 2 runs each
// block's setup alone, over the launch's grid for these arguments, to time
// it apart: a measurement mode, as launch_k5's in nice_grid.cuh, that the
// wrappers never pass).
template <class L>
static int launch_dense(const Plan& p, const int64_t* start,
                        const int64_t* classes, uint32_t num_cls,
                        uint32_t valid_total, int min_u, int32_t* out, int mma,
                        int threads, cudaStream_t s) {
  Shape sh;
  size_t smem;
  uint32_t lanes;
  const int rc = dense_shape<L>(p, num_cls, valid_total, mma, threads, &sh,
                                &smem, &lanes);
  if (rc) return rc;
  if (!mma) {
    niceonly_dense_kernel<L><<<sh.grid, sh.threads, 0, s>>>(
        start, classes, num_cls, lanes, valid_total, min_u, p, out);
  } else if (mma == 2) {
    niceonly_dense_mma_kernel<L><<<sh.grid, sh.threads, smem, s>>>(
        start, classes, num_cls, 0, 0, min_u, p, out);
  } else {
    niceonly_dense_mma_kernel<L><<<sh.grid, sh.threads, smem, s>>>(
        start, classes, num_cls, lanes, valid_total, min_u, p, out);
  }
  return 0;
}

// The dense mode's tier (2 for DenseTier), the same for K4 and K5:
// pick_tier's, with DenseTier between the small and the generic tier.
inline int dense_tier(const Plan& p) {
  if (!SmallTier::fits(p) && DenseTier::fits(p)) return 2;
  return pick_tier(p);
}

}  // namespace nice

// Return codes: 0 on success, a cudaError_t from cudaGetLastError() after
// the launch, or one of nice_kernels.cuh's codes (kNoTier, kNoSmem,
// kPlanTierOnly, kBadThreads) before launching. block_threads: the threads
// of a block, a whole number of warps up to kThreads (from kMmaMinThreads
// for K5).
extern "C" {

// K1 (mma = 0) or K5 in the detailed mode (mma = 1; lanes < 2^31; mma = 2
// its setup alone) above the plan tier, in the generic tier;
// plan_kernels.cu runs the plans of at most kPlanTierLimbs limbs.
int nice_detailed_megaloop(const uint64_t* plan_words, const void* start,
                           long long valid_total, long long pad, void* hist,
                           void* nm, int mma, int block_threads,
                           void* stream) {
  using namespace nice;
  if (!block_threads_ok(block_threads, mma ? kMmaMinThreads : kWarp)) {
    return kBadThreads;
  }
  const Plan p = plan_from_words(plan_words);
  const int64_t* st = (const int64_t*)start;
  int32_t* h = (int32_t*)hist;
  int32_t* n = (int32_t*)nm;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan_tier_takes(p)) return kPlanTierOnly;
  if (pick_tier(p) != 1) return kNoTier;
  if (mma) {
    const int rc = launch_k5<GenericTier>(p, st, valid_total, pad, h, n, mma,
                                          block_threads, s);
    return rc ? rc : (int)cudaGetLastError();
  }
  launch_k1<GenericTier>(p, st, valid_total, pad, h, n, block_threads, s);
  return (int)cudaGetLastError();
}

// K2 above the plan tier (limbs_n > kPlanTierLimbs), in the generic tier;
// plan_kernels.cu runs the plans below it.
int nice_uniques(const uint64_t* plan_words, const void* start,
                 long long lanes, void* out, void* stream) {
  using namespace nice;
  const Plan p = plan_from_words(plan_words);
  if (plan_tier_takes(p)) return kPlanTierOnly;
  if (pick_tier(p) != 1) return kNoTier;
  launch_uniques<GenericTier>(p, (const int64_t*)start, lanes, (int32_t*)out,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K4 over the valid_total lanes from start: out[0] += the kept lanes with
// min_uniques <= num_uniques <= base, out[1] += the lanes not kept (the
// caller zeroes out; the search passes min_uniques = base). The caller keeps
// 1 <= num_cls <= base - 1, base >= 3 and valid_total + base < 2^31. mma = 1
// runs K5 in the dense mode instead of K4 (mma = 2 its setup alone).
int nice_niceonly_dense(const uint64_t* plan_words, const void* start,
                        const void* classes, long long num_cls,
                        long long valid_total, int min_uniques, int mma,
                        void* out, int block_threads, void* stream) {
  using namespace nice;
  if (!block_threads_ok(block_threads, mma ? kMmaMinThreads : kWarp)) {
    return kBadThreads;
  }
  const Plan p = plan_from_words(plan_words);
  const int64_t* st = (const int64_t*)start;
  const int64_t* cl = (const int64_t*)classes;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (dense_tier(p)) {
    case 0:
      rc = launch_dense<SmallTier>(p, st, cl, (uint32_t)num_cls,
                                   (uint32_t)valid_total, min_uniques, o, mma,
                                   block_threads, s);
      break;
    case 1:
      rc = launch_dense<GenericTier>(p, st, cl, (uint32_t)num_cls,
                                     (uint32_t)valid_total, min_uniques, o,
                                     mma, block_threads, s);
      break;
    case 2:
      rc = launch_dense<DenseTier>(p, st, cl, (uint32_t)num_cls,
                                   (uint32_t)valid_total, min_uniques, o, mma,
                                   block_threads, s);
      break;
    default: return kNoTier;
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The shape a launch would take, from the same code the launch runs.
// kernel 0: K1 (K5's detailed mode with mma = 1) over a = valid_total
// lanes; 1: K2 over a lanes; 3: K4 (K5's dense mode with mma = 1) over a =
// num_cls classes and b = valid_total lanes (kernel 2, K3, is
// plan_kernels.cu's alone, as K1, K2 and K5's detailed mode are at its
// plans).
// out[0..4] = the grid's blocks, threads a block, resident blocks an SM at
// that block size, the SMs, and the tier (0 small, 1 generic, 2 dense), at
// block_threads (K2 takes kThreads whatever it is). Returns 0, or what the
// launch would return for the plan before launching.
int nice_launch_shape(int kernel, const uint64_t* plan_words, long long a,
                      long long b, int mma, int block_threads, int* out) {
  using namespace nice;
  if (!block_threads_ok(block_threads, mma ? kMmaMinThreads : kWarp)) {
    return kBadThreads;
  }
  const Plan p = plan_from_words(plan_words);
  if (kernel == 2 || (kernel < 2 && plan_tier_takes(p))) {
    return kPlanTierOnly;
  }
  const int tier = kernel == 3 ? dense_tier(p) : pick_tier(p);
  if (tier < 0) return kNoTier;
  Shape sh;
  size_t smem;
  uint32_t lanes;
  int rc = 0;
  switch (kernel * 3 + tier) {
    case 1:
      if (mma) {
        rc = k5_shape<GenericTier>(p, a, block_threads, &sh, &smem);
      } else {
        sh = k1_shape<GenericTier>(p, a, block_threads, &smem);
      }
      break;
    case 4: sh = uniques_shape<GenericTier>(a); break;
    case 9:
      rc = dense_shape<SmallTier>(p, (uint32_t)a, (uint32_t)b, mma,
                                 block_threads, &sh, &smem, &lanes);
      break;
    case 10:
      rc = dense_shape<GenericTier>(p, (uint32_t)a, (uint32_t)b, mma,
                                 block_threads, &sh, &smem, &lanes);
      break;
    case 11:
      rc = dense_shape<DenseTier>(p, (uint32_t)a, (uint32_t)b, mma,
                                 block_threads, &sh, &smem, &lanes);
      break;
    default: return kNoTier;
  }
  if (rc) return rc;
  out[0] = sh.grid;
  out[1] = sh.threads;
  out[2] = sh.blocks_per_sm;
  out[3] = sh.sms;
  out[4] = tier;
  return (int)cudaGetLastError();
}

const char* nice_error_string(int code) {
  const char* own = nice::error_string(code);
  return own ? own : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
