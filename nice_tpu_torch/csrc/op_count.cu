// The per-lane work of the kernels, built only to be counted:
// chip_smoke.py compiles this file with nvcc -cubin and counts the SASS
// instructions of each function here with cuobjdump.
//
// nice_plan.h, which the caller generates as plan_kernels.cu's
// (ops/cuda_engine.py plan_header), defines NICE_PLAN and NICE_PLAN_TIER
// for K1-K3's and K5's detailed base (the plan tier's lane of that base,
// nice_kernels.cuh PlanTier), NICE_K3_R, NICE_K3_DIV and NICE_K3_M as the
// residue count, its divisor magic (U32Divisor) and the modulus of K3's
// stride table, and for K4's (larger) base NICE_K4_PLAN, NICE_K4_TIER (the
// limb capacities of n, n^2, n^3 and the mask words: the plan's own
// counts) and NICE_K4_R (its kept residue classes). With the plan a
// compile-time constant, every loop of the per-lane arithmetic has a
// constant trip count and unrolls fully, so each function is straight-line
// code and its instruction count is what one lane issues, give or take the
// few instructions of index setup. The constants also fold (divisors and
// reciprocals become immediates). K2's, K3's and K5's detailed lanes are
// those of their kernels (plan_kernels.cu builds the same PlanTier); K1's
// lane and K4's and K5's dense lanes issue no more than what their
// runtime-plan kernels in nice_kernels.cu issue for a lane of that base.

#include <stdint.h>

#include "nice_plan.h"

// K5's schoolbook fallback serves only lanes outside the base's range, which
// the counted lanes (and the main path) never are: it stays out of the count.
#define NICE_K5_NO_FALLBACK
#include "nice_kernels.cuh"

// One lane of K2 (uniques_kernel): num_uniques, stored.
extern "C" __global__ void k2_lane(const int64_t* __restrict__ start,
                                   int32_t* __restrict__ out) {
  constexpr nice::Plan p = {NICE_PLAN};
  const uint64_t g = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  out[g] = nice::PlanTier::uniques(start, g, p);
}

// One lane of K1 (detailed_megaloop_kernel): num_uniques into the block's
// shared histogram, and the near-miss test.
extern "C" __global__ void k1_lane(const int64_t* __restrict__ start,
                                   int32_t* __restrict__ nm_out) {
  constexpr nice::Plan p = {NICE_PLAN};
  __shared__ int32_t sh[p.base + 2];
  const uint64_t g = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int u = nice::PlanTier::uniques(start, g, p);
  if (u < (int)p.base + 2) atomicAdd(&sh[u], 1);
  nm_out[g] = u > p.cutoff;
}

// One lane of K3 (strided_niceonly_kernel): the candidate's offset from the
// residue table, its limbs and range test, num_uniques, the nice test
// (min_uniques = base, as the search runs it).
extern "C" __global__ void k3_lane(const int64_t* __restrict__ desc,
                                   const int64_t* __restrict__ residues,
                                   int32_t* __restrict__ out) {
  constexpr nice::Plan p = {NICE_PLAN};
  constexpr nice::U32Divisor by_res = {NICE_K3_DIV};
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = nice::PlanTier::strided_nice(desc, residues, NICE_K3_R, by_res,
                                        NICE_K3_M, i, (int)p.base, p);
}

// One lane of K4 (niceonly_dense_kernel): the lane's class and offset, the
// ragged-period mask, its limbs, num_uniques, the nice test (min_uniques =
// base, as the search runs it) and the kept count. s, the start's residue,
// is the thread's once for all its lanes, so it comes in as an argument.
extern "C" __global__ void k4_lane(const int64_t* __restrict__ start,
                                   const int64_t* __restrict__ classes,
                                   uint32_t s, uint32_t valid_total,
                                   int32_t* __restrict__ out) {
  constexpr nice::Plan p = {NICE_K4_PLAN};
  typedef nice::Lane<NICE_K4_TIER, true> Tier;
  const uint32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  int kept = 0;
  const int c = Tier::dense_nice(start, classes, NICE_K4_R, s, j, valid_total,
                                 (int)p.base, p, &kept);
  out[j] = c + 2 * kept;
}

// One lane of K5 in the detailed mode (detailed_megaloop_mma_kernel) on the
// plan tier at K1's base: its quad's offsets and D's words, its share of the
// warp's MMAs and shuffles and its limbs' carry walk, the digit work, the
// histogram and the near-miss test. The block's setup (S^2 and S^3, formed
// once per block and reused by every lane of its grid-stride loop) is left
// out; the thread's loads of T's words, once per thread, are counted.
extern "C" __global__ void k5_detailed_lane(const int64_t* __restrict__ start,
                                            int32_t* __restrict__ nm_out) {
  constexpr nice::Plan p = {NICE_PLAN};
  typedef nice::PlanTier Tier;
  constexpr int front = 4 * ((int)p.base + 3);
  __shared__ __align__(16) unsigned char smem[nice::k5_smem_bytes(
      p.limbs_sq, p.limbs_cu, front)];
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
  const nice::K5Smem mm = nice::k5_layout(smem, p.limbs_cu, front);
  Tier::K5B b;
  Tier::load_b(b, p, mm);
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t gq = g & ~3u;
  const uint32_t iq[4] = {gq, gq + 1, gq + 2, gq + 3};
  const int u = Tier::uniques_mma(start, g, iq, true, p, b, mm);
  if (u < (int)p.base + 2) atomicAdd(&sh[u], 1);
  nm_out[g] = u > p.cutoff;
}

// One lane of K5 in the dense mode (niceonly_dense_mma_kernel) at K4's base
// (the tier of K4's lane, limbs in registers): the lane's offset, the
// ragged-period mask, its quad's offsets by shuffles, K5's products, the
// digit work, the nice test and the kept count; the block's setup left out
// as above.
extern "C" __global__ void k5_dense_lane(const int64_t* __restrict__ start,
                                         const int64_t* __restrict__ classes,
                                         uint32_t s, uint32_t valid_total,
                                         int32_t* __restrict__ out) {
  constexpr nice::Plan p = {NICE_K4_PLAN};
  typedef nice::Lane<NICE_K4_TIER, true> Tier;
  __shared__ __align__(16) unsigned char smem[nice::k5_smem_bytes(
      p.limbs_sq, p.limbs_cu, 0)];
  const nice::K5Smem mm = nice::k5_layout(smem, p.limbs_cu, 0);
  Tier::K5B b;
  Tier::load_b(b, p, mm);
  const uint32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t i = Tier::dense_offset(classes, NICE_K4_R, s, j, p);
  const bool live = i < valid_total;
  const uint32_t il = live ? i : 0u;
  uint32_t iq[4];
  NICE_UNROLL
  for (int r = 0; r < 4; ++r) {
    iq[r] = __shfl_sync(0xffffffffu, il, (threadIdx.x & ~3u) | r);
  }
  const int u = Tier::uniques_mma(start, il, iq, live, p, b, mm);
  out[j] = (live && u == (int)p.base) + 2 * live;
}
