// The per-lane work of the four kernels, built only to be counted:
// chip_smoke.py compiles this file with nvcc -cubin and counts the SASS
// instructions of each function here with cuobjdump.
//
// op_count_plan.h, which the caller generates, defines NICE_PLAN as the
// words of K1-K3's base's Plan (the order of struct Plan), NICE_K3_R and
// NICE_K3_M as the residue count and modulus of K3's stride table, and for
// K4's (larger) base NICE_K4_PLAN, NICE_K4_TIER (the limb capacities of n,
// n^2, n^3 and the mask words: the plan's own counts) and NICE_K4_R (its
// kept residue classes). With the plan a compile-time constant, every loop
// of the per-lane arithmetic has a constant trip count and unrolls fully,
// so each function is straight-line code and its instruction count is what
// one lane issues, give or take the few instructions of index setup. The
// constants also fold (divisors and reciprocals become immediates), and
// K4's limbs stay in registers where its kernel keeps them in local memory
// (the generic tier), so the count is no more than what the runtime-plan
// kernels in nice_kernels.cu issue for a lane of that base.

#include <stdint.h>

#include "op_count_plan.h"

#define NICE_PLAN_UNROLL NICE_UNROLL
#include "nice_kernels.cuh"

// One lane of K2 (uniques_kernel): num_uniques, stored.
extern "C" __global__ void k2_lane(const int64_t* __restrict__ start,
                                   int32_t* __restrict__ out) {
  constexpr nice::Plan p = {NICE_PLAN};
  const uint64_t g = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  out[g] = nice::SmallTier::uniques(start, g, p);
}

// One lane of K1 (detailed_megaloop_kernel): num_uniques into the block's
// shared histogram, and the near-miss test.
extern "C" __global__ void k1_lane(const int64_t* __restrict__ start,
                                   int32_t* __restrict__ nm_out) {
  constexpr nice::Plan p = {NICE_PLAN};
  __shared__ int32_t sh[p.base + 2];
  const uint64_t g = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int u = nice::SmallTier::uniques(start, g, p);
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
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = nice::SmallTier::strided_nice(desc, residues, NICE_K3_R, NICE_K3_M,
                                         i, (int)p.base, p);
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
