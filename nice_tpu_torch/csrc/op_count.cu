// The per-lane work of the two kernels at one base, built only to be
// counted: chip_smoke.py compiles this file with nvcc -cubin and counts the
// SASS instructions of each function here with cuobjdump.
//
// op_count_plan.h, which the caller generates, defines NICE_PLAN as the 13
// words of the base's Plan (the order of struct Plan). With the plan a
// compile-time constant, every loop of the per-lane arithmetic has a
// constant trip count and unrolls fully, so each function is straight-line
// code and its instruction count is what one lane issues, give or take the
// few instructions of index setup. The constants also fold (divisors and
// reciprocals become immediates), so the count is no more than what the
// runtime-plan kernels in nice_kernels.cu issue for a lane of that base.

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
