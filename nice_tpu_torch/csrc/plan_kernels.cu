// The per-base library: K1, K2, K3 and K5's detailed mode on the plan tier,
// the lane built for one base with its plan as constants (nice_kernels.cuh
// PlanTier). The TPU did the same: pallas_engine.py's _strided_callable
// (:390), _uniques_callable (:446) and _stats_callable (:163, its MXU arm
// included) are lru_cached per plan, so each base was traced and compiled
// with its plan as constants (K3's stride offsets expanded into the kernel
// too, _expanded_offsets :335-347). ops/cuda_build.py
// load_plan builds this file with nvcc for sm_90a at the first use of a
// base, with the generated nice_plan.h (ops/cuda_engine.py plan_header) on
// the include path, for every plan of at most kPlanTierLimbs limbs of n
// (b10-b97): all of K3's domain, and K1, K2 and K5's detailed mode there
// (their kernels are nice_grid.cuh's; K5's keeps T's words in registers).
// A library answers only the plan it was built for (kOtherPlan otherwise).
//
// K3 strided_niceonly_kernel replaces the TPU's stride-descriptor niceonly
// kernel: pallas_engine.py _strided_callable (pallas_call at :410, body
// _make_strided_kernel). Each descriptor row (n0, lo, hi as four u32 limbs)
// covers candidates n = n0 + (i / R) * M + residues[i % R], i < periods * R,
// and the kernel counts those with lo <= n < hi and num_uniques(n) == base
// (or, for a check, min_uniques <= num_uniques(n) <= base). The TPU
// expanded the offsets into a VMEM table and walked the descriptors as a
// sequential grid axis, skipping padded rows with pl.when(d < n_real); here
// the grid is (lane chunks, n_real): only real rows are launched, each
// thread derives its candidate's offset from the residue table (R u32
// words, resident in L1) with a multiply-high by the host's magic for R,
// and each block reduces its count per warp, then across warps, and adds it
// to counts[row] with one atomic. R and M change with the stride depth,
// which the adaptive floor moves between fields, so they stay launch
// arguments and one build serves a base. The block size is the launch's
// (block_threads, a whole number of warps up to kThreads): each block sums
// the warps it has.
//
// What bounds them on an H100: integer operations (see nice_kernels.cu).
// The plan tier's lane has no guard, no loop counter and no plan load, and
// divides only by immediates: its instructions are those of op_count.cu's
// constant-plan lane, which the bound counts.

#include "nice_plan.h"  // first: NICE_PLAN turns the plan tier on

#include "nice_grid.cuh"

namespace nice {

constexpr int kDescWidth = 12;  // int64 words of a stride descriptor row

template <class L>
__global__ void __launch_bounds__(kThreads)
strided_niceonly_kernel(const int64_t* __restrict__ desc,
                        const int64_t* __restrict__ residues, uint32_t num_res,
                        U32Divisor by_res, uint32_t modulus, int64_t lanes,
                        int min_u, Plan rp, int32_t* __restrict__ counts) {
  const Plan& p = L::plan(rp);
  __shared__ int32_t warp_sums[kThreads / kWarp];
  const int64_t* row = desc + (int64_t)blockIdx.y * kDescWidth;
  int c = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < lanes;
       i += stride) {
    c += L::strided_nice(row, residues, num_res, by_res, modulus, (uint32_t)i,
                         min_u, p);
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x / kWarp); ++w) s += warp_sums[w];
    if (s) atomicAdd(&counts[blockIdx.y], s);
  }
}

// One block per `threads` lanes of a descriptor (lanes <= 2^20, so at most
// 32768 at 32 threads), times the n_real real descriptors (<= 1024) on the
// grid's y axis; Shape::grid counts the blocks of both axes.
static Shape strided_shape(int64_t lanes, int n_real, int threads) {
  Shape sh;
  sh.threads = threads;
  resident((const void*)strided_niceonly_kernel<PlanTier>, threads, 0,
           &sh.blocks_per_sm, &sh.sms);
  sh.grid = (int)((lanes + threads - 1) / threads) * n_real;
  return sh;
}

static const uint64_t kPlanWords[] = {NICE_PLAN};
static_assert(sizeof(kPlanWords) / sizeof(kPlanWords[0]) == PW_COUNT,
              "NICE_PLAN holds one word per PlanWord");

// The caller's plan words are the ones this library was built for.
static bool this_plan(const uint64_t* w) {
  for (int i = 0; i < PW_COUNT; ++i) {
    if (w[i] != kPlanWords[i]) return false;
  }
  return true;
}

// The plan tier in nice_launch_shape's out[4].
constexpr int kPlanTierIndex = 3;

}  // namespace nice

// Return codes: 0 on success, a cudaError_t from cudaGetLastError() after
// the launch, or kOtherPlan or kBadThreads before launching. block_threads
// as in nice_kernels.cu (K2 keeps kThreads).
extern "C" {

// K1: n = start + g for g < valid_total into hist and *nm, the pad lanes
// into bin 0, as nice_detailed_megaloop does above the plan tier.
int nice_plan_detailed_megaloop(const uint64_t* plan_words, const void* start,
                                long long valid_total, long long pad,
                                void* hist, void* nm, int block_threads,
                                void* stream) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  if (!block_threads_ok(block_threads, kWarp)) return kBadThreads;
  launch_k1<PlanTier>(plan_from_words(plan_words), (const int64_t*)start,
                      valid_total, pad, (int32_t*)hist, (int32_t*)nm,
                      block_threads, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K2: out[g] = num_uniques(start + g) for g < lanes.
int nice_plan_uniques(const uint64_t* plan_words, const void* start,
                      long long lanes, void* out, void* stream) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  launch_uniques<PlanTier>(plan_from_words(plan_words), (const int64_t*)start,
                           lanes, (int32_t*)out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K5 in the detailed mode (mma = 1; mma = 2 runs each block's setup
// alone, over the launch's grid, to time it apart): n = start + g for g <
// valid_total < 2^31 into hist and *nm, as nice_detailed_megaloop.
int nice_plan_detailed_megaloop_mma(const uint64_t* plan_words,
                                    const void* start, long long valid_total,
                                    long long pad, void* hist, void* nm,
                                    int mma, int block_threads, void* stream) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  if (mma != 1 && mma != 2) return kNoTier;
  if (!block_threads_ok(block_threads, kMmaMinThreads)) return kBadThreads;
  const int rc = launch_k5<PlanTier>(
      plan_from_words(plan_words), (const int64_t*)start, valid_total, pad,
      (int32_t*)hist, (int32_t*)nm, mma, block_threads, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}

// K3 over desc rows [0, n_real): counts[row] += candidates of the row with
// min_uniques <= num_uniques <= base (the caller zeroes counts; the search
// passes min_uniques = base). periods * num_res lanes per row; res_magic,
// res_shift1 and res_shift2 divide by num_res (U32Divisor).
int nice_plan_strided_niceonly(const uint64_t* plan_words, const void* desc,
                               long long n_real, const void* residues,
                               long long num_res, unsigned res_magic,
                               int res_shift1, int res_shift2,
                               long long modulus, long long periods,
                               int min_uniques, void* counts,
                               int block_threads, void* stream) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  if (!block_threads_ok(block_threads, kWarp)) return kBadThreads;
  const int64_t lanes = (int64_t)periods * num_res;
  const U32Divisor by_res = {res_magic, res_shift1, res_shift2};
  const dim3 grid((unsigned)((lanes + block_threads - 1) / block_threads),
                  (unsigned)n_real);
  strided_niceonly_kernel<PlanTier><<<grid, block_threads, 0,
                                      (cudaStream_t)stream>>>(
      (const int64_t*)desc, (const int64_t*)residues, (uint32_t)num_res,
      by_res, (uint32_t)modulus, lanes, min_uniques,
      plan_from_words(plan_words), (int32_t*)counts);
  return (int)cudaGetLastError();
}

// The shape a launch would take, as nice_launch_shape (whose kernel
// numbers and arguments it keeps): kernel 0 K1 (mma = 0) or K5's detailed
// mode (mma = 1) over a lanes, 1 K2 over a lanes, 2 K3 over a lanes a row
// and b rows, at block_threads; out[4] is the plan tier's index, 3.
int nice_plan_launch_shape(int kernel, const uint64_t* plan_words,
                           long long a, long long b, int mma,
                           int block_threads, int* out) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  if (!block_threads_ok(block_threads, mma ? kMmaMinThreads : kWarp)) {
    return kBadThreads;
  }
  const Plan p = plan_from_words(plan_words);
  Shape sh;
  size_t smem;
  switch (kernel * 2 + (mma != 0)) {
    case 0: sh = k1_shape<PlanTier>(p, a, block_threads, &smem); break;
    case 1: {
      const int rc = k5_shape<PlanTier>(p, a, block_threads, &sh, &smem);
      if (rc) return rc;
      break;
    }
    case 2: sh = uniques_shape<PlanTier>(a); break;
    case 4: sh = strided_shape(a, (int)b, block_threads); break;
    default: return kNoTier;
  }
  out[0] = sh.grid;
  out[1] = sh.threads;
  out[2] = sh.blocks_per_sm;
  out[3] = sh.sms;
  out[4] = kPlanTierIndex;
  return (int)cudaGetLastError();
}

const char* nice_error_string(int code) {
  const char* own = nice::error_string(code);
  return own ? own : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
