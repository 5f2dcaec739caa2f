// Per-lane arithmetic shared by the kernels in nice_kernels.cu (K1-K4, and
// K5's tensor-core product step, in the section "K5" below).
//
// For a candidate n this computes num_uniques: the count of distinct base-b
// digits across n^2 and n^3. It is the body of the TPU's Pallas kernels
// (nice_tpu/ops/pallas_engine.py: _make_kernel in every mode,
// _uniques_callable and _make_strided_kernel, which trace
// nice_tpu/ops/vector_engine.py: num_uniques_lanes) thought through again
// for Hopper:
//   * n = start + lane is a multi-limb add of a 64-bit lane index;
//   * n^2 and n^3 are schoolbook products with native 32x32->64 multiplies
//     and an in-row carry (the TPU's 16-bit-half carry-save scheme only
//     existed because its VPU is 32-bit);
//   * digits come off by long division of the u32 limbs by a constant with
//     64-bit intermediates: chunks of base^e < 2^31 digits at a time, each
//     step (rem << 32 | limb) / chunk_div done as a multiply-high by a
//     host-computed reciprocal plus one correction (no hardware divide);
//   * presence bits live in u32 mask words, counted with __popc.
// The plain PyTorch twin (nice_tpu_torch/ops/vector_engine.py) runs the same
// steps in int64 carriers; both agree on every lane, in range or not.
//
// Everything per base is a runtime value (struct Plan), so one build serves
// every base. Array capacities are template parameters of a tier: in the
// small tier every loop runs to the constant capacity under a guard, is
// fully unrolled, and the limb arrays stay in registers; the generic tier
// loops to the runtime counts over arrays in local memory (slow, but right
// for every base up to 2046).

#pragma once

#include <mma.h>
#include <stdint.h>

#define NICE_D __device__ __forceinline__

// Unrolls a loop whose trip count is a compile-time constant; leaves a loop
// with a runtime trip count alone.
#define NICE_UNROLL _Pragma("unroll")

// Marks the loops whose trip count is a plan value (the digit chunks). The
// kernels leave them to the compiler; op_count.cu, which builds one base's
// plan as a constant to count the instructions a lane issues, defines it as
// NICE_UNROLL so that they unroll fully.
#ifndef NICE_PLAN_UNROLL
#define NICE_PLAN_UNROLL
#endif

namespace nice {

// Plan words, in the order nice_tpu_torch/ops/cuda_engine.py packs them.
enum PlanWord {
  PW_BASE = 0,
  PW_LIMBS_N,
  PW_LIMBS_SQ,
  PW_LIMBS_CU,
  PW_D_SQ,
  PW_D_CU,
  PW_N_MASKS,
  PW_CUTOFF,
  PW_CHUNK_E,
  PW_CHUNK_DIV,
  PW_CHUNK_MAGIC,
  PW_BASE_MAGIC,
  PW_LOG2_FX,
  PW_RES_MAGIC,
  PW_COUNT
};

// Fixed-point bits of Plan::log2_fx (ops/limbs.py LOG2_FX_BITS).
constexpr int kLog2FxBits = 20;

struct Plan {
  uint32_t base;
  int limbs_n, limbs_sq, limbs_cu;  // u32 limbs of n, n^2, n^3
  int d_sq, d_cu;                   // exact digit counts of n^2, n^3
  int n_masks;                      // u32 presence words (ceil(base / 32))
  int cutoff;                       // near miss: num_uniques > cutoff
  int chunk_e;                      // digits per chunk division
  uint32_t chunk_div;               // base^chunk_e < 2^31
  uint64_t chunk_magic;             // floor((2^64 - 1) / chunk_div)
  uint64_t base_magic;              // floor((2^64 - 1) / base)
  uint64_t log2_fx;                 // >= log2(base) * 2^kLog2FxBits
  uint64_t res_magic;               // floor((2^64 - 1) / (base - 1))
};

// --------------------------------------------------------------------------
// K5: the tensor-core product step (see ops/mxu.py for the algebra)
// --------------------------------------------------------------------------
//
// A lane of K1 or K4 is n = S + i, S the launch's start and i < 2^31 the
// lane's offset, so n^2 = S^2 + 2S*i + i^2 and n^3 = S^3 + 3S^2*i + 3S*i^2 +
// i^3. The lane-dependent parts are one GEMM with a shared operand: D (a row
// per lane: the 4 bytes of i and the 8 of i^2, padded to 16) times T (the
// Toeplitz bands of the bytes of 2S for n^2's byte columns, of 3S^2 and 3S
// for n^3's), on the tensor cores as u8 x u8 -> s32 (column sums at most
// 12 * 255 * 255). Each block builds T and S^2, S^3 once in shared memory
// from the start limbs; each warp stages its 32 rows of D and, one tile of
// 16 byte columns (4 limbs) at a time, its accumulators, which each thread
// walks into its lane's limbs with a 64-bit carry.

constexpr int kMmaWarps = 8;        // warps of a block (kThreads / 32)
constexpr int kMmaK = 16;           // MMA depth: D's 12 digit bytes, padded
constexpr int kTileCols = 16;       // byte columns of one MMA tile: 4 limbs
constexpr int kAccLd = 20;          // int32 words a staged accumulator row
                                    // (padded: conflict-free 16-byte reads)
constexpr int kMmaSmemMax = 48 * 1024;  // no opt-in beyond the default

__host__ __device__ constexpr int k5_tiles(int limbs) { return (limbs + 3) / 4; }
__host__ __device__ constexpr int k5_round128(int x) { return (x + 127) & ~127; }

// Shared-memory bytes of a K5 block: the caller's own `front` bytes (K1's
// histogram), T (column-major, 16 bytes a column), the launch's limb
// constants, and per warp its rows of D and of accumulators. ops/mxu.py
// smem_bytes computes the same for the detailed mode.
__host__ __device__ constexpr int k5_smem_bytes(int limbs_n, int limbs_sq,
                                                int limbs_cu, int front) {
  return k5_round128(front) +
         kMmaK * kTileCols * (k5_tiles(limbs_sq) + k5_tiles(limbs_cu)) +
         k5_round128(4 * (limbs_n + 2 * limbs_sq + 3 * limbs_cu)) +
         kMmaWarps * (32 * kMmaK + 32 * kAccLd * 4);
}

struct K5Smem {
  uint8_t* t;            // T: byte column c's 16 rows at t[16 c]
  uint32_t* s;           // S (limbs_n)
  uint32_t* two_s;       // 2S mod 2^(32 limbs_sq)
  uint32_t* s_sq;        // S^2 mod 2^(32 limbs_sq)
  uint32_t* s_cu;        // S^2 * S mod 2^(32 limbs_cu)
  uint32_t* three_s_sq;  // 3 S^2 mod 2^(32 limbs_cu)
  uint32_t* three_s;     // 3S mod 2^(32 limbs_cu)
  uint8_t* d;            // this warp's 32 rows of D (16 bytes each)
  int32_t* acc;          // this warp's 32 rows of column sums (kAccLd words)
};

// Carves base (128-byte aligned) as k5_smem_bytes lays it out.
__device__ inline K5Smem k5_layout(unsigned char* base, int limbs_n,
                                   int limbs_sq, int limbs_cu, int front) {
  K5Smem sh;
  int off = k5_round128(front);
  sh.t = base + off;
  off += kMmaK * kTileCols * (k5_tiles(limbs_sq) + k5_tiles(limbs_cu));
  uint32_t* l = reinterpret_cast<uint32_t*>(base + off);
  sh.s = l;
  sh.two_s = sh.s + limbs_n;
  sh.s_sq = sh.two_s + limbs_sq;
  sh.s_cu = sh.s_sq + limbs_sq;
  sh.three_s_sq = sh.s_cu + limbs_cu;
  sh.three_s = sh.three_s_sq + limbs_cu;
  off += k5_round128(4 * (limbs_n + 2 * limbs_sq + 3 * limbs_cu));
  sh.d = base + off + (threadIdx.x >> 5) * (32 * kMmaK + 32 * kAccLd * 4);
  sh.acc = reinterpret_cast<int32_t*>(sh.d + 32 * kMmaK);
  return sh;
}

// o = a * b mod 2^(32 lo) over shared arrays, one thread, schoolbook.
__device__ inline void k5_mul(const uint32_t* a, int la, const uint32_t* b,
                              int lb, uint32_t* o, int lo) {
  for (int k = 0; k < lo; ++k) o[k] = 0;
  for (int i = 0; i < la && i < lo; ++i) {
    uint64_t carry = 0;
    for (int j = 0; j < lb && i + j < lo; ++j) {
      const uint64_t t = (uint64_t)a[i] * b[j] + o[i + j] + carry;
      o[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    if (i + lb < lo) o[i + lb] = (uint32_t)carry;
  }
}

// o = a * m mod 2^(32 lo), a of la limbs (zero above).
__device__ inline void k5_scale(const uint32_t* a, int la, uint32_t m,
                                uint32_t* o, int lo) {
  uint64_t carry = 0;
  for (int k = 0; k < lo; ++k) {
    const uint64_t t = (uint64_t)(k < la ? a[k] : 0u) * m + carry;
    o[k] = (uint32_t)t;
    carry = t >> 32;
  }
}

// Byte j of a value of `limbs` u32 limbs (0 outside it).
NICE_D uint32_t k5_byte(const uint32_t* x, int limbs, int j) {
  return (j >= 0 && j < 4 * limbs) ? (x[j >> 2] >> (8 * (j & 3))) & 0xffu
                                   : 0u;
}

// Builds the launch's constants and T in shared memory from the start
// limbs (int64 words): every thread of the block calls it, and it ends with
// the block synchronised.
__device__ inline void k5_setup(const int64_t* start, int limbs_n,
                                int limbs_sq, int limbs_cu, const K5Smem& sh) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < limbs_n; ++i) sh.s[i] = (uint32_t)start[i];
    k5_scale(sh.s, limbs_n, 2, sh.two_s, limbs_sq);
    k5_mul(sh.s, limbs_n, sh.s, limbs_n, sh.s_sq, limbs_sq);
    k5_mul(sh.s_sq, limbs_sq, sh.s, limbs_n, sh.s_cu, limbs_cu);
    k5_scale(sh.s_sq, limbs_sq, 3, sh.three_s_sq, limbs_cu);
    k5_scale(sh.s, limbs_n, 3, sh.three_s, limbs_cu);
  }
  __syncthreads();
  const int cols_sq = kTileCols * k5_tiles(limbs_sq);
  const int cols = cols_sq + kTileCols * k5_tiles(limbs_cu);
  for (int x = threadIdx.x; x < cols * kMmaK; x += blockDim.x) {
    const int col = x / kMmaK, k = x % kMmaK;
    uint32_t v = 0;
    if (col < cols_sq) {
      if (k < 4) v = k5_byte(sh.two_s, limbs_sq, col - k);
    } else if (k < 4) {
      v = k5_byte(sh.three_s_sq, limbs_cu, col - cols_sq - k);
    } else if (k < 12) {
      v = k5_byte(sh.three_s, limbs_cu, col - cols_sq - (k - 4));
    }
    sh.t[x] = (uint8_t)v;
  }
  __syncthreads();
}

// Returns x / c and stores x % c in *r, for x < c * 2^32 and 2 <= c < 2^32,
// given m = floor((2^64 - 1) / c). __umul64hi(x, m) never over-estimates the
// quotient and under-estimates it by at most one (the error term x * (1 + c)
// / (c * 2^64) stays below 1 in that domain), so one correction is exact.
NICE_D uint32_t divmod_magic(uint64_t x, uint32_t c, uint64_t m, uint32_t* r) {
  uint64_t q = __umul64hi(x, m);
  uint64_t rr = x - q * c;
  if (rr >= c) {
    q += 1;
    rr -= c;
  }
  *r = (uint32_t)rr;
  return (uint32_t)q;
}

// Upper bound on the u32 limbs of base^rem_digits (ops/limbs.py
// quotient_limbs): the dividend shrinks to it as digits are peeled.
NICE_D int quotient_limbs(int rem_digits, uint64_t log2_fx) {
  return (int)((((uint64_t)rem_digits * log2_fx) >> kLog2FxBits) / 32) + 1;
}

// NL, SQL, CUL: limb capacities of n, n^2, n^3; NM: mask-word capacity.
// UNROLL: loop to the capacities (unrolled, register arrays) instead of the
// runtime counts (local-memory arrays).
template <int NL, int SQL, int CUL, int NM, bool UNROLL>
struct Lane {
  static bool fits(const Plan& p) {
    return p.limbs_n <= NL && p.limbs_sq <= SQL && p.limbs_cu <= CUL &&
           p.n_masks <= NM;
  }

  // n = start + g, truncated to limbs_n limbs. start holds u32 values in
  // int64 words (the port's limb carrier). Returns whether the sum wrapped
  // past limbs_n limbs (no lane inside the base's range does).
  static NICE_D bool load_n(uint32_t (&n)[NL], const int64_t* start,
                             uint64_t g, const Plan& p) {
    uint64_t carry = g;
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? NL : p.limbs_n); ++i) {
      if (UNROLL && i >= p.limbs_n) {
        n[i] = 0;
        continue;
      }
      const uint64_t s = (uint64_t)(uint32_t)start[i] + (carry & 0xffffffffull);
      n[i] = (uint32_t)s;
      carry = (carry >> 32) + (s >> 32);
    }
    return carry != 0;
  }

  // o = a * b mod 2^(32 * lo): one row of a at a time, the row's carry kept
  // in a 64-bit register; a[i]*b[j] + o[k] + carry < 2^64 always.
  template <int LA, int LB, int LO>
  static NICE_D void mul(const uint32_t (&a)[LA], int la,
                          const uint32_t (&b)[LB], int lb, uint32_t (&o)[LO],
                          int lo) {
    NICE_UNROLL
    for (int k = 0; k < (UNROLL ? LO : lo); ++k) o[k] = 0;
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? LA : la); ++i) {
      if (UNROLL && i >= la) continue;
      uint64_t carry = 0;
      NICE_UNROLL
      for (int j = 0; j <= (UNROLL ? LB : lb); ++j) {
        const int k = i + j;
        if (k >= LO || k >= lo) break;
        if (j < LB && j < lb) {
          const uint64_t t = (uint64_t)a[i] * b[j] + o[k] + carry;
          o[k] = (uint32_t)t;
          carry = t >> 32;
        } else if (j == lb) {
          o[k] = (uint32_t)carry;  // rows above i have not reached o[i + lb]
        }
      }
    }
  }

  // OR digit d's presence bit into word d >> 5; words past n_masks (a lane
  // outside the base's range can yield such digits) are dropped.
  static NICE_D void set_digit(uint32_t (&m)[NM], uint32_t d, const Plan& p) {
    const uint32_t bit = 1u << (d & 31u);
    const uint32_t w = d >> 5;
    if constexpr (UNROLL) {
      NICE_UNROLL
      for (int i = 0; i < NM; ++i) {
        if (w == (uint32_t)i && i < p.n_masks) m[i] |= bit;
      }
    } else {
      if (w < (uint32_t)p.n_masks) m[w] |= bit;
    }
  }

  // Peel ndig digits off the value in v[0..nl), destroying it. Inside the
  // base's valid range the value has exactly ndig digits.
  template <int L>
  static NICE_D void digits(uint32_t (&v)[L], int nl, int ndig, const Plan& p,
                             uint32_t (&m)[NM]) {
    int rem = ndig;
    NICE_PLAN_UNROLL
    while (rem > p.chunk_e) {
      rem -= p.chunk_e;
      uint32_t r = 0;
      NICE_UNROLL
      for (int k = 0; k < (UNROLL ? L : nl); ++k) {
        const int i = (UNROLL ? L : nl) - 1 - k;
        if (UNROLL && i >= nl) continue;
        const uint64_t cur = ((uint64_t)r << 32) | v[i];
        v[i] = divmod_magic(cur, p.chunk_div, p.chunk_magic, &r);
      }
      const int bound = quotient_limbs(rem, p.log2_fx);
      nl = nl < bound ? nl : bound;
      NICE_PLAN_UNROLL
      for (int t = 1; t < p.chunk_e; ++t) {
        uint32_t d;
        r = divmod_magic(r, p.base, p.base_magic, &d);
        set_digit(m, d, p);
      }
      set_digit(m, r, p);
    }
    uint32_t r = v[0];
    NICE_PLAN_UNROLL
    for (int t = 1; t < rem; ++t) {
      uint32_t d;
      r = divmod_magic(r, p.base, p.base_magic, &d);
      set_digit(m, d, p);
    }
    if (rem > 0) set_digit(m, r, p);
  }

  // a < b on the low limbs_n limbs, most significant limb first; b holds
  // u32 values in int64 words.
  static NICE_D bool less(const uint32_t (&a)[NL], const int64_t* b,
                          const Plan& p) {
    bool lt = false, eq = true;
    NICE_UNROLL
    for (int k = 0; k < (UNROLL ? NL : p.limbs_n); ++k) {
      const int i = (UNROLL ? NL : p.limbs_n) - 1 - k;
      if (UNROLL && i >= p.limbs_n) continue;
      const uint32_t bi = (uint32_t)b[i];
      lt = lt || (eq && a[i] < bi);
      eq = eq && a[i] == bi;
    }
    return lt;
  }

  static NICE_D int uniques(const int64_t* start, uint64_t g, const Plan& p) {
    uint32_t n[NL];
    load_n(n, start, g, p);
    return uniques_of(n, p);
  }

  // K3's lane: candidate i of one stride descriptor. row holds the
  // descriptor's n0, lo and hi as four u32 limbs each (int64 words, LSW
  // first); residues holds the stride table's num_res residues modulo
  // `modulus`. n = n0 + (i / num_res) * modulus + residues[i % num_res] in
  // u32 (the caller keeps periods * modulus < 2^32), carried through limbs_n
  // limbs; 1 when lo <= n < hi and min_u <= num_uniques(n) <= base, else 0.
  // With min_u = base this is the TPU kernel's nice test, num_uniques(n) ==
  // base; a lower min_u (a check's, never the search's) makes the count
  // sensitive to every step of a lane where nice numbers are absent. Lanes
  // outside [lo, hi) skip the digit work.
  static NICE_D int strided_nice(const int64_t* row, const int64_t* residues,
                                 uint32_t num_res, uint32_t modulus,
                                 uint32_t i, int min_u, const Plan& p) {
    const uint32_t q = i / num_res;
    const uint32_t off = q * modulus + (uint32_t)residues[i - q * num_res];
    uint32_t n[NL];
    load_n(n, row, off, p);
    if (less(n, row + 4, p) || !less(n, row + 8, p)) return 0;
    const int u = uniques_of(n, p);
    return u >= min_u && u <= (int)p.base;
  }

  // start mod (base - 1), for K4: the limbs most significant first, each
  // step (r << 32 | limb) mod (base - 1) by divmod_magic (r < base - 1, so
  // the step stays in its domain).
  static NICE_D uint32_t start_residue(const int64_t* start, const Plan& p) {
    const uint32_t m = p.base - 1;
    uint32_t r = 0;
    NICE_UNROLL
    for (int k = 0; k < (UNROLL ? NL : p.limbs_n); ++k) {
      const int i = (UNROLL ? NL : p.limbs_n) - 1 - k;
      if (UNROLL && i >= p.limbs_n) continue;
      divmod_magic(((uint64_t)r << 32) | (uint32_t)start[i], m, p.res_magic,
                   &r);
    }
    return r;
  }

  // K4's lane: enumerated lane j of a dense run from `start`, whose residue
  // modulo m = base - 1 is s. classes holds the kept residue classes modulo
  // m (num_cls of them). Lane j stands for class classes[j % num_cls] in
  // period j / num_cls, the candidate start + i with
  // i = ((classes[j % num_cls] - s) mod m) + (j / num_cls) * m, so that
  // (start + i) mod m is the class. Past valid_total it is no candidate and
  // returns 0; otherwise it adds 1 to *kept, carries i into the start limbs
  // and returns 1 when min_u <= num_uniques <= base. With min_u = base this
  // is the TPU kernel's nice test.
  static NICE_D int dense_nice(const int64_t* start, const int64_t* classes,
                               uint32_t num_cls, uint32_t s, uint32_t j,
                               uint32_t valid_total, int min_u, const Plan& p,
                               int* kept) {
    const uint32_t i = dense_offset(classes, num_cls, s, j, p);
    if (i >= valid_total) return 0;
    *kept += 1;
    uint32_t n[NL];
    load_n(n, start, i, p);
    const int u = uniques_of(n, p);
    return u >= min_u && u <= (int)p.base;
  }

  // K4's lane offset: enumerated lane j of a run is the candidate start + i
  // of class classes[j % num_cls] in period j / num_cls (see dense_nice).
  static NICE_D uint32_t dense_offset(const int64_t* classes, uint32_t num_cls,
                                      uint32_t s, uint32_t j, const Plan& p) {
    const uint32_t m = p.base - 1;
    const uint32_t q = j / num_cls;
    const uint32_t cls = (uint32_t)classes[j - q * num_cls];
    return (cls >= s ? cls - s : cls + m - s) + q * m;
  }

  static NICE_D int uniques_of(const uint32_t (&n)[NL], const Plan& p) {
    uint32_t sq[SQL], cu[CUL];
    mul(n, p.limbs_n, n, p.limbs_n, sq, p.limbs_sq);
    mul(sq, p.limbs_sq, n, p.limbs_n, cu, p.limbs_cu);
    return uniques_from(sq, cu, p);
  }

  // K5's lane: num_uniques of n = start + i (i < 2^31) through K5's
  // products. Every thread of a warp calls it together (the MMA is the
  // warp's); a lane that is not live takes part with i = 0 and returns 0.
  static NICE_D int uniques_mma(const int64_t* start, uint32_t i, bool live,
                                const Plan& p, const K5Smem& sh) {
    uint32_t n[NL], sq[SQL], cu[CUL];
    const bool wrapped = load_n(n, start, i, p);
    products_mma(n, wrapped, i, p, sh, sq, cu);
    if (!live) return 0;
    return uniques_from(sq, cu, p);
  }

  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                 unsigned char, nvcuda::wmma::row_major>
      FragA;

  // The warp's 32 rows of column sums of one tile of T (16 byte columns at
  // t_tile): two 16 x 16 x 16 MMAs (lanes 0-15, 16-31) staged through the
  // warp's accumulator rows; col gets this thread's row.
  static NICE_D void mma_tile(const FragA& a0, const FragA& a1,
                              const uint8_t* t_tile, int32_t* acc,
                              int32_t (&col)[16]) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major>
        b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
    wmma::load_matrix_sync(b, t_tile, kMmaK);
    wmma::fill_fragment(c, 0);
    wmma::mma_sync(c, a0, b, c);
    wmma::store_matrix_sync(acc, c, kAccLd, wmma::mem_row_major);
    wmma::fill_fragment(c, 0);
    wmma::mma_sync(c, a1, b, c);
    wmma::store_matrix_sync(acc + 16 * kAccLd, c, kAccLd, wmma::mem_row_major);
    __syncwarp();
    const int4* row =
        reinterpret_cast<const int4*>(acc + (threadIdx.x & 31) * kAccLd);
    NICE_UNROLL
    for (int q = 0; q < 4; ++q) {
      const int4 v = row[q];
      col[4 * q] = v.x;
      col[4 * q + 1] = v.y;
      col[4 * q + 2] = v.z;
      col[4 * q + 3] = v.w;
    }
    __syncwarp();
  }

  // A tile's 16 byte columns (LS first) into limbs 4 tile .. 4 tile + 3 of
  // o (those below lo), the carry between limbs in *carry.
  template <int L>
  static NICE_D void columns_to_limbs(const int32_t (&col)[16], int tile,
                                      uint32_t (&o)[L], int lo,
                                      uint64_t* carry) {
    NICE_UNROLL
    for (int u = 0; u < 4; ++u) {
      const uint64_t a = *carry + (uint64_t)(uint32_t)col[4 * u] +
                         ((uint64_t)(uint32_t)col[4 * u + 1] << 8) +
                         ((uint64_t)(uint32_t)col[4 * u + 2] << 16) +
                         ((uint64_t)(uint32_t)col[4 * u + 3] << 24);
      const int l = 4 * tile + u;
      if (l < L && l < lo) o[l] = (uint32_t)a;
      *carry = a >> 32;
    }
  }

  // x += c + (y2:y1:y0) mod 2^(32 lx), c a shared limb constant.
  template <int L>
  static NICE_D void add_const(uint32_t (&x)[L], int lx, const uint32_t* c,
                               uint32_t y0, uint32_t y1, uint32_t y2) {
    uint64_t carry = 0;
    NICE_UNROLL
    for (int k = 0; k < (UNROLL ? L : lx); ++k) {
      if (UNROLL && k >= lx) continue;
      const uint32_t y = k == 0 ? y0 : k == 1 ? y1 : k == 2 ? y2 : 0u;
      const uint64_t t = (uint64_t)x[k] + c[k] + y + carry;
      x[k] = (uint32_t)t;
      carry = t >> 32;
    }
  }

  // n >= 2^(16 limbs_sq), i.e. n^2 passes limbs_sq limbs (no lane inside
  // the base's range does).
  static NICE_D bool square_overflows(const uint32_t (&n)[NL], const Plan& p) {
    const int h = 16 * p.limbs_sq;
    bool over = false;
    NICE_UNROLL
    for (int k = 0; k < (UNROLL ? NL : p.limbs_n); ++k) {
      if (UNROLL && k >= p.limbs_n) continue;
      if (32 * k >= h) {
        over = over || n[k] != 0;
      } else if (32 * k + 32 > h) {
        over = over || (n[k] >> (h - 32 * k)) != 0;
      }
    }
    return over;
  }

  // K5's products of the warp's lanes n = S + i (S in sh, i this thread's):
  // D's rows staged, then the GEMM one tile at a time, each thread's 16
  // sums walked into 4 limbs, then + S^2 + i^2 and + S^3 + i^3. sq and cu
  // are K1's (n^2 mod 2^(32 limbs_sq), that times n mod 2^(32 limbs_cu)).
  // A lane whose n wrapped or whose square passes limbs_sq limbs (outside
  // the base's range) takes mul's schoolbook products instead, so K5 equals
  // K1 on every lane.
  static NICE_D void products_mma(const uint32_t (&n)[NL], bool wrapped,
                                  uint32_t i, const Plan& p, const K5Smem& sh,
                                  uint32_t (&sq)[SQL], uint32_t (&cu)[CUL]) {
    using namespace nvcuda;
    const uint64_t i2 = (uint64_t)i * i;
    __syncwarp();
    reinterpret_cast<uint4*>(sh.d)[threadIdx.x & 31] =
        make_uint4(i, (uint32_t)i2, (uint32_t)(i2 >> 32), 0u);
    __syncwarp();
    FragA a0, a1;
    wmma::load_matrix_sync(a0, sh.d, kMmaK);
    wmma::load_matrix_sync(a1, sh.d + 16 * kMmaK, kMmaK);
    const int nt_sq = k5_tiles(p.limbs_sq), nt_cu = k5_tiles(p.limbs_cu);
    int32_t col[16];
    uint64_t carry = 0;
    NICE_UNROLL
    for (int tile = 0; tile < (UNROLL ? k5_tiles(SQL) : nt_sq); ++tile) {
      if (UNROLL && tile >= nt_sq) break;
      mma_tile(a0, a1, sh.t + tile * kTileCols * kMmaK, sh.acc, col);
      columns_to_limbs(col, tile, sq, p.limbs_sq, &carry);
    }
    carry = 0;
    NICE_UNROLL
    for (int tile = 0; tile < (UNROLL ? k5_tiles(CUL) : nt_cu); ++tile) {
      if (UNROLL && tile >= nt_cu) break;
      mma_tile(a0, a1, sh.t + (nt_sq + tile) * kTileCols * kMmaK, sh.acc, col);
      columns_to_limbs(col, tile, cu, p.limbs_cu, &carry);
    }
    const uint64_t i3_lo = i2 * i;  // i^3 < 2^93: three limbs
    add_const(sq, p.limbs_sq, sh.s_sq, (uint32_t)i2, (uint32_t)(i2 >> 32), 0u);
    add_const(cu, p.limbs_cu, sh.s_cu, (uint32_t)i3_lo,
              (uint32_t)(i3_lo >> 32), (uint32_t)__umul64hi(i2, i));
#ifndef NICE_K5_NO_FALLBACK
    if (wrapped || square_overflows(n, p)) {
      mul(n, p.limbs_n, n, p.limbs_n, sq, p.limbs_sq);
      mul(sq, p.limbs_sq, n, p.limbs_n, cu, p.limbs_cu);
    }
#endif
  }

  static NICE_D int uniques_from(uint32_t (&sq)[SQL], uint32_t (&cu)[CUL],
                                 const Plan& p) {
    uint32_t m[NM];
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? NM : p.n_masks); ++i) m[i] = 0;
    digits(sq, p.limbs_sq, p.d_sq, p, m);
    digits(cu, p.limbs_cu, p.d_cu, p, m);
    int u = 0;
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? NM : p.n_masks); ++i) {
      if (!UNROLL || i < p.n_masks) u += __popc(m[i]);
    }
    return u;
  }
};

// The tiers, smallest first; the launcher takes the first that fits.
// SmallTier: b10..b55 (n <= 2, n^2 <= 4, n^3 <= 6 limbs; <= 64 digits), which
// holds the main path's b40 and every benchmark base except hi-base (b80,
// whose niceonly fields K3 runs in the generic tier).
// GenericTier: any base whose histogram the TPU kernels accept (base + 2 <= 2048;
// at b2046, n/n^2/n^3 take 141/282/422 limbs); K4's niceonly fields (b98 and
// up, 5/9/13 limbs at b98) run here.
typedef Lane<2, 4, 6, 2, true> SmallTier;
typedef Lane<144, 288, 424, 64, false> GenericTier;

inline Plan plan_from_words(const uint64_t* w) {
  Plan p;
  p.base = (uint32_t)w[PW_BASE];
  p.limbs_n = (int)w[PW_LIMBS_N];
  p.limbs_sq = (int)w[PW_LIMBS_SQ];
  p.limbs_cu = (int)w[PW_LIMBS_CU];
  p.d_sq = (int)w[PW_D_SQ];
  p.d_cu = (int)w[PW_D_CU];
  p.n_masks = (int)w[PW_N_MASKS];
  p.cutoff = (int)w[PW_CUTOFF];
  p.chunk_e = (int)w[PW_CHUNK_E];
  p.chunk_div = (uint32_t)w[PW_CHUNK_DIV];
  p.chunk_magic = w[PW_CHUNK_MAGIC];
  p.base_magic = w[PW_BASE_MAGIC];
  p.log2_fx = w[PW_LOG2_FX];
  p.res_magic = w[PW_RES_MAGIC];
  return p;
}

// 0 for SmallTier, 1 for GenericTier; -1 when no tier holds the plan.
inline int pick_tier(const Plan& p) {
  if (SmallTier::fits(p)) return 0;
  if (GenericTier::fits(p)) return 1;
  return -1;
}

}  // namespace nice
