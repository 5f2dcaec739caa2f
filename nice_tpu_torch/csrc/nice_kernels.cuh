// Per-lane arithmetic shared by the four kernels in nice_kernels.cu.
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
  // int64 words (the port's limb carrier).
  static NICE_D void load_n(uint32_t (&n)[NL], const int64_t* start,
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
    const uint32_t m = p.base - 1;
    const uint32_t q = j / num_cls;
    const uint32_t cls = (uint32_t)classes[j - q * num_cls];
    const uint32_t i = (cls >= s ? cls - s : cls + m - s) + q * m;
    if (i >= valid_total) return 0;
    *kept += 1;
    uint32_t n[NL];
    load_n(n, start, i, p);
    const int u = uniques_of(n, p);
    return u >= min_u && u <= (int)p.base;
  }

  static NICE_D int uniques_of(const uint32_t (&n)[NL], const Plan& p) {
    uint32_t sq[SQL], cu[CUL], m[NM];
    mul(n, p.limbs_n, n, p.limbs_n, sq, p.limbs_sq);
    mul(sq, p.limbs_sq, n, p.limbs_n, cu, p.limbs_cu);
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
