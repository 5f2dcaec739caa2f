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
//   * a chunk's digits come off its remainder (< 2^31) in 32-bit arithmetic:
//     one __umulhi by a host-computed magic and a shift per digit;
//   * presence bits live in u64 mask words, counted with __popcll.
// The plain PyTorch twin (nice_tpu_torch/ops/vector_engine.py) runs the same
// steps in int64 carriers; both agree on every lane, in range or not.
//
// In the main library (nice_kernels.cu) everything per base is a runtime
// value (struct Plan), so one build serves every base. Array capacities are
// template parameters of a tier: in the small tier (and K4's dense tier)
// every loop over limbs runs to the constant capacity under a guard, is
// fully unrolled, and the limb arrays stay in registers; the generic tier
// loops to the runtime counts over arrays in local memory (slow, but right
// for every base up to 2046). The plan tier (PlanTier, at the end) is the
// lane built for one base, as the TPU traced a kernel per plan: a build
// that defines NICE_PLAN (plan_kernels.cu, op_count.cu) gets it.

#pragma once

#include <stdint.h>

#define NICE_D __device__ __forceinline__

// Unrolls a loop whose trip count is a compile-time constant; leaves a loop
// with a runtime trip count alone.
#define NICE_UNROLL _Pragma("unroll")

// Marks the loops whose trip count is a plan value (the digit chunks). The
// runtime-plan kernels leave them to the compiler; a build for one base
// (NICE_PLAN defined: plan_kernels.cu, op_count.cu) unrolls them fully.
#ifdef NICE_PLAN
#define NICE_PLAN_UNROLL NICE_UNROLL
#else
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
  PW_LOG2_FX,
  PW_RES_MAGIC,
  PW_DIGIT_MAGIC,
  PW_DIGIT_MAGIC_FULL,
  PW_DIGIT_SHIFT,
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
  uint64_t log2_fx;                 // >= log2(base) * 2^kLog2FxBits
  uint64_t res_magic;               // floor((2^64 - 1) / (base - 1))
  // One digit off x < 2^32 in 32-bit arithmetic (see div_base), with
  // s = ceil(log2 base) - 1: digit_magic = ceil(2^(32 + s) / base) and
  // digit_magic_full = floor(2^(33 + s) / base) + 1 - 2^32, both < 2^32.
  uint32_t digit_magic;
  uint32_t digit_magic_full;
  int digit_shift;
};

// --------------------------------------------------------------------------
// K5: the tensor-core product step (see ops/mxu.py for the algebra)
// --------------------------------------------------------------------------
//
// A lane of K1 or K4 is n = S + i, S the launch's start and i < 2^31 the
// lane's offset, so n^2 = S^2 + 2S*i + i^2 and n^3 = S^3 + 3S^2*i + 3S*i^2 +
// i^3. The lane-dependent parts are one GEMM with a shared operand: D (a row
// per lane: the 4 bytes of i and the 8 of i^2, padded to 16) times T (the
// Toeplitz bands of the bytes of S for n^2's byte columns, of S^2 and S for
// n^3's), on the tensor cores as mma.sync m16n8k16 u8 x u8 -> s32 (column
// sums at most 12 * 255 * 255), in registers; the factors 2 and 3 of the
// algebra multiply the column sums as they are walked into limbs
// (ops/mxu.py puts them into T's bands instead: the same sums).
//   * A warp's 32 lanes are the MMA's rows, two halves of 16: in quad g
//     (lanes 4g..4g+3), quad lane r is row g + 8 (r & 1) of half r >> 1.
//   * D is the A operand: thread (g, q) holds word q of rows g and g + 8 of
//     each half, so word q of the D row ({i, lo(i^2), hi(i^2), 0}) of each
//     lane of its quad, made from the quad's four offsets.
//   * T is the B operand, 16 x 8 bytes a tile of two limbs: thread (g, q)
//     holds rows 4q..4q+3 of byte column g, one word a tile. T is the
//     launch's: the block fills its words into shared memory once, and a
//     thread loads its own before its grid-stride loop (into registers
//     where the tier's tile count is a constant).
//   * C: thread (g, q) gets byte columns 2q and 2q + 1 of each lane of its
//     quad. It folds them into one word a lane (< 2^29); three xor shuffles
//     give every lane the four words of its own row, which make the tile's
//     two limbs as 64-bit sums, walked with one carry together with S^2 +
//     i^2 (S^3 + i^3).
// Each block forms S^2 and S^3 in shared memory from the start limbs, as
// warp 0's products, while its other warps fill T's words (k5_setup).

constexpr int kTileLimbs = 2;       // u32 limbs of one m16n8 tile (8 bytes)
constexpr int kMmaSmemMax = 48 * 1024;  // no opt-in beyond the default
constexpr int kK5Pad = 2;           // zero words below T's sources S, S^2

__host__ __device__ constexpr int k5_tiles(int limbs) {
  return (limbs + kTileLimbs - 1) / kTileLimbs;
}
__host__ __device__ constexpr int k5_round16(int x) { return (x + 15) & ~15; }

// Words of each of T's sources in shared memory: kK5Pad zero words below,
// then the value zero-extended to limbs_cu + 2 words, so that every byte
// window T reads lies inside.
__host__ __device__ constexpr int k5_source_words(int limbs_cu) {
  return kK5Pad + limbs_cu + 2;
}

// Shared-memory bytes of a K5 block: the caller's own `front` bytes (K1's
// histogram), then S and S^2 (T's sources, padded), S^3, and T's words, 32
// a tile, n^2's tiles first. ops/mxu.py smem_bytes computes the same for
// the detailed mode.
__host__ __device__ constexpr int k5_smem_bytes(int limbs_sq, int limbs_cu,
                                                int front) {
  return k5_round16(front) + 4 * (2 * k5_source_words(limbs_cu) + limbs_cu) +
         4 * 32 * (k5_tiles(limbs_sq) + k5_tiles(limbs_cu));
}

struct K5Smem {
  uint32_t* s;     // S, zero-extended (kK5Pad zero words below s[0])
  uint32_t* s_sq;  // S^2 mod 2^(32 limbs_sq), zero-extended the same way
  uint32_t* s_cu;  // S^2 * S mod 2^(32 limbs_cu)
  uint32_t* b;     // T's words: tile t's word of lane l at 32 t + l
};

// Carves base (16-byte aligned) as k5_smem_bytes lays it out.
NICE_D K5Smem k5_layout(unsigned char* base, int limbs_cu, int front) {
  K5Smem sh;
  const int src = k5_source_words(limbs_cu);
  sh.s = reinterpret_cast<uint32_t*>(base + k5_round16(front)) + kK5Pad;
  sh.s_sq = sh.s + src;
  sh.s_cu = sh.s_sq + src - kK5Pad;
  sh.b = sh.s_cu + limbs_cu;
  return sh;
}

// o[0, lo) = x * y mod 2^(32 lo), x of lx limbs and y of ly, all in shared
// memory, by the 32 lanes of the calling warp. Lane k sums column k of each
// 32-limb chunk in 96 bits (c0 + c1 2^32 + c2 2^64); v_k = c0_k + c1_{k-1} +
// c2_{k-2} < 2^35 and its carry e_k < 8 go one limb up, and the 1-bit
// carries left resolve by carry-lookahead on two ballots (lane k generates
// one when it overflowed, which leaves it below 8, and passes one on when it
// is all ones). What a chunk carries past its top lane goes into the next
// chunk's lanes 0 and 1.
NICE_D void k5_warp_mul(const uint32_t* x, int lx, const uint32_t* y, int ly,
                        uint32_t* o, int lo) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  uint64_t in0 = 0;
  uint32_t in1 = 0;
  for (int c = 0; c < lo; c += 32) {
    const int k = c + lane;
    // The products' low and high words summed apart (each sum < 2^40).
    uint64_t s_lo = 0, s_hi = 0;
    if (k < lo) {
      const int i1 = k < lx - 1 ? k : lx - 1;
      _Pragma("unroll 4")
      for (int i = k - ly + 1 > 0 ? k - ly + 1 : 0; i <= i1; ++i) {
        const uint64_t t = (uint64_t)x[i] * y[k - i];
        s_lo += (uint32_t)t;
        s_hi += t >> 32;
      }
    }
    const uint64_t rest = (s_lo >> 32) + s_hi;  // the column's c1 + c2 2^32
    const uint32_t top = (uint32_t)(rest >> 32);
    const uint32_t c1 = (uint32_t)rest;
    const uint32_t c1_up = __shfl_up_sync(full, c1, 1);
    const uint32_t c2_up = __shfl_up_sync(full, top, 2);
    const uint64_t v = (uint64_t)(uint32_t)s_lo + (lane >= 1 ? c1_up : 0u) +
                       (lane >= 2 ? c2_up : 0u) +
                       (lane == 0 ? in0 : lane == 1 ? (uint64_t)in1 : 0u);
    const uint32_t e = (uint32_t)(v >> 32);
    const uint32_t e_up = __shfl_up_sync(full, e, 1);
    const uint64_t z = (uint64_t)(uint32_t)v + (lane >= 1 ? e_up : 0u);
    const uint32_t w = (uint32_t)z;
    const uint32_t gen = __ballot_sync(full, (z >> 32) != 0);
    const uint32_t pass = __ballot_sync(full, w == 0xffffffffu);
    // The carries into each lane: those of (gen | pass) + gen.
    const uint64_t sum = (uint64_t)(gen | pass) + gen;
    const uint32_t cin = (uint32_t)sum ^ pass;
    if (k < lo) o[k] = w + ((cin >> lane) & 1u);
    if (c + 32 < lo) {
      in0 = (uint64_t)__shfl_sync(full, c1, 31) + __shfl_sync(full, top, 30) +
            __shfl_sync(full, e, 31) + (uint32_t)(sum >> 32);
      in1 = __shfl_sync(full, top, 31);
    }
  }
  __syncwarp();
}

// Bytes c0 - 3 .. c0 of the zero-extended source x, byte c0 lowest: T's
// word of rows 4q..4q+3 against a band ending at byte column c0 (row k
// takes byte c0 - (k - 4q)). -4 <= c0 < 4 (limbs_cu + 1) stays inside.
NICE_D uint32_t k5_window(const uint32_t* x, int c0) {
  const int b = c0 - 3;
  const uint32_t win =
      __funnelshift_r(x[b >> 2], x[(b >> 2) + 1], 8 * (b & 3));
  return __byte_perm(win, 0u, 0x0123);
}

// T's word of lane l = 4g + q in tile t: rows 4q..4q+3 of byte column
// 8 t' + g, with t' the tile within its product. Rows 0-3 take i's bytes
// (S's band for n^2, S^2's for n^3), rows 4-11 i^2's (S's band). Only
// those rows carry a term (q = 0 in n^2's tiles, q < 3 in n^3's): the
// other words are never filled, and a thread takes them as 0.
NICE_D uint32_t k5_b_word(const K5Smem& sh, int nt_sq, int t, int l) {
  const int q = l & 3;
  const int col = 8 * (t < nt_sq ? t : t - nt_sq) + (l >> 2);
  if (t < nt_sq) return k5_window(sh.s, col);
  return q == 0 ? k5_window(sh.s_sq, col) : k5_window(sh.s, col - 4 * (q - 1));
}

// The used words of T that need S alone (n^2's tiles, n^3's rows 4-11:
// 8 + 16 a tile) or S^2 (n^3's rows 0-3: 8 a tile) into sh, by the block's
// warps but warp 0, four words a thread in flight.
NICE_D void k5_fill(const K5Smem& sh, int nt_sq, int nt, bool need_sq) {
  const int words = need_sq ? 8 * (nt - nt_sq) : 8 * nt_sq + 16 * (nt - nt_sq);
  _Pragma("unroll 4")
  for (int u = (int)threadIdx.x - 32; u < words; u += (int)blockDim.x - 32) {
    int t, l;
    if (need_sq) {
      t = nt_sq + (u >> 3);
      l = 4 * (u & 7);
    } else if (u < 8 * nt_sq) {
      t = u >> 3;
      l = 4 * (u & 7);
    } else {
      const int r = u - 8 * nt_sq;
      t = nt_sq + (r >> 4);
      l = 4 * ((r & 15) >> 1) + 1 + (r & 1);
    }
    sh.b[32 * t + l] = k5_b_word(sh, nt_sq, t, l);
  }
}

// The block's K5 constants in sh from the start limbs: S and S^2 with their
// zero words, S^3 and T's words. Warp 0 forms S^2, then S^3; meanwhile the
// other warps fill T's words from S's band, then those from S^2's. Every
// thread of the block calls it (at least two warps), and it ends with the
// block synchronised.
NICE_D void k5_setup(const int64_t* start, const Plan& p, const K5Smem& sh) {
  const int n = p.limbs_n, lsq = p.limbs_sq, lcu = p.limbs_cu;
  const int src = k5_source_words(lcu);
  for (int k = threadIdx.x; k < 2 * src; k += blockDim.x) {
    const int j = k % src - kK5Pad;  // word j of S (k < src) or of S^2
    if (k < src) {
      sh.s[j] = j >= 0 && j < n ? (uint32_t)start[j] : 0u;
    } else if (j < 0 || j >= lsq) {
      sh.s_sq[j] = 0u;
    }
  }
  __syncthreads();
  const int nt_sq = k5_tiles(lsq), nt = nt_sq + k5_tiles(lcu);
  if (threadIdx.x < 32) {
    k5_warp_mul(sh.s, n, sh.s, n, sh.s_sq, lsq);
  } else {
    k5_fill(sh, nt_sq, nt, false);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    k5_warp_mul(sh.s_sq, lsq, sh.s, n, sh.s_cu, lcu);
  } else {
    k5_fill(sh, nt_sq, nt, true);
  }
  __syncthreads();
}

// C += A * B for one m16n8k16 tile, u8 x u8 -> s32 (a: A's two words, the
// rows g and g + 8 of the thread's quad; b: B's word).
NICE_D void mma_u8(int32_t (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// x[k ^ q] for the quad lane q = l & 3 (two xor-permutation steps: the
// quad's transpose reads and writes its words at indices relative to q).
NICE_D void k5_permute(uint32_t (&x)[4], int q) {
  const bool o = q & 1, h = q & 2;
  const uint32_t y0 = o ? x[1] : x[0], y1 = o ? x[0] : x[1];
  const uint32_t y2 = o ? x[3] : x[2], y3 = o ? x[2] : x[3];
  x[0] = h ? y2 : y0;
  x[1] = h ? y3 : y1;
  x[2] = h ? y0 : y2;
  x[3] = h ? y1 : y3;
}

// One tile's two limbs of this lane's row: the MMAs of both halves, each
// thread's two byte columns of each quad lane folded into a word (p[r]
// for quad lane r), the quad's transpose, and the four words of the lane's
// own row summed into limb 2t's and 2t+1's 64-bit parts (*lo, *hi).
NICE_D void k5_tile(const uint32_t (&a)[4], uint32_t b, uint64_t* lo,
                    uint64_t* hi) {
  int32_t c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
  mma_u8(c0, a[0], a[1], b);
  mma_u8(c1, a[2], a[3], b);
  // Column sums are below 2^20, so c + (c' << 8) < 2^29.
  uint32_t p[4] = {(uint32_t)c0[0] + ((uint32_t)c0[1] << 8),
                   (uint32_t)c0[2] + ((uint32_t)c0[3] << 8),
                   (uint32_t)c1[0] + ((uint32_t)c1[1] << 8),
                   (uint32_t)c1[2] + ((uint32_t)c1[3] << 8)};
  const int q = threadIdx.x & 3;
  k5_permute(p, q);  // p[k] = the word for quad lane q ^ k
  p[1] = __shfl_xor_sync(0xffffffffu, p[1], 1);
  p[2] = __shfl_xor_sync(0xffffffffu, p[2], 2);
  p[3] = __shfl_xor_sync(0xffffffffu, p[3], 3);
  k5_permute(p, q);  // p[q'] = quad lane q''s columns 2q', 2q'+1 of my row
  *lo = (uint64_t)p[0] + ((uint64_t)p[1] << 16);
  *hi = (uint64_t)p[2] + ((uint64_t)p[3] << 16);
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

// x / base for x < 2^31: __umulhi(x, digit_magic) >> digit_shift. The
// magic over-estimates 2^(32 + s) / base by e < base <= 2^(s + 1), so the
// error term x * e / 2^(32 + s) stays below 1 while x < 2^31: exact there.
NICE_D uint32_t div_base(uint32_t x, const Plan& p) {
  return __umulhi(x, p.digit_magic) >> p.digit_shift;
}

// x / base for every x < 2^32 (Granlund and Montgomery's round-up magic:
// M = 2^32 + digit_magic_full, l = s + 1, floor(x * M / 2^(32 + l)) is exact
// on all of [0, 2^32)), with the add-and-shift fix-up that keeps the sum in
// 32 bits.
NICE_D uint32_t div_base_full(uint32_t x, const Plan& p) {
  const uint32_t t = __umulhi(x, p.digit_magic_full);
  return (t + ((x - t) >> 1)) >> p.digit_shift;
}

// x / d for every u32 x and 1 <= d < 2^32, without a division: the
// round-up magic with the add-and-shift fix-up, as div_base_full, with
// l = ceil(log2 d), magic = floor(2^32 (2^l - d) / d) + 1, shift1 = min(l, 1)
// and shift2 = max(l - 1, 0) (ops/cuda_engine.py u32_divisor computes them).
struct U32Divisor {
  uint32_t magic;
  int shift1, shift2;
};

NICE_D uint32_t div_u32(uint32_t x, const U32Divisor& d) {
  const uint32_t t = __umulhi(x, d.magic);
  return (t + ((x - t) >> d.shift1)) >> d.shift2;
}

// Upper bound on the u32 limbs of base^rem_digits (ops/limbs.py
// quotient_limbs): the dividend shrinks to it as digits are peeled.
NICE_D int quotient_limbs(int rem_digits, uint64_t log2_fx) {
  return (int)((((uint64_t)rem_digits * log2_fx) >> kLog2FxBits) / 32) + 1;
}

// NL, SQL, CUL: limb capacities of n, n^2, n^3; NM: capacity in u32 mask
// words (the plan's n_masks), held as NW u64 words.
// UNROLL: loop to the capacities (unrolled, register arrays) instead of the
// runtime counts (local-memory arrays).
template <int NL, int SQL, int CUL, int NM, bool UNROLL>
struct Lane {
  static constexpr int NW = (NM + 1) / 2;

  // The plan a kernel runs: the runtime one (PlanTier's is its own).
  static NICE_D const Plan& plan(const Plan& p) { return p; }

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

  // OR digit d's presence bit into word d >> 6, for d < base (every digit
  // the peel yields but a value's leading one). The register tiers write
  // both of their words without an index: a select by d >> 6 is one the
  // compiler folds back into an indexed store, which puts the words in
  // local memory.
  static NICE_D void set_digit(uint64_t (&m)[NW], uint32_t d) {
    if constexpr (UNROLL && NW == 1) {
      m[0] |= 1ull << d;
    } else if constexpr (UNROLL) {
      static_assert(NW == 2, "a register tier holds at most 128 digits");
      const uint64_t bit = 1ull << (d & 63u);
      const uint64_t lo = d < 64u ? bit : 0ull;
      m[0] |= lo;
      m[1] |= bit ^ lo;
    } else {
      m[d >> 6] |= 1ull << (d & 63u);
    }
  }

  // The leading digit, which a lane outside the base's range can make any
  // u32: digits past the plan's 32 * n_masks bits are dropped (as the plain
  // version drops words past n_masks).
  static NICE_D void set_top_digit(uint64_t (&m)[NW], uint32_t d,
                                   const Plan& p) {
    if (d < 32u * (uint32_t)p.n_masks) set_digit(m, d);
  }

  // Peel ndig digits off the value in v[0..nl), destroying it. Inside the
  // base's valid range the value has exactly ndig digits. A chunk's
  // remainder is below chunk_div < 2^31, so its digits come off by
  // div_base; the last stage starts from v[0], which only inside the range
  // is below base^chunk_e, so its first digit comes off by div_base_full.
  template <int L>
  static NICE_D void digits(uint32_t (&v)[L], int nl, int ndig, const Plan& p,
                             uint64_t (&m)[NW]) {
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
        const uint32_t q = div_base(r, p);
        set_digit(m, r - q * p.base);
        r = q;
      }
      set_digit(m, r);
    }
    uint32_t r = v[0];
    if (rem > 1) {
      const uint32_t q = div_base_full(r, p);
      set_digit(m, r - q * p.base);
      r = q;
    }
    NICE_PLAN_UNROLL
    for (int t = 2; t < rem; ++t) {
      const uint32_t q = div_base(r, p);
      set_digit(m, r - q * p.base);
      r = q;
    }
    set_top_digit(m, r, p);
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
  // `modulus`, and by_res divides by num_res. n = n0 + (i / num_res) *
  // modulus + residues[i % num_res] in u32 (the caller keeps periods *
  // modulus < 2^32), carried through limbs_n limbs; 1 when lo <= n < hi and
  // min_u <= num_uniques(n) <= base, else 0. With min_u = base this is the
  // TPU kernel's nice test, num_uniques(n) == base; a lower min_u (a
  // check's, never the search's) makes the count sensitive to every step of
  // a lane where nice numbers are absent. Lanes outside [lo, hi) skip the
  // digit work.
  static NICE_D int strided_nice(const int64_t* row, const int64_t* residues,
                                 uint32_t num_res, const U32Divisor& by_res,
                                 uint32_t modulus, uint32_t i, int min_u,
                                 const Plan& p) {
    const uint32_t q = div_u32(i, by_res);
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

  // The generic tier's K5 kernel asks for one block an SM (nice_grid.cuh).
  static constexpr bool kUnroll = UNROLL;

  // T's words of this thread: in registers where the tier unrolls (n^2's
  // tiles at [0, TSQ), n^3's at [TSQ, TSQ + TCU)), else read from the
  // block's shared copy a tile at a time.
  static constexpr int TSQ = k5_tiles(SQL), TCU = k5_tiles(CUL);
  struct K5B {
    uint32_t r[UNROLL ? TSQ + TCU : 1];
    const uint32_t* smem;  // this thread's word of tile 0
  };

  // A thread's T words, once, after the block's k5_setup (its unused ones
  // read as 0: in the generic tier mma_limbs tests k5_b_used itself).
  static NICE_D void load_b(K5B& b, const Plan& p, const K5Smem& sh) {
    const int l = threadIdx.x & 31;
    b.smem = sh.b + l;
    if constexpr (UNROLL) {
      const int nt_sq = k5_tiles(p.limbs_sq), nt_cu = k5_tiles(p.limbs_cu);
      NICE_UNROLL
      for (int t = 0; t < TSQ; ++t) {
        b.r[t] = t < nt_sq && (l & 3) == 0 ? b.smem[32 * t] : 0u;
      }
      NICE_UNROLL
      for (int t = 0; t < TCU; ++t) {
        b.r[TSQ + t] =
            t < nt_cu && (l & 3) < 3 ? b.smem[32 * (nt_sq + t)] : 0u;
      }
    }
  }

  // K5's lane: num_uniques of n = start + i (i < 2^31) through K5's
  // products; iq holds the offsets of the thread's quad (lanes 4g..4g+3).
  // Every thread of a warp calls it together (the MMAs and shuffles are the
  // warp's); a lane that is not live takes part with i = 0 and returns 0.
  static NICE_D int uniques_mma(const int64_t* start, uint32_t i,
                                const uint32_t (&iq)[4], bool live,
                                const Plan& p, const K5B& b,
                                const K5Smem& sh) {
    uint32_t n[NL], sq[SQL], cu[CUL];
    const bool wrapped = load_n(n, start, i, p);
    products_mma(n, wrapped, i, iq, p, b, sh, sq, cu);
    if (!live) return 0;
    return uniques_from(sq, cu, p);
  }

  // One product's limbs o[0, lo): T's tiles t0 .. t0 + nt (of capacity TN
  // where the tier unrolls) against the lane's D row a, each tile's two
  // limbs walked with one carry, times the algebra's 2 (n^2) or 3 (cube:
  // n^3), together with c (a shared limb constant) and the lane term
  // (y2:y1:y0).
  template <int L, int TN>
  static NICE_D void mma_limbs(const uint32_t (&a)[4], const K5B& b, int t0,
                               int nt, bool cube, uint32_t (&o)[L], int lo,
                               const uint32_t* c, uint32_t y0, uint32_t y1,
                               uint32_t y2) {
    const uint32_t m = cube ? 3u : 2u;
    const bool used = (threadIdx.x & 3) < (cube ? 3u : 1u);
    uint64_t carry = 0;
    NICE_UNROLL
    for (int t = 0; t < (UNROLL ? TN : nt); ++t) {
      if (UNROLL && t >= nt) break;
      uint32_t bw;
      if constexpr (UNROLL) {
        bw = b.r[t0 + t];
      } else {
        bw = used ? b.smem[32 * (t0 + t)] : 0u;
      }
      uint64_t part[2];
      k5_tile(a, bw, &part[0], &part[1]);
      NICE_UNROLL
      for (int u = 0; u < kTileLimbs; ++u) {
        const int k = kTileLimbs * t + u;
        if (k >= L || k >= lo) break;
        const uint32_t y = k == 0 ? y0 : k == 1 ? y1 : k == 2 ? y2 : 0u;
        const uint64_t v = carry + (m * part[u] + c[k] + y);
        o[k] = (uint32_t)v;
        carry = v >> 32;
      }
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

  // K5's products of the warp's lanes n = S + i (S's constants in sh, i
  // this thread's, iq its quad's): D's words of the quad (word q of each
  // quad lane's row), then the GEMM a tile at a time, + S^2 + i^2 and
  // + S^3 + i^3. sq and cu are K1's (n^2 mod 2^(32 limbs_sq), that times n
  // mod 2^(32 limbs_cu)). A lane whose n wrapped or whose square passes
  // limbs_sq limbs (outside the base's range) takes mul's schoolbook
  // products instead, so K5 equals K1 on every lane.
  static NICE_D void products_mma(const uint32_t (&n)[NL], bool wrapped,
                                  uint32_t i, const uint32_t (&iq)[4],
                                  const Plan& p, const K5B& b,
                                  const K5Smem& sh, uint32_t (&sq)[SQL],
                                  uint32_t (&cu)[CUL]) {
    const int q = threadIdx.x & 3;
    uint32_t a[4];
    NICE_UNROLL
    for (int r = 0; r < 4; ++r) {
      const uint64_t s2 = (uint64_t)iq[r] * iq[r];
      a[r] = q == 0 ? iq[r]
           : q == 1 ? (uint32_t)s2
           : q == 2 ? (uint32_t)(s2 >> 32) : 0u;
    }
    const uint64_t i2 = (uint64_t)i * i;
    const uint64_t i3_lo = i2 * i;  // i^3 < 2^93: three limbs
    const int nt_sq = k5_tiles(p.limbs_sq), nt_cu = k5_tiles(p.limbs_cu);
    mma_limbs<SQL, TSQ>(a, b, 0, nt_sq, false, sq, p.limbs_sq, sh.s_sq,
                        (uint32_t)i2, (uint32_t)(i2 >> 32), 0u);
    mma_limbs<CUL, TCU>(a, b, UNROLL ? TSQ : nt_sq, nt_cu, true, cu,
                        p.limbs_cu, sh.s_cu, (uint32_t)i3_lo, (uint32_t)(i3_lo >> 32),
                        (uint32_t)__umul64hi(i2, i));
#ifndef NICE_K5_NO_FALLBACK
    if (wrapped || square_overflows(n, p)) {
      mul(n, p.limbs_n, n, p.limbs_n, sq, p.limbs_sq);
      mul(sq, p.limbs_sq, n, p.limbs_n, cu, p.limbs_cu);
    }
#endif
  }

  static NICE_D int uniques_from(uint32_t (&sq)[SQL], uint32_t (&cu)[CUL],
                                 const Plan& p) {
    const int nw = (p.n_masks + 1) / 2;
    uint64_t m[NW];
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? NW : nw); ++i) m[i] = 0;
    digits(sq, p.limbs_sq, p.d_sq, p, m);
    digits(cu, p.limbs_cu, p.d_cu, p, m);
    int u = 0;
    NICE_UNROLL
    for (int i = 0; i < (UNROLL ? NW : nw); ++i) u += __popcll(m[i]);
    return u;
  }
};

// The tiers, smallest first; the launcher takes the first that fits.
// SmallTier: b10..b55 (n <= 2, n^2 <= 4, n^3 <= 6 limbs; <= 64 digits), which
// holds the main path's b40 and every benchmark base except hi-base (b80,
// whose niceonly fields K3 runs in the generic tier).
// DenseTier: K4's and K5's dense mode (dense_tier), sized to the dense
// path's b98 plan (5/9/13 limbs, 4 mask words), with its limbs in
// registers; it holds every base from b97 to b104 (from b105 n^3 takes 14
// limbs).
// GenericTier: any base whose histogram the TPU kernels accept (base + 2 <= 2048;
// at b2046, n/n^2/n^3 take 141/282/422 limbs); every other base above b55.
typedef Lane<2, 4, 6, 2, true> SmallTier;
typedef Lane<5, 9, 13, 4, true> DenseTier;
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
  p.log2_fx = w[PW_LOG2_FX];
  p.res_magic = w[PW_RES_MAGIC];
  p.digit_magic = (uint32_t)w[PW_DIGIT_MAGIC];
  p.digit_magic_full = (uint32_t)w[PW_DIGIT_MAGIC_FULL];
  p.digit_shift = (int)w[PW_DIGIT_SHIFT];
  return p;
}

// 0 for SmallTier, 1 for GenericTier; -1 when no tier holds the plan.
inline int pick_tier(const Plan& p) {
  if (SmallTier::fits(p)) return 0;
  if (GenericTier::fits(p)) return 1;
  return -1;
}

// The plans that K2 and K3 run on the plan tier, built per base: every plan
// of at most kPlanTierLimbs limbs of n (b10-b97), which is all of K3's
// domain (a descriptor carries four limbs). K2 above it keeps pick_tier's.
// ops/cuda_engine.py PLAN_TIER_LIMBS mirrors the constant.
constexpr int kPlanTierLimbs = 4;

inline bool plan_tier_takes(const Plan& p) {
  return p.limbs_n <= kPlanTierLimbs;
}

// Return codes of the C interfaces beside a cudaError_t: no tier holds the
// plan; K5's shared memory exceeds kMmaSmemMax; the plan belongs to the plan
// tier (the main library does not run it); a per-base library was asked for
// another plan than the one it was built for; a block size outside the
// kernel's admissible set (nice_grid.cuh block_threads_ok).
constexpr int kNoTier = -1;
constexpr int kNoSmem = -2;
constexpr int kPlanTierOnly = -3;
constexpr int kOtherPlan = -4;
constexpr int kBadThreads = -5;

inline const char* error_string(int code) {
  switch (code) {
    case kNoTier: return "plan exceeds every kernel tier";
    case kNoSmem: return "plan exceeds K5's shared memory";
    case kPlanTierOnly: return "plan is run by its per-base build (plan tier)";
    case kOtherPlan: return "per-base library built for another plan";
    case kBadThreads: return "block size outside the kernel's admissible set";
    default: return nullptr;
  }
}

#ifdef NICE_PLAN
// PlanTier: the lane built for one base. The generated nice_plan.h
// (ops/cuda_engine.py plan_header) defines NICE_PLAN as the base's plan
// words in PlanWord order (struct Plan's) and NICE_PLAN_TIER as the plan's
// own limb counts of n, n^2, n^3 and mask words. So every loop has a
// constant trip count and no guard, every plan-valued loop unrolls, and
// every magic and divisor is an immediate: what the TPU compiled for each
// base (pallas_engine.py's lru_cached callables trace the plan as
// constants). The kernels take their plan from plan() and ignore the
// runtime one.
struct PlanTier : Lane<NICE_PLAN_TIER, true> {
  static __host__ __device__ __forceinline__ Plan plan(const Plan&) {
    constexpr Plan p = {NICE_PLAN};
    return p;
  }
};
#endif

}  // namespace nice
