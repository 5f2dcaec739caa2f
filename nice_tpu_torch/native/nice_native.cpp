// Host library of the port (nice_tpu_torch/native): a copy of the parts of
// nice_tpu/native/nice_native.cpp that the port's entry points reach,
// exposed through a small extern "C" surface loaded with ctypes:
//
//   * nice_msd_valid_ranges (+ the nice_ranges_* handle functions): the
//     recursive MSD prefix filter that turns a field into the surviving
//     ranges the strided kernel (K3) gets descriptors for;
//   * nice_iterate_range_strided: CRT stride-table iteration with an
//     early-exit niceness check per candidate, the host re-scan of the
//     descriptors the kernel counted hits in (and of the audited ones);
//   * nice_iterate_range_strided_poly: the polynomial-residue kernel of
//     k >= 3 stride tables, the host engine of the native backend and of
//     the small-field niceonly host route;
//   * nice_process_range_detailed: the native backend's detailed loop;
//   * nice_strided_fast_enabled: a test hook that turns both fast strided
//     paths off, so that tests can hold them against the generic loop.
//
// Arithmetic: candidates n fit in 128 bits for every base the strided path
// takes (n < 2^128, four u32 limbs); squares fit 256 bits, cubes 384.
// Fixed-width u64-limb routines with __int128 intermediates. All functions
// are pure and thread-safe; ctypes releases the GIL for each call, so the
// engine's filter threads and the native backend's pool run in parallel.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

// ---------------------------------------------------------------------------
// Fixed-width helpers (LSW-first u64 limbs)
// ---------------------------------------------------------------------------

// out[0..4) = a[0..2) * a[0..2)  (exact 128x128 -> 256)
inline void mul_2x2(const u64 a[2], const u64 b[2], u64 out[4]) {
    u128 ll = (u128)a[0] * b[0];
    u128 lh = (u128)a[0] * b[1];
    u128 hl = (u128)a[1] * b[0];
    u128 hh = (u128)a[1] * b[1];
    u64 c0 = (u64)ll;
    u128 t1 = (ll >> 64) + (u64)lh + (u64)hl;
    u64 c1 = (u64)t1;
    u128 t2 = (t1 >> 64) + (lh >> 64) + (hl >> 64) + (u64)hh;
    u64 c2 = (u64)t2;
    u64 c3 = (u64)((t2 >> 64) + (hh >> 64));
    out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// out[0..6) = a[0..4) * b[0..2)  (256x128 -> 384)
inline void mul_4x2(const u64 a[4], const u64 b[2], u64 out[6]) {
    u64 acc[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 2; ++j) {
            u128 cur = (u128)a[i] * b[j] + acc[i + j] + carry;
            acc[i + j] = (u64)cur;
            carry = cur >> 64;
        }
        int k = i + 2;
        while (carry != 0 && k < 6) {
            u128 cur = (u128)acc[k] + carry;
            acc[k] = (u64)cur;
            carry = cur >> 64;
            ++k;
        }
    }
    std::memcpy(out, acc, sizeof(acc));
}

// value[0..len) /= divisor, returns remainder; trims trailing zero limbs.
inline u64 div_limbs_inplace(u64* value, int& len, u64 divisor) {
    u128 rem = 0;
    for (int i = len - 1; i >= 0; --i) {
        u128 cur = (rem << 64) | value[i];
        value[i] = (u64)(cur / divisor);
        rem = cur % divisor;
    }
    while (len > 0 && value[len - 1] == 0) --len;
    return (u64)rem;
}

inline bool limbs_nonzero(const u64* value, int len) { return len > 0; }

// add small constant to a 2-limb value
inline void add_2(u64 v[2], u64 x) {
    u64 s = v[0] + x;
    v[1] += (s < v[0]) ? 1 : 0;
    v[0] = s;
}

// compare 2-limb values
inline int cmp_2(const u64 a[2], const u64 b[2]) {
    if (a[1] != b[1]) return a[1] < b[1] ? -1 : 1;
    if (a[0] != b[0]) return a[0] < b[0] ? -1 : 1;
    return 0;
}

// OR the digits of value (destroyed) into a u128 indicator; digits peeled
// until the value is zero (the CPU rule, reference client_process.rs:76-127).
inline void or_digits(u64* value, int len, u64 base, u128& indicator) {
    while (limbs_nonzero(value, len)) {
        u64 d = div_limbs_inplace(value, len, base);
        indicator |= (u128)1 << d;
    }
}

// Early-exit variant: returns false as soon as a duplicate digit appears
// (reference client_process.rs:222-253).
inline bool or_digits_distinct(u64* value, int len, u64 base, u128& indicator) {
    while (limbs_nonzero(value, len)) {
        u64 d = div_limbs_inplace(value, len, base);
        u128 bit = (u128)1 << d;
        if (indicator & bit) return false;
        indicator |= bit;
    }
    return true;
}

inline int popcount128(u128 x) {
    return __builtin_popcountll((u64)x) + __builtin_popcountll((u64)(x >> 64));
}

inline int limb_len(const u64* v, int cap) {
    int len = cap;
    while (len > 0 && v[len - 1] == 0) --len;
    return len;
}

inline int num_unique_digits_impl(const u64 n[2], u64 base) {
    u64 sq[4], cu[6];
    mul_2x2(n, n, sq);
    mul_4x2(sq, n, cu);
    u128 indicator = 0;
    int sq_len = limb_len(sq, 4), cu_len = limb_len(cu, 6);
    or_digits(sq, sq_len, base, indicator);
    or_digits(cu, cu_len, base, indicator);
    return popcount128(indicator);
}

inline bool is_nice_impl(const u64 n[2], u64 base) {
    u64 sq[4], cu[6];
    mul_2x2(n, n, sq);
    u128 indicator = 0;
    int sq_len = limb_len(sq, 4);
    // Square scanned before the cube is ever multiplied (reference
    // nice_kernels.cu:270-299 ordering; most candidates die in the square).
    u64 sq_copy[4];
    std::memcpy(sq_copy, sq, sizeof(sq));
    if (!or_digits_distinct(sq_copy, sq_len, base, indicator)) return false;
    mul_4x2(sq, n, cu);
    int cu_len = limb_len(cu, 6);
    return or_digits_distinct(cu, cu_len, base, indicator);
}

// ---------------------------------------------------------------------------
// MSD prefix filter (mirrors nice_tpu/ops/msd_filter.py exactly; the
// reference's unsound cross MSD x LSD check is intentionally omitted there
// and therefore here — see that module's docstring)
// ---------------------------------------------------------------------------

constexpr int MAX_DIGITS = 200;  // cube of a 128-bit n in base >= 10

struct Digits {
    uint8_t d[MAX_DIGITS];  // LSD first
    int len = 0;
};

inline void to_digits_asc(const u64* value_in, int cap, u64 base, Digits& out) {
    u64 value[6];
    std::memcpy(value, value_in, cap * sizeof(u64));
    int len = limb_len(value, cap);
    out.len = 0;
    if (len == 0) {
        out.d[out.len++] = 0;
        return;
    }
    while (limbs_nonzero(value, len)) {
        out.d[out.len++] = (uint8_t)div_limbs_inplace(value, len, base);
    }
}

// Longest shared MSD prefix; writes into pre (MSD first).
inline int common_msd_prefix(const Digits& a, const Digits& b, uint8_t* pre) {
    int n = a.len < b.len ? a.len : b.len;
    int out = 0;
    for (int i = 0; i < n; ++i) {
        uint8_t x = a.d[a.len - 1 - i];
        if (x == b.d[b.len - 1 - i]) pre[out++] = x;
        else break;
    }
    return out;
}

inline bool has_duplicate_digits(const uint8_t* d, int len) {
    u128 seen = 0;
    for (int i = 0; i < len; ++i) {
        u128 bit = (u128)1 << d[i];
        if (seen & bit) return true;
        seen |= bit;
    }
    return false;
}

inline bool has_overlapping_digits(const uint8_t* d1, int l1, const uint8_t* d2,
                                   int l2) {
    u128 seen = 0;
    for (int i = 0; i < l1; ++i) seen |= (u128)1 << d1[i];
    for (int i = 0; i < l2; ++i)
        if (seen & ((u128)1 << d2[i])) return true;
    return false;
}

// Half-open [start, end); true when the whole range can be skipped.
bool has_duplicate_msd_prefix(const u64 start[2], const u64 end[2], u64 base) {
    u64 size_is_one[2] = {start[0] + 1, start[1] + (start[0] + 1 == 0 ? 1 : 0)};
    if (cmp_2(size_is_one, end) == 0) return false;

    u64 last[2] = {end[0] - 1, end[1] - (end[0] == 0 ? 1 : 0)};

    u64 sq_first[4], sq_last[4];
    mul_2x2(start, start, sq_first);
    mul_2x2(last, last, sq_last);
    Digits dsq_first, dsq_last;
    to_digits_asc(sq_first, 4, base, dsq_first);
    to_digits_asc(sq_last, 4, base, dsq_last);
    if (dsq_first.len != dsq_last.len) return false;

    uint8_t sq_prefix[MAX_DIGITS];
    int sq_prefix_len = common_msd_prefix(dsq_first, dsq_last, sq_prefix);
    if (has_duplicate_digits(sq_prefix, sq_prefix_len)) return true;

    u64 cu_first[6], cu_last[6];
    mul_4x2(sq_first, start, cu_first);
    mul_4x2(sq_last, last, cu_last);
    Digits dcu_first, dcu_last;
    to_digits_asc(cu_first, 6, base, dcu_first);
    to_digits_asc(cu_last, 6, base, dcu_last);
    if (dcu_first.len != dcu_last.len) return false;

    uint8_t cu_prefix[MAX_DIGITS];
    int cu_prefix_len = common_msd_prefix(dcu_first, dcu_last, cu_prefix);
    if (has_duplicate_digits(cu_prefix, cu_prefix_len)) return true;

    return has_overlapping_digits(sq_prefix, sq_prefix_len, cu_prefix,
                                  cu_prefix_len);
}

struct RangeVec {
    std::vector<u64> flat;  // (start_lo, start_hi, end_lo, end_hi) per range
};

void valid_ranges_recursive(u64 start_lo, u64 start_hi, u64 end_lo, u64 end_hi,
                            u64 base, int depth, int max_depth,
                            u64 min_range_size, int subdivision_factor,
                            RangeVec& out) {
    u128 start = ((u128)start_hi << 64) | start_lo;
    u128 end = ((u128)end_hi << 64) | end_lo;
    u128 size = end - start;
    u64 s[2] = {start_lo, start_hi};
    u64 e[2] = {end_lo, end_hi};
    if (depth >= max_depth || size <= min_range_size) {
        out.flat.insert(out.flat.end(), {start_lo, start_hi, end_lo, end_hi});
        return;
    }
    if (has_duplicate_msd_prefix(s, e, base)) return;
    if (size < (u128)min_range_size * subdivision_factor) {
        out.flat.insert(out.flat.end(), {start_lo, start_hi, end_lo, end_hi});
        return;
    }
    u128 chunk = size / subdivision_factor;
    for (int i = 0; i < subdivision_factor; ++i) {
        u128 sub_start = start + (u128)i * chunk;
        u128 sub_end = (i == subdivision_factor - 1) ? end : sub_start + chunk;
        if (sub_start < sub_end) {
            valid_ranges_recursive((u64)sub_start, (u64)(sub_start >> 64),
                                   (u64)sub_end, (u64)(sub_end >> 64), base,
                                   depth + 1, max_depth, min_range_size,
                                   subdivision_factor, out);
        }
    }
}

// ---------------------------------------------------------------------------
// Fast strided niceness filter
//
// The generic is_nice_impl peels one digit per div_limbs_inplace call, and
// each peel costs a u128 software division (~100 cycles). For ranges below
// 2^64 three changes buy ~50x:
//
//   * division by invariant constants via precomputed magic multipliers
//     (Granlund-Warren "magicu": q = mulhi(x, M) >> s, with the overflow
//     "add" variant when needed) — ~5 cycles instead of ~100,
//   * THREE digits per step: divide by base^3 and classify the 3-digit
//     remainder through a precomputed mask table (mask == 0 marks an
//     intra-block duplicate), so the serial quotient chain is 3x shorter,
//   * four candidates interleaved per loop so independent quotient chains
//     overlap in the pipeline (the scalar analog of the GPU kernel's
//     warp-parallel checks, reference nice_kernels.cu:270-299).
//
// The fast filter is EXACT for rejections (a duplicate digit is a duplicate
// digit); candidates that survive every block are re-verified with
// is_nice_impl, so a (hypothetical) fast-path bug can only cost speed on
// rejects it misses, never correctness of accepts — and the differential
// test suite drives both paths over the same ranges.
//
// Scope: n < 2^64 and 4 <= base <= 64 (digit masks fit u64; the mask table
// is base^3 * 8 bytes <= 2 MiB). Out-of-scope calls fall back to the
// generic loop.
// ---------------------------------------------------------------------------

namespace {

struct Magic {
    u64 mul;
    int shift;
    bool add;  // overflow variant: q = ((x - mulhi) >> 1 + mulhi) >> (s - 1)
};

// Unsigned magic-number computation (Hacker's Delight 10-7, W = 64).
Magic magicu(u64 d) {
    Magic mag;
    mag.add = false;
    int p = 63;
    u64 nc = (u64)-1 - (u64)(-(u128)d) % d;
    u64 q1 = 0x8000000000000000ULL / nc;
    u64 r1 = 0x8000000000000000ULL - q1 * nc;
    u64 q2 = 0x7FFFFFFFFFFFFFFFULL / d;
    u64 r2 = 0x7FFFFFFFFFFFFFFFULL - q2 * d;
    u64 delta;
    do {
        ++p;
        if (r1 >= nc - r1) {
            q1 = 2 * q1 + 1;
            r1 = 2 * r1 - nc;
        } else {
            q1 = 2 * q1;
            r1 = 2 * r1;
        }
        if (r2 + 1 >= d - r2) {
            if (q2 >= 0x7FFFFFFFFFFFFFFFULL) mag.add = true;
            q2 = 2 * q2 + 1;
            r2 = 2 * r2 + 1 - d;
        } else {
            if (q2 >= 0x8000000000000000ULL) mag.add = true;
            q2 = 2 * q2;
            r2 = 2 * r2 + 1;
        }
        delta = d - 1 - r2;
    } while (p < 128 && (q1 < delta || (q1 == delta && r1 == 0)));
    mag.mul = q2 + 1;
    mag.shift = p - 64;
    return mag;
}

inline u64 magic_div(u64 x, const Magic& m) {
    u64 q = (u64)(((u128)x * m.mul) >> 64);
    if (m.add) {
        return (((x - q) >> 1) + q) >> (m.shift - 1);
    }
    return q >> m.shift;
}

constexpr u64 FAST_BASE_MAX = 64;  // digit masks in u64

struct FastCtx {
    u64 base;
    u64 b2;  // base^2
    u64 d3;  // base^3
    Magic m_base;
    Magic m_b2;
    Magic m_d3;
    std::vector<u64> table3;  // [v] -> digit mask of (v%b, v/b%b, v/b^2); 0=dup
    std::vector<u64> table2;  // [v] -> digit mask of (v%b, v/b); 0=dup. Fits
                              // L1 (base^2 * 8 B <= 32 KiB), so the hot
                              // tracking path splits a 3-digit block into
                              // table2[r % b^2] | (1 << r / b^2) instead of
                              // paying table3's L2/L3-sized random loads.
    bool ok = false;
};

FastCtx* build_fast_ctx(u64 base) {
    auto* c = new FastCtx();
    c->base = base;
    c->b2 = base * base;
    c->d3 = base * base * base;
    c->m_base = magicu(base);
    c->m_b2 = magicu(c->b2);
    c->m_d3 = magicu(c->d3);
    c->table3.resize(c->d3);
    for (u64 v = 0; v < c->d3; ++v) {
        u64 d0 = v % base, d1 = (v / base) % base, d2 = v / (base * base);
        u64 mask = (1ULL << d0) | (1ULL << d1) | (1ULL << d2);
        c->table3[v] = (d0 == d1 || d0 == d2 || d1 == d2) ? 0 : mask;
    }
    c->table2.resize(c->b2);
    for (u64 v = 0; v < c->b2; ++v) {
        u64 d0 = v % base, d1 = v / base;
        c->table2[v] = (d0 == d1) ? 0 : ((1ULL << d0) | (1ULL << d1));
    }
    // Self-verify the magic multipliers before trusting them: boundary and
    // pseudo-random numerators against hardware division. A failure (which
    // would indicate a magicu bug) disables the fast path entirely rather
    // than risking a wrong reject.
    u64 x = 0x9E3779B97F4A7C15ULL;
    bool ok = true;
    for (int i = 0; i < 4096 && ok; ++i) {
        x ^= x << 13;
        x ^= x >> 7;
        x ^= x << 17;
        ok = magic_div(x, c->m_d3) == x / c->d3 &&
             magic_div(x, c->m_b2) == x / c->b2 &&
             magic_div(x, c->m_base) == x / base;
    }
    for (u64 v : {(u64)0, (u64)1, c->d3 - 1, c->d3, c->d3 + 1, ~(u64)0,
                  ~(u64)0 - 1, (u64)1 << 63}) {
        ok = ok && magic_div(v, c->m_d3) == v / c->d3 &&
             magic_div(v, c->m_b2) == v / c->b2 &&
             magic_div(v, c->m_base) == v / base;
    }
    c->ok = ok;
    return c;
}

std::mutex g_fast_mutex;
FastCtx* g_fast_cache[FAST_BASE_MAX + 1] = {};
bool g_fast_enabled = true;

const FastCtx* get_fast_ctx(u64 base) {
    if (base < 4 || base > FAST_BASE_MAX) return nullptr;
    std::lock_guard<std::mutex> lock(g_fast_mutex);
    if (!g_fast_enabled) return nullptr;
    FastCtx*& slot = g_fast_cache[base];
    if (slot == nullptr) slot = build_fast_ctx(base);
    return slot->ok ? slot : nullptr;
}

// Peel the <= 3 most-significant digits of a value v < base^3 (top block:
// phantom leading zeros must NOT count as digits). Returns false on dup.
inline bool peel_top_block(u64 v, const FastCtx& c, u64& seen) {
    while (v != 0) {
        u64 q = magic_div(v, c.m_base);
        u64 d = v - q * c.base;
        u64 bit = 1ULL << d;
        if (seen & bit) return false;
        seen |= bit;
        v = q;
    }
    return true;
}

// Digit-distinctness filter over a value held as up to 3 u64 limbs (cube of
// a u64 candidate). Exact: long division by base^3 in 2^32-limb steps, each
// quotient via one magic multiply; full 3-digit blocks classify through
// table3, the top partial block peels per-digit.
inline bool peel_value(u64 l0, u64 l1, u64 l2, const FastCtx& c, u64& seen) {
    constexpr u64 LO32 = 0xFFFFFFFFULL;
    while (l2 != 0) {
        u64 q4 = magic_div(l2, c.m_d3);
        u64 r = l2 - q4 * c.d3;
        u64 t3 = (r << 32) | (l1 >> 32);
        u64 q3 = magic_div(t3, c.m_d3);
        r = t3 - q3 * c.d3;
        u64 t2 = (r << 32) | (l1 & LO32);
        u64 q2 = magic_div(t2, c.m_d3);
        r = t2 - q2 * c.d3;
        u64 t1 = (r << 32) | (l0 >> 32);
        u64 q1 = magic_div(t1, c.m_d3);
        r = t1 - q1 * c.d3;
        u64 t0 = (r << 32) | (l0 & LO32);
        u64 q0 = magic_div(t0, c.m_d3);
        r = t0 - q0 * c.d3;
        u64 mask = c.table3[r];
        if (mask == 0 || (seen & mask)) return false;
        seen |= mask;
        l2 = q4;
        l1 = (q3 << 32) | q2;
        l0 = (q1 << 32) | q0;
    }
    while (l1 != 0) {
        u64 q2 = magic_div(l1, c.m_d3);
        u64 r = l1 - q2 * c.d3;
        u64 t1 = (r << 32) | (l0 >> 32);
        u64 q1 = magic_div(t1, c.m_d3);
        r = t1 - q1 * c.d3;
        u64 t0 = (r << 32) | (l0 & LO32);
        u64 q0 = magic_div(t0, c.m_d3);
        r = t0 - q0 * c.d3;
        u64 mask = c.table3[r];
        if (mask == 0 || (seen & mask)) return false;
        seen |= mask;
        l1 = q2;
        l0 = (q1 << 32) | q0;
    }
    while (l0 >= c.d3) {
        u64 q = magic_div(l0, c.m_d3);
        u64 r = l0 - q * c.d3;
        u64 mask = c.table3[r];
        if (mask == 0 || (seen & mask)) return false;
        seen |= mask;
        l0 = q;
    }
    return peel_top_block(l0, c, seen);
}

// Necessary condition for niceness of candidate n (n < 2^64): every digit of
// n^2 and n^3 distinct. Accepts may be over-approximate ONLY in theory (they
// are exact too), but callers re-verify accepts with is_nice_impl anyway.
inline bool fast_sqube_distinct(u64 n, const FastCtx& c) {
    u128 sq = (u128)n * n;
    u64 seen = 0;
    if (!peel_value((u64)sq, (u64)(sq >> 64), 0, c, seen)) return false;
    // cube = sq * n as 3 u64 limbs
    u128 t = (u128)(u64)sq * n;
    u64 c0 = (u64)t;
    u128 t2 = (u128)(u64)(sq >> 64) * n + (u64)(t >> 64);
    return peel_value(c0, (u64)t2, (u64)(t2 >> 64), c, seen);
}

// Lockstep square filter over LANES candidates: every lane advances one
// 3-digit block per round regardless of its own state (dead lanes hold
// zeros), so the four independent magic-divide quotient chains — each
// latency-bound at ~6 cycles per dependent divide — overlap in the
// pipeline instead of running serially. This is the scalar-core analog of
// the reference GPU kernel's warp-parallel digit checks
// (nice_kernels.cu:270-299): predication instead of divergence.
// Returns the bitmask of lanes whose square digits are fully distinct;
// seen[] carries their accumulated digit masks into the cube check.
// Max 3-digit blocks a square can span: a u64 candidate's square has < 2^128
// ~ 39 base-10 digits; for the smallest fast-path base (4) blocks are capped
// by the u64 value range instead (64 / (3*log2 4) = 11 for the low limb plus
// the high limb's worth) — 24 covers every base >= 4 with margin.
constexpr int SQ_BLOCKS_MAX = 24;

inline int square_lanes(const u64 n[4], const FastCtx& c, u64 seen[4]) {
    constexpr u64 LO32 = 0xFFFFFFFFULL;
    u64 l0[4], l1[4];
    u64 rs[4][SQ_BLOCKS_MAX];  // per-lane 3-digit block remainders, LSD first
    u32 vbits[4] = {0, 0, 0, 0};  // bit i: lane recorded a FULL block round i
    for (int j = 0; j < 4; ++j) {
        u128 sq = (u128)n[j] * n[j];
        l0[j] = (u64)sq;
        l1[j] = (u64)(sq >> 64);
    }
    // Phase 1 — pure divide rounds, all four quotient chains in flight.
    // NOTHING here consults the mask table or any accumulated digit state:
    // the round latency is the divide chain alone, while the remainders are
    // parked for phase 2 (whose table loads then all overlap instead of
    // serializing round-by-round through a seen-mask dependency).
    // `pr` guards lanes whose value already fell below base^3: their top
    // block has phantom leading zeros and must only be peeled digit-wise.
    int rounds = 0;
    while ((l1[0] | l1[1] | l1[2] | l1[3]) != 0) {
        for (int j = 0; j < 4; ++j) {
            u64 v1 = l1[j], v0 = l0[j];
            u64 q2 = magic_div(v1, c.m_d3);
            u64 r = v1 - q2 * c.d3;
            u64 t1 = (r << 32) | (v0 >> 32);
            u64 q1 = magic_div(t1, c.m_d3);
            r = t1 - q1 * c.d3;
            u64 t0 = (r << 32) | (v0 & LO32);
            u64 q0 = magic_div(t0, c.m_d3);
            r = t0 - q0 * c.d3;
            u64 pr = (u64)0 - (u64)((v1 != 0) | (v0 >= c.d3));
            rs[j][rounds] = r;
            vbits[j] |= (u32)(pr & 1) << rounds;
            l1[j] = q2;
            l0[j] = (((q1 << 32) | q0) & pr) | (v0 & ~pr);
        }
        ++rounds;
    }
    while ((l0[0] >= c.d3) | (l0[1] >= c.d3) | (l0[2] >= c.d3) |
           (l0[3] >= c.d3)) {
        for (int j = 0; j < 4; ++j) {
            u64 v = l0[j];
            u64 q = magic_div(v, c.m_d3);
            u64 r = v - q * c.d3;
            u64 ge = (u64)0 - (u64)(v >= c.d3);
            rs[j][rounds] = r;
            vbits[j] |= (u32)(ge & 1) << rounds;
            l0[j] = (q & ge) | (v & ~ge);
        }
        ++rounds;
    }
    // Phase 2 — replay each lane's blocks LSD-first, accumulating digit
    // masks and detecting duplicates. Early break on death keeps the
    // expected walk short (~block 3-4); the table loads for several blocks
    // are already in flight by then.
    int alive = 0;
    for (int j = 0; j < 4; ++j) {
        u64 s = 0;
        bool ok = true;
        u32 vb = vbits[j];
        for (int i = 0; i < rounds; ++i) {
            if (!((vb >> i) & 1)) continue;  // lane was past its top block
            u64 mask = c.table3[rs[j][i]];
            if (mask == 0 || (s & mask)) {
                ok = false;
                break;
            }
            s |= mask;
        }
        if (ok && peel_top_block(l0[j], c, s)) {
            seen[j] = s;
            alive |= 1 << j;
        }
    }
    return alive;
}

// Cube-phase continuation for a square survivor (~3% of candidates after
// the CRT prefilter): same exact block peeling over the 3-limb cube.
inline bool cube_survives(u64 n, const FastCtx& c, u64 seen) {
    u128 sq = (u128)n * n;
    u128 t = (u128)(u64)sq * n;
    u64 c0 = (u64)t;
    u128 t2 = (u128)(u64)(sq >> 64) * n + (u64)(t >> 64);
    return peel_value(c0, (u64)t2, (u64)(t2 >> 64), c, seen);
}

// ---------------------------------------------------------------------------
// Polynomial-residue fast path (k >= 3 stride tables)
//
// When the CRT stride modulus M is a multiple of d3 = base^3 (true for every
// table of depth k >= 3, M = (base-1) * base^k), a candidate n = q*M + res
// has
//     n^2 = q^2 M^2 + 2 q M res + res^2,   M = (base-1) * d3 * base^(k-3)
// so n^2 mod d3 = res^2 mod d3 — the square's LOW 3-digit block depends only
// on the residue and is PRECOMPUTED per table entry (likewise the cube's;
// their joint distinctness is already guaranteed by the CRT table
// construction, so the per-candidate work starts at block 1 with a seeded
// digit mask). The remaining square blocks follow from an all-u64 peeling of
//     n^2 / d3 = d3*(F q^2) + C,   F = (M/d3)^2,  C = 2(M/d3) q res + res^2/d3
// where q (and therefore the q-split F*Q1 / F*R1 constants below) only
// changes when the residue index wraps — once per M-span, amortized over
// num_residues candidates. Per candidate that leaves ONE multiply and ~6
// single u64 magic divides, about 3x fewer dependent operations than the
// generic 2^32-limb long division above.
// ---------------------------------------------------------------------------

struct PolyCtx {
    const FastCtx* fc;
    u64 modulus;
    u64 mdiv;  // M / d3  (= (base-1) * base^(k-3))
    // Packed per-residue stream: low 32 bits the residue, high 32 bits
    // floor(res^2 / d3) — one load per candidate instead of two.
    std::vector<u64> rr;
    std::vector<u64> seed;  // digit mask of sq/cube low blocks; 0 = reject
    bool ok = false;
};

PolyCtx* build_poly_ctx(const FastCtx* fc, u64 modulus, const u32* residues,
                        u64 num) {
    auto* p = new PolyCtx();
    p->fc = fc;
    p->modulus = modulus;
    p->mdiv = modulus / fc->d3;
    p->rr.resize(num);
    p->seed.resize(num);
    for (u64 i = 0; i < num; ++i) {
        u64 r = residues[i];
        u128 r2 = (u128)r * r;
        u64 sq0 = (u64)(r2 % fc->d3);
        p->rr[i] = r | ((u64)(r2 / fc->d3) << 32);
        u64 cu0 = (u64)(((r2 % fc->d3) * (r % fc->d3)) % fc->d3);
        // Low 3-digit blocks of the candidate's square and cube, exact.
        // The CRT table's LSD filter mirrors the reference's WEAKER rule
        // (stop-at-zero digit extraction, cross sq/cube overlap only,
        // lsd_filter.py:62-84) — so residues with an intra-block duplicate
        // or a zero-digit collision DO appear in the table. Those can never
        // produce a nice number (for in-range candidates both blocks are
        // full: sq >= base^4, cube >= base^6 — eligibility requires
        // first >= base^2); seed == 0 marks them and the gather loop skips
        // their candidates outright, a ~10-25%% free kill the per-candidate
        // filters would otherwise pay full price for.
        u64 m1 = fc->table3[sq0], m2 = fc->table3[cu0];
        p->seed[i] = (m1 == 0 || m2 == 0 || (m1 & m2)) ? 0 : (m1 | m2);
    }
    p->ok = true;
    return p;
}

std::vector<std::pair<std::pair<u64, u64>, PolyCtx*>> g_poly_cache;

const PolyCtx* get_poly_ctx(u64 base, u64 modulus, const u32* residues,
                            u64 num) {
    const FastCtx* fc = get_fast_ctx(base);
    if (fc == nullptr) return nullptr;
    u64 d3 = fc->d3;
    if (modulus % d3 != 0 || modulus >= ((u64)1 << 32)) return nullptr;
    std::lock_guard<std::mutex> lock(g_fast_mutex);
    for (auto& e : g_poly_cache) {
        if (e.first.first == base && e.first.second == modulus) {
            return e.second->ok ? e.second : nullptr;
        }
    }
    PolyCtx* p = build_poly_ctx(fc, modulus, residues, num);
    g_poly_cache.push_back({{base, modulus}, p});
    return p->ok ? p : nullptr;
}

// Cube check for a square survivor with the LOW block skipped (its digits
// are in the seed mask already): one discarded block step, then the generic
// exact peel.
inline bool cube_survives_skip0(u64 n, const FastCtx& c, u64 seen) {
    constexpr u64 LO32 = 0xFFFFFFFFULL;
    u128 sq = (u128)n * n;
    u128 t = (u128)(u64)sq * n;
    u64 l0 = (u64)t;
    u128 t2 = (u128)(u64)(sq >> 64) * n + (u64)(t >> 64);
    u64 l1 = (u64)t2, l2 = (u64)(t2 >> 64);
    // one 3-limb block step, remainder (block 0) discarded
    u64 q4 = magic_div(l2, c.m_d3);
    u64 r = l2 - q4 * c.d3;
    u64 ta = (r << 32) | (l1 >> 32);
    u64 q3 = magic_div(ta, c.m_d3);
    r = ta - q3 * c.d3;
    u64 tb = (r << 32) | (l1 & LO32);
    u64 q2 = magic_div(tb, c.m_d3);
    r = tb - q2 * c.d3;
    u64 tc = (r << 32) | (l0 >> 32);
    u64 q1 = magic_div(tc, c.m_d3);
    r = tc - q1 * c.d3;
    u64 td = (r << 32) | (l0 & LO32);
    u64 q0 = magic_div(td, c.m_d3);
    return peel_value((q1 << 32) | q0, (q3 << 32) | q2, q4, c, seen);
}

// Lockstep width: enough independent quotient chains to cover the ~6-cycle
// magic-divide latency at the core's issue width. The reference's sweep on
// its own bench host (a b50 1e7 field) found 4 lanes fastest: the kernel is
// issue-bound, not latency-bound, so wider only adds spills.
#ifndef POLY_LANES
#define POLY_LANES 4
#endif

// Digit mask of a whole value (full blocks + top partial block).
// ok_out: all-ones when the value's digits are internally distinct.
inline void value_digit_mask(u64 v, const FastCtx& c, u64* mask_out,
                             u64* ok_out) {
    u64 s = 0;
    bool ok = true;
    while (v >= c.d3) {
        u64 q = magic_div(v, c.m_d3);
        u64 r = v - q * c.d3;
        u64 m = c.table3[r];
        if (m == 0 || (s & m)) ok = false;
        s |= m;
        v = q;
    }
    if (!peel_top_block(v, c, s)) ok = false;
    *mask_out = s;
    *ok_out = ok ? ~(u64)0 : 0;
}

template <int PL>
void iterate_strided_poly(u64 first, u64 start_idx, u64 end, const PolyCtx& p,
                          u64* out_nice, u64 cap, u64* nice_count) {
    const FastCtx& c = *p.fc;
    const u64 M = p.modulus, d3 = c.d3;
    const u64 F = p.mdiv * p.mdiv;
    const u64 num = p.rr.size();
    u64 found = 0;
    u64 q = first / M;
    // High-digit shortcut: Z = F*Q1 + t3 where F*Q1 is a per-wrap constant
    // and t3 < ~2*(M/d3)*end/d3^2. Splitting F*Q1 = d3^2*H + hiL, the
    // candidate-varying part Y = hiL + t3 spans exactly two 3-digit blocks
    // plus a carry c into H of at most 1 (guaranteed by the gate below), so
    // the per-candidate peel is TWO divides plus a lookup of the per-wrap
    // digit masks of H and H+1 — instead of a variable lockstep round loop
    // over ~4 more blocks. H >= 1 keeps those two blocks full-width.
    u64 d3sq = d3 * d3;
    u64 t3_max = (u64)((u128)2 * p.mdiv * (end + M) / d3 / d3) + 2 * F + 2;
    bool use_hi = t3_max < d3sq && first / d3 / d3sq >= 1;
    u64 FQ1 = 0, FR1 = 0, q2m = 0;
    u64 hiL = 0, hi_mask[2] = {0, 0}, hi_okf[2] = {0, 0};
    auto wrap_setup = [&]() {
        u64 a = magic_div(q, c.m_d3), r = q - a * d3;
        u64 rr = r * r;
        u64 t = magic_div(rr, c.m_d3), R1 = rr - t * d3;
        u64 Q1 = d3 * a * a + 2 * a * r + t;
        FQ1 = F * Q1;
        FR1 = F * R1;
        q2m = 2 * p.mdiv * q;
        if (use_hi) {
            u64 H = FQ1 / d3sq;
            hiL = FQ1 - H * d3sq;
            value_digit_mask(H, c, &hi_mask[0], &hi_okf[0]);
            value_digit_mask(H + 1, c, &hi_mask[1], &hi_okf[1]);
        }
    };
    wrap_setup();
    // use_hi also requires H >= 1 on every wrap; q (hence FQ1) only grows,
    // so probing the FIRST wrap suffices — but FQ1 is only known after
    // wrap_setup, so re-check and recompute once if the probe was wrong.
    if (use_hi && FQ1 / d3sq < 1) {
        use_hi = false;
        wrap_setup();
    }
    u64 idx = start_idx;
    u64 n = first;
    u64 lanes[PL], lidx[PL];
    constexpr u64 LO32 = 0xFFFFFFFFULL;
    auto advance = [&]() {
        if (++idx == num) {
            idx = 0;
            ++q;
            wrap_setup();
            n = q * M + (p.rr[0] & LO32);
        } else {
            n += (p.rr[idx] & LO32) - (p.rr[idx - 1] & LO32);
        }
    };
    u64 seen[PL], okm[PL], Z[PL];
    while (n < end) {
        int kk = 0;
        u64 lC[PL], lFR1[PL], lFQ1[PL];
        while (kk < PL && n < end) {
            u64 sd = p.seed[idx];
            u64 rrv = p.rr[idx];
            if (sd == 0) {  // residue provably dead: skip the lane slot
                advance();
                continue;
            }
            lanes[kk] = n;
            lidx[kk] = idx;
            lC[kk] = q2m * (rrv & LO32) + (rrv >> 32);
            seen[kk] = sd;
            lFR1[kk] = FR1;
            lFQ1[kk] = FQ1;
            ++kk;
            advance();
        }
        for (int j = kk; j < PL; ++j) {  // tail: idle lanes peel zeros
            lC[j] = lFR1[j] = lFQ1[j] = seen[j] = 0;
        }
        // Blocks 1 and 2 (block 0 came precomputed in the seed): one magic
        // divide each, all four lanes' chains interleaving as straight-line
        // code. Tracking is branch-free: a duplicate clears the lane's okm
        // word; seen keeps accumulating harmlessly afterwards. The 3-digit
        // block classifies through the L1-resident table2 plus one extra
        // divide for its top digit — table3's base^3-sized random loads sat
        // on the serial seen-chain and dominated the whole kernel.
        auto track = [&](int j, u64 r) {
            u64 d2 = magic_div(r, c.m_b2);
            u64 m2 = c.table2[r - d2 * c.b2];
            u64 bit = (u64)1 << d2;
            u64 mask = m2 | bit;
            u64 bad = (u64)0 - (u64)((m2 == 0) | ((m2 & bit) != 0) |
                                     ((seen[j] & mask) != 0));
            okm[j] &= ~bad;
            seen[j] |= mask;
        };
        if (use_hi) {
            // Blocks 1-4 are four straight-line divides per lane; the
            // square's remaining high digits come from the per-wrap H masks
            // (carry selected by whether Y overflowed its two blocks).
            for (int j = 0; j < PL; ++j) {
                okm[j] = ~(u64)0;
                u64 X = lC[j];
                u64 t2 = magic_div(X, c.m_d3);
                track(j, X - t2 * d3);
                u64 X2 = lFR1[j] + t2;
                u64 t3 = magic_div(X2, c.m_d3);
                track(j, X2 - t3 * d3);
                u64 Y = hiL + t3;
                u64 y1 = magic_div(Y, c.m_d3);
                track(j, Y - y1 * d3);
                u64 cf = (u64)(y1 >= d3);
                track(j, y1 - (d3 & ((u64)0 - cf)));
                u64 hm = hi_mask[cf];
                u64 bad = (~hi_okf[cf]) |
                          ((u64)0 - (u64)((seen[j] & hm) != 0));
                okm[j] &= ~bad;
                seen[j] |= hm;
            }
        } else {
            for (int j = 0; j < PL; ++j) {
                okm[j] = ~(u64)0;
                u64 X = lC[j];
                u64 t2 = magic_div(X, c.m_d3);
                track(j, X - t2 * d3);
                u64 X2 = lFR1[j] + t2;
                u64 t3 = magic_div(X2, c.m_d3);
                track(j, X2 - t3 * d3);
                Z[j] = lFQ1[j] + t3;
            }
            // Remaining full blocks in lockstep rounds so the four quotient
            // chains overlap; lanes below base^3 hold their value (top
            // partial block, peeled digit-wise afterwards).
            for (;;) {
                u64 any_z = 0, any_ok = 0;
                for (int j = 0; j < PL; ++j) {
                    any_z |= (u64)(Z[j] >= d3);
                    any_ok |= okm[j];
                }
                if (!any_z || !any_ok) break;
                for (int j = 0; j < PL; ++j) {
                    u64 v = Z[j];
                    u64 q0 = magic_div(v, c.m_d3);
                    u64 r = v - q0 * d3;
                    u64 ge = (u64)0 - (u64)(v >= d3);
                    u64 d2 = magic_div(r, c.m_b2);
                    u64 m2 = c.table2[r - d2 * c.b2];
                    u64 bit = (u64)1 << d2;
                    u64 mask = m2 | bit;
                    u64 bad = ((u64)0 -
                               (u64)((m2 == 0) | ((m2 & bit) != 0) |
                                     ((seen[j] & mask) != 0))) &
                              ge;
                    okm[j] &= ~bad;
                    seen[j] |= mask & ge;
                    Z[j] = (q0 & ge) | (v & ~ge);
                }
            }
        }
        for (int j = 0; j < kk; ++j) {
            if (okm[j] != 0 &&
                (use_hi || peel_top_block(Z[j], c, seen[j])) &&
                cube_survives_skip0(lanes[j], c, seen[j])) {
                u64 c2[2] = {lanes[j], 0};
                if (is_nice_impl(c2, c.base)) {
                    if (found < cap) {
                        out_nice[found * 2] = lanes[j];
                        out_nice[found * 2 + 1] = 0;
                    }
                    ++found;
                }
            }
        }
    }
    *nice_count = found;
}

void iterate_strided_fast(u64 first, u64 start_idx, u64 end, u64 base,
                          const u64* gap_table, u64 num_residues,
                          const FastCtx& ctx, u64* out_nice, u64 cap,
                          u64* nice_count) {
    u64 found = 0;
    u64 idx = start_idx;
    u64 n = first;
    u64 lanes[4];
    u64 seen[4];
    auto emit = [&](u64 cand) {
        u64 c2[2] = {cand, 0};
        if (is_nice_impl(c2, base)) {
            if (found < cap) {
                out_nice[found * 2] = cand;
                out_nice[found * 2 + 1] = 0;
            }
            ++found;
        }
    };
    while (n < end) {
        int k = 0;
        while (k < 4 && n < end) {
            lanes[k++] = n;
            n += gap_table[idx];
            if (++idx == num_residues) idx = 0;
        }
        if (k == 4) {
            int alive = square_lanes(lanes, ctx, seen);
            while (alive) {
                int j = __builtin_ctz(alive);
                alive &= alive - 1;
                if (cube_survives(lanes[j], ctx, seen[j])) emit(lanes[j]);
            }
        } else {
            for (int j = 0; j < k; ++j) {
                if (fast_sqube_distinct(lanes[j], ctx)) emit(lanes[j]);
            }
        }
    }
    *nice_count = found;
}

}  // namespace

}  // namespace

extern "C" {

// Detailed range loop over [start, start+count). hist must hold base+2 u64
// slots. Near misses (num_uniques > cutoff) append (n_lo, n_hi, uniques)
// triples to out_misses (capacity cap triples); the true count is returned
// via *miss_count (callers re-run with a bigger buffer if it exceeds cap —
// the reference treats overflow as a hard error, client_process_gpu.rs:859).
void nice_process_range_detailed(u64 start_lo, u64 start_hi, u64 count,
                                 u64 base, u64 cutoff, u64* hist,
                                 u64* out_misses, u64 cap, u64* miss_count) {
    u64 n[2] = {start_lo, start_hi};
    u64 misses = 0;
    for (u64 i = 0; i < count; ++i) {
        int uniques = num_unique_digits_impl(n, base);
        hist[uniques] += 1;
        if ((u64)uniques > cutoff) {
            if (misses < cap) {
                out_misses[misses * 3] = n[0];
                out_misses[misses * 3 + 1] = n[1];
                out_misses[misses * 3 + 2] = (u64)uniques;
            }
            ++misses;
        }
        add_2(n, 1);
    }
    *miss_count = misses;
}

// Niceonly stride iteration over [start, end): start at the first valid
// candidate at-or-after start (residue index start_idx, computed host-side
// by the Python stride table), jump via the gap table, early-exit check each
// candidate. Returns number of nice numbers found (also capped appends).
void nice_iterate_range_strided(u64 first_lo, u64 first_hi, u64 start_idx,
                                u64 end_lo, u64 end_hi, u64 base,
                                const u64* gap_table, u64 num_residues,
                                u64* out_nice, u64 cap, u64* nice_count) {
    if (first_hi == 0 && end_hi == 0) {
        // Whole range below 2^64: the magic-divide fast filter applies
        // (bases 4..64; get_fast_ctx returns null outside its scope or when
        // its self-verification failed, falling through to the generic loop).
        const FastCtx* ctx = get_fast_ctx(base);
        if (ctx != nullptr) {
            iterate_strided_fast(first_lo, start_idx, end_lo, base, gap_table,
                                 num_residues, *ctx, out_nice, cap,
                                 nice_count);
            return;
        }
    }
    u64 n[2] = {first_lo, first_hi};
    u64 end[2] = {end_lo, end_hi};
    u64 idx = start_idx;
    u64 found = 0;
    while (cmp_2(n, end) < 0) {
        if (is_nice_impl(n, base)) {
            if (found < cap) {
                out_nice[found * 2] = n[0];
                out_nice[found * 2 + 1] = n[1];
            }
            ++found;
        }
        add_2(n, gap_table[idx]);
        if (++idx == num_residues) idx = 0;
    }
    *nice_count = found;
}

// Polynomial-residue strided iteration (k >= 3 stride tables; see PolyCtx
// above). Sets *used_poly to 1 and fills results when eligible; leaves it 0
// (results untouched) when the caller should use the generic entry point.
// Eligibility guards the u64 arithmetic: modulus a multiple of base^3 and
// < 2^32; first/end below 2^64; 2*(M/d3)*q*res and F*Q1 must fit u64.
void nice_iterate_range_strided_poly(u64 first_lo, u64 first_hi, u64 start_idx,
                                     u64 end_lo, u64 end_hi, u64 base,
                                     u64 modulus, const u32* residues,
                                     u64 num_residues, u64* out_nice, u64 cap,
                                     u64* nice_count, int* used_poly) {
    *used_poly = 0;
    if (first_hi != 0 || end_hi != 0 || base < 4 || base > FAST_BASE_MAX ||
        num_residues == 0 || first_lo < base * base) {
        return;  // first >= base^2 keeps the low sq/cube blocks full-width
    }
    u64 d3 = base * base * base;
    if (modulus % d3 != 0 || modulus >= ((u64)1 << 32)) return;
    // Require n >= base^4.5 (first^2 >= d3^3 == base^9): below that, n^2 has
    // fewer than three full base^3 blocks and the fixed block-1/2 decompose
    // misclassifies digits. Small n fall back to the generic limb loop.
    if ((u128)first_lo * first_lo < (u128)d3 * d3 * d3) return;
    // 2*(M/d3)*q*res < 2*(base-1)*base^(k-3)*...*n stays under 2^63 when
    // end * 2 * (M/d3) * (d3 margin) does; and F*Q1 ~ end^2 / d3^3 < 2^62.
    u64 mdiv = modulus / d3;
    u128 e = end_lo;
    // X = F*R1 + 2*(M/d3)*q*res + r2d must fit u64: q*res < n < end, and
    // F*R1 < (M/d3)^2 * d3.
    if ((((u128)2 * mdiv) * (e + modulus) + (u128)mdiv * mdiv * d3) >> 64)
        return;
    // Z = F*Q1 + t3 ~ end^2/d3^3 + 2^47 must stay comfortably inside u64.
    if ((e * e) / ((u128)d3 * d3 * d3) + ((u128)1 << 48) >= ((u128)1 << 63))
        return;
    const PolyCtx* p = get_poly_ctx(base, modulus, residues, num_residues);
    if (p == nullptr || !g_fast_enabled) return;
    if (start_idx >= p->rr.size() ||
        first_lo % modulus != (p->rr[start_idx] & 0xFFFFFFFFULL)) {
        return;  // caller/table mismatch: use the generic loop
    }
    iterate_strided_poly<POLY_LANES>(first_lo, start_idx, end_lo, *p,
                                     out_nice, cap, nice_count);
    *used_poly = 1;
}

// Test hook: force the generic strided loop (differential tests compare the
// fast filter against it over identical ranges). Returns the previous value.
int nice_strided_fast_enabled(int enable) {
    std::lock_guard<std::mutex> lock(g_fast_mutex);
    int prev = g_fast_enabled ? 1 : 0;
    g_fast_enabled = enable != 0;
    return prev;
}

// Recursive MSD filter. Returns an opaque handle; read size + data, then free.
void* nice_msd_valid_ranges(u64 start_lo, u64 start_hi, u64 end_lo, u64 end_hi,
                            u64 base, int max_depth, u64 min_range_size,
                            int subdivision_factor) {
    auto* out = new RangeVec();
    valid_ranges_recursive(start_lo, start_hi, end_lo, end_hi, base, 0,
                           max_depth, min_range_size, subdivision_factor,
                           *out);
    return out;
}

u64 nice_ranges_count(void* handle) {
    return ((RangeVec*)handle)->flat.size() / 4;
}

void nice_ranges_copy(void* handle, u64* out) {
    auto* rv = (RangeVec*)handle;
    std::memcpy(out, rv->flat.data(), rv->flat.size() * sizeof(u64));
}

void nice_ranges_free(void* handle) { delete (RangeVec*)handle; }

}  // extern "C"
