"""K5's tensor-core data path (nice_tpu_torch/csrc/nice_kernels.cuh, "K5")
modelled in Python, step by step, and held against the plain K5
(ops/mxu.py products_mxu) and Python ints. No card is needed.

The model follows the kernel's registers: which thread holds which bytes of
D (the A operand) and of T (the B operand) of an mma.sync m16n8k16 u8 tile,
which byte columns of the result (C) it gets back, how it folds them into a
word a lane, the quad's xor-shuffle transpose, the 64-bit limb sums and the
walk into limbs with the factors 2 and 3 and the constants S^2 + i^2 and
S^3 + i^3. The MMA itself is the matrix product of the A and B that the
fragments spell, laid out as the PTX ISA fixes them for .row.col u8 at
m16n8k16 (A: thread (g, q) holds row g and row g + 8, bytes 4q..4q+3; B:
rows 4q..4q+3 of column g; C: rows g and g + 8, columns 2q and 2q + 1). It
also models the block's setup: the warp-wide products S^2 and S^3 with
their carry-lookahead on ballots, and T's words read as byte windows of the
zero-padded sources.
"""

import random

import numpy as np
import pytest
import torch

from nice_tpu_torch.ops import mxu
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan

M32 = (1 << 32) - 1
PAD = mxu.SOURCE_PAD
BASES = [10, 40, 80, 97, 98, 510]


def _limbs(x: int, n: int) -> list[int]:
    return [(x >> (32 * k)) & M32 for k in range(n)]


def _value(limbs: list[int]) -> int:
    return sum(v << (32 * k) for k, v in enumerate(limbs))


# --------------------------------------------------------------------------
# The block's setup
# --------------------------------------------------------------------------

def warp_mul(x: list[int], y: list[int], lo: int) -> list[int]:
    """k5_warp_mul: o = x * y mod 2^(32 lo) by 32 lanes, a 32-limb chunk at a
    time. Lane k sums column k's products' low and high words apart; v_k =
    c0_k + c1_{k-1} + c2_{k-2} and its carry e_k go one limb up; the 1-bit
    carries left resolve by carry-lookahead on the ballots gen (lane
    overflowed) and pass (lane all ones): the carries of (gen | pass) +
    gen."""
    out = [0] * lo
    in0, in1 = 0, 0
    for c in range(0, lo, 32):
        c0, c1, c2 = [0] * 32, [0] * 32, [0] * 32
        for lane in range(32):
            k = c + lane
            if k >= lo:
                continue
            s_lo = s_hi = 0
            for i in range(max(0, k - len(y) + 1), min(k, len(x) - 1) + 1):
                t = x[i] * y[k - i]
                s_lo += t & M32
                s_hi += t >> 32
            rest = (s_lo >> 32) + s_hi
            c0[lane], c1[lane], c2[lane] = s_lo & M32, rest & M32, rest >> 32
        v = [c0[ln] + (c1[ln - 1] if ln >= 1 else 0)
             + (c2[ln - 2] if ln >= 2 else 0)
             + (in0 if ln == 0 else in1 if ln == 1 else 0) for ln in range(32)]
        assert max(v) < 1 << 35
        e = [x_ >> 32 for x_ in v]
        z = [(v[ln] & M32) + (e[ln - 1] if ln >= 1 else 0) for ln in range(32)]
        w = [x_ & M32 for x_ in z]
        gen = sum(1 << ln for ln in range(32) if z[ln] >> 32)
        pas = sum(1 << ln for ln in range(32) if w[ln] == M32)
        assert gen & pas == 0  # a lane that overflowed is left below 8
        total = (gen | pas) + gen
        cin = (total & M32) ^ pas
        for lane in range(32):
            if c + lane < lo:
                out[c + lane] = (w[lane] + ((cin >> lane) & 1)) & M32
        in0 = c1[31] + c2[30] + e[31] + (total >> 32)
        in1 = c2[31]
    return out


def setup(plan, start: int) -> dict:
    """k5_setup's shared arrays: S and S^2 zero-extended to limbs_cu + 2
    words with PAD zero words below (index PAD is limb 0), and S^3."""
    s = _limbs(start, plan.limbs_n)
    s_sq = warp_mul(s, s, plan.limbs_sq)
    s_cu = warp_mul(s_sq, s, plan.limbs_cu)
    words = plan.limbs_cu + 2
    return {"s": [0] * PAD + s + [0] * (words - len(s)),
            "s_sq": [0] * PAD + s_sq + [0] * (words - len(s_sq)),
            "s_sq_limbs": s_sq, "s_cu": s_cu}


def window(x: list[int], c0: int) -> int:
    """k5_window: bytes c0 - 3 .. c0 of the padded source, byte c0 lowest,
    as two aligned word loads, a funnel shift right and a byte reverse."""
    b = c0 - 3
    lo, hi = x[PAD + (b >> 2)], x[PAD + (b >> 2) + 1]
    win = ((hi << 32 | lo) >> (8 * (b & 3))) & M32
    return int.from_bytes(win.to_bytes(4, "little"), "big")


def b_word(sh: dict, nt_sq: int, t: int, lane: int) -> int:
    """T's word of a lane in tile t as a thread holds it (k5_b_word where
    used, 0 for the rows that carry no term)."""
    g, q = lane >> 2, lane & 3
    if t < nt_sq:
        return window(sh["s"], 8 * t + g) if q == 0 else 0
    col = 8 * (t - nt_sq) + g
    if q == 0:
        return window(sh["s_sq"], col)
    return window(sh["s"], col - 4 * (q - 1)) if q < 3 else 0


# --------------------------------------------------------------------------
# The warp's products
# --------------------------------------------------------------------------

def _bytes_of(word: int) -> list[int]:
    return [(word >> (8 * u)) & 0xFF for u in range(4)]


def mma(a_regs: list, b_regs: list) -> list:
    """One m16n8k16 u8 MMA from the fragments of a warp's 32 threads:
    a_regs[l] = (row g's word, row g + 8's word), b_regs[l] = its B word.
    Returns each thread's four C registers."""
    A = np.zeros((16, 16), dtype=np.int64)
    B = np.zeros((16, 8), dtype=np.int64)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        A[g, 4 * q:4 * q + 4] = _bytes_of(a_regs[lane][0])
        A[g + 8, 4 * q:4 * q + 4] = _bytes_of(a_regs[lane][1])
        B[4 * q:4 * q + 4, g] = _bytes_of(b_regs[lane])
    C = A @ B
    return [[int(C[lane >> 2, 2 * (lane & 3)]), int(C[lane >> 2, 2 * (lane & 3) + 1]),
             int(C[(lane >> 2) + 8, 2 * (lane & 3)]),
             int(C[(lane >> 2) + 8, 2 * (lane & 3) + 1])] for lane in range(32)]


def permute(x: list, q: int) -> list:
    """k5_permute: x[k ^ q]."""
    return [x[k ^ q] for k in range(4)]


def tile(a: list, b_regs: list) -> list:
    """k5_tile for the whole warp: each lane's (lo, hi) 64-bit parts of the
    tile's two limbs of its own row."""
    c0 = mma([(a[ln][0], a[ln][1]) for ln in range(32)], b_regs)
    c1 = mma([(a[ln][2], a[ln][3]) for ln in range(32)], b_regs)
    p = []
    for lane in range(32):
        words = [c0[lane][0] + (c0[lane][1] << 8), c0[lane][2] + (c0[lane][3] << 8),
                 c1[lane][0] + (c1[lane][1] << 8), c1[lane][2] + (c1[lane][3] << 8)]
        assert max(words) < 1 << 29
        p.append(permute(words, lane & 3))
    # Round k: every lane reads p[k] of lane l ^ k (__shfl_xor_sync).
    got = [[p[ln][0]] + [p[ln ^ k][k] for k in (1, 2, 3)] for ln in range(32)]
    out = []
    for lane in range(32):
        v = permute(got[lane], lane & 3)
        out.append((v[0] + (v[1] << 16), v[2] + (v[3] << 16)))
    return out


def warp_products(plan, start: int, offsets: list[int]) -> list:
    """(sq limbs, cu limbs) of each of a warp's 32 lanes n = start + i as the
    kernel forms them, with the schoolbook branch for the lanes outside
    the GEMM's domain (wrapped past limbs_n limbs, or n^2 past limbs_sq)."""
    sh = setup(plan, start)
    nt_sq, nt_cu = mxu.tiles(plan.limbs_sq), mxu.tiles(plan.limbs_cu)
    # D's words: thread (g, q) holds word q of each quad lane's row.
    rows = [[i, (i * i) & M32, (i * i) >> 32, 0] for i in offsets]
    a = [[rows[4 * (ln >> 2) + r][ln & 3] for r in range(4)] for ln in range(32)]
    parts = [tile(a, [b_word(sh, nt_sq, t, ln) for ln in range(32)])
             for t in range(nt_sq + nt_cu)]
    out = []
    for lane, i in enumerate(offsets):
        i2, i3 = i * i, i ** 3
        res = []
        for lo, t0, nt, m, c, y in (
                (plan.limbs_sq, 0, nt_sq, 2, sh["s_sq_limbs"], _limbs(i2, 3)),
                (plan.limbs_cu, nt_sq, nt_cu, 3, sh["s_cu"], _limbs(i3, 3))):
            limbs, carry = [], 0
            for t in range(nt):
                for u in range(2):
                    k = 2 * t + u
                    if k < lo:
                        v = carry + m * parts[t0 + t][lane][u] + c[k] + (
                            y[k] if k < 3 else 0)
                        limbs.append(v & M32)
                        carry = v >> 32
            res.append(limbs)
        n_full = start + i
        n = n_full % (1 << (32 * plan.limbs_n))
        if n != n_full or n >= 1 << (16 * plan.limbs_sq):
            sq = n * n % (1 << (32 * plan.limbs_sq))
            res = [_limbs(sq, plan.limbs_sq),
                   _limbs(sq * n % (1 << (32 * plan.limbs_cu)), plan.limbs_cu)]
        out.append(res)
    return out


def _offsets(rng: random.Random) -> list[int]:
    picks = [0, 1, 2**31 - 1, 2**31 - 2, 2**16, 2**16 - 1]
    return picks + [rng.randrange(2**31) for _ in range(32 - len(picks))]


def _top_start(plan) -> int:
    """A start whose lanes reach the top of the base's range (or, where the
    range is narrower than 2^31, its start)."""
    return max(plan.range_start, plan.range_end - 2**31)


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base", BASES)
def test_fragment_model_equals_plain_k5_and_python_ints(base):
    """The warp's products through the fragment mapping equal the plain
    K5 (mxu.products_mxu) lane for lane, and Python ints inside the range,
    with offsets 0, 1, 2^31 - 1 and random, from range_start and from a
    start at the top of the range."""
    plan = get_plan(base)
    rng = random.Random(base)
    for start in (plan.range_start, _top_start(plan)):
        offsets = _offsets(rng)
        got = warp_products(plan, start, offsets)
        sq, cu = mxu.products_mxu(plan, ve.start_limbs_tensor(start, plan, "cpu"),
                                  torch.tensor(offsets, dtype=torch.int64))
        want_sq = [list(r) for r in zip(*[x.tolist() for x in sq])]
        want_cu = [list(r) for r in zip(*[x.tolist() for x in cu])]
        assert [g[0] for g in got] == want_sq, (base, start)
        assert [g[1] for g in got] == want_cu, (base, start)
        msq, mcu = 1 << (32 * plan.limbs_sq), 1 << (32 * plan.limbs_cu)
        for lane, i in enumerate(offsets):
            n = start + i
            if n < plan.range_end:
                assert _value(got[lane][0]) == n * n % msq
                assert _value(got[lane][1]) == n ** 3 % mcu


@pytest.mark.parametrize("base", BASES)
def test_setup_and_bands_equal_the_plain_launch_constants(base):
    """The warp-wide S^2 and S^3 equal the plain K5's launch constants, and
    the kernel's bands (S for n^2; S^2 and S for n^3) with their column
    sums times 2 and 3 make the same products as the plain version's bands
    of 2S, 3S^2 and 3S, modulo the products' limbs."""
    plan = get_plan(base)
    rng = random.Random(base + 7)
    msq, mcu = 1 << (32 * plan.limbs_sq), 1 << (32 * plan.limbs_cu)
    for start in (plan.range_start, _top_start(plan), plan.range_end - 1):
        sh = setup(plan, start)
        c = mxu.launch_constants(plan, start)
        assert _value(sh["s_sq_limbs"]) == c["s_sq"]
        assert _value(sh["s_cu"]) == c["s_cu"]
        i = rng.randrange(2**31)
        d = list((i).to_bytes(4, "little")) + list((i * i).to_bytes(8, "little"))

        def gemm(bands, cols):
            # sum over byte columns of (rows . band windows) << 8 col
            return sum(sum(d[k] * (band[col - k + off] if 0 <= col - k + off
                                   < len(band) else 0)
                           for k, (band, off) in bands) << (8 * col)
                       for col in range(cols))

        s_b = list(start.to_bytes(4 * plan.limbs_n, "little"))
        sq_b = list(c["s_sq"].to_bytes(4 * plan.limbs_sq, "little"))
        mine_sq = 2 * gemm([(k, (s_b, 0)) for k in range(4)], 8 * mxu.tiles(plan.limbs_sq))
        plain_sq = gemm([(k, (c["two_s"], 0)) for k in range(4)], 4 * plan.limbs_sq)
        assert mine_sq % msq == plain_sq % msq
        mine_cu = 3 * gemm([(k, (sq_b, 0)) for k in range(4)]
                           + [(k, (s_b, 4)) for k in range(4, 12)],
                           8 * mxu.tiles(plan.limbs_cu))
        plain_cu = gemm([(k, (c["three_s_sq"], 0)) for k in range(4)]
                        + [(k, (c["three_s"], 4)) for k in range(4, 12)],
                        4 * plan.limbs_cu)
        assert mine_cu % mcu == plain_cu % mcu


def test_warp_product_carries_across_chunks_and_runs_of_ones():
    """k5_warp_mul's carry-lookahead: products whose columns leave long runs
    of all-ones limbs, over several 32-limb chunks, equal Python ints."""
    rng = random.Random(5)
    cases = [((1 << 32 * 40) - 1, (1 << 32 * 40) - 1, 80),
             ((1 << 32 * 29) - 1, 1, 58), (1 << 32 * 28, (1 << 32 * 29) - 1, 87)]
    for _ in range(40):
        n = rng.choice([1, 2, 5, 29, 33, 64])
        x = rng.choice([rng.randrange(1 << 32 * n), (1 << 32 * n) - 1 - rng.randrange(99)])
        y = rng.choice([x, rng.randrange(1 << 32 * n)])
        cases.append((x, y, rng.randint(n, 3 * n)))
    for x, y, lo in cases:
        nx, ny = max(1, -(-x.bit_length() // 32)), max(1, -(-y.bit_length() // 32))
        got = warp_mul(_limbs(x, nx), _limbs(y, ny), lo)
        assert _value(got) == x * y % (1 << (32 * lo)), (x, y, lo)


def test_byte_windows_read_the_padded_sources():
    """k5_window (two aligned loads, a funnel shift, a byte reverse) gives
    bytes c0 - 3 .. c0 of the value, byte c0 lowest, zero outside it, for
    every c0 T reads: -4 <= c0 < 4 (limbs_cu + 1)."""
    rng = random.Random(9)
    for limbs, lcu in ((1, 1), (2, 4), (5, 13), (29, 87)):
        value = rng.randrange(1 << (32 * limbs))
        padded = [0] * PAD + _limbs(value, limbs) + [0] * (lcu + 2 - limbs)
        data = value.to_bytes(4 * limbs, "little")
        for c0 in range(-4, 4 * (lcu + 1)):
            want = [data[c0 - u] if 0 <= c0 - u < len(data) else 0
                    for u in range(4)]
            assert _bytes_of(window(padded, c0)) == want, (limbs, c0)


def test_quad_transpose_hands_each_lane_its_own_columns():
    """The two xor permutations around the three xor shuffles give lane q of
    a quad the words the other three hold for its row: word from lane q' at
    index q' (checked with words tagged by holder and owner)."""
    held = [[(ln, 4 * (ln >> 2) + r) for r in range(4)] for ln in range(32)]
    p = [permute(h, ln & 3) for ln, h in enumerate(held)]
    got = [[p[ln][0]] + [p[ln ^ k][k] for k in (1, 2, 3)] for ln in range(32)]
    for ln in range(32):
        v = permute(got[ln], ln & 3)
        assert v == [(4 * (ln >> 2) + qq, ln) for qq in range(4)]


def test_smem_layout_matches_the_header_formula():
    """mxu.smem_bytes: the histogram rounded to 16 bytes, S and S^2 padded
    and zero-extended to limbs_cu + 2 words, S^3, and 32 words a tile of
    two limbs, as csrc/nice_kernels.cuh k5_smem_bytes lays them out."""
    for base in BASES:
        plan = get_plan(base)
        front = -(-4 * (plan.base + 3) // 16) * 16
        source = PAD + plan.limbs_cu + 2
        tiles = -(-plan.limbs_sq // 2) - (-plan.limbs_cu // 2)
        assert mxu.smem_bytes(plan) == front + 4 * (2 * source + plan.limbs_cu) \
            + 128 * tiles
