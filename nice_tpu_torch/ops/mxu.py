"""The tensor-core arm of the detailed and dense niceonly kernels (K5): its
bound, the plans it takes, and the plain PyTorch version of its product step
(the port's counterpart of nice_tpu/ops/mxu.py).

The TPU's MXU arm (nice_tpu/ops/mxu.py mul_limbs_mxu / sqr_limbs_mxu,
:162-190) contracts each lane's own banded Toeplitz matrix of 8-bit digits
against its 16-bit halves: a batched matrix-vector product whose matrix
differs per lane. On an MMA that fills one output column of eight. K5 uses
the shape every lane of K1 and K4 shares instead: a lane is n = S + i, S
the launch's start and i < 2^31 the lane's offset, so

    n^2 = S^2 + 2S*i + i^2
    n^3 = S^3 + 3S^2*i + 3S*i^2 + i^3

and the lane-dependent multi-limb parts are one GEMM with a shared operand,
Out[lane][t] = sum_k D[lane][k] * T[k][t]:

    D: the lane's byte digits of i (4 bytes) and of i^2 (8), padded to 16;
    T: the Toeplitz bands of the bytes of 2S (n^2's columns, rows 0-3), of
       3S^2 (n^3's columns, rows 0-3) and of 3S (n^3's columns, rows 4-11).

Output column t is worth 2^(8t). Its sum has at most 12 terms of 255 * 255
(accum_bound), so it fits an s32 accumulator for every plan. The columns
are walked in ascending order into u32 limbs with a 64-bit carry, then
S^2 + i^2 (S^3 + i^3) is added, modulo 2^(32 * limbs_sq) (limbs_cu).

That equals K1's truncation contract (sq = n^2 mod 2^(32 limbs_sq), cu =
sq * n mod 2^(32 limbs_cu), n = (S + i) mod 2^(32 limbs_n)) whenever S + i
does not wrap past limbs_n limbs and n^2 fits limbs_sq limbs, which holds
for every lane inside the base's valid range. A lane outside it (the
engine never launches one) takes K1's schoolbook product instead, so K5
equals K1 on every lane.

Carrier rule: as in vector_engine.py, u32 values in int64 tensors.
"""

from __future__ import annotations

import torch

from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import BasePlan

_DIGIT_MAX = 255  # both GEMM operands are bytes

# Rows of D (and of T) that carry a term: i's 4 bytes, then i^2's 8 (the
# MMA's depth pads them to 16).
D_ROWS = 12
# u32 limbs of one m16n8k16 tile: its 8 byte columns.
TILE_LIMBS = 2
# The kernels launch without opting in to more than the default 48 KiB of
# shared memory a block.
SMEM_LIMIT = 48 * 1024


def accum_bound() -> int:
    """Worst-case column sum of the s32 accumulator: each of the D_ROWS
    digit rows times a maximal byte of T."""
    return D_ROWS * _DIGIT_MAX * _DIGIT_MAX


def tiles(limbs: int) -> int:
    """MMA column tiles of a product region of `limbs` u32 limbs."""
    return -(-limbs // TILE_LIMBS)


# Zero words below each of T's sources (S, S^2) in shared memory; above,
# each is zero-extended to limbs_cu + 2 words.
SOURCE_PAD = 2


def smem_bytes(plan: BasePlan) -> int:
    """Shared memory of one K5 block (csrc/nice_kernels.cuh k5_smem_bytes)
    in the detailed mode: its histogram (bins 0..base+1 and the near-miss
    count, rounded to 16 bytes), T's sources S and S^2 (padded), S^3, and
    T's words (32 a tile); the dense mode has no histogram."""
    front = -(-4 * (plan.base + 3) // 16) * 16
    source = SOURCE_PAD + plan.limbs_cu + 2
    return (front + 4 * (2 * source + plan.limbs_cu)
            + 4 * 32 * (tiles(plan.limbs_sq) + tiles(plan.limbs_cu)))


def reference_takes(plan: BasePlan) -> bool:
    """The reference's own bound on its MXU arm (nice_tpu/ops/mxu.py
    supports_plan): a contraction over the 2 * limbs_n 16-bit halves of n,
    each times an 8-bit digit, fits i32 (limbs_n <= 64)."""
    return 2 * plan.limbs_n * _DIGIT_MAX * 65535 < 2**31


def supports_plan(plan: BasePlan) -> bool:
    """True when K5 takes this plan: the accumulator bound fits s32 (for
    every plan), a block's shared memory fits SMEM_LIMIT, and the reference
    takes it too: every base up to b1024 (from b1025 n takes 65 limbs)."""
    return (accum_bound() < 2**31 and smem_bytes(plan) <= SMEM_LIMIT
            and reference_takes(plan))


# --------------------------------------------------------------------------
# The plain product step
# --------------------------------------------------------------------------

def _bytes(x: int, count: int) -> list[int]:
    return [(x >> (8 * j)) & 0xFF for j in range(count)]


def launch_constants(plan: BasePlan, start: int) -> dict:
    """The per-launch constants a K5 block builds from the start limbs: T's
    bands as byte lists (2S mod 2^(32 limbs_sq), 3S^2 and 3S mod
    2^(32 limbs_cu)) and S^2, S^3 under the truncation contract."""
    msq, mcu = 1 << (32 * plan.limbs_sq), 1 << (32 * plan.limbs_cu)
    s_sq = start * start % msq
    return {
        "two_s": _bytes(2 * start % msq, 4 * plan.limbs_sq),
        "three_s_sq": _bytes(3 * s_sq % mcu, 4 * plan.limbs_cu),
        "three_s": _bytes(3 * start % mcu, 4 * plan.limbs_cu),
        "s_sq": s_sq,
        "s_cu": s_sq * start % mcu,
    }


def _column(digits: list, band: list, t: int):
    """Column t of one band product: sum_k digits[k] * band[t - k], the
    Toeplitz row t of T against D (the kernel's MMA, one column)."""
    acc = None
    for k, d in enumerate(digits):
        if 0 <= t - k < len(band) and band[t - k]:
            term = d * band[t - k]
            acc = term if acc is None else acc + term
    return acc


def _reassemble(cols: list, out_len: int, zero) -> list:
    """Byte columns (LS first) into out_len u32 limbs, carry in 64 bits."""
    out = []
    carry = zero
    for l in range(out_len):
        acc = carry
        for u in range(4):
            c = cols[4 * l + u]
            if c is not None:
                acc = acc + (c << (8 * u))
        out.append(acc & ve.MASK32)
        carry = acc >> 32
    return out


def _add_limbs(a: list, b: list) -> list:
    """a + b mod 2^(32 len(a)); b may be shorter, entries broadcast."""
    out = []
    carry = 0
    for k, x in enumerate(a):
        s = x + carry + (b[k] if k < len(b) else 0)
        out.append(s & ve.MASK32)
        carry = s >> 32
    return out


def _int_limbs(x: int, count: int) -> list[int]:
    return [(x >> (32 * k)) & ve.MASK32 for k in range(count)]


def products_mxu(plan: BasePlan, start_limbs: torch.Tensor, offsets):
    """(sq, cu) limb lists of the lanes n = start + offsets (int64 offsets
    in [0, 2^31)), computed the way K5 computes them: the GEMM of the
    lanes' byte digits against the start's Toeplitz bands, reassembled and
    completed with S^2 + i^2 and S^3 + i^3; lanes that wrap past limbs_n
    limbs or whose square passes limbs_sq limbs take K1's schoolbook
    product (vector_engine.sqr_limbs / mul_limbs)."""
    start = sum(int(v) << (32 * k) for k, v in enumerate(start_limbs.tolist()))
    c = launch_constants(plan, start)
    i = offsets
    i2 = i * i  # < 2^62
    digits = ve.byte_digits([i & ve.MASK32], 4) + ve.byte_digits(
        [i2 & ve.MASK32, i2 >> 32], 8)
    i3 = ve.mul_limbs([i2 & ve.MASK32, i2 >> 32], [i], 3)
    zero = torch.zeros_like(i)
    sq_cols = [_column(digits[:4], c["two_s"], t)
               for t in range(4 * plan.limbs_sq)]
    cu_cols = []
    for t in range(4 * plan.limbs_cu):
        a = _column(digits[:4], c["three_s_sq"], t)
        b = _column(digits[4:], c["three_s"], t)
        cu_cols.append(a if b is None else b if a is None else a + b)
    sq = _add_limbs(_reassemble(sq_cols, plan.limbs_sq, zero),
                    _int_limbs(c["s_sq"], plan.limbs_sq))
    sq = _add_limbs(sq, [i2 & ve.MASK32, i2 >> 32])
    cu = _add_limbs(_reassemble(cu_cols, plan.limbs_cu, zero),
                    _int_limbs(c["s_cu"], plan.limbs_cu))
    cu = _add_limbs(cu, i3)
    # The lanes outside the decomposition's domain, as K1 computes them.
    n, wrapped = ve.add_u32_carry([start_limbs[k] for k in range(plan.limbs_n)], i)
    odd = torch.nonzero(wrapped | ve.square_overflows(plan, n)).flatten()
    if odd.numel():
        n_odd = [x[odd] for x in n]
        sq_odd = ve.sqr_limbs(n_odd, plan.limbs_sq)
        cu_odd = ve.mul_limbs(sq_odd, n_odd, plan.limbs_cu)
        sq = [x.index_put((odd,), y) for x, y in zip(sq, sq_odd)]
        cu = [x.index_put((odd,), y) for x, y in zip(cu, cu_odd)]
    return sq, cu


def uniques_mxu(plan: BasePlan, start_limbs: torch.Tensor, offsets):
    """num_uniques of the lanes start + offsets through the K5 product
    step, as int32."""
    sq, cu = products_mxu(plan, start_limbs, offsets)
    return ve.uniques_of_products(plan, sq, cu)
