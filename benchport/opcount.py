"""The least multiplies one candidate of the detailed kernel needs at a base,
counted from the base's shapes alone: the work side of `k1_roofline`.

A frozen copy of nice_tpu_torch/scripts/generic_bound.py's count for
detailed_megaloop_kernel (with the plan arithmetic it reads from
nice_tpu_torch/ops/limbs.py), as it stood at commit ec3f0c4: 167
multiplies at b40 and 649 at b80. It counts what the
arithmetic of a candidate needs in u32 limbs, whatever kernel does it:

  * a partial product of n^2 = n * n or of n^3 = n^2 * n, modulo the
    product's limbs: one 32x32->64 multiply-add;
  * a limb step of a chunk division (r << 32 | limb) / base^e: four for the
    64x64 high product by the chunk's reciprocal, one for the remainder;
  * a digit off a chunk's remainder: one for the multiply-high by the digit
    magic, one for r - q * base.

Adds, shifts, compares, moves and loop control are left out, so the count
lies below what any compiled candidate issues. Being a copy, it does not
move when a kernel changes: a faster kernel shows as a higher share.
"""

from __future__ import annotations

import math

from benchport import reference

MUL_PER_PRODUCT = 1
MUL_PER_LIMB_STEP = 5
MUL_PER_DIGIT = 2
CHUNK_LIMIT = 1 << 31
LOG2_FX_BITS = 20


def _limbs_for(value: int) -> int:
    """u32 limbs that hold any integer in [0, value)."""
    return (max((value - 1).bit_length(), 1) + 31) // 32


def _digit_chunk(base: int) -> int:
    """e: the largest with base**e < 2^31."""
    e = 1
    while base ** (e + 1) < CHUNK_LIMIT:
        e += 1
    return e


def _quotient_limbs(rem_digits: int, base: int) -> int:
    """An upper bound on the u32 limbs of base**rem_digits."""
    lfx = int(math.log2(base) * (1 << LOG2_FX_BITS)) + 2
    return ((rem_digits * lfx) >> LOG2_FX_BITS) // 32 + 1


def _products(la: int, lb: int, lo: int) -> int:
    """Partial products of a * b mod 2^(32 lo), a of la limbs, b of lb."""
    return sum(min(lb, lo - i) for i in range(min(la, lo)))


def _peel(base: int, nl: int, ndig: int) -> tuple[int, int]:
    """(limb steps, digit steps) that take ndig digits off a value of nl
    limbs, chunk by chunk, its limbs shrinking as digits go."""
    e = _digit_chunk(base)
    limb_steps = digit_steps = 0
    rem = ndig
    while rem > e:
        rem -= e
        limb_steps += nl
        nl = min(nl, _quotient_limbs(rem, base))
        digit_steps += e - 1
    return limb_steps, digit_steps + max(rem - 1, 0)


def detailed_multiplies(base: int) -> int:
    """Multiplies one candidate of a detailed field needs at `base`."""
    _, hi = reference.base_range(base)
    d_sq, d_cu = reference.digit_counts(base)
    n = _limbs_for(hi)
    sq = _limbs_for(base**d_sq)
    cu = _limbs_for(base**d_cu)
    limb_sq, digit_sq = _peel(base, sq, d_sq)
    limb_cu, digit_cu = _peel(base, cu, d_cu)
    return (MUL_PER_PRODUCT * (_products(n, n, sq) + _products(sq, n, cu))
            + MUL_PER_LIMB_STEP * (limb_sq + limb_cu)
            + MUL_PER_DIGIT * (digit_sq + digit_cu))
