"""Per-base fixed-width plans and host-side limb packing
(copy of nice_tpu/ops/limbs.py, plus plan_from_reference and the port's own
digit-chunk constants).

Candidates, squares and cubes are vectors of u32 limbs, least significant
first. Everything shape-determining is computed here per base and handed to
the kernels as host-side Python ints: limb counts, exact digit counts, and
the constant divisors of the digit extraction.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields

import numpy as np

from nice_tpu_torch.core import base_range, number_stats


def bits_for(value: int) -> int:
    """Bits needed to store any integer in [0, value)."""
    return max((value - 1).bit_length(), 1)


def limbs_for(value: int) -> int:
    """u32 limbs needed to store any integer in [0, value)."""
    return (bits_for(value) + 31) // 32


def halfwords_for(value: int) -> int:
    """16-bit halfwords needed to store any integer in [0, value)."""
    return (bits_for(value) + 15) // 16


@dataclass(frozen=True)
class BasePlan:
    """All per-base constants, field for field the JAX package's BasePlan
    (so a plan can cross between the two packages as a dict)."""

    base: int
    range_start: int
    range_end: int
    d_sq: int  # exact digit count of n^2 in the valid range
    d_cu: int  # exact digit count of n^3
    limbs_n: int  # u32 limbs for n
    limbs_sq: int
    limbs_cu: int
    hw_sq: int  # 16-bit halfwords for n^2 (the TPU kernels' unit)
    hw_cu: int
    chunk_e: int  # digits per chunk division on the TPU (base^e <= 2^16)
    chunk_div: int
    n_masks: int  # u32 digit-presence masks (ceil(base / 32))
    near_miss_cutoff: int

    @property
    def total_digits(self) -> int:
        return self.d_sq + self.d_cu  # == base


@functools.lru_cache(maxsize=None)
def get_plan(base: int) -> BasePlan:
    r = base_range.get_base_range(base)
    if r is None:
        raise ValueError(f"base {base} has no valid range")
    start, end = r
    d_sq, d_cu = base_range.sqube_digit_counts(base)

    chunk_e = 1
    while base ** (chunk_e + 1) <= 1 << 16:
        chunk_e += 1

    max_n = end - 1
    return BasePlan(
        base=base,
        range_start=start,
        range_end=end,
        d_sq=d_sq,
        d_cu=d_cu,
        limbs_n=limbs_for(max_n + 1),
        limbs_sq=limbs_for(base**d_sq),
        limbs_cu=limbs_for(base**d_cu),
        hw_sq=halfwords_for(base**d_sq),
        hw_cu=halfwords_for(base**d_cu),
        chunk_div=base**chunk_e,
        chunk_e=chunk_e,
        n_masks=(base + 31) // 32,
        near_miss_cutoff=number_stats.get_near_miss_cutoff(base),
    )


def plan_from_reference(d: dict) -> BasePlan:
    """The port's BasePlan from `dataclasses.asdict` of the JAX package's
    plan, so tests can run both packages on one plan. Rejects a dict whose
    keys are not exactly the plan's fields."""
    names = {f.name for f in fields(BasePlan)}
    if set(d) != names:
        raise ValueError(f"plan dict keys {sorted(set(d) ^ names)} do not match BasePlan")
    return BasePlan(**{k: int(v) for k, v in d.items()})


# --------------------------------------------------------------------------
# The port's digit-extraction constants (kernel and plain version alike)
# --------------------------------------------------------------------------
#
# The TPU peels base^e <= 2^16 at a time because its VPU is 32-bit. With
# 64-bit intermediates a chunk can be base^e < 2^31: long division of u32
# limbs computes (rem << 32 | limb) / chunk_div with rem < chunk_div, which
# stays below 2^63 — inside int64 for the plain PyTorch version as well as
# u64 in the kernel, so both run the same arithmetic.

CHUNK_LIMIT = 1 << 31

# Fixed-point bits of the log2(base) upper bound that sizes the shrinking
# quotient during digit extraction.
LOG2_FX_BITS = 20


def digit_chunk(base: int) -> tuple[int, int]:
    """(e, base**e): the largest e with base**e < 2^31."""
    e = 1
    while base ** (e + 1) < CHUNK_LIMIT:
        e += 1
    return e, base**e


def log2_fx(base: int) -> int:
    """An integer L >= log2(base) * 2^LOG2_FX_BITS (float error is ~1e-9
    here, so the +2 margin keeps it an upper bound)."""
    return int(math.log2(base) * (1 << LOG2_FX_BITS)) + 2


def quotient_limbs(rem_digits: int, log2_base_fx: int) -> int:
    """Upper bound on the u32 limbs of base**rem_digits: bits <= floor(r *
    log2 b) + 1, rounded up to whole limbs. Used to shrink the dividend as
    digits are peeled; an over-estimate only divides zero limbs."""
    return ((rem_digits * log2_base_fx) >> LOG2_FX_BITS) // 32 + 1


# --------------------------------------------------------------------------
# Host packing
# --------------------------------------------------------------------------

def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Pack a Python int into LSW-first u32 limbs."""
    if x < 0 or x >= 1 << (32 * num_limbs):
        raise ValueError(f"{x} does not fit in {num_limbs} u32 limbs")
    return np.array(
        [(x >> (32 * i)) & 0xFFFFFFFF for i in range(num_limbs)], dtype=np.uint32
    )


def limbs_to_int(limbs) -> int:
    """Inverse of int_to_limbs (accepts any sequence of u32 values)."""
    out = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        out |= int(limb) << (32 * i)
    return out
