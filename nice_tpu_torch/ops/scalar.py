"""Scalar reference engine: the Python-int oracle (copy of nice_tpu/ops/scalar.py).

Python ints are arbitrary-precision, so one implementation covers every
base and every range, including out-of-range slivers that the fixed-width
kernels do not accept. Tests and chip_smoke.py hold the kernels against it.
"""

from __future__ import annotations

from nice_tpu_torch.core import number_stats
from nice_tpu_torch.core.types import (
    FieldResults,
    FieldSize,
    NiceNumberSimple,
    UniquesDistributionSimple,
)


def get_num_unique_digits(num: int, base: int) -> int:
    """Number of unique digits in (n^2, n^3) written in base b; a number is
    nice iff this equals b."""
    indicator = 0
    squared = num * num
    cubed = squared * num
    n = squared
    while n != 0:
        n, d = divmod(n, base)
        indicator |= 1 << d
    n = cubed
    while n != 0:
        n, d = divmod(n, base)
        indicator |= 1 << d
    return indicator.bit_count()


def get_is_nice(num: int, base: int) -> bool:
    """True iff the digits of n^2 and n^3 are all distinct, stopping at the
    first repeated digit (the host re-scan's and the stride iteration's
    check)."""
    indicator = 0
    squared = num * num
    n = squared
    while n != 0:
        n, d = divmod(n, base)
        bit = 1 << d
        if indicator & bit:
            return False
        indicator |= bit
    n = squared * num
    while n != 0:
        n, d = divmod(n, base)
        bit = 1 << d
        if indicator & bit:
            return False
        indicator |= bit
    return True


def process_range_detailed(range_: FieldSize, base: int) -> FieldResults:
    """Full histogram + near-miss list for a half-open range."""
    nice_list_cutoff = number_stats.get_near_miss_cutoff(base)
    histogram = [0] * (base + 2)
    nice_numbers: list[NiceNumberSimple] = []

    for num in range_.range_iter():
        num_uniques = get_num_unique_digits(num, base)
        histogram[num_uniques] += 1
        if num_uniques > nice_list_cutoff:
            nice_numbers.append(
                NiceNumberSimple(number=num, num_uniques=num_uniques)
            )

    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=histogram[i])
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution, nice_numbers=tuple(nice_numbers))


def process_range_niceonly(range_: FieldSize, base: int) -> FieldResults:
    """Nice numbers of a half-open range through the full filter cascade:
    recursive MSD range subdivision, then CRT stride iteration with the
    early-exit check on each candidate."""
    from nice_tpu_torch.ops import msd_filter, stride_filter

    stride_table = stride_filter.get_stride_table(base, 1)
    nice_list: list[NiceNumberSimple] = []
    for sub_range in msd_filter.get_valid_ranges(range_, base):
        nice_list.extend(stride_table.iterate_range(sub_range, base))

    return FieldResults(distribution=(), nice_numbers=tuple(nice_list))
