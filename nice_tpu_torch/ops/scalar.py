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
