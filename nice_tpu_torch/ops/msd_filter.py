"""MSD prefix filter: skip whole sub-ranges via most-significant-digit analysis
(copy of nice_tpu/ops/msd_filter.py).

If every square (or cube) in [a, b) shares a most-significant-digit prefix that
contains a duplicate, or the square and cube prefixes overlap, no number in the
range can be nice and the whole range is skipped. Recursive binary subdivision
(depth <= 22, floor 250, factor 2) yields the surviving sub-ranges.

get_valid_ranges runs the port's host library (nice_tpu_torch/native); the
Python recursion below is the semantic definition, which the tests hold the
library against, and serves the bases the library does not take (above 128).

Like the JAX package, this drops the "cross MSD x LSD collision check" of the
filter it was modelled on: its gate does not establish its premise (only a
size-1 range shares one residue mod b^k), so it could skip ranges holding
nice numbers ([50, 70) in base 10 holds 69). This filter skips slightly fewer
ranges but never loses a nice number.
"""

from __future__ import annotations

from nice_tpu_torch import native
from nice_tpu_torch.core.types import FieldSize

# Recursion tuning (reference msd_prefix_filter.rs:281-287).
MSD_RECURSIVE_MAX_DEPTH = 22
MSD_RECURSIVE_MIN_RANGE_SIZE = 250
MSD_RECURSIVE_SUBDIVISION_FACTOR = 2


def to_digits_asc(n: int, base: int) -> list[int]:
    """Base digits, LSD first. n == 0 -> [0]."""
    if n == 0:
        return [0]
    out = []
    while n:
        n, d = divmod(n, base)
        out.append(d)
    return out


def _common_msd_prefix(d1: list[int], d2: list[int]) -> list[int]:
    """Longest shared most-significant-digit prefix (LSD-first inputs);
    reference msd_prefix_filter.rs:296-314."""
    out = []
    len1, len2 = len(d1), len(d2)
    for i in range(min(len1, len2)):
        a = d1[len1 - 1 - i]
        if a == d2[len2 - 1 - i]:
            out.append(a)
        else:
            break
    return out


def _has_duplicate_digits(digits: list[int]) -> bool:
    seen = 0
    for d in digits:
        bit = 1 << d
        if seen & bit:
            return True
        seen |= bit
    return False


def _has_overlapping_digits(d1: list[int], d2: list[int]) -> bool:
    seen = 0
    for d in d1:
        seen |= 1 << d
    for d in d2:
        if seen & (1 << d):
            return True
    return False


def has_duplicate_msd_prefix(range_: FieldSize, base: int) -> bool:
    """True when the whole half-open range can be skipped
    (reference msd_prefix_filter.rs:382-563)."""
    assert range_.size() > 0
    assert base <= 256, "Base must be 256 or less"

    if range_.size() == 1:
        return False

    first = range_.first()
    last = range_.last()

    start_sq = to_digits_asc(first * first, base)
    end_sq = to_digits_asc(last * last, base)
    # Digit-count changes across the range make prefixes ambiguous; err safe.
    if len(start_sq) != len(end_sq):
        return False

    square_prefix = _common_msd_prefix(start_sq, end_sq)
    if _has_duplicate_digits(square_prefix):
        return True

    start_cu = to_digits_asc(first * first * first, base)
    end_cu = to_digits_asc(last * last * last, base)
    if len(start_cu) != len(end_cu):
        return False

    cube_prefix = _common_msd_prefix(start_cu, end_cu)
    if _has_duplicate_digits(cube_prefix):
        return True

    if _has_overlapping_digits(square_prefix, cube_prefix):
        return True

    # NOTE: the reference's cross MSD x LSD check is intentionally omitted —
    # it is unsound as gated (see module docstring).
    return False


def get_valid_ranges_recursive(
    range_: FieldSize,
    base: int,
    current_depth: int = 0,
    max_depth: int = MSD_RECURSIVE_MAX_DEPTH,
    min_range_size: int = MSD_RECURSIVE_MIN_RANGE_SIZE,
    subdivision_factor: int = MSD_RECURSIVE_SUBDIVISION_FACTOR,
) -> list[FieldSize]:
    """Recursively subdivide, returning sub-ranges that still need processing
    (reference msd_prefix_filter.rs:583-658)."""
    if current_depth >= max_depth:
        return [range_]
    if range_.size() <= min_range_size:
        return [range_]
    if has_duplicate_msd_prefix(range_, base):
        return []
    if range_.size() < min_range_size * subdivision_factor:
        return [range_]

    chunk_size = range_.size() // subdivision_factor
    valid_ranges: list[FieldSize] = []
    for i in range(subdivision_factor):
        sub_start = range_.range_start + i * chunk_size
        sub_end = (
            range_.range_end
            if i == subdivision_factor - 1
            else sub_start + chunk_size
        )
        if sub_start < sub_end:
            valid_ranges.extend(
                get_valid_ranges_recursive(
                    FieldSize(sub_start, sub_end),
                    base,
                    current_depth + 1,
                    max_depth,
                    min_range_size,
                    subdivision_factor,
                )
            )
    return valid_ranges


def get_valid_ranges(
    range_: FieldSize,
    base: int,
    min_range_size: int = MSD_RECURSIVE_MIN_RANGE_SIZE,
    max_depth: int = MSD_RECURSIVE_MAX_DEPTH,
) -> list[FieldSize]:
    """Surviving sub-ranges, in ascending order. min_range_size is the
    recursion floor: the strided device path raises it (a coarser filter
    trades host time for cheap device lanes)."""
    if not native.supports(base, range_.end()):
        return get_valid_ranges_recursive(
            range_, base, max_depth=max_depth, min_range_size=min_range_size
        )
    return [
        FieldSize(s, e)
        for s, e in native.msd_valid_ranges(
            range_.start(), range_.end(), base, max_depth, min_range_size,
            MSD_RECURSIVE_SUBDIVISION_FACTOR,
        )
    ]
