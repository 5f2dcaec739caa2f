"""Valid search interval per base (copy of nice_tpu/core/base_range.py).

A number n is a candidate in base b only when digits_b(n^2) + digits_b(n^3)
== b, which pins n to one contiguous interval per base (b % 5 case
analysis). Inside that interval the digit counts of n^2 and n^3 are exact
constants:

    b % 5 == 0 (k=b//5): digits(n^2) = 2k,   digits(n^3) = 3k
    b % 5 == 2:          digits(n^2) = 2k+1, digits(n^3) = 3k+1
    b % 5 == 3:          digits(n^2) = 2k+1, digits(n^3) = 3k+2
    b % 5 == 4:          digits(n^2) = 2k+2, digits(n^3) = 3k+2

which lets the kernels extract digits with a fixed trip count.
"""

from __future__ import annotations

import math
from typing import Optional

from nice_tpu_torch.core.types import FieldSize


def floor_root(x: int, n: int) -> int:
    """Exact integer floor(x ** (1/n)) for x >= 0, n >= 1."""
    if x < 0:
        raise ValueError("floor_root of negative number")
    if n == 1 or x in (0, 1):
        return x
    if n == 2:
        return math.isqrt(x)
    r = 1 << -(-x.bit_length() // n)  # 2^ceil(bits/n) >= x^(1/n)
    while True:
        nxt = ((n - 1) * r + x // r ** (n - 1)) // n
        if nxt >= r:
            break
        r = nxt
    while r**n > x:
        r -= 1
    return r


def ceiling_root(x: int, n: int) -> int:
    """Exact integer ceil(x ** (1/n))."""
    r = floor_root(x, n)
    return r if r**n == x else r + 1


def get_base_range(base: int) -> Optional[tuple[int, int]]:
    """Half-open [start, end) of valid n for a base, or None when empty."""
    b = base
    k = base // 5
    m = base % 5
    if m == 0:
        return (ceiling_root(b ** (3 * k - 1), 3), b**k)
    if m == 2:
        return (b**k, ceiling_root(b ** (3 * k + 1), 3))
    if m == 3:
        return (
            ceiling_root(b ** (3 * k + 1), 3),
            ceiling_root(b ** (2 * k + 1), 2),
        )
    if m == 4:
        return (
            ceiling_root(b ** (2 * k + 1), 2),
            ceiling_root(b ** (3 * k + 2), 3),
        )
    return None


def get_base_range_field(base: int) -> Optional[FieldSize]:
    r = get_base_range(base)
    if r is None:
        return None
    return FieldSize(r[0], r[1])


def sqube_digit_counts(base: int) -> tuple[int, int]:
    """Exact (digits(n^2), digits(n^3)) for every n in the base's valid range.
    Raises for bases with an empty range (b % 5 == 1)."""
    k = base // 5
    m = base % 5
    if m == 0:
        return (2 * k, 3 * k)
    if m == 2:
        return (2 * k + 1, 3 * k + 1)
    if m == 3:
        return (2 * k + 1, 3 * k + 2)
    if m == 4:
        return (2 * k + 2, 3 * k + 2)
    raise ValueError(f"base {base} has no valid range (base % 5 == 1)")
