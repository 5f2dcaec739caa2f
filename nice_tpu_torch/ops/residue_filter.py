"""Residue filter: valid n mod (b-1) classes (copy of
nice_tpu/ops/residue_filter.py).

If n is nice, the digits of n^2 and n^3 are a permutation of 0..b-1, whose sum
is b(b-1)/2. Digit sums are preserved mod (b-1), so n^2 + n^3 must be congruent
to b(b-1)/2 mod (b-1). Mirrors reference common/src/residue_filter.rs:6-11.
"""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def get_residue_filter(base: int) -> tuple[int, ...]:
    """Residues r in [0, b-1) with r^2 + r^3 congruent to b(b-1)/2 mod (b-1)."""
    target_residue = base * (base - 1) // 2 % (base - 1)
    return tuple(
        r
        for r in range(base - 1)
        if (r * r + r * r * r) % (base - 1) == target_residue
    )
