"""LSD filter: valid last-k-digit suffixes mod b^k (copy of
nice_tpu/ops/lsd_filter.py).

The last k digits of n determine the last k digits of n^2 and n^3. A suffix is
invalid when any digit of (n^2 mod b^k) collides with any digit of
(n^3 mod b^k) — a guaranteed duplicate. Mirrors reference
common/src/lsd_filter.rs:67-238.

The bitmap construction is vectorized (numpy over all b^k suffixes at once)
because stride-depth planning consults deep tables: the scalar loop takes ~5 s
at b=50, k=3 (125k suffixes in pure Python) while the vectorized pass takes
~0.1 s. `_bitmap_scalar` keeps the direct transcription of the definition as
the differential-test oracle (tests/test_filters.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _extract_digits(value: int, base: int, num_digits: int) -> set[int]:
    """Unique digits among the low `num_digits` digits, stopping at zero
    (reference lsd_filter.rs:132-148: always inserts the first digit)."""
    digits = set()
    remaining = value
    for _ in range(num_digits):
        remaining, d = divmod(remaining, base)
        digits.add(d)
        if remaining == 0:
            break
    return digits


@lru_cache(maxsize=None)
def get_valid_lsds(base: int) -> tuple[int, ...]:
    """Single-digit filter: LSDs where n^2 and n^3 end in different digits
    (reference lsd_filter.rs:67-121)."""
    out = []
    for lsd in range(base):
        if (lsd * lsd) % base != (lsd * lsd * lsd) % base:
            out.append(lsd)
    return tuple(out)


def _bitmap_scalar(base: int, k: int) -> np.ndarray:
    """Direct transcription of the definition (the test oracle)."""
    modulus = base**k
    bitmap = np.zeros(modulus, dtype=bool)
    for suffix in range(modulus):
        sq = (suffix * suffix) % modulus
        cb = (suffix * suffix * suffix) % modulus
        sq_digits = _extract_digits(sq, base, k)
        cb_digits = _extract_digits(cb, base, k)
        if sq_digits.isdisjoint(cb_digits):
            bitmap[suffix] = True
    return bitmap


def _digit_presence_masks(values: np.ndarray, base: int, k: int) -> np.ndarray:
    """u64[..., n_words] digit-presence bitmasks of the low k digits of each
    value, with the reference's stop-at-zero rule: peel digits LSD-first,
    always recording the first, and stop once the remaining quotient is zero.

    The word count scales with the base (digits span [0, base)): bases up to
    256 need four u64 words. A fixed two-word layout silently produced
    `one << (d - 64)` with d >= 128 — a >= 64-bit shift, undefined in numpy —
    for bases above 128 (advisor finding, round 3)."""
    n_words = (base + 63) // 64
    one = np.uint64(1)
    masks = np.zeros(values.shape + (n_words,), dtype=np.uint64)
    rem = values.astype(np.int64)
    alive = np.ones(values.shape, dtype=bool)
    for _ in range(k):
        d = rem % base
        rem = rem // base
        bit = one << (d.astype(np.uint64) & np.uint64(63))
        word = d >> 6
        for w in range(n_words):
            masks[..., w] |= np.where(alive & (word == w), bit, 0)
        alive &= rem != 0
    return masks


@lru_cache(maxsize=None)
def get_valid_multi_lsd_bitmap(base: int, k: int) -> np.ndarray:
    """bitmap[s] == True when suffix s (mod b^k) can produce a nice number
    (reference lsd_filter.rs:174-224). Returns a read-only bool ndarray."""
    modulus = base**k
    s = np.arange(modulus, dtype=np.int64)
    # s < b^k <= ~9e5^... keep products in range: s*s < modulus^2 and the cube
    # is reduced in two steps so every intermediate stays below 2^63
    # (modulus <= 96^3 < 2^20, so modulus^2 < 2^40).
    sq = (s * s) % modulus
    cb = (sq * s) % modulus
    sq_masks = _digit_presence_masks(sq, base, k)
    cb_masks = _digit_presence_masks(cb, base, k)
    bitmap = ~np.any(sq_masks & cb_masks, axis=-1)
    bitmap.setflags(write=False)
    return bitmap


@lru_cache(maxsize=None)
def valid_multi_lsd_count(base: int, k: int) -> int:
    """Number of valid k-digit suffixes (used by stride-depth planning to
    score depths without materializing full stride tables)."""
    return int(get_valid_multi_lsd_bitmap(base, k).sum())


def get_recommended_k(base: int) -> int:
    """Locked to 1 in the reference after benchmarking (lsd_filter.rs:234-238)."""
    return 1
