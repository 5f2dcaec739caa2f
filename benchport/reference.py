"""The plain reference of a detailed field, in plain PyTorch integer tensors.

A number n is searched in base b when the digits of n^2 and n^3 together
number b; its num_uniques is how many distinct digits they hold. A detailed
field [start, end) answers with the histogram of num_uniques over 1..b and
the near misses: every n whose num_uniques exceeds the server's cutoff,
floor(f32(b) * f32(0.9)) (upstream nice `common/src/lib.rs`).

This file works that out from the field alone, written from those
definitions and imported from nowhere but torch and the standard library:

  * the base's valid range and the exact digit counts of n^2 and n^3 in it
    (upstream `base_range.rs`'s case analysis on b mod 5);
  * n, n^2 and n^3 as limbs of radix b^e, so that each limb holds e whole
    digits and a digit is a division of one limb; e is the largest that
    keeps every column sum of a schoolbook product below 2^62 in int64;
  * the digits of each number, scattered into a one-hot table of the
    digit values it holds, whose column sum is its num_uniques.

`field_result` runs it on any device in batches of `batch` numbers;
`uniques_int` is the same definition on Python ints, for single numbers.
`field_result(..., arithmetic="float64")` is the control: the squares and
cubes taken in float64 (53-bit) where the server's rule is exact, the
nearest precision below exact integers, which the comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEAR_MISS_SHARE = 0.9
INT64_HEADROOM = 1 << 62
BATCH = 1 << 22


def floor_root(x: int, k: int) -> int:
    """The exact integer floor of x ** (1/k)."""
    if x < 2:
        return x
    r = 1 << -(-x.bit_length() // k)
    while True:
        nxt = ((k - 1) * r + x // r ** (k - 1)) // k
        if nxt >= r:
            break
        r = nxt
    while r**k > x:
        r -= 1
    return r


def ceil_root(x: int, k: int) -> int:
    r = floor_root(x, k)
    return r if r**k == x else r + 1


def base_range(base: int) -> tuple[int, int] | None:
    """Half-open [lo, hi) of the n whose n^2 and n^3 hold `base` digits
    together, or None where there is none (b mod 5 == 1)."""
    b, k, m = base, base // 5, base % 5
    if m == 0:
        return ceil_root(b ** (3 * k - 1), 3), b**k
    if m == 2:
        return b**k, ceil_root(b ** (3 * k + 1), 3)
    if m == 3:
        return ceil_root(b ** (3 * k + 1), 3), ceil_root(b ** (2 * k + 1), 2)
    if m == 4:
        return ceil_root(b ** (2 * k + 1), 2), ceil_root(b ** (3 * k + 2), 3)
    return None


def digit_counts(base: int) -> tuple[int, int]:
    """Digits of n^2 and of n^3 for every n in the base's valid range."""
    k, m = base // 5, base % 5
    table = {0: (2 * k, 3 * k), 2: (2 * k + 1, 3 * k + 1),
             3: (2 * k + 1, 3 * k + 2), 4: (2 * k + 2, 3 * k + 2)}
    if m not in table:
        raise ValueError(f"base {base} has no valid range")
    return table[m]


def near_miss_cutoff(base: int) -> int:
    """num_uniques above this is a near miss: floor(f32(b) * f32(0.9))."""
    return int(math.floor(float(np.float32(base) * np.float32(NEAR_MISS_SHARE))))


def uniques_int(n: int, base: int) -> int:
    """num_uniques of n in `base`, on Python ints."""
    seen = set()
    for x in (n * n, n * n * n):
        while x:
            x, d = divmod(x, base)
            seen.add(d)
    return len(seen)


def _digits_of(x: int, base: int) -> int:
    d = 0
    while x:
        x //= base
        d += 1
    return d


def radix_digits(base: int) -> int:
    """e: digits a limb of radix base^e holds, the largest for which every
    column of n^2 = n * n and n^3 = n^2 * n stays under 2^62."""
    _, hi = base_range(base)
    dn = _digits_of(hi - 1, base)
    e = 1
    while True:
        r = base ** (e + 1)
        if -(-dn // (e + 1)) * ((r - 1) ** 2 + r) >= INT64_HEADROOM:
            return e
        e += 1


def _to_limbs(x: int, radix: int, n: int) -> list[int]:
    out = []
    for _ in range(n):
        x, r = divmod(x, radix)
        out.append(r)
    if x:
        raise ValueError("value does not fit its limbs")
    return out


def _normalize(cols: list, radix: int) -> list:
    """Carry a list of int64 column tensors into limbs below radix."""
    out, carry = [], None
    for c in cols:
        v = c if carry is None else c + carry
        carry = torch.div(v, radix, rounding_mode="floor")
        out.append(v - carry * radix)
    out.append(carry)
    return out


def _product(a: list, b: list, radix: int) -> list:
    cols = [None] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            p = x * y
            cols[i + j] = p if cols[i + j] is None else cols[i + j] + p
    return _normalize(cols, radix)


def _limb_digits(limbs: list, base: int, e: int, ndig: int):
    """Yield the ndig lowest digits held by `limbs`, limb by limb, each a
    [digits, count] tensor: limb // base^j % base for j < e."""
    powers = torch.tensor([base**j for j in range(e)], dtype=torch.int64,
                          device=limbs[0].device)
    for i, limb in enumerate(limbs):
        k = min(e, ndig - i * e)
        if k <= 0:
            return
        yield torch.remainder(
            torch.div(limb.unsqueeze(0), powers[:k, None],
                      rounding_mode="floor"), base)


def _count_distinct(digits, base: int, count: int, device) -> torch.Tensor:
    """Distinct values among the digit tensors, lane by lane: a one-hot
    present[value, lane] set by a scatter, summed over the values."""
    present = torch.zeros((base, count), dtype=torch.bool, device=device)
    for d in digits:
        present.scatter_(0, d, True)
    return present.sum(0)


def _batch_uniques(base: int, start: int, count: int, device) -> torch.Tensor:
    """num_uniques of start + [0, count), int64 on `device`, exact."""
    e = radix_digits(base)
    radix = base**e
    _, hi = base_range(base)
    n_limbs = -(-_digits_of(hi - 1, base) // e)
    d_sq, d_cu = digit_counts(base)
    s = _to_limbs(start, radix, n_limbs)
    cols = [torch.arange(count, dtype=torch.int64, device=device) + s[0]]
    cols += [torch.full((count,), x, dtype=torch.int64, device=device)
             for x in s[1:]]
    n = _normalize(cols, radix)[:n_limbs]
    sq = _product(n, n, radix)
    cu = _product(sq, n, radix)

    def digits():
        yield from _limb_digits(sq, base, e, d_sq)
        yield from _limb_digits(cu, base, e, d_cu)

    return _count_distinct(digits(), base, count, device)


def _batch_uniques_float64(base: int, start: int, count: int, device
                           ) -> torch.Tensor:
    """The control: _batch_uniques with n^2 and n^3 taken in float64."""
    d_sq, d_cu = digit_counts(base)
    n = (torch.arange(count, dtype=torch.float64, device=device)
         + float(start))

    def digits():
        for x, nd in ((n * n, d_sq), (n * n * n, d_cu)):
            for _ in range(nd):
                q = torch.floor(x / base)
                yield (x - q * base).clamp(0, base - 1).to(torch.int64)[None]
                x = q

    return _count_distinct(digits(), base, count, device)


def field_result(base: int, start: int, end: int, device="cpu",
                 batch: int = BATCH, arithmetic: str = "int64"
                 ) -> tuple[list[int], list[tuple[int, int]]]:
    """(histogram of num_uniques over 1..base, [(n, num_uniques)] of the
    near misses in ascending n) of the field [start, end), which has to lie
    inside the base's valid range. arithmetic "float64" is the control."""
    lo, hi = base_range(base)
    if not lo <= start < end <= hi:
        raise ValueError(f"[{start}, {end}) is not inside b{base}'s range "
                         f"[{lo}, {hi})")
    uniques = {"int64": _batch_uniques,
               "float64": _batch_uniques_float64}[arithmetic]
    cutoff = near_miss_cutoff(base)
    hist = torch.zeros(base + 1, dtype=torch.int64, device=device)
    near: list[tuple[int, int]] = []
    for s in range(start, end, batch):
        count = min(batch, end - s)
        u = uniques(base, s, count, device)
        hist += torch.bincount(u, minlength=base + 1)[: base + 1]
        idx = torch.nonzero(u > cutoff).flatten()
        if idx.numel():
            near.extend((s + int(i), int(v))
                        for i, v in zip(idx.tolist(), u[idx].tolist()))
    return hist[1:].tolist(), near
