"""CRT stride iteration: combine residue (mod b-1) and LSD (mod b^k) filters
(copy of nice_tpu/ops/stride_filter.py, cut to what niceonly uses).

Instead of testing filters per candidate, precompute the valid residues of the
combined modulus M = (b-1) * b^k (gcd(b-1, b^k) = 1) and jump candidate to
candidate with a gap table — zero per-candidate filter cost.

The table also drives the strided niceonly kernel (K3): candidate i of a
descriptor is n0 + (i // R) * M + residues[i % R].
"""

from __future__ import annotations

import bisect
from functools import lru_cache

import numpy as np

from nice_tpu_torch.core.types import FieldSize, NiceNumberSimple
from nice_tpu_torch.ops import lsd_filter, residue_filter
from nice_tpu_torch.ops.scalar import get_is_nice


class StrideTable:
    """Precomputed valid residues mod M = (b-1) * b^k, plus gap table."""

    def __init__(self, base: int, k: int):
        b_minus_1 = base - 1
        b_k = base**k
        self.base = base
        self.k = k
        self.modulus = b_minus_1 * b_k

        residue_set = np.array(residue_filter.get_residue_filter(base), dtype=np.int64)
        lsd_bitmap = np.asarray(lsd_filter.get_valid_multi_lsd_bitmap(base, k))

        r = np.arange(self.modulus, dtype=np.int64)
        passes_residue = np.isin(r % b_minus_1, residue_set)
        passes_lsd = lsd_bitmap[r % b_k]
        valid = np.nonzero(passes_residue & passes_lsd)[0]

        self.valid_residues: list[int] = valid.tolist()
        if len(valid):
            gaps = np.empty(len(valid), dtype=np.int64)
            gaps[:-1] = valid[1:] - valid[:-1]
            gaps[-1] = self.modulus - valid[-1] + valid[0]
            self.gap_table: list[int] = gaps.tolist()
            # ndarray twins: the native library takes the gap table by
            # pointer, and the device keeps the residues (modulus < 2^32).
            self.gap_array = gaps.astype(np.uint64)
            self.gap_array.setflags(write=False)
            self.residues_u32 = valid.astype(np.uint32)
            self.residues_u32.setflags(write=False)
        else:
            self.gap_table = []
            self.gap_array = np.empty(0, dtype=np.uint64)
            self.residues_u32 = np.empty(0, dtype=np.uint32)

    @property
    def num_residues(self) -> int:
        return len(self.valid_residues)

    def first_valid_at_or_after(self, start: int) -> tuple[int, int]:
        """Smallest valid candidate n >= start, plus its residue index.

        Raises ValueError when the table is empty (a base whose residue filter
        admits nothing, e.g. 15 — such bases provably contain no nice numbers;
        callers should use num_residues == 0 as "nothing to search").
        """
        if not self.valid_residues:
            raise ValueError(
                f"base {self.base} has no valid stride residues: no number "
                "can be nice"
            )
        r = start % self.modulus
        idx = bisect.bisect_left(self.valid_residues, r)
        if idx >= len(self.valid_residues):
            idx = 0
        target_r = self.valid_residues[idx]
        if target_r >= r:
            n = start + (target_r - r)
        else:
            n = start + (self.modulus - r + target_r)
        return (n, idx)

    def count_candidates(self, range_: FieldSize) -> int:
        """Number of valid candidates in a half-open range, via dense indices."""
        if not self.valid_residues:
            return 0
        n0, idx0 = self.first_valid_at_or_after(range_.start())
        if n0 >= range_.end():
            return 0
        g0 = (n0 // self.modulus) * len(self.valid_residues) + idx0
        n1, idx1 = self.first_valid_at_or_after(range_.end())
        g1 = (n1 // self.modulus) * len(self.valid_residues) + idx1
        return g1 - g0

    def iterate_range(self, range_: FieldSize, base: int) -> list[NiceNumberSimple]:
        """Gap-jump through valid candidates, early-exit nice check on each."""
        if not self.valid_residues:
            return []
        results: list[NiceNumberSimple] = []
        n, idx = self.first_valid_at_or_after(range_.start())
        end = range_.end()
        gap_table = self.gap_table
        num = len(gap_table)
        while n < end:
            if get_is_nice(n, base):
                results.append(NiceNumberSimple(number=n, num_uniques=base))
            n += gap_table[idx]
            idx += 1
            if idx == num:
                idx = 0
        return results


@lru_cache(maxsize=None)
def get_stride_table(base: int, k: int) -> StrideTable:
    """Shared per-(base, k) table (built once per process)."""
    return StrideTable(base, k)


@lru_cache(maxsize=None)
def stride_residue_count(base: int, k: int) -> int:
    """num_residues of the (base, k) table WITHOUT building it.

    gcd(b-1, b^k) = 1, so by CRT the count factors into
    |valid residues mod b-1| * |valid k-suffixes mod b^k|: depth planning
    scores every depth with this product and builds only the chosen table."""
    return len(residue_filter.get_residue_filter(base)) * (
        lsd_filter.valid_multi_lsd_count(base, k)
    )
