"""Offline benchmark field definitions (copy of nice_tpu/core/benchmark.py)."""

from __future__ import annotations

import enum

from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import DataToClient


class BenchmarkMode(str, enum.Enum):
    BASE_TEN = "base-ten"
    DEFAULT = "default"
    LARGE = "large"
    EXTRA_LARGE = "extra-large"
    MASSIVE = "massive"
    HI_BASE = "hi-base"
    MSD_EFFECTIVE = "msd-effective"
    MSD_INEFFECTIVE = "msd-ineffective"


_BASES = {
    BenchmarkMode.BASE_TEN: 10,
    BenchmarkMode.DEFAULT: 40,
    BenchmarkMode.LARGE: 40,
    BenchmarkMode.EXTRA_LARGE: 40,
    BenchmarkMode.MASSIVE: 50,
    BenchmarkMode.HI_BASE: 80,
    BenchmarkMode.MSD_EFFECTIVE: 50,
    BenchmarkMode.MSD_INEFFECTIVE: 50,
}

_STARTS = {
    BenchmarkMode.MSD_EFFECTIVE: 26_507_984_537_059_635,
    BenchmarkMode.MSD_INEFFECTIVE: 94_760_515_586_064_977,
}

_SIZES = {
    BenchmarkMode.DEFAULT: 1_000_000,
    BenchmarkMode.LARGE: 100_000_000,
    BenchmarkMode.EXTRA_LARGE: 1_000_000_000,
    BenchmarkMode.MASSIVE: 10_000_000_000_000,
    BenchmarkMode.HI_BASE: 1_000_000_000,
    BenchmarkMode.MSD_EFFECTIVE: 1_000_000_000_000,
    BenchmarkMode.MSD_INEFFECTIVE: 10_000_000,
}


def get_benchmark_field(mode: BenchmarkMode) -> DataToClient:
    """Benchmark field as a half-open range."""
    base = _BASES[mode]
    br = base_range.get_base_range_field(base)
    assert br is not None
    range_start = _STARTS.get(mode, br.range_start)
    range_size = _SIZES.get(mode, br.size())  # BASE_TEN: whole base range
    return DataToClient(
        claim_id=0,
        base=base,
        range_start=range_start,
        range_end=range_start + range_size,
        range_size=range_size,
    )
