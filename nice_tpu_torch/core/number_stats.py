"""Near-miss cutoff (copy of nice_tpu/core/number_stats.py:19-22).

The cutoff replicates f32 arithmetic bit-for-bit (numpy float32): e.g.
10 * 0.9f32 rounds to exactly 9.0 while float64 gives 9.000000000000002, and
a different floor at some bases would change which numbers are recorded.
"""

from __future__ import annotations

import math

import numpy as np

from nice_tpu_torch.core.constants import NEAR_MISS_CUTOFF_PERCENT


def get_near_miss_cutoff(base: int) -> int:
    """floor(base as f32 * 0.9f32): numbers with MORE uniques than this are
    saved as near misses."""
    return int(math.floor(float(np.float32(base) * np.float32(NEAR_MISS_CUTOFF_PERCENT))))
