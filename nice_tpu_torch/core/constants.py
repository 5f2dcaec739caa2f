"""Global constants (copy of nice_tpu/core/constants.py, cut to the slice)."""

# Fraction of base digits that must be unique for a number to be recorded as a
# "near miss". Kept as a float; number_stats replicates the f32 rounding.
NEAR_MISS_CUTOFF_PERCENT = 0.9

# HTTP client request timeout.
CLIENT_REQUEST_TIMEOUT_SECS = 5

# Detailed runners never get a field larger than this.
DETAILED_SEARCH_MAX_FIELD_SIZE = 1_000_000_000
