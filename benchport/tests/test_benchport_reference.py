"""The plain reference against Python ints, and the control against it."""

import random

import pytest

from benchport import manifest, opcount, reference
from benchport.run import Field

NEAR_MISS_B40 = 3621949312977  # num_uniques 37 at b40


def python_ints(base, start, end):
    cutoff = reference.near_miss_cutoff(base)
    bins = [0] * base
    near = []
    for n in range(start, end):
        u = reference.uniques_int(n, base)
        bins[u - 1] += 1
        if u > cutoff:
            near.append((n, u))
    return bins, near


def test_cutoffs_are_the_servers():
    assert [reference.near_miss_cutoff(b) for b in (10, 40, 80)] == [9, 36, 72]


def test_b10_whole_range():
    lo, hi = reference.base_range(10)
    assert (lo, hi) == (47, 100)
    bins, near = reference.field_result(10, lo, hi, batch=7)
    assert (bins, near) == python_ints(10, lo, hi)
    assert near == [(69, 10)]


@pytest.mark.parametrize("base", [40, 80])
def test_random_slices_against_python_ints(base):
    lo, hi = reference.base_range(base)
    rng = random.Random(base)
    for _ in range(3):
        start = rng.randrange(lo, hi - 2000)
        assert (reference.field_result(base, start, start + 2000, batch=300)
                == python_ints(base, start, start + 2000))


def test_b40_slice_with_a_near_miss():
    start = NEAR_MISS_B40 - 700
    bins, near = reference.field_result(40, start, start + 1500, batch=512)
    assert (bins, near) == python_ints(40, start, start + 1500)
    assert (NEAR_MISS_B40, 37) in near


def test_slices_at_the_range_edges():
    for base in (40, 80):
        lo, hi = reference.base_range(base)
        for start in (lo, hi - 900):
            assert (reference.field_result(base, start, start + 900)
                    == python_ints(base, start, start + 900))
    with pytest.raises(ValueError):
        reference.field_result(40, lo - 1, lo + 10)


@pytest.mark.parametrize("base", [10, 40, 80, 97])
def test_limb_columns_fit_int64(base):
    """e is the largest radix exponent whose product columns (at most n's
    limb count of products, plus a carry) stay under 2^62."""
    _, hi = reference.base_range(base)

    def columns(e):
        r, x, n_limbs = base**e, hi - 1, 0
        while x:
            x //= r
            n_limbs += 1
        return n_limbs * ((r - 1) ** 2 + r)

    e = reference.radix_digits(base)
    assert columns(e) < 2**62 <= columns(e + 1)


@pytest.mark.parametrize("base", [40, 80])
def test_the_control_fails_the_comparison(base):
    """The reference computed in float64 (the control), put in the
    program's place on small fields, fails the comparison."""
    detailed = manifest.load_mode("detailed")
    config = {"base": base}
    lo, hi = reference.base_range(base)
    rng = random.Random(7)
    fields = []
    for _ in range(2):
        start = rng.randrange(lo, hi - 3000)
        field = Field(start, start + 3000, 0.0, 0.0, {}, None)
        fields.append(field._replace(
            results=detailed.control(config, reference, field, "cpu")))
    got, bad = detailed.readings(config, reference, fields, [0, 1], "cpu")
    assert got["hist_gap"] > 0 and bad == 2


def test_frozen_multiply_counts():
    """The copy of generic_bound's count for detailed_megaloop_kernel, as
    it stood when the benchmark was defined (commit ec3f0c4)."""
    assert opcount.detailed_multiplies(40) == 167
    assert opcount.detailed_multiplies(80) == 649
    assert opcount.detailed_multiplies(510) == 35658
