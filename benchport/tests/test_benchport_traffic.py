"""The traffic generator: fields on the server's grid over the base's range,
the same fields from the same seed, and the two orders."""

import bisect
import itertools

import pytest

from benchport import manifest, reference, traffic

B40 = {"base": 40, "field_size": 10**9, "warm_index": 1705}
THIN = {"order": "uniform", "strata": 256}
NEXT = {"order": "sequential", "start_fields": 64}


def take(config, mix, seed, n):
    return list(itertools.islice(traffic.fields(config, mix, seed), n))


def test_grid_counts_whole_fields_of_the_range():
    lo, hi = reference.base_range(40)
    assert traffic.grid(B40) == (lo, 10**9, 4637)
    # The server's grid ends with a shorter field, which is left out.
    assert -(-(hi - lo) // 10**9) == 4638
    lo80, size, count = traffic.grid({"base": 80, "field_size": 10**9})
    assert count == 2161504212685761056912


@pytest.mark.parametrize("mix", [THIN, NEXT])
@pytest.mark.parametrize("base", [40, 80])
def test_fields_lie_on_the_grid_inside_the_range(mix, base):
    config = {"base": base, "field_size": 10**9}
    lo, hi = reference.base_range(base)
    for start, end in take(config, mix, 2**31 + 11, 600):
        assert (start - lo) % 10**9 == 0
        assert end - start == 10**9
        assert lo <= start and end <= hi


@pytest.mark.parametrize("mix", [THIN, NEXT])
def test_same_seed_same_fields(mix):
    seed = 3_000_000_017
    assert take(B40, mix, seed, 300) == take(B40, mix, seed, 300)
    assert take(B40, mix, seed, 300) != take(B40, mix, seed + 1, 300)


def test_thin_draws_one_field_a_band_in_each_pass():
    lo, size, count = traffic.grid(B40)
    ks = [(s - lo) // size for s, _ in take(B40, THIN, 99, 512)]
    bounds = [count * i // 256 for i in range(257)]
    for p in (ks[:256], ks[256:]):
        bands = sorted(bisect.bisect_right(bounds, k) - 1 for k in p)
        assert bands == list(range(256))
    assert len(set(ks)) > 400


def test_next_runs_in_order_from_the_range_start():
    lo, size, _ = traffic.grid(B40)
    for seed in range(20):
        ks = [(s - lo) // size for s, _ in take(B40, NEXT, seed, 50)]
        assert ks[0] < 64
        assert ks == list(range(ks[0], ks[0] + 50))


def test_warm_field_is_the_configured_index_whatever_the_seed():
    lo, size, _ = traffic.grid(B40)
    assert traffic.warm_field(B40) == (lo + 1705 * size, lo + 1706 * size)
    # The near miss the rare path is warmed by lies in it.
    start, end = traffic.warm_field(B40)
    assert start <= 3621949312977 < end
    with pytest.raises(ValueError):
        traffic.warm_field(dict(B40, warm_index=4637))


def test_unknown_order_raises():
    with pytest.raises(ValueError):
        next(traffic.fields(B40, {"order": "zigzag"}, 1))


@pytest.mark.parametrize("name", ["thin", "next"])
def test_committed_mixes_generate(name):
    cell_mix = manifest._read_json(
        f"{manifest.HERE}/traffic/{name}.json")
    assert len(take(B40, cell_mix, 5, 10)) == 10
