"""Detailed mode: a field answers with the histogram of num_uniques over
1..base and its near misses, checked against the plain reference that the
configuration's `reference` key names (benchport/reference.py).

The mode contract (manifest.MODE_CONTRACT), as run.py, compare.py and
control.py call it:

  * warm(session, config, field): build or load what a field of the
    configuration needs, before the set-up's warm field runs;
  * stats(session): a reader called right after each field of a window
    returns; what it returns is kept as that field's `stats`;
  * LIMITS, pick(config, n_fields, seed) and readings(config, reference,
    fields, picked, device): the comparison, over the window's fields
    (run.Field: start, end, stats, results), the picked ones in full;
  * control(config, reference, field, device): the control's answer to a
    field, put in the program's place by benchport.control.

Every completed field, on the host with Python ints:
  * bins_sum_gap: |sum of its bins - its size|, summed over the fields;
  * near_miss_wrong: its near misses that lie outside the field, repeat,
    are out of order, are not above the cutoff, or whose num_uniques
    disagrees with Python ints' (reference.uniques_int);
  * near_miss_bin_gap: for each bin above the cutoff, |its count - the near
    misses listed with that num_uniques|.
The first and the last two are what the server checks of a submission.
The configuration's `check_fields` fields, drawn from the seed, in full by
the reference:
  * hist_gap: sum over the bins of |program - reference|;
  * near_miss_gap: near misses in one list and not in the other.
Every limit is 0: the answers are exact, so any gap is a wrong answer.
The control is the reference with n^2 and n^3 taken in float64.
"""

from __future__ import annotations

from typing import NamedTuple

from benchport import compare

LIMITS = {"bins_sum_gap": 0, "near_miss_wrong": 0, "near_miss_bin_gap": 0,
          "hist_gap": 0, "near_miss_gap": 0}


def warm(session, config: dict, field) -> None:
    """The libraries a detailed field of the base launches."""
    session.engine.warm_detailed(int(config["base"]),
                                 device=session.args.device)


def stats(session):
    """The feed loop's idle seconds of the field (feed_idle_s)."""
    engine = session.engine
    return lambda: {"feed_idle_s":
                    engine.LAST_FEED_STATS.get("idle_total", 0.0)}


class Bin(NamedTuple):
    num_uniques: int
    count: int


class Near(NamedTuple):
    number: int
    num_uniques: int


class Answer(NamedTuple):
    """A field's answer in the shape of the program's FieldResults."""
    distribution: tuple
    nice_numbers: tuple


def answer(bins: list[int], near: list[tuple[int, int]]) -> Answer:
    """An Answer from a histogram over 1..base and (n, uniques) pairs."""
    return Answer(tuple(Bin(u, c) for u, c in enumerate(bins, 1)),
                  tuple(Near(n, u) for n, u in near))


def pick(config: dict, n_fields: int, seed: int) -> list[int]:
    return compare.sample(n_fields, int(config["check_fields"]), seed)


def _bins(results, base: int) -> tuple[list[int], int]:
    """(counts of num_uniques 1..base, the count put in any other bin)."""
    counts: dict = {}
    for d in results.distribution:
        counts[d.num_uniques] = counts.get(d.num_uniques, 0) + d.count
    bins = [counts.pop(u, 0) for u in range(1, base + 1)]
    return bins, sum(abs(c) for c in counts.values())


def _near(results) -> list[tuple[int, int]]:
    return [(n.number, n.num_uniques) for n in results.nice_numbers]


def field_readings(reference, base: int, start: int, end: int, results
                   ) -> dict:
    """bins_sum_gap, near_miss_wrong and near_miss_bin_gap of one field's
    answer."""
    cutoff = reference.near_miss_cutoff(base)
    bins, stray = _bins(results, base)
    wrong, prev = 0, None
    listed = [0] * (base + 1)
    for n, u in _near(results):
        if (not start <= n < end or (prev is not None and n <= prev)
                or u <= cutoff or reference.uniques_int(n, base) != u):
            wrong += 1
        if cutoff < u <= base:
            listed[u] += 1
        prev = n
    bin_gap = sum(abs(bins[u - 1] - listed[u])
                  for u in range(cutoff + 1, base + 1))
    return {"bins_sum_gap": abs(sum(bins) - (end - start)) + stray,
            "near_miss_wrong": wrong, "near_miss_bin_gap": bin_gap}


def reference_readings(reference, base: int, start: int, end: int, results,
                       device) -> dict:
    """hist_gap and near_miss_gap of one field's answer against the
    reference's."""
    ref_bins, ref_near = reference.field_result(base, start, end, device)
    bins, stray = _bins(results, base)
    gap = stray + sum(abs(a - b) for a, b in zip(bins, ref_bins))
    near = set(_near(results))
    return {"hist_gap": gap, "near_miss_gap": len(near ^ set(ref_near))}


def readings(config: dict, reference, fields, picked, device
             ) -> tuple[dict, int]:
    """(the readings summed over the fields, how many fields read wrong)."""
    base = int(config["base"])
    total = dict.fromkeys(LIMITS, 0)
    bad = 0
    picked = set(picked)
    for i, f in enumerate(fields):
        r = field_readings(reference, base, f.start, f.end, f.results)
        if i in picked:
            r.update(reference_readings(reference, base, f.start, f.end,
                                        f.results, device))
        for k, v in r.items():
            total[k] += v
        bad += any(r.values())
    return total, bad


def control(config: dict, reference, field, device) -> Answer:
    bins, near = reference.field_result(int(config["base"]), field.start,
                                        field.end, device,
                                        arithmetic="float64")
    return answer(bins, near)
