"""The one traffic generator: the fields a closed-loop client is handed.

Every field lies on the server's grid over its base's valid range,
[lo + k * size, lo + (k + 1) * size), for k below the count of whole fields
(the range's last, shorter field is left out, so that every field is the
same work). A mix, benchport/traffic/<mix>.json, picks the k's:

  * {"order": "uniform", "strata": S}: pass after pass over the grid, each
    pass cutting the k's into S bands of equal width and drawing one k
    uniformly in each band, the bands in a seeded order; as the server's
    Thin and Random claims pick fields, each field drawn uniformly, with the
    bands keeping every seed's mix of positions alike;
  * {"order": "sequential", "start_fields": F}: the first k drawn among the
    range's first F fields, then k + 1, k + 2, ..., as the server's Next
    claims hand them.

The same seed gives the same fields. `fields` yields (start, end) forever.
`warm_field` is the set-up's field, the configuration's `warm_index` on the
grid, whatever the seed: one that drives every path the window does (at b40
one with near misses, so that the rare path's first launch is set-up's).
"""

from __future__ import annotations

import random
from typing import Iterator

from benchport import reference


def grid(config: dict) -> tuple[int, int, int]:
    """(lo, size, count): the first number, the field size and the number of
    whole fields of the configuration's base."""
    lo, hi = reference.base_range(config["base"])
    size = int(config["field_size"])
    count = (hi - lo) // size
    if count < 1:
        raise ValueError(f"b{config['base']} holds no whole field of {size}")
    return lo, size, count


def warm_field(config: dict) -> tuple[int, int]:
    """The configuration's warm field, (start, end)."""
    lo, size, count = grid(config)
    k = int(config["warm_index"])
    if not 0 <= k < count:
        raise ValueError(f"warm_index {k} is not among b{config['base']}'s "
                         f"{count} fields")
    return lo + k * size, lo + (k + 1) * size


def _uniform(rng: random.Random, count: int, strata: int) -> Iterator[int]:
    strata = max(1, min(int(strata), count))
    bounds = [count * i // strata for i in range(strata + 1)]
    while True:
        order = list(range(strata))
        rng.shuffle(order)
        for s in order:
            yield rng.randrange(bounds[s], bounds[s + 1])


def _sequential(rng: random.Random, count: int, start_fields: int
                ) -> Iterator[int]:
    k = rng.randrange(min(int(start_fields), count))
    while True:
        yield k
        k = (k + 1) % count


def fields(config: dict, mix: dict, seed: int) -> Iterator[tuple[int, int]]:
    """The fields of `mix` over `config`'s grid, drawn from `seed`."""
    lo, size, count = grid(config)
    rng = random.Random(int(seed))
    order = mix["order"]
    if order == "uniform":
        ks = _uniform(rng, count, mix.get("strata", 1))
    elif order == "sequential":
        ks = _sequential(rng, count, mix["start_fields"])
    else:
        raise ValueError(f"unknown traffic order {order!r}")
    for k in ks:
        yield lo + k * size, lo + (k + 1) * size
