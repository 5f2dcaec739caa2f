"""What the program recorded of a run, for the readers of benchport/metrics/
whose source it is: its field records (nice_tpu_torch.obs.trace's
field_records) of the window's fields, and its libraries' loads
(nice_tpu_torch.ops.cuda_build's LOADS). Both are read from the modules the
run has loaded; nothing of the program is imported here.

A field is recorded when torch's profiler is recording at its entry (or a
trace sink is configured, which the harness never does): in a --trace 1
run, the traced stretch's fields and the warm field, which set-up runs
under a first profiler. The warm field's record is left out, and every
other record is matched to a field of the window by (base, start, end).
A tree whose tracing keeps no field records gives none, and its readers
return None.
"""

from __future__ import annotations

import sys
from collections import Counter

from benchport import traffic


def _program(module: str, name: str):
    """`name` of the program's loaded `module`, or None."""
    return getattr(sys.modules.get(module), name, None)


def library_seconds() -> float | None:
    """The wall seconds of the process's library builds and loads, or None
    where it counted none."""
    loads = _program("nice_tpu_torch.ops.cuda_build", "LOADS")
    if not loads or not loads["count"]:
        return None
    return loads["seconds"]


def window_records(run) -> list[dict]:
    """The records of the window's fields, in the order recorded."""
    records = _program("nice_tpu_torch.obs.trace", "field_records")
    if records is None:
        return []
    base = int(run.config["base"])
    warm = (base, *traffic.warm_field(run.config))
    want = Counter((base, f.start, f.end) for f in run.fields)
    out, warm_seen = [], False
    for r in records():
        key = (r["base"], r["range_start"], r["range_end"])
        if key == warm and not warm_seen:
            warm_seen = True  # set-up hands the warm field over first
            continue
        if want[key] > 0:
            want[key] -= 1
            out.append(r)
    return out


def seconds(record: dict, name: str) -> float:
    """The seconds a record holds under `name` (0.0 where it holds none)."""
    return record["spans"].get(name, (0.0, 0))[0]


def mean_ms(run, value, needs: tuple) -> float | None:
    """1e3 x the mean of value(record) over the window's records that hold
    every name in `needs`; None where none does."""
    rs = [r for r in window_records(run)
          if all(n in r["spans"] for n in needs)]
    if not rs:
        return None
    return 1e3 * sum(value(r) for r in rs) / len(rs)
