"""The comparison that decides `correct`, the same for every mode.

The configuration's mode (benchport/modes/<mode>.py, found by manifest)
knows its answers: its LIMITS, which fields of a window its plain reference
checks in full (`pick`, from the seed and the configuration's own keys), the
readings over the window's fields (`readings`) and the control's answer to a
field (`control`). The reference is the file that the configuration's
`reference` key names. Here: the seeded draw of a sample, the readings of
the program's fields and of the control in the program's place on the same
sample.
"""

from __future__ import annotations

import random
import sys
import time


def sample(n_fields: int, k: int, seed: int) -> list[int]:
    """Indexes of k fields (all, where fewer) drawn from the seed."""
    rng = random.Random(f"benchport-check-{int(seed)}")
    return sorted(rng.sample(range(n_fields), min(k, n_fields)))


def check(cell, fields: list, seed: int, device, control: bool = False
          ) -> tuple[dict, int, int]:
    """(the readings, the count of fields read wrong, the fields checked in
    full) of the window's fields; with control, of the picked fields each
    answered by the control in the program's place."""
    import torch

    mode, config, ref = cell.mode, cell.config, cell.reference
    picked = mode.pick(config, len(fields), seed)
    t = time.perf_counter()
    with torch.no_grad():
        if control:
            fields = [fields[i]._replace(
                results=mode.control(config, ref, fields[i], device))
                for i in picked]
            picked = range(len(fields))
        readings, bad = mode.readings(config, ref, fields, picked, device)
    print(f"reference: {len(picked)} fields in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return readings, bad, len(picked)
