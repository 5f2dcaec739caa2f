"""The readings that set the comparison's limits, on the card at a cell's own
size: the program's over a dozen seeds or more (the lower readings) and the
control's over three or more (the upper ones).

    python3 -m benchport.control --workload b40.thin --seeds 12 \\
        --control-seeds 3 --seconds 3

One process sets the cell up once. For each seed it runs a short window of
the seed's traffic at the cell's own load, as a run does, and reads the
mode's numbers (compare.check) over the window's fields, with the sample of
them that a run checks in full. For each control seed it then puts the
mode's control (in detailed mode the reference with n^2 and n^3 taken in
float64) in the program's place on that sample and reads the same numbers.
One JSON line a reading; the last line sums them up as
{"program": {number: largest}, "control": {number: smallest}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchport import compare, manifest, run, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = manifest.Cell(args.workload)
    if not torch.cuda.is_available():
        print("benchport.control: needs a CUDA card", file=sys.stderr)
        return 2
    session = run.Session(cell)
    session.warm(traffic.warm_field(cell.config), False)
    worst = dict.fromkeys(cell.mode.LIMITS, 0)
    least: dict = {}
    for i in range(max(args.seeds, args.control_seeds)):
        seed = args.first_seed + i
        r = session.window(traffic.fields(cell.config, cell.mix, seed),
                           args.seconds, False, time.perf_counter())
        if i < args.seeds:
            got, bad, checked = compare.check(cell, r.fields, seed, "cuda")
            for name, v in got.items():
                worst[name] = max(worst[name], v)
            print(json.dumps({"side": "program", "seed": seed,
                              "fields": len(r.fields), "checked": checked,
                              "failed": bad, "readings": got}), flush=True)
        if i < args.control_seeds:
            got, bad, checked = compare.check(cell, r.fields, seed, "cuda",
                                              control=True)
            for name, v in got.items():
                least[name] = min(least.get(name, v), v)
            print(json.dumps({"side": "control", "seed": seed,
                              "checked": checked, "failed": bad,
                              "readings": got}), flush=True)
    print(json.dumps({"workload": args.workload, "program": worst,
                      "control": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
