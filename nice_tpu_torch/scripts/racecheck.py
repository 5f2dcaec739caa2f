"""racecheck of the port: drive every schedex scenario and verify its
verdict (the twin of scripts/racecheck_smoke.py).

    python -m nice_tpu_torch.scripts.racecheck [--only NAME ...] [--json P]

For each scenario in nice_tpu_torch/analysis/scenarios.py the explorer runs
the FIFO baseline, the k<=2 systematic preemption schedules (capped by
--max-schedules), and --seeds seeded random schedules.  A scenario with ``expect = "pass"`` must hold its invariant on
EVERY schedule; an ``expect = "race"`` twin must be caught on at least one
schedule within the bound — and that failing schedule is then replayed from
its id alone to prove byte-for-byte determinism.

Also emits the zero-cost line: with lockdep off and no schedex window open
no lockdep factory hook is installed, so ``lockdep.make_lock`` must hand out
plain ``threading.Lock`` objects at plain-lock speed — measured A/B against
a raw threading.Lock and reported in the JSON report.

Exits nonzero (listing the mismatches) if any verdict diverges, if a replay
is not trace-identical, or if the schedex-off path is not hook-free.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nice_tpu_torch.analysis import scenarios as scen_mod
from nice_tpu_torch.analysis import schedex
from nice_tpu_torch.utils import fsio


def run(only: list[str] | None, seeds: int, preemptions: int,
        max_schedules: int, json_path: str | None,
        verbose: bool) -> int:
    names = only or sorted(scen_mod.SCENARIOS)
    unknown = [n for n in names if n not in scen_mod.SCENARIOS]
    if unknown:
        print(f"racecheck: unknown scenarios {unknown}; "
              f"known: {sorted(scen_mod.SCENARIOS)}", file=sys.stderr)
        return 2

    problems: list[str] = []
    report: dict = {"scenarios": {}, "settings": {
        "seeds": seeds, "preemptions": preemptions,
        "max_schedules": max_schedules,
    }}

    for name in names:
        cls = scen_mod.SCENARIOS[name]
        t0 = time.perf_counter()
        rep = schedex.explore(
            cls, seeds=seeds, preemptions=preemptions,
            max_schedules=max_schedules,
            stop_on_failure=(cls.expect == "race"))
        elapsed = time.perf_counter() - t0
        entry = rep.as_dict()
        entry["expect"] = cls.expect
        entry["elapsed_s"] = round(elapsed, 3)

        caught = not rep.ok
        if cls.expect == "pass" and caught:
            first = rep.first_failing()
            problems.append(
                f"{name}: expected PASS but schedule {first.schedule_id} "
                f"broke the invariant: {first.failures}")
            entry["verdict"] = "UNEXPECTED-RACE"
            entry["failing"][0]["trace"] = [
                list(t) for t in first.trace]
        elif cls.expect == "race" and not caught:
            problems.append(
                f"{name}: expected the explorer to catch the race within "
                f"{rep.schedules_run} schedules (k<={preemptions}), but "
                f"every schedule passed")
            entry["verdict"] = "RACE-MISSED"
        else:
            entry["verdict"] = "OK"

        # Determinism: replay the first failing schedule from its id and
        # demand the identical trace.
        if caught:
            first = rep.first_failing()
            replayed = schedex.replay(cls, first.schedule_id)
            entry["replay"] = {
                "schedule": first.schedule_id,
                "trace_identical": replayed.trace == first.trace,
                "still_failing": not replayed.ok,
            }
            entry.setdefault("failing", [])
            if entry["failing"]:
                entry["failing"][0]["trace"] = [list(t) for t in first.trace]
            if replayed.trace != first.trace or replayed.ok:
                problems.append(
                    f"{name}: replay of {first.schedule_id} diverged "
                    f"(trace_identical={replayed.trace == first.trace}, "
                    f"still_failing={not replayed.ok})")
                entry["verdict"] = "REPLAY-DIVERGED"

        report["scenarios"][name] = entry
        status = entry["verdict"]
        detail = (f"caught by {rep.first_failing().schedule_id}" if caught
                  else "all schedules held")
        print(f"racecheck: {name:<38} expect={cls.expect:<5} "
              f"schedules={rep.schedules_run:<4} {status} ({detail}, "
              f"{elapsed:.2f}s)")
        if verbose and caught:
            for step, thread, point in rep.first_failing().trace:
                print(f"    [{step:3d}] {thread:<16} {point}")

    bench = schedex.zero_cost_report()
    report["bench_schedex_off"] = bench
    print(f"racecheck: schedex_off_lock_overhead: "
          f"raw={bench['raw_ns_per_op']:.0f}ns/op "
          f"minted={bench['minted_ns_per_op']:.0f}ns/op "
          f"ratio={bench['ratio']:.2f} "
          f"minted_type={bench['minted_type']} "
          f"hook_installed={bench['hook_installed']}")
    if bench["hook_installed"]:
        problems.append(
            "schedex-off path is not clean: a lockdep factory hook is "
            "installed outside any instrument() window")
    if not bench["minted_is_plain"]:
        problems.append(
            f"schedex-off make_lock minted a {bench['minted_type']}, "
            f"expected a plain threading.Lock")

    report["ok"] = not problems
    report["problems"] = problems
    if json_path:
        fsio.atomic_write_text(json_path,
                               json.dumps(report, indent=1) + "\n")
        print(f"racecheck: wrote {json_path}")

    if problems:
        print("racecheck: FAIL", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"racecheck: OK ({len(names)} scenarios)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", default=None, metavar="NAME",
                    help="run just this scenario (repeatable)")
    ap.add_argument("--seeds", type=int, default=schedex.DEFAULT_SEEDS)
    ap.add_argument("--preemptions", type=int,
                    default=schedex.DEFAULT_PREEMPTIONS)
    ap.add_argument("--max-schedules", type=int,
                    default=schedex.DEFAULT_MAX_SCHEDULES)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--verbose", action="store_true",
                    help="print the failing trace for caught races")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    args = ap.parse_args(argv)
    if args.list:
        for name, cls in sorted(scen_mod.SCENARIOS.items()):
            print(f"{name:<38} expect={cls.expect}")
        return 0
    return run(args.only, args.seeds, args.preemptions,
               args.max_schedules, args.json, args.verbose)


if __name__ == "__main__":
    sys.exit(main())
