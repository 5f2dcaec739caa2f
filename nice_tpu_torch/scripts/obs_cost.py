"""Host cost of the observability layer on the main path: the extra-large
detailed field (1e9 @ b40) through engine.process_range_detailed on the
card, in one or more source trees, each tree in a subprocess of its own a
round, the rounds alternating the trees' order.

    python -m nice_tpu_torch.scripts.obs_cost [--reps 20] [--rounds 2]
        [--feed-depth 2] NAME=TREE[:noobs] ...

TREE is the root of a checkout (its nice_tpu_torch is imported first, so a
parent commit unpacked with `git archive` runs its own engine). `:noobs`
turns the engine's instrumentation into no-ops at run time (the launch
times and their fold into nice_pallas_dispatch_seconds, the field's series,
its spans), to tell the instrumentation's own cost from the rest of the
tree. Each subprocess makes three warm passes, then --reps timed passes,
and prints one JSON line: the median, quartiles, min and max of the pass
seconds and the host's gaps between dispatches (engine.LAST_FEED_STATS).
The card's name and power limit (nvidia-smi) come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _noobs(engine, ce) -> None:
    """The engine's instrumentation as no-ops (this process only)."""
    import contextlib
    import types

    class _Nop:
        def __getattr__(self, _name):
            return lambda *a, **k: self

    class _NoTimes(dict):
        def __missing__(self, _key):
            return _Nop()

    nop = _Nop()
    ce.DISPATCH_SECONDS = _NoTimes()
    ce.fold_dispatch_seconds = lambda: None
    for name in ("ENGINE_DISPATCHES", "MESH_FEED_IDLE",
                 "ENGINE_BATCH_KERNEL_SECONDS", "ENGINE_READBACK_BYTES",
                 "ENGINE_STATS_TRANSFERS", "ENGINE_NUMBERS"):
        setattr(engine, name, nop)
    engine.obs = types.SimpleNamespace(
        span=lambda *a, **k: contextlib.nullcontext())


def _child(tree: str, noobs: bool, reps: int, depth: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine

    if not torch.cuda.is_available():
        raise SystemExit("obs_cost: CUDA is not available")
    check = engine.__file__.startswith(tree)
    if noobs:
        _noobs(engine, ce)
    field = get_benchmark_field(BenchmarkMode.EXTRA_LARGE).to_field_size()
    secs = []
    for i in range(3 + reps):
        t0 = time.perf_counter()
        engine.process_range_detailed(field, 40, feed_depth=depth)
        torch.cuda.synchronize()
        if i >= 3:
            secs.append(time.perf_counter() - t0)
    q = statistics.quantiles(secs, n=4)
    return {"engine_from_tree": check, "median_secs": statistics.median(secs),
            "q1_secs": q[0], "q3_secs": q[2], "min_secs": min(secs),
            "max_secs": max(secs), "secs": secs,
            "idle_total_secs": engine.LAST_FEED_STATS["idle_total"],
            "dispatches": engine.LAST_FEED_STATS["dispatches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="NAME=TREE[:noobs]")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--feed-depth", type=int, default=2)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        tree, _, flag = args.child.partition(":")
        print(json.dumps(_child(tree, flag == "noobs", args.reps,
                                args.feed_depth)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    specs = [t.split("=", 1) for t in args.trees]
    for rnd in range(args.rounds):
        order = specs if rnd % 2 == 0 else specs[::-1]
        for name, tree in order:
            # The script by its path: the child imports the tree's package
            # first, not the one this process runs from.
            proc = subprocess.run(
                [sys.executable, __file__, "--child", tree, "--reps",
                 str(args.reps), "--feed-depth", str(args.feed_depth), "-"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"tree": name, "round": rnd, "card": card,
                              "feed_depth": args.feed_depth, **line}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
