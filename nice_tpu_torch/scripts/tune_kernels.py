"""Sweep the port's kernel-shape knobs on a field and report throughput
(the port's counterpart of scripts/tune_kernels.py, kinds detailed and
niceonly).

Each configuration is passed to the engine as explicit arguments
(batch_size, segment, use_mxu; the niceonly kind also pins the MSD floor
with adaptive_floor.reset_for_tests), never through the environment. The
slice runs once untimed at the configuration's shape (its kernel built at
first use), then REPS times timed (5 detailed, 10 niceonly, the JAX
harness's repetitions): elapsed_secs is the mean pass, the ranking value,
with min_secs and max_secs beside it. --json prints one JSON line per
configuration, with the JAX harness's keys; ops/autotune.sweep() runs this
module that way and records the best one. A configuration that raises ends
the run with a non-zero exit code (the JAX harness keeps the
configurations that finished).

    python -m nice_tpu_torch.scripts.tune_kernels detailed --mode extra-large \\
        --slice 100000000 --batches 17,18,19 --segments 4,8,16 --mxu auto
    python -m nice_tpu_torch.scripts.tune_kernels niceonly \\
        --field 98:413428759798923141071530212209627033363:1000000000 \\
        --slice 1000000000 --batches 18 --segments 8 --mxu auto

The niceonly kind's batch, segment and use_mxu shape the dense loop (bases
above 4 u32 limbs, b98 and up); at a strided base (b10-b97) it sweeps the
floors alone. JAX's blocks and stride-blocks kinds time TPU block rows,
which no kernel of the port takes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import torch

from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, engine
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops.limbs import get_plan

MXU_SWEEP = {"auto": [0, 1], "on": [1], "off": [0]}
# Timed passes a configuration (scripts/tune_kernels.py's reps).
REPS = {"detailed": 5, "niceonly": 10}


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def _field(args) -> tuple[str, int, int, int]:
    """(name, base, start, size) of the field to time."""
    if args.field:
        base, start, size = (int(x) for x in args.field.split(":"))
        return f"b{base}@{start}", base, start, size
    data = get_benchmark_field(BenchmarkMode(args.mode))
    return args.mode, data.base, data.range_start, data.range_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind", choices=["detailed", "niceonly"])
    p.add_argument("--mode", default="extra-large",
                   help="benchmark field to time (core/benchmark.py)")
    p.add_argument("--field", default="",
                   help="BASE:START:SIZE, a field to time instead of --mode")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per configuration (autotune.sweep)")
    p.add_argument("--slice", type=int, default=100_000_000,
                   help="numbers timed, from the field's start")
    p.add_argument("--batches", default="18", help="log2 batch sizes")
    p.add_argument("--segments", default="",
                   help="megaloop segment lengths (default: the engine's)")
    p.add_argument("--mxu", default="auto", choices=sorted(MXU_SWEEP),
                   help="auto times K1/K4 and K5; on/off one of them")
    p.add_argument("--floors", default="",
                   help="MSD floors (niceonly; default: the adaptive floor)")
    args = p.parse_args(argv)

    dev = engine.resolve_device(args.device)
    name, base, start, size = _field(args)
    rng = FieldSize(start, start + min(args.slice, size))
    dense = get_plan(base).limbs_n > 4
    shifts = _ints(args.batches)
    segments = _ints(args.segments) or [engine.MEGALOOP_SEGMENT_DEFAULT]
    floors = _ints(args.floors) or [None]
    if args.kind == "detailed" or dense:
        grid = list(itertools.product(floors, shifts, segments,
                                      MXU_SWEEP[args.mxu]))
    else:
        grid = [(f, None, None, None) for f in floors]
    if not args.json:
        print(f"{args.kind} {name}: base {base}, {rng.size()} numbers on {dev}")
    for floor, shift, seg, arm in grid:
        if args.kind == "niceonly":
            adaptive_floor.reset_for_tests(pinned=floor)
        batch = None if shift is None else 1 << shift
        if batch is not None:
            batch, seg, arm = engine.resolve_tuning(args.kind, base, dev, batch,
                                                    seg, arm)
        if args.kind == "detailed":
            process = engine.process_range_detailed
        else:
            process = engine.process_range_niceonly

        def run():
            process(rng, base, device=dev, batch_size=batch, segment=seg,
                    use_mxu=arm)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run()  # the same-shape warm-up
        before = dict(ce.LAUNCHES)
        times = []
        for _ in range(REPS[args.kind]):
            t0 = time.monotonic()
            run()
            times.append(time.monotonic() - t0)
        el = sum(times) / len(times)
        rec = {"kind": args.kind, "mode": name, "base": base,
               "backend": "device", "device": str(dev), "batch_size": batch,
               "block_rows": None, "carry_interval": None, "use_mxu": arm,
               "megaloop": seg, "msd_floor": floor, "elapsed_secs": el,
               "min_secs": min(times), "max_secs": max(times),
               "reps": len(times),
               "numbers_per_sec": rng.size() / el if el > 0 else None,
               "launches": {k: (v - before[k]) // len(times)
                            for k, v in ce.LAUNCHES.items() if v != before[k]}}
        if args.json:
            print(json.dumps(rec), flush=True)
        else:
            print(f"  floor {floor} batch {batch} segment {seg} use_mxu {arm}: "
                  f"{el:8.4f}s (min {min(times):.4f}, max {max(times):.4f}) "
                  f"{rec['numbers_per_sec'] / 1e6:10.1f} M n/s", flush=True)
    if args.kind == "niceonly":
        adaptive_floor.reset_for_tests()
    return 0


if __name__ == "__main__":
    sys.exit(main())
