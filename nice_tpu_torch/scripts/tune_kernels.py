"""Sweep the port's kernel-shape knobs on a field and report throughput
(the port's counterpart of scripts/tune_kernels.py, kinds detailed,
niceonly, blocks and stride-blocks).

Each configuration of the detailed and niceonly kinds is passed to the
engine as explicit arguments (batch_size, segment, use_mxu, block_threads;
the niceonly kind also pins the MSD floor with adaptive_floor.reset_for_tests),
never through the environment. The slice runs once untimed at the
configuration's shape (its kernel built at first use), then REPS times
timed (5 detailed, 10 niceonly, the JAX harness's repetitions):
elapsed_secs is the mean pass, the ranking value, with min_secs and
max_secs beside it. --json prints one JSON line per configuration, with the
JAX harness's keys; ops/autotune.sweep() runs this module that way and
records the best one. A configuration that raises ends the run with a
non-zero exit code (the JAX harness keeps the configurations that
finished). A record's block_threads is the size the engine ran with
(LAST_FEED_STATS), which a winner stores; on the card, launch_threads is
what launch_shape reports for the field's launch at it (a full segment;
the dense loop's median run, which K4 and K5 may run in smaller blocks,
nice_kernels.cu dense_shape).

    python -m nice_tpu_torch.scripts.tune_kernels detailed --mode extra-large \\
        --slice 100000000 --batches 17,18,19 --segments 4,8,16 --mxu auto \\
        --sweep-threads 128,256
    python -m nice_tpu_torch.scripts.tune_kernels niceonly \\
        --field 98:413428759798923141071530212209627033363:1000000000 \\
        --slice 1000000000 --batches 18 --segments 8 --mxu auto

The niceonly kind's batch, segment, use_mxu and block size shape the dense
loop (bases above 4 u32 limbs, b98 and up); at a strided base (b10-b97) it
sweeps the floors alone.

The blocks and stride-blocks kinds time one kernel launch a block size
(--threads), as JAX's sweep_stats_blocks and sweep_stride_blocks time
block rows:

    python -m nice_tpu_torch.scripts.tune_kernels blocks --mode extra-large
    python -m nice_tpu_torch.scripts.tune_kernels blocks \\
        --field 98:413428759798923141071530212209627033363:1000000000 \\
        --block-lanes 488281 --mxu off
    python -m nice_tpu_torch.scripts.tune_kernels stride-blocks --mode extra-large

* blocks: at a base of at most 4 u32 limbs, K1 (and K5 under --mxu on or
  auto) over --block-batch (log2) lanes, or --block-lanes, from the field's
  start; at a wider base (b98 and up) K4 (and K5's dense mode) over a run of
  as many candidates, its residue classes the fused mode's, counted at
  --min-uniques.
* stride-blocks: K3 on a group of 1024 descriptors at the field's stride
  shape (engine.strided_setup: its depth, periods and table), built as
  JAX's sweep_stride_blocks builds them: row i starts at the field's start
  rounded down to the modulus plus i spans and takes [start, start + 1024
  spans), counted at --min-uniques. K3's main-path size is the module
  constant cuda_engine.STRIDED_BLOCK_THREADS, which no winner sets.

Each prints a size's milliseconds and G lanes/s (--json: one record each).
On the card the time is the kernel's device time (scripts/kernel_ab.py
device_ms) and block_threads is what launch_shape reports; with --device
cpu the plain versions run instead, timed by the wall clock, and the record
says so ("plain": true). Every size's output must equal the default size's
(DEFAULT_BLOCK_THREADS, run first), and with --plain on the card the
default size's output must equal the plain version's on the CPU: the run
exits 1 when one differs.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, engine
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

MXU_SWEEP = {"auto": [0, 1], "on": [1], "off": [0]}
# Timed passes a configuration (scripts/tune_kernels.py's reps).
REPS = {"detailed": 5, "niceonly": 10}
# Launches a block size of the blocks kinds (device_ms's mean over them),
# kernel_ab's counts at these shapes.
BLOCK_REPS = {"detailed_megaloop": 20, "detailed_megaloop_mma": 20,
              "niceonly_dense": 50, "niceonly_dense_mma": 50,
              "strided_niceonly": 10}
# The descriptors of the stride-blocks group (JAX's 1024).
STRIDE_GROUP = 1024
DEFAULT_SIZES = "32,64,128,256"


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def _field(args) -> tuple[str, int, int, int]:
    """(name, base, start, size) of the field to time."""
    if args.field:
        base, start, size = (int(x) for x in args.field.split(":"))
        return f"b{base}@{start}", base, start, size
    data = get_benchmark_field(BenchmarkMode(args.mode))
    return args.mode, data.base, data.range_start, data.range_size


def _launch_threads(kind: str, dev, base: int, batch: int, seg: int,
                    arm: int, threads: int):
    """The threads a block that launch_shape reports for the field's
    launch (None off the card)."""
    if dev.type != "cuda":
        return None
    plan = get_plan(base)
    if kind == "detailed":
        name = "detailed_megaloop_mma" if arm else "detailed_megaloop"
        return ce.launch_shape(name, plan, batch * seg,
                               block_threads=threads)["threads"]
    if plan.limbs_n <= ce.PLAN_TIER_LIMBS:
        return None  # the strided pipeline: K3 at STRIDED_BLOCK_THREADS
    run = engine.LAST_NICEONLY_STATS.get("median_run")
    if not run:
        return None  # no run survived the filter: nothing launched
    name = "niceonly_dense_mma" if arm else "niceonly_dense"
    classes = ce.niceonly_classes(plan, True, "cpu").shape[0]
    return ce.launch_shape(name, plan, classes, run[1],
                           block_threads=threads)["threads"]


def sweep_fields(args, dev) -> int:
    """The detailed and niceonly kinds: the engine on a slice of the field
    at each configuration."""
    name, base, start, size = _field(args)
    rng = FieldSize(start, start + min(args.slice, size))
    dense = get_plan(base).limbs_n > 4
    shifts = _ints(args.batches)
    segments = _ints(args.segments) or [engine.MEGALOOP_SEGMENT_DEFAULT]
    floors = _ints(args.floors) or [None]
    sizes = _ints(args.sweep_threads) or [None]
    if args.kind == "detailed" or dense:
        grid = list(itertools.product(floors, shifts, segments,
                                      MXU_SWEEP[args.mxu], sizes))
    else:
        grid = [(f, None, None, None, None) for f in floors]
    if not args.json:
        print(f"{args.kind} {name}: base {base}, {rng.size()} numbers on {dev}")
    for floor, shift, seg, arm, threads in grid:
        if args.kind == "niceonly":
            adaptive_floor.reset_for_tests(pinned=floor)
        batch = None if shift is None else 1 << shift
        if batch is not None:
            batch, seg, arm, threads = engine.resolve_tuning(
                args.kind, base, dev, batch, seg, arm, block_threads=threads)
        if args.kind == "detailed":
            process = engine.process_range_detailed
        else:
            process = engine.process_range_niceonly

        def run():
            process(rng, base, device=dev, batch_size=batch, segment=seg,
                    use_mxu=arm, block_threads=threads)
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
        ran = None
        if batch is not None:
            ran = engine.LAST_FEED_STATS.get("block_threads", threads)
        rec = {"kind": args.kind, "mode": name, "base": base,
               "backend": "device", "device": str(dev), "batch_size": batch,
               "block_rows": None, "carry_interval": None, "use_mxu": arm,
               "megaloop": seg, "block_threads": ran,
               "launch_threads": None if ran is None else _launch_threads(
                   args.kind, dev, base, batch, seg, arm, ran),
               "msd_floor": floor, "elapsed_secs": el,
               "min_secs": min(times), "max_secs": max(times),
               "reps": len(times),
               "numbers_per_sec": rng.size() / el if el > 0 else None,
               "launches": {k: (v - before[k]) // len(times)
                            for k, v in ce.LAUNCHES.items() if v != before[k]}}
        if args.json:
            print(json.dumps(rec), flush=True)
        else:
            print(f"  floor {floor} batch {batch} segment {seg} use_mxu {arm} "
                  f"block_threads {ran}: {el:8.4f}s (min {min(times):.4f}, "
                  f"max {max(times):.4f}) "
                  f"{rec['numbers_per_sec'] / 1e6:10.1f} M n/s", flush=True)
    if args.kind == "niceonly":
        adaptive_floor.reset_for_tests()
    return 0


class _Case:
    """One kernel of a blocks kind: run(threads) launches it once at a block
    size and returns its outputs, plain() the plain version's on the CPU;
    lanes is what a launch covers, extra what its records add."""

    def __init__(self, kernel: str, lanes: int, run, plain, extra=None):
        self.kernel, self.lanes, self.run, self.plain = (kernel, lanes, run,
                                                         plain)
        self.extra = extra or {}


def _blocks_cases(args, dev, base: int, start: int) -> list[_Case]:
    """K1/K5 (detailed) at a strided base, K4/K5 (dense) above it."""
    plan = get_plan(base)
    lanes = args.block_lanes or 1 << args.block_batch
    cases = []
    if plan.limbs_n <= ce.PLAN_TIER_LIMBS:
        for arm in MXU_SWEEP[args.mxu]:
            st = ve.start_limbs_tensor(start, plan, dev)
            acc = torch.zeros(plan.base + 2, dtype=torch.int32, device=dev)

            def run(threads, arm=arm, st=st, acc=acc):
                acc.zero_()
                h, nm = ce.detailed_accum_megaloop(
                    plan, lanes, 1, acc, st, lanes, use_mxu=arm,
                    block_threads=threads)
                return torch.cat([h, nm.reshape(1)])

            def plain(arm=arm):
                h, nm = ve.detailed_accum_megaloop(
                    plan, lanes, 1,
                    torch.zeros(plan.base + 2, dtype=torch.int32),
                    ve.start_limbs_tensor(start, plan, "cpu"), lanes, arm)
                return torch.cat([h, nm.reshape(1)])

            name = "detailed_megaloop_mma" if arm else "detailed_megaloop"
            cases.append(_Case(name, lanes, run, plain))
        return cases
    min_u = plan.base if args.min_uniques is None else args.min_uniques
    classes = ce.niceonly_classes(plan, True, str(dev))
    for arm in MXU_SWEEP[args.mxu]:
        st = ve.start_limbs_tensor(start, plan, dev)
        out = torch.zeros(2, dtype=torch.int32, device=dev)

        def run(threads, arm=arm, st=st, out=out):
            out.zero_()
            return ce.niceonly_dense_megaloop(
                plan, lanes, 1, classes, st, lanes, min_u, use_mxu=arm,
                out=out, block_threads=threads)

        def plain(arm=arm):
            return ve.niceonly_dense_megaloop(
                plan, lanes, 1, ce.niceonly_classes(plan, True, "cpu"),
                ve.start_limbs_tensor(start, plan, "cpu"), lanes, min_u, arm)

        name = "niceonly_dense_mma" if arm else "niceonly_dense"
        cases.append(_Case(name, lanes, run, plain))
    return cases


def stride_group(base: int, start: int, size: int):
    """(setup, int64 [1024, 12] descriptors) of the stride-blocks group:
    JAX's sweep_stride_blocks' rows at the field's stride shape."""
    s = engine.strided_setup(base, size)
    if s is None:
        raise ValueError(f"base {base}: no strided path")
    modulus = s.table.modulus
    span = s.periods * modulus
    desc = np.zeros((STRIDE_GROUP, ce.DESC_WIDTH), dtype=np.int64)
    for i in range(STRIDE_GROUP):
        n0 = (start // modulus) * modulus + i * span
        for k, x in enumerate((n0, start, start + STRIDE_GROUP * span)):
            desc[i, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
    return s, desc


def _stride_case(args, dev, base: int, start: int, size: int) -> _Case:
    s, desc = stride_group(base, start, size)
    modulus = s.table.modulus
    min_u = base if args.min_uniques is None else args.min_uniques
    res = engine._device_residues(base, s.k, str(dev))
    d = torch.from_numpy(desc).to(dev)

    def run(threads):
        return ce.strided_niceonly_batch(s.plan, modulus, res, s.periods, d,
                                         STRIDE_GROUP, min_u,
                                         block_threads=threads)

    def plain():
        return ve.niceonly_strided_counts(
            s.plan, modulus, engine._device_residues(base, s.k, "cpu"),
            s.periods, torch.from_numpy(desc), STRIDE_GROUP, min_u)

    return _Case("strided_niceonly",
                 STRIDE_GROUP * s.periods * s.table.num_residues, run, plain,
                 {"k": s.k, "periods": s.periods, "modulus": modulus,
                  "residues": s.table.num_residues})


def _shape_args(case: _Case, base: int) -> tuple:
    """launch_shape's (a, b) for one launch of the case."""
    plan = get_plan(base)
    if case.kernel == "strided_niceonly":
        return (case.lanes // STRIDE_GROUP, STRIDE_GROUP)
    if case.kernel.startswith("niceonly_dense"):
        return (ce.niceonly_classes(plan, True, "cpu").shape[0], case.lanes)
    return (case.lanes,)


def sweep_blocks(args, dev) -> int:
    """The blocks and stride-blocks kinds (see the module note)."""
    from nice_tpu_torch.scripts.kernel_ab import device_ms

    name, base, start, size = _field(args)
    if args.kind == "blocks":
        cases = _blocks_cases(args, dev, base, start)
    else:
        cases = [_stride_case(args, dev, base, start, size)]
    sizes = _ints(args.threads)
    cuda = dev.type == "cuda"
    bad = 0
    for case in cases:
        mma = int(case.kernel.endswith("_mma"))
        default = case.run(ce.DEFAULT_BLOCK_THREADS).cpu()
        equal_plain = None
        if args.plain and cuda:
            equal_plain = bool(torch.equal(default, case.plain()))
            bad += not equal_plain
        for threads in sizes:
            if not ce.block_threads_ok(threads, mma):
                continue  # K5 starts at two warps
            t0 = time.monotonic()
            got = case.run(threads)
            if cuda:
                ms = device_ms(lambda: case.run(threads),
                               BLOCK_REPS[case.kernel], case.kernel + "_kernel")
                shape = ce.launch_shape(case.kernel, get_plan(base),
                                        *_shape_args(case, base),
                                        block_threads=threads)
            else:
                ms = (time.monotonic() - t0) * 1e3
                shape = None
            equal = bool(torch.equal(got.cpu(), default))
            bad += not equal
            rec = {"kind": args.kind, "mode": name, "base": base,
                   "device": str(dev), "kernel": case.kernel,
                   "block_threads": shape["threads"] if shape else threads,
                   "requested": threads, "lanes": case.lanes, "ms": ms,
                   "g_lanes_per_s": case.lanes / ms / 1e6 if ms > 0 else None,
                   "timing": "device_ms" if cuda else "wall",
                   "plain": not cuda, "equal_to_default": equal,
                   "equal_to_plain": equal_plain, "launch": shape,
                   **case.extra}
            if args.json:
                print(json.dumps(rec), flush=True)
            else:
                print(f"  {case.kernel} b{base} block_threads "
                      f"{rec['block_threads']:3d}: {ms:9.4f} ms = "
                      f"{rec['g_lanes_per_s']:.2f} G lanes/s"
                      f"{'' if equal else '  DIFFERS from the default'}",
                      flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kind",
                   choices=["detailed", "niceonly", "blocks", "stride-blocks"])
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
    p.add_argument("--sweep-threads", default="",
                   help="block sizes to sweep a configuration (detailed, "
                        "niceonly; default: the engine's resolved size)")
    p.add_argument("--threads", default=DEFAULT_SIZES,
                   help="block sizes to time (blocks, stride-blocks)")
    p.add_argument("--block-batch", type=int, default=21,
                   help="log2 lanes of the blocks kind's launch (21: the "
                        "main path's 2^18 x 8 segment)")
    p.add_argument("--block-lanes", type=int, default=0,
                   help="lanes of the blocks kind's launch, in place of "
                        "--block-batch")
    p.add_argument("--min-uniques", type=int, default=None,
                   help="the count's threshold of K3 and K4 (default: the "
                        "base, the nice test)")
    p.add_argument("--plain", action="store_true",
                   help="on the card, also hold the default size's output "
                        "against the plain version on the CPU")
    args = p.parse_args(argv)

    dev = engine.resolve_device(args.device)
    if args.kind in ("blocks", "stride-blocks"):
        return sweep_blocks(args, dev)
    return sweep_fields(args, dev)


if __name__ == "__main__":
    sys.exit(main())
