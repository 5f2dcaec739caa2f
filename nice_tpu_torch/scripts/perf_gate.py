"""Regression gate of the port's client: the three legs of
scripts/perf_gate.py that measure a client, on the card.

    python -m nice_tpu_torch.scripts.perf_gate [--out REPORT.json] [--strict]
        [--device cuda|cpu] [--records-dir DIR] [--legs bench,stepprof,feed-idle]
        [--write-record FILE] [--reps N] [--bench-budget SECS]

  bench      a fresh `python -m nice_tpu_torch.scripts.bench --suite
             default:detailed,msd-ineffective:niceonly --budget 70
             --stepprof` (the reference's suite and budget) in a
             subprocess; its headline's suite is diffed case by case
             against the newest port record (TORCH_BENCH_r*.json under
             --records-dir, the repository root by default: not BENCH_r*,
             which the reference gate reads) from the same card, as
             nvidia-smi names it (a CPU run matches only a CPU record). A
             case more than REGRESSION_TOLERANCE below the record's
             numbers/sec is a problem, and so are a critpath segment whose
             share of the wall moved by more than REGRESSION_TOLERANCE
             (absolute) and peak RSS grown by more than it. With no such
             record the leg writes the reference's note and skips, unless
             --write-record asks for the fresh run to be written as one
             (the shape of BENCH_r*.json: cmd, n, parsed, rc, tail, plus
             the card stamp).
  stepprof   the device-step profiler's A/B (obs/stepprof.py, switched with
             stepprof.configure): --reps detailed runs of the first
             400,000 numbers of b30 at a batch of 1 << 12 with the
             profiler off must issue 0 fences; on, the breakdown must hold
             both modes and each key's buckets must sum to its wall within
             10 %. The niceonly arm runs at b98 (a field the MSD filter
             keeps, engine.surviving_field): the port's profiler covers the
             dense loop, and the strided pipeline of b10-b97 has none.
             Reports overhead_frac_on_vs_off.
  feed-idle  the reference's megaloop off/on gate: the port always runs
             segments, so its A/B is feed depth 0 against the default
             depth (engine.FEED_DEPTH_DEFAULT), on the bench's feed_ab
             field: extra-large (1e9 @ b40) at the engine's shape (its
             first 400,000 numbers on the CPU). The idle fraction
             (h2d_feed + host_other) / wall of the default depth, the
             median of ten profiled passes interleaved with depth 0's, may
             not exceed depth 0's by more than FEED_IDLE_MARGIN, and every
             pass must dispatch the same segments.

The reference's other legs drive or sample the server (the observatory,
SLO, resource and load legs) and stay with the JAX package. The report
goes to --out through utils/fsio, stamped with the card's name and power
limit and the NVIDIA, torch and CUDA versions (bench.device_facts). Exit
code 0 unless --strict is given and a leg found a problem.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REGRESSION_TOLERANCE = 0.25  # >25% worse than the record = a problem
# Absolute headroom on the feed-idle fraction: single-run profiles jitter
# by a few points, and the gate must not flap on that noise.
FEED_IDLE_MARGIN = 0.10
RECONCILE_FRAC = 0.10

BENCH_SUITE = "default:detailed,msd-ineffective:niceonly"
BENCH_BUDGET = 70
RECORD_GLOB = "TORCH_BENCH_r*.json"
DEFAULT_OUT = "TORCH_OBSERVATORY_r01.json"

STEPPROF_BASE = 30
STEPPROF_NUMBERS = 400_000
STEPPROF_BATCH = 1 << 12
# The feed-idle leg's numbers of the extra-large field by device type
# (run_feed_idle_gate) and its pairs of passes; a CPU run is a witness of
# the plumbing, not a profile.
FEED_IDLE_NUMBERS = {"cuda": 1_000_000_000, "cpu": STEPPROF_NUMBERS}
FEED_IDLE_PAIRS = 10
DENSE_BASE = 98
DENSE_SEED = 0
LEGS = ("bench", "stepprof", "feed-idle")


def card_name(facts: dict) -> str:
    """The card of a stamp (bench.device_facts): the nvidia-smi name
    without the power limit, or "cpu"."""
    return str(facts.get("device", "")).split(",")[0].strip()


# -- the bench leg ------------------------------------------------------------


def latest_record(records_dir: str, card: str):
    """(file name, parsed headline) of the newest TORCH_BENCH_r*.json under
    records_dir with a suite from `card`, else (None, None)."""
    for path in sorted(glob.glob(os.path.join(records_dir, RECORD_GLOB)),
                       reverse=True):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = rec.get("parsed") or {}
        stamp = rec.get("card") or parsed
        if parsed.get("suite") and card_name(stamp) == card:
            return os.path.basename(path), parsed
    return None, None


def bench_cmd(device: str, budget: int = BENCH_BUDGET,
              size: int = 0) -> list:
    """The bench's command line; size clamps every case (0: the cases' own
    fields)."""
    return [sys.executable, "-m", "nice_tpu_torch.scripts.bench",
            "--suite", BENCH_SUITE, "--budget", str(budget), "--stepprof",
            "--device", device, *(("--size", str(size)) if size else ())]


def run_bench(cmd: list, timeout: float):
    """The bench subprocess from the repository root."""
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def parse_headline(stdout: str):
    """The last line of the bench's output that is a dict with a suite."""
    for line in reversed(stdout.splitlines()):
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        if isinstance(parsed, dict) and "suite" in parsed:
            return parsed
    return None


def write_record(path: str, cmd: list, proc, headline: dict,
                 facts: dict) -> None:
    """The fresh run as a record in the shape of BENCH_r*.json, with the
    card stamp."""
    from nice_tpu_torch.utils import fsio

    m = re.search(r"_r(\d+)\.json$", path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fsio.atomic_write_json(path, {
        "n": int(m.group(1)) if m else None,
        "cmd": " ".join(["python"] + cmd[1:]),
        "rc": proc.returncode,
        "note": "written by nice_tpu_torch/scripts/perf_gate.py --write-record",
        "tail": proc.stdout[-3000:],
        "parsed": headline,
        "card": facts,
    }, indent=1, sort_keys=True)


def run_bench_gate(report: dict, problems: list, *, device: str,
                   records_dir: str = REPO, budget: int = BENCH_BUDGET,
                   record_path: str | None = None, runner=None) -> None:
    """The bench leg (module doc). runner(cmd, timeout) runs the bench and
    returns its CompletedProcess (run_bench when None)."""
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.scripts import bench

    facts = bench.device_facts(engine.resolve_device(device))
    card = card_name(facts)
    baseline_name, baseline = latest_record(records_dir, card)
    gate = report["regression"]["bench"] = {"card": card,
                                            "baseline": baseline_name}
    if baseline is None:
        gate["note"] = (f"no committed {RECORD_GLOB} record from card "
                        f"{card!r}; throughput diff skipped")
        if record_path is None:
            return
    cmd = bench_cmd(device, budget)
    gate["cmd"] = " ".join(["python"] + cmd[1:])
    proc = (runner or run_bench)(cmd, budget * 4)
    headline = parse_headline(proc.stdout)
    if proc.returncode != 0 or headline is None:
        problems.append(f"gate bench run failed (rc={proc.returncode}); "
                        f"tail: {proc.stdout[-300:]!r} {proc.stderr[-300:]!r}")
        gate["error"] = f"rc={proc.returncode}"
        return
    if record_path is not None:
        write_record(record_path, cmd, proc, headline, facts)
        gate["record_written"] = record_path
    if baseline is not None:
        bench_diff(gate, problems, baseline, headline)


def bench_diff(gate: dict, problems: list, baseline: dict,
               headline: dict) -> None:
    """Case by case throughput, then the critpath shift and peak RSS."""
    suite = headline["suite"]
    baseline_suite = baseline.get("suite") or {}
    gate["fresh_suite"] = suite
    gate["cases"] = {}
    for case, new in suite.items():
        old = baseline_suite.get(case)
        if not old or old.get("skipped") or new.get("skipped"):
            continue
        old_v, new_v = float(old["value"]), float(new["value"])
        drop = (old_v - new_v) / old_v if old_v else 0.0
        regressed = drop > REGRESSION_TOLERANCE
        gate["cases"][case] = {"baseline": old_v, "current": new_v,
                               "drop_frac": drop, "regressed": regressed}
        if regressed:
            problems.append(
                f"bench {case}: {new_v:.0f} vs baseline {old_v:.0f} "
                f"numbers/sec/chip ({drop:.0%} drop > "
                f"{REGRESSION_TOLERANCE:.0%})")
    critpath_diff(gate, problems, baseline, headline)
    mem_diff(gate, problems, baseline, headline)


def mem_diff(gate: dict, problems: list, baseline: dict,
             headline: dict) -> None:
    """Diff the bench suite's peak-RSS watermark between rounds: throughput
    can hold steady while the run quietly doubles its resident set."""
    block = gate["peak_mem"] = {}
    new_mem = headline.get("peak_mem")
    if not new_mem:
        block["note"] = "fresh run carried no peak_mem block; diff skipped"
        return
    block["current"] = new_mem
    old_mem = baseline.get("peak_mem")
    if not old_mem or not old_mem.get("peak_rss_bytes"):
        block["note"] = ("baseline round predates peak_mem accounting; "
                         "memory diff starts with the next committed record")
        return
    block["baseline"] = old_mem
    old_peak = float(old_mem["peak_rss_bytes"])
    new_peak = float(new_mem.get("peak_rss_bytes") or 0)
    growth = (new_peak - old_peak) / old_peak if old_peak else 0.0
    block["growth_frac"] = growth
    block["regressed"] = growth > REGRESSION_TOLERANCE
    if block["regressed"]:
        problems.append(
            f"bench peak RSS {new_peak / 1e6:.0f}MB vs baseline "
            f"{old_peak / 1e6:.0f}MB ({growth:.0%} growth > "
            f"{REGRESSION_TOLERANCE:.0%})")


def critpath_diff(gate: dict, problems: list, baseline: dict,
                  headline: dict) -> None:
    """Diff the bench critpath segment shares between rounds: a segment
    whose share of wall moved by more than REGRESSION_TOLERANCE (absolute)
    means the workload's bottleneck shifted, which the throughput alone can
    hide (compute got faster while feed stalls grew to fill the gap)."""
    block = gate["critpath"] = {}
    new_cp = headline.get("critpath")
    if not new_cp:
        block["note"] = ("fresh run produced no critpath summary (profiler "
                         "recorded no wall); shift diff skipped")
        return
    block["current"] = new_cp
    old_cp = baseline.get("critpath")
    if not old_cp:
        block["note"] = ("baseline round has no critpath block; shift diff "
                         "starts with the next committed record")
        return
    block["baseline"] = old_cp
    old_shares = old_cp.get("shares") or {}
    new_shares = new_cp.get("shares") or {}
    shifts = {}
    for seg in sorted(set(old_shares) | set(new_shares)):
        a = float(old_shares.get(seg, 0.0))
        b = float(new_shares.get(seg, 0.0))
        if abs(b - a) > REGRESSION_TOLERANCE:
            shifts[seg] = {"baseline": a, "current": b}
    block["shifted_segments"] = shifts
    block["dominant"] = {
        "baseline": old_cp.get("dominant"),
        "current": new_cp.get("dominant"),
        "changed": old_cp.get("dominant") != new_cp.get("dominant"),
    }
    for seg, move in shifts.items():
        problems.append(
            f"critpath segment {seg} share moved "
            f"{move['baseline']:.0%} -> {move['current']:.0%} "
            f"(> {REGRESSION_TOLERANCE:.0%} shift vs baseline)")


# -- the engine legs ------------------------------------------------------------


def _detailed_field(numbers: int):
    from nice_tpu_torch.core.base_range import get_base_range
    from nice_tpu_torch.core.types import FieldSize

    start, _ = get_base_range(STEPPROF_BASE)
    return FieldSize(start, start + numbers)


def _timed_detailed(field, dev, base: int = STEPPROF_BASE,
                    **kw) -> float:
    """Seconds of one detailed pass (the stepprof leg's batch unless kw
    names one)."""
    import torch

    from nice_tpu_torch.ops import engine

    kw.setdefault("batch_size", STEPPROF_BATCH)
    t0 = time.monotonic()
    engine.process_range_detailed(field, base, device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.monotonic() - t0


def run_stepprof(report: dict, problems: list, *, device: str, reps: int,
                 numbers: int = STEPPROF_NUMBERS) -> None:
    """The profiler A/B (module doc)."""
    from nice_tpu_torch.obs import stepprof
    from nice_tpu_torch.ops import engine

    dev = engine.resolve_device(device)
    field = _detailed_field(numbers)
    out = report["stepprof"]
    was = stepprof.enabled()
    try:
        # Builds and a first pass before either arm, so that both compare
        # steady-state walls; the dense field is found with the profiler off.
        stepprof.configure(False)
        engine.warm_detailed(STEPPROF_BASE, device=dev)
        _timed_detailed(field, dev)
        dense = engine.surviving_field(DENSE_BASE, numbers, DENSE_SEED,
                                       device=dev)
        out["dense_field"] = [str(dense.start()), str(dense.end())]

        stepprof.reset()
        off = [_timed_detailed(field, dev) for _ in range(reps)]
        out["profiler_off"] = {"walls_secs": off,
                               "mean_secs": statistics.mean(off),
                               "fences": stepprof.fence_count(),
                               "cumulative_keys": sorted(stepprof.cumulative())}
        if stepprof.fence_count() != 0:
            problems.append(f"the profiler off still issued "
                            f"{stepprof.fence_count()} fences")

        stepprof.reset()  # which also turns the profiler off
        stepprof.configure(True)
        on = [_timed_detailed(field, dev) for _ in range(reps)]
        engine.process_range_niceonly(dense, DENSE_BASE, device=dev,
                                      batch_size=STEPPROF_BATCH)
        cum = stepprof.cumulative()
        out["profiler_on"] = {"walls_secs": on, "mean_secs": statistics.mean(on),
                              "fences": stepprof.fence_count(),
                              "phase_breakdown": cum}
    finally:
        stepprof.configure(was)

    modes = {k.split("|", 1)[0] for k in cum}
    if not {"detailed", "niceonly"} <= modes:
        problems.append(f"phase breakdown missing a mode: {sorted(modes)}")
    rec = out["reconciliation"] = {}
    for key, entry in cum.items():
        bucket_sum = sum(entry[p] for p in stepprof.PHASES)
        ok = abs(bucket_sum - entry["wall"]) <= RECONCILE_FRAC * entry["wall"]
        rec[key] = {"bucket_sum_secs": bucket_sum, "wall_secs": entry["wall"],
                    "within_10pct": ok}
        if not ok:
            problems.append(f"stepprof buckets for {key} sum to "
                            f"{bucket_sum:.3f}s vs wall {entry['wall']:.3f}s "
                            "(>10% apart)")
    off_mean, on_mean = statistics.mean(off), statistics.mean(on)
    out["overhead_frac_on_vs_off"] = ((on_mean - off_mean) / off_mean
                                      if off_mean else 0.0)


def run_feed_idle_gate(report: dict, problems: list, *, device: str,
                       pairs: int = FEED_IDLE_PAIRS,
                       numbers: int | None = None) -> None:
    """Feed-idle gate: the reference profiles a field with the megaloop
    pinned off and on and fails when the loop's host share (h2d_feed +
    host_other over the wall) grew by more than the noise margin, or when
    its dispatches did not collapse. The port always runs segments, so its
    A/B is the feed thread: depth 0 (each block of starts made inline)
    against the default depth. Both depths dispatch the same segments of
    the same plan, so there is no collapse to check; the leg checks instead
    that every pass of both dispatched the same count, which a feed that
    dropped or repeated an item would break.

    After a warm pass of each, `pairs` pairs of profiled passes, the order
    alternating, each depth's fraction the median of its passes, on the
    bench's feed_ab field: the first FEED_IDLE_NUMBERS[device type] numbers
    of extra-large (b40) at the engine's shape, the main path's. Under the
    profiler's fences the feed thread overlaps nothing and only adds
    hand-offs, so the default depth reads a few points above depth 0, and
    the more the host's share of the wall: on the reference's field (the
    stepprof leg's 400,000 numbers at a batch of 1 << 12, 2-3 ms a pass on
    the card) three summed passes once read 0.14 above it, and 2^24 of its
    numbers 0.04-0.08 in the medians of ten pairs."""
    import statistics

    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.obs import stepprof
    from nice_tpu_torch.obs.series import ENGINE_DISPATCHES
    from nice_tpu_torch.ops import engine

    dev = engine.resolve_device(device)
    data = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    field = FieldSize(data.range_start, data.range_start + min(
        data.range_size, numbers or FEED_IDLE_NUMBERS[dev.type]))
    depths = {"depth_0": 0, "default": engine.FEED_DEPTH_DEFAULT}
    passes: dict = {arm: [] for arm in depths}
    was = stepprof.enabled()
    try:
        for depth in depths.values():
            _timed_detailed(field, dev, data.base, batch_size=None,
                            feed_depth=depth)
        for i in range(pairs):
            for arm in (list(depths) if i % 2 == 0 else list(depths)[::-1]):
                stepprof.reset()  # which also turns the profiler off
                stepprof.configure(True)
                d0 = ENGINE_DISPATCHES.value(("detailed",))
                _timed_detailed(field, dev, data.base, batch_size=None,
                                feed_depth=depths[arm])
                entry = next(v for k, v in stepprof.cumulative().items()
                             if k.startswith("detailed|"))
                passes[arm].append({
                    "wall": entry["wall"],
                    "idle": entry["h2d_feed"] + entry["host_other"],
                    "dispatches": int(ENGINE_DISPATCHES.value(("detailed",))
                                      - d0)})
    finally:
        stepprof.reset()
        stepprof.configure(was)
    arms = {}
    for arm, runs in passes.items():
        arms[arm] = {
            "feed_depth": depths[arm],
            "numbers": field.size(),
            "passes": len(runs),
            "idle_frac": statistics.median(r["idle"] / r["wall"]
                                           for r in runs),
            "idle_fracs": [r["idle"] / r["wall"] for r in runs],
            "wall_secs": statistics.median(r["wall"] for r in runs),
            "dispatches": runs[0]["dispatches"],
        }
    report["stepprof"]["feed_idle"] = arms
    drift = arms["default"]["idle_frac"] - arms["depth_0"]["idle_frac"]
    if drift > FEED_IDLE_MARGIN:
        problems.append(
            f"feed-idle regression: idle frac "
            f"{arms['default']['idle_frac']:.2f} at the default depth vs "
            f"{arms['depth_0']['idle_frac']:.2f} at depth 0 "
            f"(> +{FEED_IDLE_MARGIN:.2f} margin)")
    counts = {r["dispatches"] for runs in passes.values() for r in runs}
    if len(counts) != 1:
        problems.append(f"the feed depths dispatched {sorted(counts)} "
                        "segments of one plan")


# -- the gate ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nice-tpu-torch-perf-gate",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=DEFAULT_OUT, help="the report's path")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any gate problem (default: warn only)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--records-dir", default=REPO,
                   help=f"where the {RECORD_GLOB} records are")
    p.add_argument("--legs", default=",".join(LEGS),
                   help=f"comma-separated subset of {','.join(LEGS)}")
    p.add_argument("--write-record", default=None, metavar="FILE",
                   help="write the fresh bench run as a record here")
    p.add_argument("--reps", type=int, default=3,
                   help="detailed runs per profiler state")
    p.add_argument("--bench-budget", type=int, default=BENCH_BUDGET,
                   help="wall budget (s) of the fresh bench run")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    legs = [leg.strip() for leg in args.legs.split(",") if leg.strip()]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        raise SystemExit(f"unknown legs {unknown} (of {', '.join(LEGS)})")
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.scripts import bench
    from nice_tpu_torch.utils import fsio

    report: dict = {
        "run": "perf-gate",
        "generated_ts": time.time(),
        "card": bench.device_facts(engine.resolve_device(args.device)),
        "legs": {},
        "stepprof": {},
        "regression": {},
    }
    runs = {
        "bench": lambda probs: run_bench_gate(
            report, probs, device=args.device, records_dir=args.records_dir,
            budget=args.bench_budget, record_path=args.write_record),
        "stepprof": lambda probs: run_stepprof(
            report, probs, device=args.device, reps=args.reps),
        "feed-idle": lambda probs: run_feed_idle_gate(
            report, probs, device=args.device),
    }
    problems: list = []
    for leg in LEGS:
        if leg not in legs:
            continue
        print(f"== {leg} ==", flush=True)
        t0 = time.monotonic()
        probs: list = []
        entry = report["legs"][leg] = {}
        try:
            runs[leg](probs)
        except Exception as exc:  # noqa: BLE001 — reported in the report
            entry["error"] = repr(exc)
            entry["traceback"] = traceback.format_exc()
            probs.append(f"{leg} leg raised {exc!r}")
        entry["problems"] = probs
        entry["secs"] = time.monotonic() - t0
        problems += probs
    report["problems"] = problems
    report["ok"] = not problems
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fsio.atomic_write_json(args.out, report, indent=1, sort_keys=True)
    print(f"wrote {args.out}")
    for prob in problems:
        print(f"WARN: {prob}")
    if problems and args.strict:
        return 1
    if problems:
        print(f"{len(problems)} problem(s); warn-only (pass --strict to fail)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
