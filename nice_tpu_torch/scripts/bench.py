"""The repository's benchmark suite on the card: one JSON line per case, the
headline (detailed extra-large: 1e9 @ b40, one server field) printed first
and again last with the whole suite embedded (the twin of bench.py).

    python -m nice_tpu_torch.scripts.bench [--only MODE] [--suite M:K,...]
        [--size N] [--batch N] [--budget SECS] [--reps N] [--device cuda|cpu]
        [--stepprof]

Each case builds and loads its libraries (engine.warm_detailed /
warm_niceonly, `build_secs`), times a first field (`first_field_secs`: the
first pass of that shape in the process), runs a warm pass (`warm_secs`)
and then --reps timed passes: `value` is the field size over the median
pass, `elapsed_secs` the median, with `min_secs` and `max_secs` beside it.
Every pass must give the same results. Beside the timing a line carries
the kernels' launches per field (cuda_engine.LAUNCHES, the last pass), the
feed stats of the detailed and dense loops (engine.LAST_FEED_STATS), the
niceonly pipeline's split (engine.LAST_NICEONLY_STATS: MSD busy seconds,
descriptors, groups) and its `route` ("host" where the engine's default
host_niceonly_max sends the field to the host library, else "device"),
the distribution (detailed) and the nice numbers or near misses, and the
case's memory axis (`peak_mem`: the process's peak RSS at the case's end,
the RSS the case added and the card's peak allocated bytes, from
obs/memwatch.py). With --stepprof every pass runs under the device-step
profiler and the line carries the case's `phase_breakdown` (phase seconds
by mode|base|backend over all its passes, obs/stepprof.py) and its
`critpath` (obs/critpath.py phase_shares: each critical-path segment's share
of the wall and the dominant one); the final headline carries the whole
run's `phase_breakdown` and `critpath` in place of its case's, which is
what scripts/perf_gate.py diffs against a committed record. Detailed
extra-large also times feed depth 0 against the default (`feed_ab`);
detailed hi-base times K1 against K5 on one slice (`mxu_ab`). Every line names the card as nvidia-smi gives it (name, power
limit) and the torch, CUDA and driver versions; a run with --device cpu
runs the kernels' plain versions and is marked "witness": "cpu": a
correctness witness, not a speed. Without a card and without --device cpu
it raises before any case.

The wall budget (--budget, from the start of the process) skips a case
whose estimate exceeds what is left with a {"skipped": "budget"} line; each
case runs in a worker thread under a cap that keeps the later cases' share;
a case past its cap and a grace is recorded as an error and the remaining
cases are skipped ("timeout-wedge"). The exit code is 1 when a case failed.

The multi-tenant case (bench.py's _run_multi_tenant) times the scheduler
(sched/): a detailed and a niceonly tenant on two 2^20-number slices of
extra-large (clamped by --size), built and run once first, then --reps
rounds of the two run back to back through the engine (`sequential_secs`,
the median) and interleaved page by page under the deficit policy with a
preemption at every page boundary (`elapsed_secs`, the median);
`vs_sequential` is the first over the second, `results_equal` whether
every pass gave the first pass's fields; `pages`, `preemptions` and
`launches` (the last interleaved pass) are by tenant, and so are the
medians over the passes of each page's busy seconds (`busy_secs`) and of
each sequential call's (`sequential_by_tenant`), beside the median of
what an interleaved pass spent outside its pages (`outside_pages_secs`).
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import threading
import time

import torch

from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.obs import critpath, memwatch, stepprof
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops.limbs import get_plan
from nice_tpu_torch.utils import resources

DEFAULT_BUDGET = 480.0
DEFAULT_REPS = 5
UNIT = "numbers/sec/chip"

# The suite of bench.py, in its order: the headline first (its line exists
# from the first seconds), the cheap cases next, massive last.
DEFAULT_SUITE = (
    ("extra-large", "detailed"),
    ("msd-effective", "niceonly"),
    ("msd-ineffective", "niceonly"),
    ("extra-large", "niceonly"),
    ("hi-base", "detailed"),
    ("multi-tenant", "detailed"),
    ("massive", "niceonly"),
)
HEADLINE = ("extra-large", "detailed")
_MODE_KIND = {"massive": "niceonly", "msd-effective": "niceonly",
              "msd-ineffective": "niceonly"}

# Conservative wall estimates of a case on the card, a first nvcc build of
# the base's library included (6-14 s a base); used only for the
# skip-or-run decision.
_EST_SECS = {
    ("extra-large", "detailed"): 40.0,
    ("msd-effective", "niceonly"): 20.0,
    ("msd-ineffective", "niceonly"): 20.0,
    ("extra-large", "niceonly"): 10.0,
    ("hi-base", "detailed"): 40.0,
    ("multi-tenant", "detailed"): 10.0,
    ("massive", "niceonly"): 120.0,
}
_EST_DEFAULT = 60.0
# Hard per-case caps (the worker's join timeout) and the grace after one.
_CAP_SECS = {("massive", "niceonly"): 330.0}
_CAP_DEFAULT = 150.0
_CASE_GRACE_SECS = 15.0

# K1 against K5 on the first numbers of the hi-base field.
MXU_AB_SLICE = 1 << 26

# The keys of a case the final headline's "suite" carries.
_SUITE_KEYS = ("value", "elapsed_secs", "min_secs", "max_secs",
               "first_field_secs", "build_secs", "error", "hits", "skipped",
               "case_elapsed_secs", "case_budget_secs", "over_budget")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def device_facts(dev: torch.device) -> dict:
    """The device keys every line carries."""
    facts = {"torch": torch.__version__, "n_chips": 1}
    if dev.type == "cpu":
        return {"device": "cpu", "witness": "cpu", **facts}
    return {"device": nvidia_smi("name,power.limit"),
            "cuda": torch.version.cuda,
            "driver": nvidia_smi("driver_version"), **facts}


def _pairs(results) -> tuple:
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _stats(times: list[float]) -> dict:
    s = sorted(times)
    n = len(s)
    median = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    return {"median_secs": median, "min_secs": s[0], "max_secs": s[-1],
            "secs": times}


def _stepprof_delta(before: dict, after: dict) -> dict:
    """Per-(mode|base|backend) phase-seconds delta between two snapshots of
    stepprof.cumulative() (the keys with fields in the window)."""
    out = {}
    for key, cur in after.items():
        prev = before.get(key, {})
        fields = int(cur.get("fields", 0)) - int(prev.get("fields", 0))
        if not fields:
            continue
        d = {k: round(float(v) - float(prev.get(k, 0.0)), 6)
             for k, v in cur.items() if k != "fields"}
        d["fields"] = fields
        out[key] = d
    return out


def _mem_snapshot() -> dict:
    """Host RSS and peak RSS, and the largest per-device peak of allocated
    bytes once CUDA is initialized: the memory axis of a line."""
    out = {"rss_bytes": resources.rss_bytes() or 0,
           "peak_rss_bytes": resources.peak_rss_bytes() or 0}
    peaks = [e["peak"] for e in memwatch.device_memory()["devices"].values()]
    if peaks:
        out["device_peak_bytes"] = max(peaks)
    return out


def _mem_delta(before: dict, after: dict) -> dict:
    """A window's memory: the peaks reached by its end and the resident set
    the window itself added."""
    out = {"peak_rss_bytes": after["peak_rss_bytes"],
           "rss_delta_bytes": after["rss_bytes"] - before["rss_bytes"]}
    if "device_peak_bytes" in after:
        out["device_peak_bytes"] = after["device_peak_bytes"]
    return out


def _launches(before: dict) -> dict:
    return {k: v - before[k] for k, v in ce.LAUNCHES.items() if v != before[k]}


def _plain(d: dict) -> dict:
    """A stats dict as JSON (numpy scalars to numbers; the descriptor
    columns of a first group left out)."""
    out = {}
    for k, v in d.items():
        if k == "first_group":
            continue
        out[k] = v.item() if hasattr(v, "item") else v
    return out


class _Field:
    """One case's field and how to run it."""

    def __init__(self, base: int, kind: str, range_: FieldSize,
                 dev: torch.device, shape: dict):
        self.base, self.kind, self.range = base, kind, range_
        self.size = range_.size()
        self.dev, self.shape = dev, shape

    @staticmethod
    def of_case(mode: str, kind: str, args, dev: torch.device) -> "_Field":
        """The benchmark field of a case, clamped to --size numbers."""
        data = get_benchmark_field(BenchmarkMode(mode))
        size = data.range_size
        if 0 < args.size < size:
            size = args.size
        shape = {}
        # The strided pipeline (niceonly to b97) takes its shapes from the
        # MSD floor: no batch.
        if args.batch and (kind == "detailed"
                           or get_plan(data.base).limbs_n > 4):
            shape["batch_size"] = args.batch
        return _Field(data.base, kind,
                      FieldSize(data.range_start, data.range_start + size),
                      dev, shape)

    def head(self, size: int) -> "_Field":
        """The same field cut to its first `size` numbers."""
        start = self.range.start()
        return _Field(self.base, self.kind,
                      FieldSize(start, start + min(size, self.size)),
                      self.dev, self.shape)

    def warm(self) -> None:
        if self.kind == "detailed":
            engine.warm_detailed(self.base, device=self.dev)
        else:
            engine.warm_niceonly(self.base, self.size, device=self.dev,
                                 field_start=self.range.start())

    def run(self, **kw):
        """(results, seconds, launches) of one pass."""
        process = (engine.process_range_detailed if self.kind == "detailed"
                   else engine.process_range_niceonly)
        before = dict(ce.LAUNCHES)
        t0 = time.monotonic()
        results = process(self.range, self.base, device=self.dev,
                          **{**self.shape, **kw})
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return results, time.monotonic() - t0, _launches(before)

    def timed(self, reps: int, want=None, **kw) -> tuple:
        """A warm pass, then reps timed passes, each required to equal
        `want` (the warm pass's results when None): (results, the timing
        stats, the last pass's launches, the warm pass's seconds)."""
        results, warm_secs, _ = self.run(**kw)
        want = _pairs(results) if want is None else want
        if _pairs(results) != want:
            raise RuntimeError(f"a pass with {kw} changed the results")
        times = []
        launches: dict = {}
        for _ in range(reps):
            results, secs, launches = self.run(**kw)
            if _pairs(results) != want:
                raise RuntimeError(f"a timed pass with {kw} changed the results")
            times.append(secs)
        return results, _stats(times), launches, warm_secs


# The multi-tenant case's slice of extra-large, each tenant's field.
MULTI_TENANT_SLICE = 1 << 20


def _interleaved(det: _Field, nice: _Field, args, dev: torch.device):
    """One interleaved pass of the two fields: (the assembled results by
    tenant, seconds, the scheduler's stats, the launches)."""
    from nice_tpu_torch.sched import (MultiTenantScheduler, StaticSource,
                                      TenantRegistry, TenantSpec)

    registry = TenantRegistry([
        TenantSpec(name="det", mode="detailed", base=det.base, priority=2,
                   batch_size=args.batch or None),
        TenantSpec(name="nice", mode="niceonly", base=nice.base, priority=1),
    ])
    source = StaticSource({
        name: [(f"{name}/f0", f.base, f.range.start(), f.range.end())]
        for name, f in (("det", det), ("nice", nice))})
    scheduler = MultiTenantScheduler(registry, source, policy="deficit",
                                     page_batches=1, quantum_secs=1e-9,
                                     device=dev)
    before = dict(ce.LAUNCHES)
    t0 = time.monotonic()
    stats = scheduler.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.monotonic() - t0
    results = {name: source.results[name][f"{name}/f0"]
               for name in ("det", "nice")}
    return results, secs, stats, _launches(before)


def run_multi_tenant(args, dev: torch.device) -> dict:
    """The scheduler's A/B (module doc): after the builds and a first pass
    of each field, --reps rounds of the two fields back to back and then
    interleaved, so vs_sequential (the medians' ratio) isolates what
    switching tenants at every page boundary costs."""
    data = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    size = MULTI_TENANT_SLICE
    if 0 < args.size < size:
        size = args.size
    start = data.range_start
    det = _Field(data.base, "detailed", FieldSize(start, start + size), dev,
                 {"batch_size": args.batch} if args.batch else {})
    nice = _Field(data.base, "niceonly",
                  FieldSize(start + size, start + 2 * size), dev, {})
    t0 = time.monotonic()
    det.warm()
    nice.warm()
    build_secs = time.monotonic() - t0
    want = {}
    first_secs = 0.0
    for name, f in (("det", det), ("nice", nice)):
        results, secs, _ = f.run()
        want[name] = _pairs(results)
        first_secs += secs
    seq, inter = [], []
    # Each pass's seconds by tenant: the sequential call, and the page's
    # busy seconds in the interleaved pass (the rest is outside the pages).
    seq_by = {name: [] for name in want}
    busy_by = {name: [] for name in want}
    equal = True
    for _ in range(args.reps):
        seq_launches = {}
        for name, f in (("det", det), ("nice", nice)):
            results, secs, seq_launches[name] = f.run()
            equal = equal and _pairs(results) == want[name]
            seq_by[name].append(secs)
        seq.append(sum(by[-1] for by in seq_by.values()))
        results, secs, stats, launches = _interleaved(det, nice, args, dev)
        equal = equal and all(_pairs(results[n]) == want[n] for n in want)
        inter.append(secs)
        for name in want:
            busy_by[name].append(stats["tenants"][name]["busy_secs"])
    st, seq_st = _stats(inter), _stats(seq)
    outside = [t - sum(by[i] for by in busy_by.values())
               for i, t in enumerate(inter)]
    total = 2 * size
    return {
        "metric": f"numbers/sec/chip sched (multi-tenant, base {data.base})",
        "value": total / st["median_secs"],
        "unit": UNIT,
        "vs_sequential": seq_st["median_secs"] / st["median_secs"],
        "elapsed_secs": st["median_secs"],
        "min_secs": st["min_secs"],
        "max_secs": st["max_secs"],
        "reps": args.reps,
        "pass_secs": st["secs"],
        "sequential_secs": seq_st["median_secs"],
        "sequential_pass_secs": seq_st["secs"],
        "first_field_secs": first_secs,
        "build_secs": build_secs,
        "range_size": total,
        "base": data.base,
        "range_start": start,
        "hits": sum(len(nums) for _, nums in want.values()),
        "pages": {t: s["pages"] for t, s in stats["tenants"].items()},
        "preemptions": {t: s["preemptions"]
                        for t, s in stats["tenants"].items()},
        "occupancy": stats["occupancy"],
        "busy_secs": {t: _stats(v)["median_secs"] for t, v in busy_by.items()},
        "sequential_by_tenant": {t: _stats(v)["median_secs"]
                                 for t, v in seq_by.items()},
        "outside_pages_secs": _stats(outside)["median_secs"],
        "launches": launches,
        "sequential_launches": seq_launches,
        "results_equal": equal,
    }


def run_case(mode: str, kind: str, args, dev: torch.device) -> dict:
    if mode == "multi-tenant":
        return run_multi_tenant(args, dev)
    mem0, prof0 = _mem_snapshot(), stepprof.cumulative()
    f = _Field.of_case(mode, kind, args, dev)
    clamped = f.size < get_benchmark_field(BenchmarkMode(mode)).range_size
    t0 = time.monotonic()
    f.warm()
    build_secs = time.monotonic() - t0
    first, first_secs, _ = f.run()
    results, st, launches, warm_secs = f.timed(args.reps, _pairs(first))
    if kind == "detailed":
        total = sum(d.count for d in results.distribution)
        if total != f.size:
            raise RuntimeError(f"bins sum to {total}, not {f.size}")
    median = st["median_secs"]
    line = {
        "metric": f"numbers/sec/chip {kind} ({mode}, base {f.base})",
        "value": f.size / median,
        "unit": UNIT,
        "elapsed_secs": median,
        "min_secs": st["min_secs"],
        "max_secs": st["max_secs"],
        "reps": args.reps,
        "pass_secs": st["secs"],
        "first_field_secs": first_secs,
        "warm_secs": warm_secs,
        "build_secs": build_secs,
        "range_size": f.size,
        "hits": len(results.nice_numbers),
        "base": f.base,
        "range_start": f.range.start(),
        "launches": launches,
        "nice_numbers": [[n.number, n.num_uniques]
                         for n in results.nice_numbers],
    }
    if clamped:
        line["range_clamped"] = True
    if kind == "detailed":
        line["distribution"] = [d.count for d in results.distribution]
        line["feed_stats"] = dict(engine.LAST_FEED_STATS)
    else:
        line["niceonly_stats"] = _plain(engine.LAST_NICEONLY_STATS)
        line["route"] = engine.LAST_NICEONLY_STATS.get("route")
        if get_plan(f.base).limbs_n > 4:
            line["feed_stats"] = dict(engine.LAST_FEED_STATS)
    if (mode, kind) == ("extra-large", "detailed"):
        line["feed_ab"] = _feed_ab(f, args.reps, _pairs(results))
    if (mode, kind) == ("hi-base", "detailed"):
        line["mxu_ab"] = _mxu_ab(f, args.reps)
    line["peak_mem"] = _mem_delta(mem0, _mem_snapshot())
    prof = _stepprof_delta(prof0, stepprof.cumulative())
    if prof:
        line["phase_breakdown"] = prof
        cp = critpath.phase_shares(prof)
        if cp is not None:
            line["critpath"] = cp
    return line


def _feed_ab(f: _Field, reps: int, want) -> dict:
    """The field at feed depth 0 (each block of starts made inline) against
    the default depth, each after a warm pass: the port's counterpart of
    bench.py's megaloop A/B (the port always runs segments)."""
    out = {}
    for depth in (0, engine.FEED_DEPTH_DEFAULT):
        _, st, launches, _ = f.timed(reps, want, feed_depth=depth)
        out[str(depth)] = {**st, "launches": launches,
                           "feed_stats": dict(engine.LAST_FEED_STATS)}
    return out


def _mxu_ab(f: _Field, reps: int) -> dict:
    """K1 (use_mxu=0) against K5 (use_mxu=1) on the field's first
    MXU_AB_SLICE numbers, each after a warm pass; the results must be
    equal (timed() raises otherwise)."""
    ab = f.head(MXU_AB_SLICE)
    out: dict = {"slice": ab.size}
    want = None
    for name, arm in (("k1", 0), ("k5", 1)):
        results, st, launches, _ = ab.timed(reps, want, use_mxu=arm)
        want = _pairs(results)
        out[name] = {**st, "launches": launches}
    return out


def _skip_line(mode: str, kind: str, reason: str) -> dict:
    return {"metric": f"numbers/sec/chip {kind} ({mode})", "value": 0,
            "unit": UNIT, "skipped": reason}


def _error_line(mode: str, kind: str, error: str) -> dict:
    return {"metric": f"numbers/sec/chip {kind} ({mode})", "value": 0,
            "unit": UNIT, "error": error}


def run_case_capped(mode: str, kind: str, args, dev, cap: float):
    """run_case in a worker thread under a wall cap: (line, wedged). A case
    that finishes within the grace after its cap keeps its numbers with
    over_budget; one still running is recorded as an error and reported
    wedged."""
    box: dict = {}

    def work():
        try:
            box["line"] = run_case(mode, kind, args, dev)
        except Exception as exc:  # noqa: BLE001 — reported as a JSON line
            logging.getLogger(__name__).exception("case %s/%s", kind, mode)
            box["exc"] = exc

    t = threading.Thread(target=work, name=f"bench-{mode}", daemon=True)
    t.start()
    t.join(cap)
    over = t.is_alive()
    if over:
        t.join(_CASE_GRACE_SECS)
        if t.is_alive():
            return _error_line(mode, kind, f"case exceeded its {cap:.0f}s "
                               f"budget plus {_CASE_GRACE_SECS:.0f}s grace"), True
    if "exc" in box:
        return _error_line(mode, kind, repr(box["exc"])), False
    line = box["line"]
    if over:
        line["over_budget"] = True
    return line, False


def parse_suite(raw: str) -> tuple:
    suite = []
    for entry in raw.split(","):
        mode, sep, kind = entry.strip().partition(":")
        if not sep or kind not in ("detailed", "niceonly"):
            raise ValueError(f"--suite entry {entry!r} must be <mode>:detailed "
                             "or <mode>:niceonly")
        suite.append((mode, kind))
    return tuple(suite)


def select_suite(args) -> tuple:
    suite = parse_suite(args.suite) if args.suite else DEFAULT_SUITE
    if args.only:
        suite = (tuple((m, k) for m, k in suite if m == args.only)
                 or ((args.only, _MODE_KIND.get(args.only, "detailed")),))
    return suite


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nice-tpu-torch-bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--only", default=None, help="run only this case's mode")
    p.add_argument("--suite", default=None,
                   help="comma-separated mode:kind list replacing the default "
                   "suite (kind = detailed|niceonly)")
    p.add_argument("--size", type=int, default=0,
                   help="clamp every case's field to at most this many numbers "
                   "(the line says range_clamped)")
    p.add_argument("--batch", type=int, default=0,
                   help="lanes a batch of the detailed and dense loops (0: the "
                   "tuned winner, else the engine's default)")
    p.add_argument("--budget", type=float, default=DEFAULT_BUDGET,
                   help="wall budget of the whole run, seconds")
    p.add_argument("--reps", type=int, default=DEFAULT_REPS,
                   help="timed passes a case, after the first and a warm pass")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--stepprof", action="store_true",
                   help="run every pass under the device-step profiler and "
                   "report each case's phase_breakdown")
    return p


def main(argv=None) -> int:
    t_start = time.monotonic()
    args = build_parser().parse_args(argv)
    if args.reps < 1:
        raise SystemExit("--reps must be at least 1")
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="INFO:%(name)s: %(message)s")
    dev = engine.resolve_device(args.device)  # no card: raise
    facts = device_facts(dev)
    stepprof.configure(args.stepprof)
    try:
        suite = select_suite(args)
    except ValueError as exc:
        print(json.dumps(_error_line("suite", "-", str(exc))), flush=True)
        return 1

    def remaining() -> float:
        return args.budget - (time.monotonic() - t_start)

    results: dict = {}
    headline = line = None
    wedged = False
    suite_prof0 = stepprof.cumulative()
    for idx, (mode, kind) in enumerate(suite):
        t_case = time.monotonic()
        case_budget = None
        if wedged:
            line = _skip_line(mode, kind, "timeout-wedge")
        elif ((mode, kind) != HEADLINE
              and _EST_SECS.get((mode, kind), _EST_DEFAULT) > remaining()):
            line = _skip_line(mode, kind, "budget")
            line["budget_remaining_secs"] = remaining()
        else:
            # Keep wall for the cases still queued behind this one (at
            # their estimate, capped), so one slow case cannot starve them.
            reserve = sum(min(_EST_SECS.get(c, _EST_DEFAULT),
                              _CAP_SECS.get(c, _CAP_DEFAULT))
                          for c in suite[idx + 1:])
            cap = _CAP_SECS.get((mode, kind), _CAP_DEFAULT)
            if (mode, kind) == HEADLINE:
                cap = max(30.0, min(cap, remaining() - 10.0))
            else:
                cap = max(10.0, min(cap, remaining() - 15.0,
                                    remaining() - reserve - 10.0))
            case_budget = cap
            line, wedged = run_case_capped(mode, kind, args, dev, cap)
        line.update(facts)
        line["case_elapsed_secs"] = time.monotonic() - t_case
        if case_budget is not None:
            line["case_budget_secs"] = case_budget
        results[(mode, kind)] = line
        print(json.dumps(line), flush=True)
        if (mode, kind) == HEADLINE:
            headline = line
    headline = dict(headline if headline is not None else line)
    headline["suite"] = {
        f"{kind}/{mode}": {k: v for k, v in r.items() if k in _SUITE_KEYS}
        for (mode, kind), r in results.items()
    }
    headline["budget_secs"] = args.budget
    headline["budget_used_secs"] = args.budget - remaining()
    # The whole run's phase table, in place of the headline case's own:
    # what the regression gate diffs (scripts/perf_gate.py).
    suite_prof = _stepprof_delta(suite_prof0, stepprof.cumulative())
    if suite_prof:
        headline["phase_breakdown"] = suite_prof
        cp = critpath.phase_shares(suite_prof)
        if cp is not None:
            headline["critpath"] = cp
    print(json.dumps(headline), flush=True)
    return 1 if any("error" in r for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
