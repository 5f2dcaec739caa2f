"""One run of one cell of the port's benchmark.

    python3 -m benchport.run --workload b40.thin --seed 7 --seconds 51 --trace 0

The cell (BENCHMARK.json's `workloads`) names a configuration and a traffic
mix. The run drives nice_tpu_torch's client entry, client.main.process_field,
on the first card in the configuration's mode with the client's defaults
(the device backend, no mesh, no winners table), as one closed-loop client:
each field (traffic.py, from --seed) is handed over when the previous one
has returned. What differs by mode is the mode's file,
benchport/modes/<mode>.py (manifest.MODE_CONTRACT).

  * Set-up (setup_s): the process's start, torch's import, the libraries'
    build or load (the mode's warm) and one warm field of the cell's own
    shape (the configuration's warm_index on its grid, a field that drives
    every path the window's fields take), not counted.
  * The window: fields are handed over for --seconds; each is timed from
    hand-over to return, and the mode's stats and the program's counters
    are read after it.
  * --trace 1: torch.profiler records a stretch of whole fields from a
    third of the way in, for the configuration's profile_seconds; the
    per-layer metrics are read from it and from the counters.
  * After the window: the card's peak memory is read, the process is
    checked for modules of JAX or of the JAX package (by top-level name,
    compared whole), the program's state is freed, the answers are
    compared with the configuration's plain reference (compare.py and
    the mode's readings), and the process is checked again.

The last line of standard output is one JSON object: correct, attempted,
failed (fields), metrics (the cell's end-to-end metrics, or with --trace 1
its per-layer ones, each read by benchport/metrics/<name>.py), device,
breakdown (--trace 1) and last `checks`, each number compared beside its
limit, which also end standard error. Without enough CUDA cards, or with a
JAX module loaded, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()  # the process's start, as near as code gets

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from typing import NamedTuple  # noqa: E402

from benchport import compare, devtrace, manifest, peaks, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nice_tpu")
TRACE_FROM = 1 / 3  # the traced stretch starts this far into the window
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions"}


class Field(NamedTuple):
    start: int
    end: int
    wall_s: float  # hand-over to return
    done_s: float  # its return, from the window's start
    stats: dict  # the mode's stats, read right after it returned
    results: object

    @property
    def feed_idle_s(self) -> float:
        """engine.LAST_FEED_STATS["idle_total"] after it (detailed mode)."""
        return self.stats.get("feed_idle_s", 0.0)


class Run:
    """What a run measured, as the metric readers read it."""

    def __init__(self, cell):
        self.cell = cell
        self.config = cell.config
        self.setup_s = 0.0
        self.fields: list[Field] = []
        self.launches: dict = {}  # cuda_engine.LAUNCHES over the window
        self.stretch: dict | None = None  # devtrace.summarize + its fields
        self.card: dict = {}
        self.error: str | None = None

    def numbers(self) -> int:
        return sum(f.end - f.start for f in self.fields)


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (nice_tpu_torch is not nice_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_env(root: str) -> None:
    """Keep any kernel cache torch or triton would write inside the
    checkout, at fixed paths (the port builds into nice_tpu_torch/_build)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, "benchport", "_cache", sub)


class Session:
    """The program set up for a cell: the client's arguments and entry, the
    counters it is read by. `warm` is the set-up's warm field; `window` runs
    the measured window. The cell's mode reaches the program through it
    (`engine`, `args`)."""

    def __init__(self, cell, client_argv=()):
        import torch
        from torch.profiler import ProfilerActivity

        from nice_tpu_torch.client import main as client
        from nice_tpu_torch.core.types import DataToClient
        from nice_tpu_torch.ops import autotune, engine
        from nice_tpu_torch.ops import cuda_engine as ce

        # No winners table: the shapes are the client's defaults.
        autotune.WINNERS_PATH = os.path.join(cell.root, "benchport",
                                             "_cache", "no-winners.json")
        self.cell = cell
        self.torch, self.engine, self.ce = torch, engine, ce
        self.client, self.data_type = client, DataToClient
        self.args = client.build_parser().parse_args(
            [cell.config["mode"], "--no-shard", *client_argv])
        self.on_card = self.args.device == "cuda"
        self.base = int(cell.config["base"])
        self.activities = [ProfilerActivity.CPU]
        if self.on_card:
            self.activities.append(ProfilerActivity.CUDA)
        self.claims = 0

    def handover(self, start: int, end: int):
        """One field through the client's entry; its FieldResults."""
        self.claims += 1
        data = self.data_type(claim_id=self.claims, base=self.base,
                              range_start=start, range_end=end,
                              range_size=end - start)
        return self.client.process_field(data, self.args)[0]

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize()

    def warm(self, field, trace: bool) -> None:
        """Build or load the libraries (the mode's warm) and run one field
        of the cell's shape; with trace, under a first profiler, whose
        start-up (CUPTI's) is then set-up's and not the stretch's."""
        from torch.profiler import profile

        self.cell.mode.warm(self, self.cell.config, field)
        with profile(activities=self.activities) if trace else nullcontext():
            self.handover(*field)
            self.sync()

    def window(self, gen, seconds: float, trace: bool, t_start: float) -> Run:
        """Hand over fields from `gen` for `seconds`, one after another;
        with trace, profile a stretch of whole fields from TRACE_FROM in."""
        from torch.profiler import profile, record_function

        ce, run = self.ce, Run(self.cell)
        field_stats = self.cell.mode.stats(self)
        if self.on_card:
            run.card = peaks.card(0)
        prof = stretch_range = None
        stretch_at = launches_at = None
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        t_end = t0 + seconds
        prof_from = t0 + seconds * TRACE_FROM
        prof_until = prof_from + float(
            self.cell.config.get("profile_seconds", 2.0))
        launches0 = dict(ce.LAUNCHES)

        def stop_profiler():
            self.sync()
            stretch_range.__exit__(None, None, None)
            prof.stop()
            fields = run.fields[stretch_at:]
            run.stretch = {
                "summary": None,  # read once the window has closed
                "fields": len(fields),
                "numbers": sum(f.end - f.start for f in fields),
                "launches": {k: v - launches_at[k]
                             for k, v in ce.LAUNCHES.items()},
            }

        while time.perf_counter() < t_end:
            if trace and prof is None and time.perf_counter() >= prof_from:
                prof = profile(activities=self.activities)
                prof.start()
                stretch_range = record_function(devtrace.STRETCH)
                stretch_range.__enter__()
                stretch_at, launches_at = len(run.fields), dict(ce.LAUNCHES)
            start, end = next(gen)
            profiling = prof is not None and run.stretch is None
            with (record_function(devtrace.FIELD) if profiling
                  else nullcontext()):
                t_a = time.perf_counter()
                try:
                    results = self.handover(start, end)
                except Exception as e:  # noqa: BLE001 — reported, not raised
                    run.error = f"{type(e).__name__}: {e}"
                    break
                t_b = time.perf_counter()
            run.fields.append(Field(start, end, t_b - t_a, t_b - t0,
                                    field_stats(), results))
            if profiling and t_b >= prof_until:
                stop_profiler()
        if prof is not None and run.stretch is None:
            stop_profiler()
        run.launches = {k: v - launches0[k] for k, v in ce.LAUNCHES.items()}
        if prof is not None:
            run.stretch["summary"] = devtrace.summarize(prof.events())
        return run


def drive(cell, seed: int, seconds: int, trace: bool, *,
          client_argv=(), t_start: float = T_START) -> Run:
    """Set up and run the window of the seed's traffic."""
    session = Session(cell, client_argv)
    session.warm(traffic.warm_field(cell.config), trace)
    return session.window(traffic.fields(cell.config, cell.mix, seed),
                          seconds, trace, t_start)


def read_metrics(cell, run: Run, trace: bool) -> dict:
    out = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(run: Run, cell, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit_w": run.card.get("power_limit_w")}
    summary = (run.stretch or {}).get("summary")
    if trace and summary:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def result_line(run: Run, cell, seed: int, trace: bool, device: dict,
                device_kind: str) -> dict:
    """The run's result line. The card's cached blocks are released before
    the reference runs, so that it sets no peak the program is read by."""
    import torch

    metrics = read_metrics(cell, run, trace)
    summary = (run.stretch or {}).get("summary")
    attempted = len(run.fields) + (run.error is not None)
    gc.collect()
    if device_kind == "cuda":
        torch.cuda.empty_cache()
    readings, bad, _ = compare.check(cell, run.fields, seed, device_kind)
    limits = cell.mode.LIMITS
    correct = (run.error is None and bool(run.fields)
               and all(readings[k] <= lim for k, lim in limits.items()))
    line = {"correct": correct, "attempted": attempted,
            "failed": bad + (run.error is not None),
            "metrics": metrics, "device": device}
    if trace and summary:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {k: {"value": readings[k], "limit": lim}
                      for k, lim in limits.items()}
    return line


def refused_for_imports() -> bool:
    """Whether JAX or the JAX package is loaded, named on standard error."""
    bad = loaded_forbidden()
    if bad:
        print(f"benchport: the run loaded {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


def report(run: Run, cell, seed: int, trace: bool, device: dict,
           device_kind: str) -> int:
    """Compare and print the result; 3 and no result where JAX or the JAX
    package is loaded once the window has closed, or once the comparison
    (the mode's readings, the configuration's reference) has run."""
    if refused_for_imports():
        return 3
    line = result_line(run, cell, seed, trace, device, device_kind)
    if refused_for_imports():
        return 3
    stretch = run.stretch or {}
    print(json.dumps({"fields": len(run.fields), "setup_s": run.setup_s,
                      "launches": run.launches,
                      "stretch_fields": stretch.get("fields"),
                      "stretch_launches": stretch.get("launches")}),
          file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.Cell(args.workload)
    _cache_env(cell.root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchport: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    trace = bool(args.trace)
    run = drive(cell, args.seed, args.seconds, trace)
    if run.error:
        print(f"benchport: a field raised: {run.error}", file=sys.stderr)
    return report(run, cell, args.seed, trace,
                  device_info(run, cell, trace), "cuda")


if __name__ == "__main__":
    sys.exit(main())
