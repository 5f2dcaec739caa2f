"""nice-tpu-torch search client CLI (the port's cut of nice_tpu/client/main.py).

  * single shot: claim one field (detailed or niceonly) from --api-base,
    process it on the card, submit it; niceonly takes every base, b10-b97
    through the strided pipeline and b98 and up through the dense loop;
  * --repeat: the 3-stage pipeline — claim N+1 and submit N-1 overlap
    processing N, until interrupted;
  * --claim-block N: N fields a round trip under one block lease
    (/claim_block, /submit_block, one heartbeat for the block), single shot
    or with --repeat, falling back to per-field claims against a server
    without block leases;
  * --api-base may list several servers, and --servers and the servers.json
    beside the checkpoints add more: every request fails over between them
    (client/api_client.py), fenced by the highest epoch seen;
  * --prefetch (on by default): when the next claim resolves, a thread
    builds what its fields need (engine.warm_detailed / warm_niceonly)
    while the current field runs;
  * --checkpoint-dir: crash-safe snapshots of the field being scanned
    (ckpt/), written on the engine's checkpoint ticker; a restarted client
    resumes the claim it died holding from its newest snapshot, and a
    snapshot is deleted only once its submit is owned (accepted or spooled);
  * --spool-dir (default <checkpoint-dir>/spool): submissions whose retries
    ran out are journaled (faults/spool.py) and replayed at startup and at
    every loop boundary;
  * --renew-secs: a lease heartbeat (/renew_claim) while a field scans;
  * --benchmark <field>: process a built-in benchmark field offline and
    print one JSON summary line (the JAX client's keys);
  * --validate [--base B]: recompute a double-checked field and compare it
    with the server's canonical submission; exit code 0 when they agree;
  * observability (obs/): --telemetry-secs (a /telemetry heartbeat that also
    learns the server list from /status; the fleet snapshot rides on every
    submit too), --metrics-port (local /metrics, /debug/flight, /history,
    /debug/profile), --stepprof (the per-field phase breakdown, fenced on
    CUDA events), --memwatch-secs, --pyprof-hz, --history-secs, --trace /
    --trace-max-bytes (JSON spans joined by the claim's trace id, sent as
    traceparent), --profile-dir (a torch.profiler Chrome trace a field),
    --flight-dir / --flight-events (the crash flight recorder), --log-file
    (JSON log lines), and --faults / --faults-seed (the fault sites);
  * --tenants "name:mode:base[:opt...];...": the multi-tenant scheduler
    (sched/) in place of the single-workload loop: each tenant claims with
    its name and base window, its fields run page by page interleaved with
    the other tenants' on the card, and each finished field is submitted;
    --sched-policy, --sched-page-batches, --sched-quantum-secs,
    --sched-starvation-rounds, --sched-slo-boost, --slo-window-scale and
    --slo-override set the scheduler and its per-tenant SLOs (the JAX
    client's NICE_TPU_SCHED_* and NICE_TPU_SLO_* knobs);
  * --devices cuda:0,cuda:1 (or cuda:0,cuda:0: logical slices of one card):
    the device backend's fields run on a mesh of those slices (one process,
    one stream a slice, ops/engine.resolve_mesh; the JAX client's device
    set, which JAX takes from its environment); without it a bare --device
    cuda takes every visible card. --no-shard keeps a field on one device
    and --no-elastic makes a lost slice fail the field (with a resumable
    state) instead of downshifting onto the survivors (the JAX client's
    NICE_TPU_SHARD and NICE_TPU_ELASTIC).

The default device is cuda; --device cpu runs the kernels' plain PyTorch
versions, --backend scalar the Python-int oracle (checkpointed in chunks
like the device loops) and --backend native the host library on --threads
cores (0: all), which neither checkpoints nor resumes: with it
--checkpoint-dir is dropped, as the JAX client drops it. A niceonly field
on the card of at most --host-niceonly-max numbers that the host library's
polynomial-residue kernel takes runs on the host instead (the small-field
host route; off by default, engine.HOST_NICEONLY_MAX). Every knob is a
flag: the port reads no environment variable.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys
import threading
import time
from contextlib import nullcontext
from typing import Optional

from nice_tpu_torch import CLIENT_VERSION
from nice_tpu_torch import ckpt, obs
from nice_tpu_torch.client import api_client
from nice_tpu_torch.core import number_stats
from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    FieldResults,
    SearchMode,
)
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.faults import spool as spool_mod
from nice_tpu_torch.obs import (
    flight,
    history,
    journal,
    logsink,
    memwatch,
    pyprof,
    stepprof,
    trace,
)
from nice_tpu_torch.obs.series import (
    CKPT_RENEWALS,
    CLIENT_FIELD_SECONDS,
    CLIENT_FIELDS,
    CLIENT_NUMBERS,
)
from nice_tpu_torch.ops import engine
from nice_tpu_torch.parallel import mesh as pmesh
from nice_tpu_torch.sched import scheduler as sched_defaults
from nice_tpu_torch.utils import fsio, lockdep

log = logging.getLogger("nice_tpu_torch.client")

_LOG_LEVELS = ("trace", "debug", "info", "warn", "error")


def _device_list(value: str) -> list[str]:
    """--devices: a comma-separated device list of one kind."""
    devices = [d.strip() for d in value.split(",") if d.strip()]
    try:
        pmesh.device_kind(devices)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return devices


def _mesh_kwargs(args) -> dict:
    """The engine's and the warms' mesh arguments from the flags."""
    return {"devices": args.devices, "shard": args.shard,
            "elastic": args.elastic}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nice-tpu-torch-client",
        description="Distributed search client for square-cube pandigitals "
        "(PyTorch/CUDA)",
    )
    p.add_argument("mode", nargs="?", default="detailed",
                   choices=["detailed", "niceonly"],
                   help="search mode: detailed (histogram and near misses) or "
                   "niceonly (nice numbers only: strided up to b97, dense "
                   "from b98)")
    p.add_argument("--api-base", default="https://api.nicenumbers.net",
                   help="API base URL; may be a comma-separated list for "
                   "failover")
    p.add_argument("--servers", default=None,
                   help="additional comma-separated server endpoints merged "
                   "into --api-base for multi-server failover")
    p.add_argument("--username", default="anonymous",
                   help="username credited with submissions")
    p.add_argument("--max-retries", type=int,
                   default=api_client.DEFAULT_MAX_RETRIES,
                   help="HTTP retry ceiling")
    p.add_argument("--repeat", action="store_true",
                   help="run until interrupted, with the 3-stage pipeline "
                   "(claim N+1 and submit N-1 while N is processed)")
    p.add_argument("--backend", default="device", choices=list(engine.BACKENDS),
                   help="device: the kernels (or their plain versions with "
                   "--device cpu); scalar: the Python-int oracle; native: "
                   "the multithreaded C++ host engine")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the device backend runs")
    p.add_argument("--devices", type=_device_list, default=None,
                   help="comma-separated slices of a mesh, e.g. "
                   "cuda:0,cuda:1 or cuda:0,cuda:0 (logical slices of one "
                   "card), or cpu,cpu with --device cpu; default: every "
                   "visible card")
    p.add_argument("--shard", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run a field on a mesh when the device list has at "
                   "least two live slices")
    p.add_argument("--elastic", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on a lost slice, downshift onto the survivors "
                   "(--no-elastic: the field fails with a resumable state)")
    p.add_argument("--batch-size", type=lambda v: int(v) or None, default=None,
                   help="lanes per batch of the detailed and dense loops; 0 "
                   "= the tuned winner, else "
                   f"{engine.DEFAULT_BATCH_SIZE} (the strided pipeline "
                   "takes its shapes from the MSD floor)")
    p.add_argument("--threads", type=int, default=0,
                   help="host threads of the native backend and of the "
                   "niceonly host route; 0 = all cores")
    p.add_argument("--host-niceonly-max", type=int, default=None,
                   help="niceonly fields on the card of at most this many "
                   "numbers go to the host engine when its polynomial-residue "
                   "kernel takes them; 0 disables (default: "
                   f"{engine.HOST_NICEONLY_MAX}, measured on the card's "
                   "machine, where the host route won at no size)")
    p.add_argument("--progress-secs", type=float, default=5.0,
                   help="seconds between in-field progress lines; 0 disables")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for crash-safe field-scan snapshots; "
                   "enables periodic checkpointing and auto-resume of an "
                   "interrupted claim on startup")
    p.add_argument("--spool-dir", default=None,
                   help="directory journaling submissions whose HTTP retries "
                   "were exhausted, for replay at the next loop iteration / "
                   "startup; defaults to <checkpoint-dir>/spool when "
                   "checkpointing is on")
    p.add_argument("--checkpoint-secs", type=float,
                   default=engine.CKPT_EVERY_SECS,
                   help="seconds between snapshots while scanning")
    p.add_argument("--checkpoint-batches", type=int,
                   default=engine.CKPT_EVERY_BATCHES,
                   help="dispatched segments, runs or descriptor groups "
                   "between snapshots (whichever of this and "
                   "--checkpoint-secs fires first; 0 disables this trigger)")
    p.add_argument("--claim-block", type=int, default=1,
                   help="fields per claim round trip: >1 claims through the "
                   "block-lease endpoints (/claim_block, /submit_block) with "
                   "one lease covering the whole block; 1 = per-field. Falls "
                   "back to per-field claims against a server without block "
                   "support")
    p.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="when the next claim resolves, build what its fields "
                   "need on a background thread while the current field runs")
    p.add_argument("--renew-secs", type=float, default=900.0,
                   help="seconds between claim-lease renewal heartbeats to "
                   "/renew_claim; 0 disables")
    p.add_argument("--benchmark", default=None,
                   choices=[m.value for m in BenchmarkMode],
                   help="process a benchmark field offline")
    p.add_argument("--validate", action="store_true",
                   help="self-check against a canonical double-checked field")
    p.add_argument("--base", type=int, default=None,
                   help="restrict --validate to a specific base")
    p.add_argument("--log-level", default="info", choices=list(_LOG_LEVELS),
                   help="log verbosity")
    p.add_argument("--log-file", default=None,
                   help="also append the JSON log lines to this file")
    p.add_argument("--telemetry-secs", type=float, default=60.0,
                   help="seconds between fleet-telemetry heartbeats to "
                   "/telemetry (throughput, backend, spool depth, phase "
                   "breakdown); each beat also learns the server list from "
                   "/status; 0 disables")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics, /debug/flight, /history and "
                   "/debug/profile on this localhost port (0: a free port, "
                   "exported as nice_metrics_bound_port)")
    p.add_argument("--stepprof", action="store_true",
                   help="attribute each field's wall time to compile / "
                   "h2d_feed / device_compute / fold / readback / host_other "
                   "(one CUDA-event fence a dispatch)")
    p.add_argument("--memwatch-secs", type=float,
                   default=memwatch.DEFAULT_INTERVAL_SECS,
                   help="seconds between device-memory / RSS / disk samples; "
                   "0 disables")
    p.add_argument("--pyprof-hz", type=float, default=pyprof.DEFAULT_HZ,
                   help="samples a second of the statistical Python "
                   "profiler; 0 disables")
    p.add_argument("--history-secs", type=float,
                   default=history.DEFAULT_INTERVAL_SECS,
                   help="seconds between samples of the metrics history "
                   "behind /history; 0 disables")
    p.add_argument("--trace", default=None,
                   help="JSON trace-span sink: stderr, or a file path")
    p.add_argument("--trace-max-bytes", type=int,
                   default=trace.DEFAULT_MAX_SINK_BYTES,
                   help="rotate a file trace sink past this size; 0 disables")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of each field "
                   "into this directory")
    p.add_argument("--flight-dir", default=None,
                   help="directory of flight-recorder dumps (crash, SIGUSR2, "
                   "spool quarantine); default: the system temp dir")
    p.add_argument("--flight-events", type=int,
                   default=flight.DEFAULT_CAPACITY,
                   help="events the flight recorder's ring keeps")
    p.add_argument("--faults", default=None,
                   help="fault-injection spec, site:action[@selector],... "
                   "(sites http.<endpoint>, engine.dispatch, ckpt.write)")
    p.add_argument("--faults-seed", type=int, default=faults.DEFAULT_SEED,
                   help="seed of the fault spec's probability draws")
    p.add_argument("--tenants", default=None,
                   help="run the multi-tenant scheduler instead of the "
                   "single-workload loop: semicolon-separated "
                   "name:mode:base[:opt...] tenant specs (modes detailed, "
                   "niceonly, near-miss, hi-base; opts prio=N, slo=SECS, "
                   "bases=LO-HI, batch=N, backend=NAME); each tenant claims "
                   "one field, or until the server runs dry with --repeat")
    p.add_argument("--sched-policy", default=sched_defaults.POLICY_DEFAULT,
                   choices=list(sched_defaults.POLICIES),
                   help="tenant selection: deficit (priority-weighted "
                   "deficit round-robin), priority (strict) or rr")
    p.add_argument("--sched-page-batches", type=int,
                   default=sched_defaults.PAGE_BATCHES_DEFAULT,
                   help="loop segments a scheduler page")
    p.add_argument("--sched-quantum-secs", type=float,
                   default=sched_defaults.QUANTUM_SECS_DEFAULT,
                   help="a tenant's time slice: it yields at the next page "
                   "boundary after this many seconds; <=0 disables")
    p.add_argument("--sched-starvation-rounds", type=int,
                   default=sched_defaults.STARVATION_ROUNDS_DEFAULT,
                   help="a runnable tenant skipped this many rounds runs "
                   "next; <=0 disables the bound")
    p.add_argument("--sched-slo-boost", type=int,
                   default=sched_defaults.SLO_BOOST_DEFAULT,
                   help="priority points a tenant whose page-latency SLO "
                   "burns earns per burn level (warn 1, page 2)")
    p.add_argument("--slo-window-scale", type=float, default=1.0,
                   help="scale of every SLO burn-rate window")
    p.add_argument("--slo-override", action="append", default=[],
                   type=_slo_override, metavar="NAME_THRESHOLD=V",
                   help="replace an SLO's threshold or objective, e.g. "
                   "TENANT_CANON_THRESHOLD=2 (repeatable)")
    return p


def _slo_override(item: str) -> tuple[str, float]:
    """One --slo-override NAME_{THRESHOLD,OBJECTIVE}=VALUE item."""
    key, sep, value = item.partition("=")
    key = key.strip().upper()
    if not sep or not key.endswith(("_THRESHOLD", "_OBJECTIVE")):
        raise argparse.ArgumentTypeError(
            f"{item!r}: want NAME_THRESHOLD=V or NAME_OBJECTIVE=V")
    try:
        return key, float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{item!r}: {value!r} is no number")


def configure_obs(args) -> None:
    """Arm the observability layer from the client's flags: the span sink
    and profiler directory, the flight recorder's ring, stepprof, the fault
    plan, the local metrics endpoint and the history, memwatch and pyprof
    samplers (each once a process; a rate or interval of 0 starts no
    thread). A bad fault spec, an unopenable sink or a port that cannot be
    bound raises. The flight recorder's crash and SIGUSR2 dumps hook the
    process (sys.excepthook, a signal handler): the command line's entry
    (client/__main__.py) arms them with flight.install(), and so may a
    program that owns its process and calls main()."""
    trace.configure(args.trace, args.trace_max_bytes, args.profile_dir)
    flight.configure(args.flight_dir, args.flight_events)
    stepprof.configure(args.stepprof)
    faults.configure(args.faults, args.faults_seed)
    pyprof.configure(args.pyprof_hz)
    obs.maybe_serve_metrics(args.metrics_port)
    history.maybe_start_sampler(args.history_secs)
    memwatch.maybe_start_sampler(args.memwatch_secs)
    pyprof.maybe_start()


def _mode(args) -> SearchMode:
    return (SearchMode.DETAILED if args.mode == "detailed"
            else SearchMode.NICEONLY)


def _progress_logger(every_secs: float):
    """Throttled in-field progress callback: % done, live n/s, ETA.
    Thread-safe: the engine may call it from a pipeline worker thread."""
    if not every_secs or every_secs <= 0:
        return None
    t0 = time.monotonic()
    state = {"last": t0}
    lock = lockdep.make_lock("client.main._progress_logger.lock")

    def cb(done: int, total: int) -> None:
        now = time.monotonic()
        with lock:
            if now - state["last"] < every_secs or done <= 0 or done >= total:
                return
            state["last"] = now
        rate = done / max(now - t0, 1e-9)
        eta = (total - done) / rate if rate > 0 else float("inf")
        log.info(
            "progress %5.1f%% (%s / %s) %s numbers/sec, ETA %.0fs",
            100.0 * done / total, f"{done:,}", f"{total:,}", f"{rate:,.0f}", eta,
        )

    return cb


def process_field(data: DataToClient, args, *, checkpointer=None,
                  resume=None, mode: Optional[SearchMode] = None,
                  ) -> tuple[FieldResults, float]:
    """Process one field in `mode` (args.mode when None); returns results
    and elapsed seconds.

    checkpointer: an optional ckpt.FieldCheckpointer whose save() becomes
    the engine's checkpoint_cb (on the ticker of args.checkpoint_batches /
    args.checkpoint_secs); resume: a validated state from its load() or
    find_resumable, to continue from instead of restarting the scan. A
    detailed field's libraries are built (engine.warm_detailed) before the
    timed window, as the JAX client warms its executables.

    The whole call is one client.process_field span (under --profile-dir,
    inside the capture), tiled by three steps: client.prepare (the engine's
    arguments, the device, the libraries), client.engine (the engine's
    call, its engine.detailed span inside) and client.report (the series,
    the journal's phases event, the log line); a recorded field
    (obs.trace.field) keeps their seconds."""
    mode = mode if mode is not None else _mode(args)
    mode_label = "detailed" if mode == SearchMode.DETAILED else "niceonly"
    with obs.profiler("process_field"), \
            trace.field(data.base, data.range_start, data.range_end) as rec, \
            obs.span("client.process_field", base=data.base,
                     size=data.range_size, mode=mode_label,
                     backend=args.backend):
        steps = rec.steps()
        steps.to("client.prepare")
        try:
            kwargs = {"device": args.device, "backend": args.backend,
                      "progress": _progress_logger(args.progress_secs),
                      "threads": args.threads or None, **_mesh_kwargs(args)}
            if checkpointer is not None or resume is not None:
                kwargs.update(checkpoint_cb=(checkpointer.save if checkpointer
                                             else None),
                              resume=resume,
                              checkpoint_batches=args.checkpoint_batches,
                              checkpoint_secs=args.checkpoint_secs)
            if mode == SearchMode.DETAILED:
                if args.backend == "device":
                    # No card: raise, not build.
                    engine.resolve_device(args.device)
                    engine.warm_detailed(data.base, device=args.device,
                                         devices=args.devices)
                process = engine.process_range_detailed
                kwargs["batch_size"] = args.batch_size
            else:
                process = engine.process_range_niceonly
                kwargs["host_niceonly_max"] = args.host_niceonly_max
                if engine.niceonly_takes_batch(data.base, args.backend):
                    kwargs["batch_size"] = args.batch_size
            profiled0 = stepprof.finished()
            steps.to("client.engine")
            t0 = time.monotonic()
            results = process(data.to_field_size(), data.base, **kwargs)
            elapsed = time.monotonic() - t0
            steps.to("client.report")
            CLIENT_FIELD_SECONDS.labels(mode_label).observe(elapsed)
            CLIENT_FIELDS.labels(mode_label).inc()
            CLIENT_NUMBERS.inc(data.range_size)
            if stepprof.finished() > profiled0:
                # The field's phase breakdown, keyed to its claim, for the
                # server's critical-path waterfall: only when a profiled
                # loop ran this field (the strided and host niceonly routes
                # have none).
                lb = dict(stepprof.LAST_BREAKDOWN)
                if lb.get("base") == data.base:
                    phases = {p: round(float(lb.get(p, 0.0) or 0.0), 6)
                              for p in stepprof.PHASES}
                    journal.record_client_event(
                        "phases", claim_id=data.claim_id,
                        wall=round(float(lb.get("wall", elapsed) or elapsed),
                                   6),
                        **phases)
            rate = data.range_size / elapsed if elapsed > 0 else float("inf")
            log.info("processed %s numbers in %.2fs (%s numbers/sec)",
                     f"{data.range_size:,}", elapsed, f"{rate:,.0f}")
        finally:
            steps.to(None)
    return results, elapsed


def compile_results(data: DataToClient, results: FieldResults,
                    mode: SearchMode, username: str) -> DataToServer:
    """The submission payload (no distribution in niceonly mode), stamped
    with the exactly-once submit_id (claim id + content hash), computed as
    the JAX client computes it."""
    payload = DataToServer(
        claim_id=data.claim_id,
        username=username,
        client_version=CLIENT_VERSION,
        unique_distribution=(list(results.distribution)
                             if mode == SearchMode.DETAILED else None),
        nice_numbers=list(results.nice_numbers),
    )
    content = json.dumps(payload.to_json(), sort_keys=True).encode()
    payload.submit_id = (
        f"{data.claim_id}-{hashlib.sha256(content).hexdigest()[:16]}"
    )
    return payload


def run_benchmark(args) -> int:
    bench = BenchmarkMode(args.benchmark)
    data = get_benchmark_field(bench)
    log.info("benchmark %s: base %d, range [%d, %d) (%s numbers), backend %s "
             "on %s", bench.value, data.base, data.range_start, data.range_end,
             f"{data.range_size:,}", args.backend, args.device)
    results, elapsed = process_field(data, args)
    summary = {
        "benchmark": bench.value,
        "base": data.base,
        "range_size": data.range_size,
        "mode": args.mode,
        "backend": args.backend,
        "device": args.device,
        "elapsed_secs": round(elapsed, 4),
        "numbers_per_sec": round(data.range_size / elapsed, 1),
        "nice_count": sum(
            1 for n in results.nice_numbers if n.num_uniques == data.base
        ),
        "near_miss_cutoff": number_stats.get_near_miss_cutoff(data.base),
        "near_misses": len(results.nice_numbers),
    }
    print(json.dumps(summary), flush=True)
    return 0


class _ClaimRenewer:
    """Background lease heartbeat for one claim: POSTs /renew_claim
    immediately on entry (a resumed claim may be near expiry) and then every
    every_secs. Failures are logged and swallowed — a missed heartbeat is
    recoverable, killing the scan over one is not."""

    kind = "claim"

    def __init__(self, api_base: str, claim_id: int, every_secs: float):
        self.api_base = api_base
        self.lease = claim_id
        self.every_secs = every_secs
        self.renewals = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"{self.kind}-renew", daemon=True
        )

    def _renew(self) -> None:
        api_client.renew_claim(self.api_base, self.lease)

    def _renew_once(self) -> None:
        try:
            self._renew()
            self.renewals += 1
            CKPT_RENEWALS.inc()
            log.debug("renewed %s %s lease", self.kind, self.lease)
        except Exception as e:  # noqa: BLE001 — a missed heartbeat is logged
            log.warning("%s %s lease renewal failed: %s", self.kind,
                        self.lease, e)

    def _run(self) -> None:
        self._renew_once()
        while not self._stop.wait(self.every_secs):
            self._renew_once()

    def __enter__(self) -> "_ClaimRenewer":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class _BlockRenewer(_ClaimRenewer):
    """The heartbeat of a block claim: one POST /renew_claim {block_id}
    re-arms every member field's lease."""

    kind = "block"

    def _renew(self) -> None:
        api_client.renew_block(self.api_base, self.lease)


def _maybe_renewer(args, claim_id: int):
    if args.renew_secs and args.renew_secs > 0 and claim_id > 0:
        return _ClaimRenewer(args.api_base, claim_id, args.renew_secs)
    return nullcontext()


def _maybe_block_renewer(args, block_id: str):
    if args.renew_secs and args.renew_secs > 0 and block_id:
        return _BlockRenewer(args.api_base, block_id, args.renew_secs)
    return nullcontext()


def _new_checkpointer(args, data: DataToClient, mode: SearchMode):
    if not args.checkpoint_dir:
        return None
    return ckpt.FieldCheckpointer(args.checkpoint_dir, data, mode,
                                  args.backend, args.batch_size, args.device)


def _find_resumable(args, mode: SearchMode):
    if not args.checkpoint_dir:
        return None
    return ckpt.find_resumable(args.checkpoint_dir, mode, args.backend,
                               args.batch_size, args.device)


def _resume_or_claim(args, api: api_client.AsyncApi, mode: SearchMode):
    """(data, resume_state, checkpointer): the newest matching snapshot in
    --checkpoint-dir if one exists (same claim, no re-claim round-trip), else
    a fresh server claim."""
    found = _find_resumable(args, mode)
    if found is not None:
        data, state, ckptr = found
        log.info(
            "resuming claim %d from checkpoint: base %d, range [%d, %d), "
            "cursor %d",
            data.claim_id, data.base, data.range_start, data.range_end,
            state["cursor"],
        )
        return data, state, ckptr
    data = api.claim_async(mode).result()
    log.info("claimed field (claim %d): base %d, range [%d, %d)",
             data.claim_id, data.base, data.range_start, data.range_end)
    return data, None, _new_checkpointer(args, data, mode)


def _spool_or_raise(err: api_client.ApiError, spool) -> None:
    """A failed submit is journaled when the spool can replay it: a 4xx
    rejection (or no spool) raises, since a replay of a rejected payload can
    never succeed."""
    if spool is None or (err.status is not None and 400 <= err.status < 500):
        raise err


def _await_submit(future, submission: DataToServer, spool) -> Optional[dict]:
    """Confirm a submit, journaling to the spool when the server stayed
    unreachable past the retry budget; returns the server's reply, or None
    when spooled. A 4xx rejection always raises. Once this returns,
    delivery is OWNED (accepted, already-accepted duplicate, or spooled),
    so the field's snapshot may be retired."""
    try:
        resp = future.result()
    except api_client.ApiError as e:
        _spool_or_raise(e, spool)
        spool.add(submission)
        return None
    log.info("submitted claim %d%s", submission.claim_id,
             " (duplicate)" if resp.get("duplicate") else "")
    return resp


def _process_claimed(data: DataToClient, args, mode: SearchMode, *,
                     checkpointer=None, resume=None, block: str | None = None,
                     renewer=None):
    """process_field of a claimed field inside the claim's trace context
    (one distributed trace a claim: the id derives from the claim id, so
    the server's handler spans and the engine's share it), with its claim
    event and flight record, under `renewer` when given."""
    extra = {} if block is None else {"block": block}
    with obs.trace_context(obs.claim_trace_id(data.claim_id)):
        obs.trace_event("client.claim", claim=data.claim_id, base=data.base,
                        range_start=str(data.range_start),
                        size=data.range_size, resumed=resume is not None,
                        **extra)
        flight.record("claim", claim=data.claim_id, base=data.base, **extra)
        with renewer if renewer is not None else nullcontext():
            results, _ = process_field(data, args, checkpointer=checkpointer,
                                       resume=resume, mode=mode)
    return results


def _fleet_snapshot(args, spool) -> dict:
    """This client's obs.telemetry snapshot, spool depth included."""
    depth = 0
    if spool is not None:
        try:
            depth = len(spool.pending())
        except OSError:
            pass
    return obs.telemetry.snapshot(username=args.username,
                                  backend=args.backend, spool_depth=depth,
                                  client_version=CLIENT_VERSION)


def run_single_iteration(args, api: Optional[api_client.AsyncApi] = None,
                         mode: Optional[SearchMode] = None, spool=None):
    """Claim (or resume) one field of args.mode, process it, submit it;
    returns the field, the submission and the server's reply (None when the
    submission was spooled). Without `api` it makes its own and shuts it
    down."""
    own = api is None
    if own:
        api = api_client.AsyncApi(args.api_base, args.username,
                                  args.max_retries)
    mode = mode if mode is not None else _mode(args)
    try:
        data, resume, ckptr = _resume_or_claim(args, api, mode)
        results = _process_claimed(data, args, mode, checkpointer=ckptr,
                                   resume=resume,
                                   renewer=_maybe_renewer(args, data.claim_id))
        submission = compile_results(data, results, mode, args.username)
        # The snapshot rides along AFTER submit_id is stamped: it must not
        # perturb the content hash that makes replays idempotent.
        submission.telemetry = _fleet_snapshot(args, spool)
        resp = _await_submit(api.submit_async(submission), submission, spool)
    finally:
        if own:
            api.shutdown()
    # Only an owned submit (confirmed or spooled) retires the snapshot; any
    # failure before this point leaves it on disk for the next startup.
    if ckptr is not None:
        ckptr.delete()
    return data, submission, resp


def _warm_field(data: DataToClient, mode: SearchMode, args) -> None:
    """Build what one claimed field will need; a failure is logged (the
    field's own first launch builds again, and raises)."""
    try:
        if mode == SearchMode.DETAILED:
            engine.warm_detailed(data.base, device=args.device,
                                 backend=args.backend, devices=args.devices)
        else:
            engine.warm_niceonly(data.base, data.range_size,
                                 device=args.device, backend=args.backend,
                                 field_start=data.range_start,
                                 host_niceonly_max=args.host_niceonly_max,
                                 devices=args.devices)
    except Exception:  # noqa: BLE001 — the field's dispatch raises it again
        log.warning("prefetch warm failed for base %d", data.base,
                    exc_info=True)


def _prefetch_on_claim(future, args, mode: SearchMode) -> None:
    """--prefetch: when the next claim (one field, or a block's
    (block_id, fields)) resolves, typically while the current field still
    runs, warm what its fields need on a thread named nice-prefetch, each
    distinct (base, size) once (detailed fields need the same libraries at
    every size), so that a base change at the field boundary costs no
    foreground nvcc build. The warms make no launch and no torch call, so
    they do not contend with the running field's threads."""
    if not args.prefetch:
        return

    def _cb(fut) -> None:
        try:
            resolved = fut.result()
        except Exception:  # noqa: BLE001 — the loop's .result() raises it
            return
        fields = resolved[1] if isinstance(resolved, tuple) else [resolved]
        todo = {}
        for data in fields:
            size = data.range_size if mode == SearchMode.NICEONLY else 0
            todo.setdefault((data.base, size), data)

        def _warm_all() -> None:
            for data in todo.values():
                _warm_field(data, mode, args)

        threading.Thread(target=_warm_all, name="nice-prefetch",
                         daemon=True).start()

    future.add_done_callback(_cb)


def run_pipelined_loop(args, api: api_client.AsyncApi, mode: SearchMode,
                       spool=None) -> None:
    """claim N+1 || process N || submit N-1, until interrupted or a claim
    fails."""
    pending_submit = None  # (future, checkpointer, submission)
    data, resume, ckptr = _resume_or_claim(args, api, mode)
    while True:
        if spool is not None:
            # Loop-boundary replay: a no-op when empty, and the natural
            # moment to drain journaled submissions once the server is back.
            spool.replay(args.api_base)
        next_claim = api.claim_async(mode)  # overlap with processing
        _prefetch_on_claim(next_claim, args, mode)
        results = _process_claimed(data, args, mode, checkpointer=ckptr,
                                   resume=resume,
                                   renewer=_maybe_renewer(args, data.claim_id))
        if pending_submit is not None:
            # Settle the previous submit before queueing the next one; only
            # an owned submit (confirmed or spooled) retires its snapshot.
            prev_future, prev_ckptr, prev_sub = pending_submit
            _await_submit(prev_future, prev_sub, spool)
            if prev_ckptr is not None:
                prev_ckptr.delete()
        submission = compile_results(data, results, mode, args.username)
        submission.telemetry = _fleet_snapshot(args, spool)
        pending_submit = (api.submit_async(submission), ckptr, submission)
        data = next_claim.result()
        resume = None
        ckptr = _new_checkpointer(args, data, mode)
        log.info("claimed field (claim %d): base %d, size %s",
                 data.claim_id, data.base, f"{data.range_size:,}")


def _process_block(args, mode: SearchMode, block_id: str, fields):
    """Process every field of a block in turn under ONE block-lease
    renewer; returns [(submission, checkpointer), ...] in field order."""
    submissions = []
    with _maybe_block_renewer(args, block_id):
        for data in fields:
            ckptr = _new_checkpointer(args, data, mode)
            results = _process_claimed(data, args, mode, checkpointer=ckptr,
                                       block=block_id)
            submissions.append(
                (compile_results(data, results, mode, args.username), ckptr))
    return submissions


def _await_block_submit(future, submissions, spool) -> Optional[dict]:
    """Settle one /submit_block: per-item rejections are logged (a replay of
    a rejected payload can never succeed, so they retire their snapshots
    too); retries that run out spool every member for per-field replay
    (the server keeps /submit for that). Returns the server's reply, or
    None when spooled. Once this returns, every member's delivery is
    owned."""
    resp = None
    try:
        resp = future.result()
        for (sub, _), result in zip(submissions, resp.get("results", [])):
            if result.get("status") == "error":
                log.error("block submission for claim %d rejected (%s): %s",
                          sub.claim_id, result.get("code"),
                          result.get("message"))
            else:
                log.info("submitted claim %d%s", sub.claim_id,
                         " (duplicate)" if result.get("duplicate") else "")
    except api_client.ApiError as e:
        _spool_or_raise(e, spool)
        for sub, _ in submissions:
            spool.add(sub)
    for _, ck in submissions:
        if ck is not None:
            ck.delete()
    return resp


def _drain_resumable(args, api: api_client.AsyncApi, mode: SearchMode,
                     spool) -> None:
    """A lone per-field snapshot cannot resume into a block, so a
    crash-recovered scan finishes through the per-field path first."""
    while _find_resumable(args, mode) is not None:
        run_single_iteration(args, api, mode, spool=spool)


def _claim_block(args, api: api_client.AsyncApi, mode: SearchMode):
    """(block_id, fields), or None when the server predates block leases
    (404): the caller falls back to per-field claims."""
    try:
        return api.claim_block_async(mode, args.claim_block).result()
    except api_client.ApiError as e:
        if e.status == 404:
            log.warning("server has no /claim_block; falling back to "
                        "per-field claims")
            return None
        raise


def run_block_iteration(args, api: api_client.AsyncApi, mode: SearchMode,
                        spool=None) -> bool:
    """Claim one block, process every member, submit them at once. False
    means the server predates block leases and the caller falls back."""
    _drain_resumable(args, api, mode, spool)
    claimed = _claim_block(args, api, mode)
    if claimed is None:
        return False
    block_id, fields = claimed
    log.info("claimed block %s: %d fields", block_id, len(fields))
    submissions = _process_block(args, mode, block_id, fields)
    future = api.submit_block_async(block_id, [s for s, _ in submissions])
    _await_block_submit(future, submissions, spool)
    return True


def run_block_pipelined_loop(args, api: api_client.AsyncApi, mode: SearchMode,
                             spool=None) -> bool:
    """claim block N+1 || process block N || settle the submit of block
    N-1: the 3-stage pipeline over block leases, one round trip per
    --claim-block fields at each stage, until interrupted or a claim fails.
    False = the server has no block support."""
    _drain_resumable(args, api, mode, spool)
    claimed = _claim_block(args, api, mode)
    if claimed is None:
        return False
    block_id, fields = claimed
    pending_submit = None  # (future, submissions) awaiting confirmation
    while True:
        if spool is not None:
            spool.replay(args.api_base)
        log.info("claimed block %s: %d fields", block_id, len(fields))
        next_block = api.claim_block_async(mode, args.claim_block)
        _prefetch_on_claim(next_block, args, mode)
        submissions = _process_block(args, mode, block_id, fields)
        if pending_submit is not None:
            _await_block_submit(*pending_submit, spool)
        pending_submit = (api.submit_block_async(
            block_id, [s for s, _ in submissions]), submissions)
        block_id, fields = next_block.result()


def run_validate(args) -> int:
    """Recompute a double-checked field (of --base, when given) and diff it
    against the server's canonical submission: 0 when the distribution and
    the near misses agree, else 1. No canonical field raises (the server's
    404)."""
    vdata = api_client.get_validation_data_from_server(
        args.api_base, args.username, args.base, args.max_retries)
    log.info("validating field %d: base %d, range [%d, %d)", vdata.field_id,
             vdata.base, vdata.range_start, vdata.range_end)
    data = DataToClient(claim_id=0, base=vdata.base,
                        range_start=vdata.range_start,
                        range_end=vdata.range_end,
                        range_size=vdata.range_size)
    results, _ = process_field(data, args, mode=SearchMode.DETAILED)
    ok = True
    canon_dist = {d.num_uniques: d.count for d in vdata.unique_distribution}
    local_dist = {d.num_uniques: d.count for d in results.distribution}
    if canon_dist != local_dist:
        ok = False
        for k in sorted(set(canon_dist) | set(local_dist)):
            if canon_dist.get(k) != local_dist.get(k):
                log.error("distribution mismatch at %d uniques: canon=%s "
                          "local=%s", k, canon_dist.get(k), local_dist.get(k))
    canon_nums = {(n.number, n.num_uniques) for n in vdata.nice_numbers}
    local_nums = {(n.number, n.num_uniques) for n in results.nice_numbers}
    if canon_nums != local_nums:
        ok = False
        log.error("nice-number mismatch: only-canon=%s only-local=%s",
                  sorted(canon_nums - local_nums),
                  sorted(local_nums - canon_nums))
    if ok:
        log.info("validation passed: local results match canonical submission")
        return 0
    log.error("validation FAILED")
    return 1


def run_tenants(args) -> int:
    """--tenants: parse the tenant specs, claim with tenant routing and run
    every tenant's pages interleaved on this process's device, under the
    sched-slo thread. Each tenant runs one field, or claims until the
    server runs dry with --repeat. 2 when the specs name no tenant."""
    from nice_tpu_torch import sched
    from nice_tpu_torch.ops import autotune

    registry = sched.TenantRegistry(sched.parse_tenants(args.tenants))
    if not len(registry):
        log.error("--tenants parsed to zero tenants")
        return 2
    source = sched.ServerSource(
        args.api_base, args.username,
        fields_per_tenant=None if args.repeat else 1,
        max_retries=args.max_retries,
    )
    scheduler = sched.MultiTenantScheduler(
        registry, source, policy=args.sched_policy,
        page_batches=args.sched_page_batches,
        quantum_secs=args.sched_quantum_secs,
        starvation_rounds=args.sched_starvation_rounds,
        slo_boost=args.sched_slo_boost,
        slo_window_scale=args.slo_window_scale,
        slo_overrides=dict(args.slo_override),
        device=args.device,
        **_mesh_kwargs(args),
    )
    for row in autotune.tenant_report(
            [(s.name, s.mode, s.base, s.backend) for s in registry],
            args.device):
        log.info("tenant %s: %s tuned=%s batch=%d megaloop=%d use_mxu=%d "
                 "page_quantum=%d", row["tenant"], row["key"], row["tuned"],
                 row["batch_size"], row["megaloop"], row["use_mxu"],
                 row["page_quantum"])
    scheduler.start_slo_thread()
    try:
        stats = scheduler.run()
    finally:
        scheduler.stop_slo_thread()
    log.info(
        "scheduler done: %d rounds, occupancy %.2f; per-tenant %s",
        stats["rounds"], stats["occupancy"],
        {t: (v["fields"], v["pages"]) for t, v in stats["tenants"].items()},
    )
    return 0


def _known_servers_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "servers.json")


def _load_known_servers(checkpoint_dir: Optional[str]) -> list[str]:
    """Server endpoints a previous run learned from /status (this package's
    or the JAX client's: the file is the same), merged into the failover
    list at startup, so a restarted client can fail over even when its
    configured primary is the server that died."""
    if not checkpoint_dir:
        return []
    try:
        with open(_known_servers_path(checkpoint_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(data, list):
        return []
    return [s.rstrip("/") for s in data if isinstance(s, str) and s.strip()]


def _save_known_servers(checkpoint_dir: Optional[str],
                        servers: list[str]) -> None:
    if not checkpoint_dir or not servers:
        return
    try:
        os.makedirs(checkpoint_dir, exist_ok=True)
        fsio.atomic_write_json(
            _known_servers_path(checkpoint_dir),
            list(dict.fromkeys(s.rstrip("/") for s in servers)),
        )
    except OSError as e:
        log.debug("failed to persist known servers: %s", e)


def _learn_servers(args) -> None:
    """Persist the server list /status advertises (the primary and its live
    standbys) beside the checkpoints, so that the next run's failover list
    covers them. Called on every telemetry beat; best-effort."""
    if not args.checkpoint_dir:
        return
    try:
        status = api_client.failover_request(args.api_base, "/status",
                                             max_retries=0,
                                             endpoint="telemetry")
        servers = (status.get("repl") or {}).get("servers") or []
        _save_known_servers(args.checkpoint_dir, servers)
    except Exception as e:  # noqa: BLE001 — the list is an optimisation
        log.debug("server-list learn failed: %s", e)


class _TelemetryReporter:
    """The fleet-visibility heartbeat: POSTs /telemetry at once on entry and
    then every args.telemetry_secs, so a long-scanning client shows on the
    server's fleet views before its first submission, and learns the server
    list from /status on each beat (_learn_servers). Failures are logged
    and the scan goes on: telemetry is a side channel. The thread makes no
    torch call."""

    def __init__(self, args, spool):
        self.args = args
        self.spool = spool
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry-report", daemon=True)

    def _report_once(self) -> None:
        try:
            api_client.post_telemetry(self.args.api_base,
                                      _fleet_snapshot(self.args, self.spool))
        except Exception as e:  # noqa: BLE001 — a missed beat is logged
            log.warning("telemetry heartbeat failed: %s", e)
        _learn_servers(self.args)

    def _run(self) -> None:
        self._report_once()
        while not self._stop.wait(self.args.telemetry_secs):
            self._report_once()

    def __enter__(self) -> "_TelemetryReporter":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def telemetry_beat(args, spool=None):
    """The heartbeat of --telemetry-secs as a context manager (nothing when
    it is 0)."""
    if args.telemetry_secs and args.telemetry_secs > 0:
        return _TelemetryReporter(args, spool)
    return nullcontext()


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logsink.install(args.log_level, args.log_file)
    configure_obs(args)
    if args.backend == "device":
        engine.resolve_device(args.device)  # no card: raise before a claim
    if args.benchmark:
        return run_benchmark(args)
    if args.checkpoint_dir and args.backend == "native":
        # The native engine's thread fan-out has no consistent cursor to
        # snapshot; disable rather than write unresumable state.
        log.warning("--checkpoint-dir is not supported with backend "
                    "'native'; checkpointing disabled")
        args.checkpoint_dir = None
    # The failover list: --api-base (itself maybe a list), --servers and
    # what a previous run learned. The joined list IS the api_base from here
    # on: every api_client call (spool replay included) rotates across it.
    server_list = api_client.split_servers(args.api_base)
    if args.servers:
        server_list += api_client.split_servers(args.servers)
    server_list += _load_known_servers(args.checkpoint_dir)
    args.api_base = ",".join(dict.fromkeys(server_list))
    if args.validate:
        return run_validate(args)
    if args.tenants:
        with telemetry_beat(args):
            return run_tenants(args)
    mode = _mode(args)
    spool = spool_mod.maybe_spool(args.spool_dir, args.checkpoint_dir)
    api = api_client.AsyncApi(args.api_base, args.username, args.max_retries,
                              telemetry=lambda: _fleet_snapshot(args, spool))
    # On-disk footprints the resource sampler watches.
    if spool is not None:
        memwatch.watch_path("spool", spool.dir)
    memwatch.watch_path("ckpt", args.checkpoint_dir)
    memwatch.watch_path("trace", trace.sink_path())
    try:
        if spool is not None:
            # Startup replay: deliver anything journaled by a previous run
            # before claiming new work.
            spool.replay(args.api_base)
        with telemetry_beat(args, spool):
            handled = False
            if args.claim_block > 1:
                # The block-lease path; False means the server predates
                # /claim_block, and the per-field loop below runs instead.
                if args.repeat:
                    handled = run_block_pipelined_loop(args, api, mode, spool)
                else:
                    handled = run_block_iteration(args, api, mode, spool)
            if not handled:
                if args.repeat:
                    run_pipelined_loop(args, api, mode, spool=spool)
                else:
                    run_single_iteration(args, api, mode, spool=spool)
    except KeyboardInterrupt:
        log.info("interrupted; shutting down")
    finally:
        api.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
