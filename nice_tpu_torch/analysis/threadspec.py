"""ThreadRegistry of the port: the declared ground truth racelint's R-rules
hold ``nice_tpu_torch/`` and ``chip_smoke.py`` to (the twin of
nice_tpu/analysis/threadspec.py, with the port's own entries).

* :class:`ThreadRoot` — every thread the port starts: where it is spawned
  (file + enclosing scope), what code it runs, its role, which locks it is
  expected to take, and whether it may block. R1 cross-checks the registry
  against every ``threading.Thread(`` / ``ThreadPoolExecutor(`` /
  ``ThreadingHTTPServer(`` construction: an unregistered spawn is a
  finding, a registered root with no surviving spawn site is stale.
* :class:`LockSpec` — every ``lockdep.make_lock``/``make_rlock`` label, what
  it guards, and whether blocking work is legitimate while holding it (the
  nvcc build locks exist to serialize a build; a metrics cell lock must
  never be held across I/O). R3 flags blocking calls under
  ``may_block_under=False`` locks; an undeclared label is an R2 finding.
* :class:`SharedState` — per-object ownership declarations (lock-guarded,
  owner-thread-only, immutable-after-init, queue-transferred, or
  GIL-atomic). R2 verifies write sites against the declaration; R1 flags
  multi-root mutation of anything UNDECLARED with no common lock.

The mesh's dispatch path (parallel/mesh.py, the engine's _mesh_loop) starts
no thread of its own: each slice's feed is an engine-feed root and its
readbacks a collector root.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "ThreadRoot",
    "LockSpec",
    "SharedState",
    "THREAD_ROOTS",
    "LOCK_SPECS",
    "SHARED_STATE",
    "roots_by_site",
    "lock_spec",
    "shared_state_for",
    "SPAWN_KINDS",
]

# Call-name suffix -> spawn kind the coverage gate matches on.
SPAWN_KINDS = {
    "Thread": "thread",
    "ThreadPoolExecutor": "pool",
    "ThreadingHTTPServer": "http-server",
}


@dataclasses.dataclass(frozen=True)
class ThreadRoot:
    """One registered thread root (or pool)."""

    name: str            # runtime thread name, or a symbolic id for pools
    path: str            # repo-relative file containing the spawn call
    spawn_scope: str     # qualified function enclosing the spawn call
    entries: Tuple[str, ...]  # qualnames (in ``path``) the root executes;
                              # empty = stdlib code only (serve_forever)
    role: str            # producer | collector | worker-pool | periodic
                         # | http-server | helper
    kind: str = "thread"  # thread | pool | http-server
    may_block: bool = True
    locks: Tuple[str, ...] = ()   # lockdep labels this root may acquire
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class LockSpec:
    label: str
    guards: str
    may_block_under: bool = False


@dataclasses.dataclass(frozen=True)
class SharedState:
    path: str            # repo-relative file owning the object
    scope: str           # class name, or "<module>" for module globals
    attr: str
    ownership: str       # "lock:<label>" | "owner:<root-name>" |
                         # "immutable-after-init" | "queue-transferred" |
                         # "atomic"
    notes: str = ""

    @property
    def lock_label(self) -> Optional[str]:
        if self.ownership.startswith("lock:"):
            return self.ownership.split(":", 1)[1]
        return None

    @property
    def owner_root(self) -> Optional[str]:
        if self.ownership.startswith("owner:"):
            return self.ownership.split(":", 1)[1]
        return None


_ENGINE = "nice_tpu_torch/ops/engine.py"
_CLIENT = "nice_tpu_torch/client/main.py"

THREAD_ROOTS: Tuple[ThreadRoot, ...] = (
    # ----------------------------------------------------- ops/engine.py
    ThreadRoot(
        name="engine-feed",
        path=_ENGINE,
        spawn_scope="_SliceFeed._start",
        entries=("_SliceFeed._fill",),
        role="producer",
        notes="the pipelined loop's producer: blocks of FEED_BLOCK items "
              "into a bounded queue (feed_depth 0 starts no thread); one a "
              "slice on a mesh. A loop thread for lockdep's long holds",
    ),
    ThreadRoot(
        name="detailed-collect",
        path=_ENGINE,
        spawn_scope="_Collector.__init__",
        entries=("_Collector._run",),
        role="collector",
        locks=("obs.metrics._Metric._lock",),
        notes="the detailed loop's readbacks, rare-path re-scans, folds and "
              "checkpoints: the only thread that touches the histogram",
    ),
    ThreadRoot(
        name="niceonly-collect",
        path=_ENGINE,
        spawn_scope="_Collector.__init__",
        entries=("_Collector._run",),
        role="collector",
        notes="the strided niceonly pipeline's counts and audits",
    ),
    ThreadRoot(
        name="dense-collect",
        path=_ENGINE,
        spawn_scope="_Collector.__init__",
        entries=("_Collector._run",),
        role="collector",
        notes="the dense (b98 and up) loop's readbacks",
    ),
    ThreadRoot(
        name="niceonly-msd",
        path=_ENGINE,
        spawn_scope="_niceonly_strided",
        entries=("_niceonly_strided.<locals>.produce",),
        role="producer",
        locks=("ops.adaptive_floor._CONTROLLERS_LOCK",
               "ops.adaptive_floor.AdaptiveFloor._lock"),
        notes="the MSD filter's producer, feeding descriptor groups",
    ),
    ThreadRoot(
        name="niceonly-msd-pool",
        path=_ENGINE,
        spawn_scope="_niceonly_strided.<locals>.produce",
        entries=(),
        role="worker-pool",
        kind="pool",
        notes="scoped with-block pool of the MSD recursion inside the "
              "producer",
    ),
    ThreadRoot(
        name="native-detailed-pool",
        path=_ENGINE,
        spawn_scope="_native_detailed",
        entries=(),
        role="worker-pool",
        kind="pool",
        notes="scoped with-block pool of the host library's detailed scan",
    ),
    ThreadRoot(
        name="native-niceonly-pool",
        path=_ENGINE,
        spawn_scope="_native_niceonly",
        entries=(),
        role="worker-pool",
        kind="pool",
        notes="scoped with-block pool of the host library's niceonly scan",
    ),
    # ---------------------------------------------------------- client/
    ThreadRoot(
        name="nice-prefetch",
        path=_CLIENT,
        spawn_scope="_prefetch_on_claim.<locals>._cb",
        entries=("_prefetch_on_claim.<locals>._cb.<locals>._warm_all",),
        role="helper",
        locks=("ops.cuda_build._lock", "ops.cuda_build._plan_locks",
               "native._lock"),
        notes="builds the next claim's libraries (nvcc, g++) while a field "
              "runs; no launch and no torch call",
    ),
    ThreadRoot(
        name="claim-renew",
        path=_CLIENT,
        spawn_scope="_ClaimRenewer.__init__",
        entries=("_ClaimRenewer._run",),
        role="periodic",
        locks=("client.api_client._epoch_lock",),
    ),
    ThreadRoot(
        name="block-renew",
        path=_CLIENT,
        spawn_scope="_ClaimRenewer.__init__",
        entries=("_ClaimRenewer._run",),
        role="periodic",
        locks=("client.api_client._epoch_lock",),
        notes="_BlockRenewer's thread, spawned by the base class",
    ),
    ThreadRoot(
        name="telemetry-report",
        path=_CLIENT,
        spawn_scope="_TelemetryReporter.__init__",
        entries=("_TelemetryReporter._run",),
        role="periodic",
        locks=("obs.telemetry._lock", "client.api_client._epoch_lock"),
    ),
    ThreadRoot(
        name="nice-api",
        path="nice_tpu_torch/client/api_client.py",
        spawn_scope="AsyncApi.__init__",
        entries=(),
        role="worker-pool",
        kind="pool",
        locks=("client.api_client._epoch_lock",
               "client.api_client._failover_lock",
               "client.api_client._dead_hosts_lock"),
        notes="claim/submit overlap: futures consumed by the client loop",
    ),
    # ----------------------------------------------------------- sched/
    ThreadRoot(
        name="sched-slo",
        path="nice_tpu_torch/sched/scheduler.py",
        spawn_scope="MultiTenantScheduler.start_slo_thread",
        entries=("MultiTenantScheduler.start_slo_thread.<locals>._slo_run",),
        role="periodic",
        locks=("sched.scheduler.MultiTenantScheduler._lock",
               "obs.slo.SloEngine._lock",
               "obs.history.HistoryStore._lock"),
        notes="per-tenant SLO burn evaluation; makes no torch call",
    ),
    # ------------------------------------------------------------- obs/
    ThreadRoot(
        name="nice-history",
        path="nice_tpu_torch/obs/history.py",
        spawn_scope="maybe_start_sampler",
        entries=("maybe_start_sampler.<locals>._run",),
        role="periodic",
        locks=("obs.history._sampler_lock", "obs.history.HistoryStore._lock"),
    ),
    ThreadRoot(
        name="nice-memwatch",
        path="nice_tpu_torch/obs/memwatch.py",
        spawn_scope="maybe_start_sampler",
        entries=("maybe_start_sampler.<locals>._run",),
        role="periodic",
        locks=("obs.memwatch._sampler_lock", "obs.memwatch._lock"),
        notes="--memwatch-secs 0 starts no thread",
    ),
    ThreadRoot(
        name="nice-pyprof",
        path="nice_tpu_torch/obs/pyprof.py",
        spawn_scope="maybe_start",
        entries=("maybe_start.<locals>._run",),
        role="periodic",
        locks=("obs.pyprof._started_lock", "obs.pyprof._lock"),
        notes="wall-clock sampler over sys._current_frames() (--pyprof-hz "
              "0 starts no thread)",
    ),
    ThreadRoot(
        name="nice-metrics-httpd",
        path="nice_tpu_torch/obs/serve.py",
        spawn_scope="serve_metrics",
        entries=(),
        role="http-server",
        kind="http-server",
        notes="per-connection handler threads of the local /metrics port",
    ),
    ThreadRoot(
        name="nice-metrics",
        path="nice_tpu_torch/obs/serve.py",
        spawn_scope="serve_metrics",
        entries=(),
        role="http-server",
        locks=("obs.serve._started_lock",),
        notes="runs stdlib serve_forever",
    ),
    # --------------------------------------------------------- scripts/
    ThreadRoot(
        name="bench-case",
        path="nice_tpu_torch/scripts/bench.py",
        spawn_scope="run_case_capped",
        entries=("run_case_capped.<locals>.work",),
        role="helper",
        notes="bench-<mode>: one case under a wall cap, joined with a "
              "timeout",
    ),
    ThreadRoot(
        name="kernel-ab-build",
        path="nice_tpu_torch/scripts/kernel_ab.py",
        spawn_scope="build",
        entries=(),
        role="worker-pool",
        kind="pool",
        notes="one tree's nvcc builds at once (cuda_build.nvcc_library, "
              "no lock)",
    ),
    ThreadRoot(
        name="kernel-ab-trees",
        path="nice_tpu_torch/scripts/kernel_ab.py",
        spawn_scope="main",
        entries=(),
        role="worker-pool",
        kind="pool",
        notes="every tree's builds at once",
    ),
    ThreadRoot(
        name="smoke-build",
        path="chip_smoke.py",
        spawn_scope="phase_build",
        entries=(),
        role="worker-pool",
        kind="pool",
        locks=("ops.cuda_build._lock", "native._lock"),
        notes="the smoke's build phase: every nvcc and g++ build at once "
              "(cuda_build.build_plan takes no lock)",
    ),
)


LOCK_SPECS: Tuple[LockSpec, ...] = (
    # may_block_under=True is reserved for locks that exist to serialize a
    # blocking resource: holding them across I/O is the point, not a bug.
    LockSpec("ops.cuda_build._lock",
             "the main library's build and load, and the per-header lock "
             "table", may_block_under=True),
    LockSpec("ops.cuda_build._plan_locks",
             "one per generated header: its nvcc build and load. Every "
             "header's lock has this label; load_plan holds one at a time "
             "(never two), so lockdep's same-label re-entry rule loses no "
             "order", may_block_under=True),
    LockSpec("native._lock", "the host library's g++ build and load",
             may_block_under=True),
    LockSpec("ops.autotune._lock",
             "the winners table: its load, lookups and atomic rewrite",
             may_block_under=True),
    LockSpec("ops.adaptive_floor.AdaptiveFloor._lock", "controller state"),
    LockSpec("ops.adaptive_floor._CONTROLLERS_LOCK",
             "controller registry dict"),
    LockSpec("ops.engine._mesh_cache_lock",
             "slice tuple -> mesh cache + generation counter"),
    LockSpec("parallel.mesh._dead_lock", "simulated-dead slice set"),
    LockSpec("parallel.mesh._step_lock", "per-slice step cache"),
    LockSpec("parallel.mesh.OccupancyMeter._lock",
             "busy-interval accumulator + observation window"),
    LockSpec("sched.scheduler.MultiTenantScheduler._lock",
             "per-tenant deficit/skip/boost maps + run counters"),
    LockSpec("faults.injector.FaultPlan._lock", "fault plan counters"),
    LockSpec("faults.injector._plan_lock", "active plan slot"),
    LockSpec("client.main._progress_logger.lock", "progress line state"),
    LockSpec("client.api_client._epoch_lock",
             "last-seen replication epoch stamped on outgoing writes"),
    LockSpec("client.api_client._dead_hosts_lock",
             "dead-endpoint marks used to evict pooled keep-alive sockets"),
    LockSpec("client.api_client._failover_lock",
             "sticky per-server-list failover cursor + its generation"),
    LockSpec("obs.telemetry._lock", "telemetry buffer"),
    LockSpec("obs.history.HistoryStore._lock", "history ring",
             may_block_under=True),
    LockSpec("obs.history._sampler_lock", "sampler once-guard"),
    LockSpec("obs.trace._lock", "span sink + its rotation",
             may_block_under=True),
    LockSpec("obs.metrics._Metric._lock", "metric cells"),
    LockSpec("obs.metrics.Registry._lock", "metric registry"),
    LockSpec("obs.slo.SloEngine._lock", "SLO windows"),
    LockSpec("obs.stepprof._state_lock", "stepprof install state"),
    LockSpec("obs.stepprof.StepProfiler._lock",
             "one profiled field's buckets (built only when enabled)"),
    LockSpec("obs.flight.FlightRecorder._lock", "flight ring"),
    LockSpec("obs.flight._install_lock", "recorder install slot"),
    LockSpec("obs.memwatch._lock", "watched-path table + last sample",
             may_block_under=True),
    LockSpec("obs.memwatch._sampler_lock", "memwatch sampler once-guard"),
    LockSpec("obs.pyprof._lock", "folded-stack tables + sample counters"),
    LockSpec("obs.pyprof._started_lock", "pyprof sampler once-guard"),
    LockSpec("obs.serve._started_lock", "metrics-server once-guard"),
    LockSpec("obs.journal._client_lock", "client event buffer"),
    LockSpec("analysis.schedex.zero_cost_report",
             "minted only to time make_lock's off path against a raw lock; "
             "never shared"),
)


SHARED_STATE: Tuple[SharedState, ...] = (
    # client/api_client.py — module state shared by the client loop, the
    # nice-api pool, the renewers and the telemetry reporter.
    SharedState("nice_tpu_torch/client/api_client.py", "<module>",
                "_last_epoch", "lock:client.api_client._epoch_lock"),
    SharedState("nice_tpu_torch/client/api_client.py", "<module>",
                "_dead_hosts", "lock:client.api_client._dead_hosts_lock"),
    SharedState("nice_tpu_torch/client/api_client.py", "<module>",
                "_failover_idx", "lock:client.api_client._failover_lock",
                notes="gen-checked store; replayed by the schedex pair "
                      "failover_cursor_rotate_vs_store / _prefix"),
    SharedState("nice_tpu_torch/client/api_client.py", "<module>",
                "_failover_gen", "lock:client.api_client._failover_lock"),
    # ops/engine.py — the mesh cache rebuilt on elastic downshift.
    SharedState("nice_tpu_torch/ops/engine.py", "<module>", "_MESH_CACHE",
                "lock:ops.engine._mesh_cache_lock"),
    SharedState("nice_tpu_torch/ops/engine.py", "<module>",
                "_MESH_CACHE_GEN", "lock:ops.engine._mesh_cache_lock",
                notes="downshift generation; a rebuild that started before "
                      "an invalidation must not repopulate the cache"),
    # parallel/mesh.py — the dead-slice registry the drills and probes
    # write and every mesh build reads.
    SharedState("nice_tpu_torch/parallel/mesh.py", "<module>",
                "_simulated_dead", "lock:parallel.mesh._dead_lock"),
    # ops/adaptive_floor.py — one MSD-floor controller a pipeline, made on
    # first use by whichever thread asks.
    SharedState("nice_tpu_torch/ops/adaptive_floor.py", "<module>",
                "_CONTROLLERS", "lock:ops.adaptive_floor._CONTROLLERS_LOCK"),
    # faults/injector.py — the active plan, swapped by configure()/reset()
    # while the dispatch sites read it.
    SharedState("nice_tpu_torch/faults/injector.py", "<module>", "_plan",
                "lock:faults.injector._plan_lock"),
    # sched/scheduler.py — the run loop mutates these while the sched-slo
    # periodic and stats() readers look on.
    SharedState("nice_tpu_torch/sched/scheduler.py", "MultiTenantScheduler",
                "_boost", "lock:sched.scheduler.MultiTenantScheduler._lock"),
    SharedState("nice_tpu_torch/sched/scheduler.py", "MultiTenantScheduler",
                "_deficit",
                "lock:sched.scheduler.MultiTenantScheduler._lock"),
    SharedState("nice_tpu_torch/sched/scheduler.py", "MultiTenantScheduler",
                "_skipped",
                "lock:sched.scheduler.MultiTenantScheduler._lock"),
    SharedState("nice_tpu_torch/sched/scheduler.py", "MultiTenantScheduler",
                "_exhausted",
                "lock:sched.scheduler.MultiTenantScheduler._lock"),
    # Per-instance slots of threads that run the same code on several
    # roots: each instance has one writer, its own thread, and its owner
    # reads the slot after the thread ends.
    SharedState(_ENGINE, "_Collector", "_err", "atomic",
                notes="set by the instance's collector thread on failure; "
                      "read by the caller through failed()/"
                      "raise_if_failed() and after shutdown's join"),
    SharedState(_CLIENT, "_ClaimRenewer", "renewals", "atomic",
                notes="incremented by the instance's own renew thread "
                      "(claim-renew or block-renew); read after __exit__ "
                      "joins it"),
    # utils/lockdep.py — the loop-thread set, under lockdep's own plain
    # _state_lock (the instrumentation does not instrument itself).
    SharedState("nice_tpu_torch/utils/lockdep.py", "<module>",
                "_loop_thread_ids", "atomic",
                notes="added to by the feed and collector threads under "
                      "lockdep's private plain lock"),
    # obs/ — sampler once-guards and tables.
    SharedState("nice_tpu_torch/obs/history.py", "<module>",
                "_sampler_started", "lock:obs.history._sampler_lock"),
    SharedState("nice_tpu_torch/obs/memwatch.py", "<module>", "_watched",
                "lock:obs.memwatch._lock"),
    SharedState("nice_tpu_torch/obs/memwatch.py", "<module>",
                "_sampler_started", "lock:obs.memwatch._sampler_lock"),
    SharedState("nice_tpu_torch/obs/pyprof.py", "<module>", "_tables",
                "lock:obs.pyprof._lock"),
    SharedState("nice_tpu_torch/obs/pyprof.py", "<module>", "_started",
                "lock:obs.pyprof._started_lock"),
)


def roots_by_site() -> Dict[Tuple[str, str, str], Tuple[ThreadRoot, ...]]:
    """(path, spawn_scope, kind) -> registered roots at that site."""
    out: Dict[Tuple[str, str, str], list] = {}
    for root in THREAD_ROOTS:
        out.setdefault((root.path, root.spawn_scope, root.kind),
                       []).append(root)
    return {k: tuple(v) for k, v in out.items()}


def lock_spec(label: str) -> Optional[LockSpec]:
    for spec in LOCK_SPECS:
        if spec.label == label:
            return spec
    return None


def shared_state_for(path: str, scope: str,
                     attr: str) -> Optional[SharedState]:
    for decl in SHARED_STATE:
        if decl.path == path and decl.scope == scope and decl.attr == attr:
            return decl
    return None
