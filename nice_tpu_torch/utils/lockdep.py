"""Runtime lock-order instrumentation of the port (the dynamic half of
nicelint X1; the twin of nice_tpu/utils/lockdep.py).

With lockdep on (``configure("on")``), every lock of the port built through
:func:`make_lock` / :func:`make_rlock` is an instrumented wrapper that
records, per thread, the stack of locks it holds. Each time a thread takes
lock B while holding lock A, the directed edge A->B enters a process-global
order graph; an acquisition that would close a cycle (B ⟶* A already
exists) is an ``order-cycle`` violation, with both acquisition sites. So an
ABBA deadlock is caught without ever having to deadlock.

A lock held longer than ``hold_secs`` on a thread registered through
:func:`mark_loop_thread` (the pipelined loop's feed and collector threads,
which hand the card its work) is a ``long-hold`` violation. ``"strict"``
makes callers fail on long holds too; under ``"on"`` they are reported.

Off (the default) the factories return the plain stdlib objects: no
wrapper, no cost on any acquisition. The switch is a call, not an
environment variable, and locks are built when their module is imported
or their object constructed: switch lockdep on in a fresh process before
any module of the port that builds a lock is imported, which is what

    python -m nice_tpu_torch.utils.lockdep --device cuda|cpu --dump-graph P

does before it drives the port's main paths (``_exercise``) and writes
the observed graph (``dump_graph``) that racelint R2 holds against X1's
static graph. This module imports nothing of the port at import time.

Cycle detection is by NAME (the label given to make_lock), as X1's static
graph is, so the two reports line up.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Set

__all__ = [
    "configure",
    "enabled",
    "strict",
    "make_lock",
    "make_rlock",
    "mark_loop_thread",
    "violations",
    "violation_count",
    "order_edges",
    "reset",
    "set_factory_hook",
    "factory_hook",
    "dump_graph",
]

MODES = ("off", "on", "strict")
DEFAULT_HOLD_SECS = 0.25

_mode = "off"
_hold_secs = DEFAULT_HOLD_SECS


def configure(mode: str = "off", hold_secs: float = DEFAULT_HOLD_SECS) -> None:
    """Switch lockdep: "off", "on" or "strict" (long holds fail too), and
    the long-hold threshold in seconds. Locks built before the switch stay
    what they were built as."""
    global _mode, _hold_secs
    if mode not in MODES:
        raise ValueError(f"lockdep mode {mode!r} is not one of {MODES}")
    if hold_secs < 0:
        raise ValueError(f"hold_secs must be >= 0, got {hold_secs}")
    _mode = mode
    _hold_secs = float(hold_secs)


def enabled() -> bool:
    return _mode != "off"


def strict() -> bool:
    return _mode == "strict"


# Internal state. _state_lock is a PLAIN threading.Lock on purpose: the
# instrumentation must never instrument itself.
_state_lock = threading.Lock()
_tls = threading.local()

# name -> set of names acquired while holding <name>
_graph: Dict[str, Set[str]] = {}
# (outer, inner) -> first-observed acquisition site
_edge_sites: Dict[tuple, str] = {}
_violations: List[dict] = []
_loop_thread_ids: Set[int] = set()


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def mark_loop_thread(ident: Optional[int] = None) -> None:
    """Register the calling (or given) thread as a loop thread for
    long-hold attribution. A no-op when lockdep is off."""
    if not enabled():
        return
    with _state_lock:
        _loop_thread_ids.add(
            threading.get_ident() if ident is None else ident
        )


def _site(skip: int = 3) -> str:
    """A one-line acquisition site, e.g. 'engine.py:301 in _run'."""
    for frame in reversed(traceback.extract_stack(limit=skip + 4)[: -skip]):
        fn = frame.filename
        if "lockdep" in fn:
            continue
        return f"{fn.rsplit('/', 1)[-1]}:{frame.lineno} in {frame.name}"
    return "<unknown>"


def _path_exists(src: str, dst: str) -> bool:
    """DFS: does src reach dst in the order graph? Caller holds _state_lock."""
    seen = {src}
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        for nxt in _graph.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return False


def _record_acquire(name: str) -> None:
    stack = _held_stack()
    if any(entry[0] == name for entry in stack):
        # Re-entrant hold of the same named lock (RLock recursion, or two
        # sibling instances sharing a name): no ordering information.
        stack.append((name, time.monotonic(), False))
        return
    if stack:
        outer = stack[-1][0]
        with _state_lock:
            if name not in _graph.get(outer, ()):
                # New edge outer->name: a cycle exists iff name already
                # reaches outer. The site is taken for new edges only: an
                # edge keeps its first site.
                site = _site()
                if _path_exists(name, outer):
                    _violations.append({
                        "kind": "order-cycle",
                        "edge": (outer, name),
                        "site": site,
                        "reverse_site": _edge_sites.get((name, outer))
                        or _first_site_reaching(name, outer),
                        "thread": threading.current_thread().name,
                        "held": [e[0] for e in stack],
                    })
                _graph.setdefault(outer, set()).add(name)
                _edge_sites.setdefault((outer, name), site)
    stack.append((name, time.monotonic(), True))


def _first_site_reaching(src: str, dst: str) -> Optional[str]:
    """The site of the first edge on some src⟶dst path (for the cycle
    report). Caller holds _state_lock."""
    for nxt in _graph.get(src, ()):
        if nxt == dst or _path_exists(nxt, dst):
            return _edge_sites.get((src, nxt))
    return None


def _record_release(name: str) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            _, t0, outermost = stack.pop(i)
            if outermost:
                held_for = time.monotonic() - t0
                threshold = _hold_secs
                if held_for > threshold:
                    ident = threading.get_ident()
                    with _state_lock:
                        if ident in _loop_thread_ids:
                            _violations.append({
                                "kind": "long-hold",
                                "lock": name,
                                "held_secs": round(held_for, 4),
                                "threshold_secs": threshold,
                                "thread": threading.current_thread().name,
                                "site": _site(),
                            })
            return
    # Release of a lock this thread never recorded (taken before the switch
    # or handed across threads): ignored; the real lock is released anyway.


class _DepLock:
    """Instrumented Lock/RLock: the same acquire/release/context-manager
    surface, recording order edges and hold times around the real lock."""

    __slots__ = ("_name", "_lock")

    def __init__(self, name: str, lock):
        self._name = name
        self._lock = lock

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            _record_acquire(self._name)
        return got

    def release(self) -> None:
        self._lock.release()
        _record_release(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<DepLock {self._name} wrapping {self._lock!r}>"


# Factory hook: schedex (analysis/schedex.py) swaps the port's locks for its
# scheduled wrappers during an instrument() window. None otherwise, so
# make_lock's only added cost is this one global load.
_factory_hook = None


def set_factory_hook(hook) -> None:
    """Install (or clear, with None) the schedex lock factory hook."""
    global _factory_hook
    _factory_hook = hook


def factory_hook():
    return _factory_hook


def make_lock(name: str):
    """A threading.Lock, instrumented when lockdep is on. ``name`` labels
    the lock in the order graph: the dotted attribute path under the
    package (e.g. "ops.engine._mesh_cache_lock"), so that runtime reports
    line up with X1's static graph."""
    if _factory_hook is not None:
        return _factory_hook(name, "lock")
    return _DepLock(name, threading.Lock()) if enabled() else threading.Lock()


def make_rlock(name: str):
    """A threading.RLock, instrumented when lockdep is on."""
    if _factory_hook is not None:
        return _factory_hook(name, "rlock")
    return (
        _DepLock(name, threading.RLock()) if enabled() else threading.RLock()
    )


def violations() -> List[dict]:
    with _state_lock:
        return list(_violations)


def violation_count() -> int:
    with _state_lock:
        return len(_violations)


def order_edges() -> Dict[str, Set[str]]:
    """Snapshot of the observed acquisition-order graph."""
    with _state_lock:
        return {k: set(v) for k, v in _graph.items()}


def reset() -> None:
    """Drop all recorded state (tests)."""
    with _state_lock:
        _graph.clear()
        _edge_sites.clear()
        _violations.clear()
        _loop_thread_ids.clear()


GRAPH_RELPATH = "nice_tpu_torch/analysis/lockorder.json"


def dump_graph(path: str, merge: bool = True) -> dict:
    """Write the observed name-level order graph as JSON (what racelint R2
    holds against X1's static graph). ``merge=True`` unions it with the
    file's edges, so a run that drives fewer paths never forgets an edge
    another run observed. Returns the edge dict that was written."""
    import json
    import os

    from nice_tpu_torch.utils import fsio

    edges = {k: sorted(v) for k, v in order_edges().items()}
    if merge and os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as f:
                old = json.load(f).get("edges", {})
        except (OSError, ValueError):
            old = {}
        for outer, inners in old.items():
            edges[outer] = sorted(set(edges.get(outer, [])) | set(inners))
    payload = {
        "comment": "observed lockdep acquisition-order graph of the port; "
                   "regenerate with `python -m nice_tpu_torch.utils.lockdep "
                   f"--device cuda --dump-graph {GRAPH_RELPATH}` (merges, "
                   "never forgets edges)",
        "edges": dict(sorted(edges.items())),
    }
    fsio.atomic_write_text(path, json.dumps(payload, indent=1) + "\n")
    return edges


# -- the exercise: the port's main paths under lockdep -----------------------

# A b40 number with a near miss (num_uniques past the cutoff): the default
# mid-range field is centred on it, so a field of any size reaches K2.
NEAR_MISS_B40 = 3621949312977
MESH_SLICES = 4
MESH_DRILL = "mesh.dispatch:dead:1@100"
DENSE_BASE = 98
# The seed of the default b98 field's draw (engine.surviving_field: the
# range's first field is pruned whole at full width, and K4 never runs).
DENSE_SEED = 0
# The kernels (cuda_engine.LAUNCHES keys) each step must launch on a card.
STEP_KERNELS = {"detailed+prefetch": ("detailed_megaloop",),
                "mid-range": ("uniques",),
                "niceonly": ("strided_niceonly",),
                "b98-surviving": ("niceonly_dense",),
                "mesh-drill": ("detailed_megaloop",),
                "sched": ("detailed_megaloop", "strided_niceonly")}
# A plan-tier base no other path of the exercise (or of chip_smoke.py)
# builds: the prefetch warm builds its per-base library while the detailed
# field runs.
PREFETCH_BASE = 95
# The history and memwatch samplers' and sched-slo's interval: several ticks
# inside a run of a few seconds.
SAMPLER_SECS = 0.5


def _pairs(results) -> list:
    return [[[d.num_uniques, d.count] for d in results.distribution],
            [[n.number, n.num_uniques] for n in results.nice_numbers]]


def _field(base: int, start: int, size: int):
    from nice_tpu_torch.core.types import DataToClient

    return DataToClient(claim_id=0, base=base, range_start=start,
                        range_end=start + size, range_size=size)


def _exercise(device: str = "cuda", size: Optional[int] = None,
              batch_size: Optional[int] = None,
              mid_range_start: Optional[int] = None,
              dense_start: Optional[int] = None,
              drill: str = MESH_DRILL,
              checkpoint_batches: int = 64) -> dict:
    """Drive the port's main paths on ``device`` with every thread they
    start: the obs samplers (history, memwatch, pyprof, the metrics
    server), then

    * detailed: extra-large (b40 from the range's start) through the
      client's process_field with a checkpoint ticker (a state every
      ``checkpoint_batches``), while the client's prefetch hook warms
      PREFETCH_BASE on its nice-prefetch thread (its nvcc build on the
      card);
    * mid-range: a b40 detailed field holding near misses (K2's path);
    * niceonly: extra-large in niceonly mode (the MSD threads, the
      collector, K3);
    * b98-surviving: a b98 niceonly field the MSD filter does not prune
      whole (the dense loop, K4; by default engine.surviving_field's draw
      with DENSE_SEED);
    * mesh: extra-large detailed on MESH_SLICES logical slices of the
      device under the fault drill ``drill`` (the mesh cache, the
      downshift);
    * sched: a two-tenant scheduler run (extra-large detailed and
      niceonly) with its sched-slo thread running.

    ``size`` cuts every field to that many numbers (None: full width, 1e9).
    A failed step raises: nothing is skipped, and on a card a step that
    launched none of its STEP_KERNELS fails too. Returns {"ran": [...],
    "results": {flow: [histogram pairs, near-miss pairs]}, ...}."""
    from concurrent.futures import Future

    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.core.types import SearchMode
    from nice_tpu_torch.faults import injector as faults
    from nice_tpu_torch.obs import series, stepprof
    from nice_tpu_torch.ops import cuda_build, cuda_engine as ce, engine
    from nice_tpu_torch.ops.limbs import get_plan
    from nice_tpu_torch.parallel import mesh as pmesh
    from nice_tpu_torch.sched import (MultiTenantScheduler, StaticSource,
                                      TenantRegistry, TenantSpec)

    xl = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    size = xl.range_size if size is None else int(size)
    xl = _field(xl.base, xl.range_start, size)
    if mid_range_start is None:
        mid_range_start = NEAR_MISS_B40 - size // 2
    mid = _field(40, mid_range_start, size)
    if dense_start is None:
        dense_start = engine.surviving_field(DENSE_BASE, size, DENSE_SEED,
                                             device=device).range_start
    dense = _field(DENSE_BASE, dense_start, size)

    argv = ["detailed", "--device", device, "--telemetry-secs", "0",
            "--pyprof-hz", "20", "--memwatch-secs", str(SAMPLER_SECS),
            "--history-secs", str(SAMPLER_SECS), "--metrics-port", "0",
            "--stepprof", "--checkpoint-batches", str(checkpoint_batches)]
    if batch_size is not None:
        argv += ["--batch-size", str(batch_size)]
    args = client.build_parser().parse_args(argv)
    client.configure_obs(args)
    ran: List[str] = ["samplers"]
    results: Dict[str, list] = {}
    out: dict = {"ran": ran, "results": results}

    class _Saves:
        def __init__(self):
            self.states = 0

        def save(self, state) -> None:
            self.states += 1

    def _run(name, fn):
        before = dict(ce.LAUNCHES)
        t0 = time.monotonic()
        fn()
        out.setdefault("secs", {})[name] = round(time.monotonic() - t0, 4)
        idle = [k for k in STEP_KERNELS.get(name, ())
                if ce.LAUNCHES[k] == before.get(k, 0)]
        if device != "cpu" and idle:
            raise RuntimeError(f"{name} launched none of {idle}")
        ran.append(name)

    def detailed():
        header = ce.plan_header(get_plan(PREFETCH_BASE))
        claim = Future()
        client._prefetch_on_claim(claim, args, SearchMode.DETAILED)
        claim.set_result(_field(PREFETCH_BASE,
                                get_plan(PREFETCH_BASE).range_start, size))
        saves = _Saves()
        got, _ = client.process_field(xl, args, checkpointer=saves)
        for t in threading.enumerate():
            if t.name == "nice-prefetch":
                t.join()
        if device != "cpu":
            if header not in cuda_build.PLAN_BUILDS:
                raise RuntimeError(f"the prefetch warm did not load "
                                   f"b{PREFETCH_BASE}'s library")
            out["prefetch_nvcc_secs"] = \
                cuda_build.PLAN_BUILDS[header]["seconds"]
        if saves.states == 0:
            raise RuntimeError("the checkpoint ticker saved no state")
        results["extra-large"] = _pairs(got)
        out["checkpoints"] = saves.states

    def mid_range():
        got, _ = client.process_field(mid, args)
        if not got.nice_numbers:
            raise RuntimeError("the mid-range field holds no near miss")
        results["mid-range"] = _pairs(got)

    def niceonly():
        got, _ = client.process_field(xl, args, mode=SearchMode.NICEONLY)
        results["extra-large-niceonly"] = _pairs(got)

    def b98():
        got, _ = client.process_field(dense, args, mode=SearchMode.NICEONLY)
        if not engine.LAST_NICEONLY_STATS.get("runs"):
            raise RuntimeError(f"the MSD filter pruned the b{DENSE_BASE} "
                               f"field from {dense.range_start} whole")
        results["b98-surviving"] = _pairs(got)

    def mesh():
        slices = [("cuda:0" if device == "cuda" else device)] * MESH_SLICES
        faults.configure(drill)
        try:
            got = engine.process_range_detailed(
                xl.to_field_size(), xl.base, device=device, devices=slices,
                batch_size=batch_size)
            stats = dict(engine.LAST_FEED_STATS)
        finally:
            faults.reset()
            pmesh.heal_devices()
        if stats.get("reshards") != 1:
            raise RuntimeError(f"the mesh drill {drill} did not downshift "
                               f"once: {stats}")
        results["mesh-drill"] = _pairs(got)
        out["mesh"] = {"n_dev_start": stats.get("n_dev_start"),
                       "n_dev_end": stats.get("n_dev_end")}

    def sched():
        fields = {"canon": xl, "nice": xl}
        specs = [TenantSpec(name="canon", mode="detailed", base=40,
                            priority=3, batch_size=batch_size),
                 TenantSpec(name="nice", mode="niceonly", base=40,
                            priority=1, batch_size=batch_size)]
        source = StaticSource({n: [(n, d.base, d.range_start, d.range_end)]
                               for n, d in fields.items()})
        scheduler = MultiTenantScheduler(TenantRegistry(specs), source,
                                         device=device)
        scheduler.start_slo_thread(interval=SAMPLER_SECS)
        try:
            stats = scheduler.run()
        finally:
            scheduler.stop_slo_thread()
        for name in fields:
            got = source.results[name].get(name)
            if got is None:
                raise RuntimeError(f"sched: tenant {name} has no result")
            results[f"sched-{name}"] = _pairs(got)
        out["sched_pages"] = {n: t["pages"]
                              for n, t in stats["tenants"].items()}

    def scrape():
        import urllib.request

        port = int(series.METRICS_BOUND_PORT.value())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            if r.status != 200:
                raise RuntimeError(f"/metrics answered {r.status}")

    ce.reset_launches()
    try:
        _run("detailed+prefetch", detailed)
        _run("mid-range", mid_range)
        _run("niceonly", niceonly)
        _run("b98-surviving", b98)
        _run("mesh-drill", mesh)
        _run("sched", sched)
        _run("metrics-scrape", scrape)
    finally:
        stepprof.configure(False)
    out["launches"] = dict(ce.LAUNCHES)
    return out


def _main(argv=None) -> int:  # pragma: no cover - run through the CLI tests
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="lockdep of the port: drive its main paths with every "
                    "lock instrumented and dump the observed lock-order "
                    "graph")
    ap.add_argument("--dump-graph", metavar="PATH", required=True,
                    help=f"write the order graph JSON here ({GRAPH_RELPATH} "
                         "to update the committed graph)")
    ap.add_argument("--no-merge", action="store_true",
                    help="overwrite instead of unioning with the file")
    ap.add_argument("--mode", choices=("on", "strict"), default="on",
                    help="strict: long holds on the loop threads fail too")
    ap.add_argument("--hold-secs", type=float, default=DEFAULT_HOLD_SECS,
                    help="the long-hold threshold")
    ap.add_argument("--device", default="cuda",
                    help="where the fields run (cuda, or cpu: the plain "
                         "versions)")
    ap.add_argument("--size", type=int, default=None,
                    help="numbers a field (default: full width, 1e9)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="the fields' batch size (default: tuned/default)")
    ap.add_argument("--mid-range-start", type=int, default=None,
                    help="start of the b40 field with near misses (default: "
                         "centred on a known near miss)")
    ap.add_argument("--dense-start", type=int, default=None,
                    help="start of the b98 niceonly field (default: a seeded "
                         "draw the MSD filter does not prune whole)")
    ap.add_argument("--drill", default=MESH_DRILL,
                    help="the mesh run's fault spec (it must downshift once)")
    ap.add_argument("--checkpoint-batches", type=int, default=64,
                    help="the detailed field's checkpoint interval")
    ap.add_argument("--results", metavar="PATH",
                    help="write the exercise's report (each field's results) "
                         "as JSON")
    args = ap.parse_args(argv)

    # Before anything of the port that builds a lock is imported.
    configure(args.mode, args.hold_secs)
    report = _exercise(
        device=args.device, size=args.size, batch_size=args.batch_size,
        mid_range_start=args.mid_range_start, dense_start=args.dense_start,
        drill=args.drill, checkpoint_batches=args.checkpoint_batches)
    print("lockdep: exercised " + ", ".join(report["ran"]))
    edges = dump_graph(args.dump_graph, merge=not args.no_merge)
    n = sum(len(v) for v in edges.values())
    print(f"lockdep: wrote {len(edges)} nodes / {n} edges "
          f"to {args.dump_graph}")
    found = violations()
    report["violations"] = found
    report["observed_edges"] = {k: sorted(v)
                                for k, v in sorted(order_edges().items())}
    if args.results:
        from nice_tpu_torch.utils import fsio

        fsio.atomic_write_text(args.results,
                               json.dumps(report, indent=1, default=str)
                               + "\n")
    failing = [v for v in found
               if v["kind"] == "order-cycle" or strict()]
    for v in found:
        print(f"lockdep: {'VIOLATION' if v in failing else 'reported'} {v}")
    return 1 if failing else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    # Under `python -m` this file runs as the __main__ module, a SECOND
    # instance beside the `nice_tpu_torch.utils.lockdep` that every lock of
    # the port records into: dispatch to the canonical instance, or the
    # switch and the dump would see an empty graph.
    from nice_tpu_torch.utils import lockdep as _canonical

    sys.exit(_canonical._main())
