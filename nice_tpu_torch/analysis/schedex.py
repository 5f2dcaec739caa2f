"""schedex of the port: deterministic interleaving explorer for its threads
(the twin of nice_tpu/analysis/schedex.py, ported whole).

Static analysis (racelint, R1-R5) tells us *where* a race could live;
schedex tells us *whether a specific interleaving actually breaks an
invariant*, and — crucially — replays that interleaving byte-for-byte
from its schedule id so a fix can be regression-tested against the
exact window that bit us.

How it works
------------
A :class:`Scheduler` runs a small set of named threads cooperatively:
exactly one managed thread executes at a time, and control transfers
only at *switch points*.  Switch points come from two places:

* instrumented primitives (:class:`Lock`, :class:`Event`,
  :class:`Queue`, :class:`Future`) that scenario code injects into the
  production objects under test — usually via the lockdep factory hook
  (:func:`instrument`), which makes ``lockdep.make_lock`` hand out
  schedex locks for the duration of a scenario's build;
* explicit ``sched.yield_point("label")`` calls in modeled scenarios.

Because preemption can only happen at switch points, a run is fully
determined by its :class:`Policy`:

* ``FIFOPolicy``      — never preempts; the baseline serial schedule.
* ``RandomPolicy(s)`` — seeded ``random.Random(s)`` pick at every
  switch point; the same seed always yields the same trace.
* ``PreemptPolicy(p)``— FIFO except at switch-point indices in ``p``,
  where the scheduler rotates to the next runnable thread.  With the
  baseline run's switch-point count N, :func:`explore` enumerates all
  k<=2 subsets of [0, N) (DPOR-lite, preemption-bounded), capped by
  ``max_schedules``.

Every schedule has a string id (``fifo``, ``rand:7``, ``pre:3``,
``pre:3,11``); :func:`replay` re-runs one id and must reproduce the
identical trace — that is the regression contract the in-code
``nicelint: allow R5`` comment in client/api_client.py points at.

The reference reads its settings from the environment; here they are
keyword arguments: ``explore(seeds=8, preemptions=2, max_schedules=256)``
and ``Scheduler.run(timeout=30.0)`` by default.

The whole module is import-cost only: the port's code never imports
schedex, and outside an :func:`instrument` window no hook is installed
and ``lockdep.make_lock`` returns plain ``threading.Lock``s (asserted by
tests/test_torch_racelint.py and racecheck's zero-cost line).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time

from nice_tpu_torch.utils import lockdep

DEFAULT_SEEDS = 8
DEFAULT_PREEMPTIONS = 2
DEFAULT_MAX_SCHEDULES = 256
DEFAULT_TIMEOUT_SECS = 30.0


class SchedexAborted(BaseException):
    """Raised inside managed threads when a run is torn down.

    Derives from BaseException so scenario code's ``except Exception``
    handlers cannot swallow the teardown.
    """


class DeadlockError(AssertionError):
    """No runnable thread, at least one blocked thread: a real deadlock."""


# ---------------------------------------------------------------------------
# policies


class Policy:
    """Decides which runnable thread runs after each switch point."""

    id: str = "?"

    def pick(self, preferred, runnable, step):
        raise NotImplementedError


class FIFOPolicy(Policy):
    """Run the current thread until it blocks or finishes; never preempt."""

    id = "fifo"

    def pick(self, preferred, runnable, step):
        if preferred in runnable:
            return preferred
        return runnable[0]


class RandomPolicy(Policy):
    """Seeded uniform pick at every switch point — deterministic per seed."""

    def __init__(self, seed: int):
        self.seed = seed
        self.id = f"rand:{seed}"
        self._rng = random.Random(seed)

    def pick(self, preferred, runnable, step):
        return self._rng.choice(runnable)


class PreemptPolicy(Policy):
    """FIFO, except at the given switch-point indices force a rotation.

    ``points`` indexes the global switch-point counter of the run; at
    those steps control rotates to the next runnable thread after the
    preferred one (registration order), which is how a bounded DPOR
    enumeration plants at most k context switches.
    """

    def __init__(self, points):
        self.points = frozenset(points)
        self.id = "pre:" + ",".join(str(p) for p in sorted(self.points))

    def pick(self, preferred, runnable, step):
        if preferred not in runnable:
            return runnable[0]
        if step in self.points and len(runnable) > 1:
            i = runnable.index(preferred)
            return runnable[(i + 1) % len(runnable)]
        return preferred


def policy_for(schedule_id: str) -> Policy:
    """Parse a schedule id back into its policy (the replay entry point)."""
    if schedule_id == "fifo":
        return FIFOPolicy()
    if schedule_id.startswith("rand:"):
        return RandomPolicy(int(schedule_id.split(":", 1)[1]))
    if schedule_id.startswith("pre:"):
        return PreemptPolicy(int(p) for p in schedule_id.split(":", 1)[1].split(","))
    raise ValueError(f"unknown schedule id {schedule_id!r}")


# ---------------------------------------------------------------------------
# scheduler


class Scheduler:
    """Cooperative single-token scheduler over named threads."""

    def __init__(self, policy: Policy):
        self.policy = policy
        self._cv = threading.Condition()
        self._threads: dict[str, dict] = {}
        self._order: list[str] = []
        self._ident: dict[int, str] = {}
        self._current: str | None = None
        self._step = 0
        self.trace: list[tuple[int, str, str]] = []
        self._abort = False
        self.failures: list[tuple[str, BaseException]] = []
        self._started = False

    # -- registration ------------------------------------------------------

    def thread(self, name: str, fn, *args) -> None:
        if self._started:
            raise RuntimeError("cannot add threads after run()")
        if name in self._threads:
            raise ValueError(f"duplicate thread name {name!r}")
        t = threading.Thread(
            target=self._bootstrap, args=(name, fn, args),
            name=f"schedex:{name}", daemon=True,
        )
        self._threads[name] = {"thread": t, "state": "runnable", "pred": None}
        self._order.append(name)

    def _me(self) -> str | None:
        return self._ident.get(threading.get_ident())

    def is_managed(self) -> bool:
        return self._me() is not None

    # -- core scheduling (all under self._cv) ------------------------------

    def _runnable(self) -> list[str]:
        return [n for n in self._order if self._threads[n]["state"] == "runnable"]

    def _reschedule(self, preferred: str | None, step: int) -> None:
        for rec in self._threads.values():
            if rec["state"] == "blocked" and rec["pred"]():
                rec["state"] = "runnable"
                rec["pred"] = None
        runnable = self._runnable()
        if not runnable:
            blocked = [n for n in self._order
                       if self._threads[n]["state"] == "blocked"]
            if blocked:
                self.failures.append(
                    ("<scheduler>", DeadlockError(
                        f"deadlock: all live threads blocked: {blocked}")))
                self._abort = True
            self._current = None
        else:
            if preferred is not None and preferred in runnable:
                self._current = self.policy.pick(preferred, runnable, step)
            else:
                self._current = self.policy.pick(None, runnable, step)
        self._cv.notify_all()

    def switch_point(self, point: str, block_pred=None) -> None:
        """Yield control; optionally block until ``block_pred()`` is true.

        No-op on unmanaged threads so instrumented primitives stay safe
        to touch from the calling thread (e.g. in ``Scenario.check``).
        """
        name = self._me()
        if name is None:
            return
        rec = self._threads[name]
        with self._cv:
            step = self._step
            self._step += 1
            self.trace.append((step, name, point))
            while True:
                if block_pred is not None and not block_pred():
                    rec["state"] = "blocked"
                    rec["pred"] = block_pred
                self._reschedule(name, step)
                while self._current != name and not self._abort:
                    self._cv.wait(0.05)
                if self._abort:
                    raise SchedexAborted()
                rec["state"] = "runnable"
                rec["pred"] = None
                if block_pred is None or block_pred():
                    return

    def yield_point(self, point: str) -> None:
        """A pure preemption opportunity for modeled scenario code."""
        self.switch_point(point)

    # -- thread lifecycle --------------------------------------------------

    def _bootstrap(self, name, fn, args):
        self._ident[threading.get_ident()] = name
        with self._cv:
            while self._current != name and not self._abort:
                self._cv.wait(0.05)
        if self._abort:
            return
        try:
            fn(*args)
        except SchedexAborted:
            pass
        except BaseException as exc:  # scenario invariants raise AssertionError
            with self._cv:
                self.failures.append((name, exc))
        finally:
            with self._cv:
                self._threads[name]["state"] = "done"
                if self._current == name or self._current is None:
                    self._reschedule(None, self._step)
                self._cv.notify_all()

    def run(self, timeout: float | None = None) -> None:
        """Start every registered thread and drive the run to completion."""
        if timeout is None:
            timeout = DEFAULT_TIMEOUT_SECS
        self._started = True
        for name in self._order:
            self._threads[name]["thread"].start()
        with self._cv:
            self._reschedule(self._order[0] if self._order else None, 0)
        deadline = time.monotonic() + timeout
        for name in self._order:
            self._threads[name]["thread"].join(
                max(0.0, deadline - time.monotonic()))
        alive = [n for n in self._order if self._threads[n]["thread"].is_alive()]
        if alive:
            with self._cv:
                self._abort = True
                self.failures.append(
                    ("<scheduler>", TimeoutError(
                        f"watchdog: threads still alive after {timeout}s: {alive}")))
                self._cv.notify_all()
            for name in alive:
                self._threads[name]["thread"].join(1.0)


# ---------------------------------------------------------------------------
# instrumented primitives
#
# Each wrapper degrades to real-threading behaviour when touched from an
# unmanaged thread, so the calling code (scenario build/check on the pytest
# thread) can use the same objects safely.


class Lock:
    """Scheduler-aware (R)Lock; a drop-in for ``lockdep.make_lock`` output."""

    def __init__(self, sched: Scheduler, name: str, reentrant: bool = False):
        self._sched = sched
        self._name = name
        self._re = reentrant
        self._owner: str | None = None
        self._count = 0
        self._fallback = threading.RLock()  # nicelint: allow X1 (scheduler machinery, not a project lock: minting it via make_lock inside the instrument() hook window would recurse)

    def _free_for(self, me: str):
        def pred():
            return self._owner is None or (self._re and self._owner == me)
        return pred

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = self._sched._me()
        if me is None:
            return self._fallback.acquire(blocking, timeout)
        pred = self._free_for(me)
        if not blocking:
            self._sched.switch_point(f"tryacquire:{self._name}")
            if not pred():
                return False
        else:
            self._sched.switch_point(f"acquire:{self._name}", block_pred=pred)
        self._owner = me
        self._count += 1
        return True

    def release(self) -> None:
        me = self._sched._me()
        if me is None:
            self._fallback.release()
            return
        if self._owner != me:
            raise RuntimeError(f"release of {self._name} by non-owner {me}")
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._sched.switch_point(f"release:{self._name}")

    def locked(self) -> bool:
        return self._owner is not None

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


class Event:
    """Scheduler-aware ``threading.Event``."""

    def __init__(self, sched: Scheduler, name: str):
        self._sched = sched
        self._name = name
        self._flag = False
        self._real = threading.Event()

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        self._real.set()
        if self._sched.is_managed():
            self._sched.switch_point(f"event-set:{self._name}")

    def clear(self) -> None:
        self._flag = False
        self._real.clear()

    def wait(self, timeout: float | None = None) -> bool:
        if not self._sched.is_managed():
            return self._real.wait(timeout)
        if timeout is not None:
            # Deterministic model of a timed wait: yield once, then
            # report whatever the flag is — never stall the schedule.
            self._sched.switch_point(f"event-wait:{self._name}")
            return self._flag
        self._sched.switch_point(
            f"event-wait:{self._name}", block_pred=lambda: self._flag)
        return True


class Queue:
    """Scheduler-aware FIFO with ``queue.Queue``'s put/get surface."""

    def __init__(self, sched: Scheduler, name: str, maxsize: int = 0):
        self._sched = sched
        self._name = name
        self._maxsize = maxsize
        self._items: list = []

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def put(self, item, block: bool = True, timeout: float | None = None) -> None:
        if self._sched.is_managed():
            if self._maxsize > 0 and block:
                self._sched.switch_point(
                    f"put:{self._name}",
                    block_pred=lambda: len(self._items) < self._maxsize)
            else:
                self._sched.switch_point(f"put:{self._name}")
        self._items.append(item)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: float | None = None):
        import queue as _q
        if not self._sched.is_managed():
            if not self._items:
                raise _q.Empty
            return self._items.pop(0)
        if block and timeout is None:
            self._sched.switch_point(
                f"get:{self._name}", block_pred=lambda: bool(self._items))
        else:
            # Timed/non-blocking get: one deterministic yield, then Empty
            # if nothing arrived — models the timeout without wall time.
            self._sched.switch_point(f"get:{self._name}")
            if not self._items:
                raise _q.Empty
        return self._items.pop(0)

    def get_nowait(self):
        return self.get(block=False)


class Future:
    """Scheduler-aware ``concurrent.futures.Future`` subset."""

    def __init__(self, sched: Scheduler, name: str):
        self._sched = sched
        self._name = name
        self._done = False
        self._value = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._done

    def set_result(self, value) -> None:
        self._value = value
        self._done = True
        if self._sched.is_managed():
            self._sched.switch_point(f"future-set:{self._name}")

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True
        if self._sched.is_managed():
            self._sched.switch_point(f"future-set:{self._name}")

    def result(self, timeout: float | None = None):
        if self._sched.is_managed():
            self._sched.switch_point(
                f"future-wait:{self._name}", block_pred=lambda: self._done)
        elif not self._done:
            raise TimeoutError(f"future {self._name} not resolved")
        if self._exc is not None:
            raise self._exc
        return self._value


@contextlib.contextmanager
def instrument(sched: Scheduler):
    """Route ``lockdep.make_lock``/``make_rlock`` to schedex locks.

    Scenario ``build`` runs production constructors inside this window
    so the objects under test carry instrumented locks; the hook is
    always restored, keeping the production path zero-cost afterwards.
    """
    prev = lockdep.factory_hook()
    lockdep.set_factory_hook(
        lambda name, kind: Lock(sched, name, reentrant=(kind == "rlock")))
    try:
        yield sched
    finally:
        lockdep.set_factory_hook(prev)


# ---------------------------------------------------------------------------
# exploration


@dataclasses.dataclass
class ScheduleResult:
    schedule_id: str
    ok: bool
    failures: list[str]
    trace: list[tuple[int, str, str]]
    switch_points: int

    def as_dict(self) -> dict:
        return {
            "schedule": self.schedule_id,
            "ok": self.ok,
            "failures": self.failures,
            "switch_points": self.switch_points,
        }


@dataclasses.dataclass
class ExploreReport:
    scenario: str
    schedules_run: int
    failing: list[ScheduleResult]
    baseline_switch_points: int
    truncated: int  # systematic schedules dropped by the cap

    @property
    def ok(self) -> bool:
        return not self.failing

    def first_failing(self) -> ScheduleResult | None:
        return self.failing[0] if self.failing else None

    def as_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "schedules_run": self.schedules_run,
            "baseline_switch_points": self.baseline_switch_points,
            "truncated": self.truncated,
            "ok": self.ok,
            "failing": [f.as_dict() for f in self.failing],
        }


def run_schedule(scenario_factory, policy: Policy,
                 timeout: float | None = None) -> ScheduleResult:
    """One scenario instance under one policy, with guaranteed cleanup."""
    scenario = scenario_factory()
    sched = Scheduler(policy)
    try:
        for name, fn in scenario.build(sched):
            sched.thread(name, fn)
        sched.run(timeout=timeout)
        failures = [f"{name}: {exc!r}" for name, exc in sched.failures]
        if not failures:
            try:
                scenario.check()
            except AssertionError as exc:
                failures.append(f"invariant: {exc}")
        return ScheduleResult(
            schedule_id=policy.id,
            ok=not failures,
            failures=failures,
            trace=list(sched.trace),
            switch_points=sched._step,
        )
    finally:
        cleanup = getattr(scenario, "cleanup", None)
        if cleanup is not None:
            cleanup()


def replay(scenario_factory, schedule_id: str) -> ScheduleResult:
    """Re-run one schedule byte-for-byte (same id => same trace)."""
    return run_schedule(scenario_factory, policy_for(schedule_id))


def explore(scenario_factory, seeds: int | None = None,
            preemptions: int | None = None,
            max_schedules: int | None = None,
            stop_on_failure: bool = False) -> ExploreReport:
    """Baseline + bounded systematic preemptions + seeded random sweeps."""
    if seeds is None:
        seeds = DEFAULT_SEEDS
    if preemptions is None:
        preemptions = DEFAULT_PREEMPTIONS
    if max_schedules is None:
        max_schedules = DEFAULT_MAX_SCHEDULES

    baseline = run_schedule(scenario_factory, FIFOPolicy())
    results = [baseline]
    n = baseline.switch_points

    combos: list[tuple[int, ...]] = []
    if preemptions >= 1:
        combos.extend((i,) for i in range(n))
    if preemptions >= 2:
        combos.extend((i, j) for i in range(n) for j in range(i + 1, n))
    truncated = 0
    if len(combos) > max_schedules:
        # Stride-sample so coverage stays spread across the run instead
        # of clustering at the first switch points.
        stride = -(-len(combos) // max_schedules)
        kept = combos[::stride]
        truncated = len(combos) - len(kept)
        combos = kept

    failing = [] if baseline.ok else [baseline]
    for combo in combos:
        if stop_on_failure and failing:
            break
        res = run_schedule(scenario_factory, PreemptPolicy(combo))
        results.append(res)
        if not res.ok:
            failing.append(res)
    for seed in range(seeds):
        if stop_on_failure and failing:
            break
        res = run_schedule(scenario_factory, RandomPolicy(seed))
        results.append(res)
        if not res.ok:
            failing.append(res)

    name = getattr(scenario_factory, "scenario_name", None) or getattr(
        scenario_factory, "__name__", str(scenario_factory))
    return ExploreReport(
        scenario=name,
        schedules_run=len(results),
        failing=failing,
        baseline_switch_points=n,
        truncated=truncated,
    )


# ---------------------------------------------------------------------------
# the off path


def zero_cost_report(iters: int = 50_000) -> dict:
    """Time `with lock: pass` for a raw threading.Lock vs. one minted by
    lockdep.make_lock with lockdep and schedex off — the ratio must be ~1x
    because no wrapper may be installed on the port's path."""
    hook_installed = lockdep.factory_hook() is not None
    minted = lockdep.make_lock("analysis.schedex.zero_cost_report")
    raw = threading.Lock()  # nicelint: allow X1 (the raw side of the A/B)

    def _time(lock) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            with lock:
                pass
        return time.perf_counter() - t0

    _time(raw)  # warm
    raw_s = _time(raw)
    minted_s = _time(minted)
    return {
        "iters": iters,
        "hook_installed": hook_installed,
        "minted_type": type(minted).__name__,
        "minted_is_plain": type(minted) is type(raw),
        "lockdep_enabled": lockdep.enabled(),
        "raw_ns_per_op": raw_s / iters * 1e9,
        "minted_ns_per_op": minted_s / iters * 1e9,
        "ratio": (minted_s / raw_s) if raw_s else None,
    }
