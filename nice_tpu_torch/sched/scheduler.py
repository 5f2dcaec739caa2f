"""Priority/deficit round-robin over tenant pages (the port's copy of
nice_tpu/sched/scheduler.py).

The scheduler sits above the engine and below the field sources: each
*round* it picks one tenant (policy + SLO-burn boost + anti-starvation
bound), runs that tenant's pages until its time quantum expires, and
preempts at the next page boundary — which the PageTable guarantees is a
loop segment boundary. Each page is one ordinary process_range_* call on
the scheduler's device (and device list: a mesh of slices, with its
elastic downshift, as the reference's pages run on its mesh), so a page
launches exactly the kernels a solo field launches there. The builds run before the dispatch loop (warm), so
switching tenants never waits on nvcc; a build that fails raises.

Per-tenant SLO budgets feed back into scheduling: every page's wall time
lands in a scheduler-local HistoryStore under
``nice_sched_page_seconds{tenant="..."}``; an SloEngine built from
``obs.slo.tenant_specs`` evaluates burn rates, and a burning tenant earns
a temporary priority boost (``slo_boost`` points per burn level) that can
preempt the incumbent at the next boundary.

The reference's NICE_TPU_SCHED_* and NICE_TPU_SLO_* knobs are constructor
arguments with the knobs' defaults (the client's --sched-* and --slo-*
flags).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from nice_tpu_torch.core.types import FieldResults, FieldSize
from nice_tpu_torch.obs import flight
from nice_tpu_torch.obs.history import HistoryStore
from nice_tpu_torch.obs.series import (
    SCHED_FIELDS,
    SCHED_MESH_OCCUPANCY,
    SCHED_OCCUPANCY,
    SCHED_PAGE_SECONDS,
    SCHED_PAGES,
    SCHED_PREEMPTIONS,
    SCHED_SLO_BURN,
    SCHED_STARVED,
)
from nice_tpu_torch.obs.slo import STATE_LEVELS, SloEngine, tenant_specs
from nice_tpu_torch.parallel.mesh import OccupancyMeter
from nice_tpu_torch.sched.pagetable import PAGE_BATCHES_DEFAULT, PageTable
from nice_tpu_torch.sched.tenants import TenantRegistry, TenantSpec
from nice_tpu_torch.utils import lockdep

POLICIES = ("deficit", "priority", "rr")

# The reference's knob defaults.
POLICY_DEFAULT = "deficit"
QUANTUM_SECS_DEFAULT = 5.0
STARVATION_ROUNDS_DEFAULT = 8
SLO_BOOST_DEFAULT = 2


class MultiTenantScheduler:
    """Runs a TenantRegistry's workloads interleaved on one device.

    policy, page_batches, quantum_secs, starvation_rounds and slo_boost are
    the reference's NICE_TPU_SCHED_* knobs (quantum_secs <= 0 and
    starvation_rounds <= 0 turn those off); slo_window_scale and
    slo_overrides are its NICE_TPU_SLO_* knobs (obs/slo.py). Every page and
    every warm runs on ``device`` ("cuda" unless the caller asks for the
    CPU's plain versions), over ``devices`` with ``shard`` and ``elastic``
    as the engine's entry points take them (ops/engine.resolve_mesh: a
    slice a downshift lost stays out of the later pages). Injectable clocks
    keep the tests deterministic:
    ``clock`` (monotonic) drives quantum/occupancy accounting, ``wall``
    (epoch) stamps history points for the SLO windows."""

    def __init__(
        self,
        registry: TenantRegistry,
        source,
        *,
        policy: str = POLICY_DEFAULT,
        page_batches: int = PAGE_BATCHES_DEFAULT,
        quantum_secs: float = QUANTUM_SECS_DEFAULT,
        starvation_rounds: int = STARVATION_ROUNDS_DEFAULT,
        slo_boost: int = SLO_BOOST_DEFAULT,
        slo_window_scale: float = 1.0,
        slo_overrides: Optional[dict] = None,
        history: Optional[HistoryStore] = None,
        meter: Optional[OccupancyMeter] = None,
        clock=time.monotonic,
        wall=time.time,
        device="cuda",
        devices=None,
        shard: bool = True,
        elastic: bool = True,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown scheduler policy {policy!r}; want one of"
                f" {POLICIES}"
            )
        self.registry = registry
        self.source = source
        self.device = device
        self.mesh_args = {"devices": devices, "shard": shard,
                          "elastic": elastic}
        self.table = PageTable(page_batches, device=device)
        self.policy = policy
        self.quantum_secs = quantum_secs
        self.starvation_rounds = starvation_rounds
        self.slo_boost = slo_boost
        self.history = history if history is not None else HistoryStore()
        self.slo = SloEngine(
            self.history,
            tenant_specs(registry.slo_pairs(), overrides=slo_overrides),
            window_scale=slo_window_scale,
        )
        self.meter = meter if meter is not None else OccupancyMeter()
        self._clock = clock
        self._wall = wall
        # Guards the mutable per-tenant maps below: the run loop mutates
        # them while the optional sched-slo periodic and stats() readers
        # look on.
        self._lock = lockdep.make_lock(
            "sched.scheduler.MultiTenantScheduler._lock")
        self._deficit = {s.name: 0.0 for s in registry}
        self._skipped = {s.name: 0 for s in registry}
        self._exhausted: set[str] = set()
        self._boost = {s.name: 0 for s in registry}
        self._rr_next = 0
        self.rounds = 0
        self.pages_run = {s.name: 0 for s in registry}
        self.fields_done = {s.name: 0 for s in registry}
        self.preemptions = {s.name: 0 for s in registry}
        self.starved = {s.name: 0 for s in registry}
        self._slo_thread: Optional[threading.Thread] = None
        self._slo_stop = threading.Event()

    # -- builds (off the critical path) ----------------------------------

    def warm(self) -> None:
        """Build what each tenant's pages launch before the dispatch loop,
        so no tenant switch waits on nvcc: engine.warm_detailed for a
        detailed tenant's base, engine.warm_niceonly for a niceonly one's at
        its page quantum (the size its pages' strided setup derives from).
        A failed build raises: the port has no degrade path."""
        from nice_tpu_torch.ops import engine

        for spec in self.registry:
            if spec.mode == "detailed":
                engine.warm_detailed(spec.base, device=self.device,
                                     backend=spec.backend,
                                     devices=self.mesh_args["devices"])
            else:
                engine.warm_niceonly(spec.base, self.table.quantum_for(spec),
                                     device=self.device,
                                     backend=spec.backend,
                                     devices=self.mesh_args["devices"])

    # -- work feed ---------------------------------------------------------

    def _ensure_work(self, spec: TenantSpec) -> bool:
        """True when the tenant has at least one page queued (claiming a
        fresh field from the source if needed)."""
        if self.table.has_pages(spec.name):
            return True
        if spec.name in self._exhausted:
            return False
        handle = self.source.next_field(spec)
        if handle is None:
            with self._lock:
                self._exhausted.add(spec.name)
            return False
        field_key, base, start, end = handle
        self.table.add_field(spec, field_key, base, start, end)
        return True

    def _runnable(self) -> list[TenantSpec]:
        return [s for s in self.registry if self._ensure_work(s)]

    # -- tenant selection --------------------------------------------------

    def effective_priority(self, spec: TenantSpec) -> int:
        with self._lock:
            return spec.priority + self._boost.get(spec.name, 0)

    def _pick(self, runnable: list[TenantSpec]) -> TenantSpec:
        # Anti-starvation bound beats every policy: a tenant skipped past
        # the bound runs next, whatever its priority.
        if self.starvation_rounds > 0:
            with self._lock:
                overdue = [
                    s for s in runnable
                    if self._skipped[s.name] >= self.starvation_rounds
                ]
            if overdue:
                victim = max(overdue, key=lambda s: self._skipped[s.name])
                with self._lock:
                    self.starved[victim.name] += 1
                SCHED_STARVED.labels(victim.name).inc()
                flight.record(
                    "tenant_starved", tenant=victim.name,
                    skipped_rounds=self._skipped[victim.name],
                    policy=self.policy,
                )
                return victim
        if self.policy == "rr":
            names = [s.name for s in self.registry]
            for _ in range(len(names)):
                cand = names[self._rr_next % len(names)]
                self._rr_next += 1
                for s in runnable:
                    if s.name == cand:
                        return s
            return runnable[0]
        if self.policy == "priority":
            return max(runnable, key=self.effective_priority)
        # deficit: every runnable tenant accrues its (boosted) priority
        # weight each round; the largest accumulated deficit runs and
        # resets. Weight is priority+1 so a priority-0 tenant still
        # accrues and cannot starve outright.
        with self._lock:
            for s in runnable:
                boosted = s.priority + self._boost.get(s.name, 0)
                self._deficit[s.name] += boosted + 1
            chosen = max(runnable, key=lambda s: self._deficit[s.name])
            self._deficit[chosen.name] = 0.0
        return chosen

    # -- SLO feedback ------------------------------------------------------

    def _slo_tick(self, now: Optional[float] = None) -> None:
        """Evaluate per-tenant burn rates and refresh priority boosts."""
        results = self.slo.evaluate(now=self._wall() if now is None else now)
        boosts = {}
        for res in results:
            name = res["slo"]
            if not name.startswith("tenant_"):
                continue
            tenant = name[len("tenant_"):]
            level = STATE_LEVELS.get(res["state"], 0)
            boosts[tenant] = level * self.slo_boost
            burn = res.get("burn_short")
            if burn is not None:
                SCHED_SLO_BURN.labels(tenant).set(burn)
        with self._lock:
            for tenant, boost in boosts.items():
                if tenant in self._boost:
                    self._boost[tenant] = boost

    def start_slo_thread(self, interval: float = 5.0) -> None:
        """Periodic burn evaluation for long runs (tests call _slo_tick
        synchronously instead). The thread makes no torch call."""
        if self._slo_thread is not None:
            return
        self._slo_stop.clear()

        def _slo_run():
            while not self._slo_stop.wait(interval):
                self._slo_tick()

        self._slo_thread = threading.Thread(
            target=_slo_run, name="sched-slo", daemon=True
        )
        self._slo_thread.start()

    def stop_slo_thread(self) -> None:
        if self._slo_thread is None:
            return
        self._slo_stop.set()
        self._slo_thread.join(timeout=10)
        self._slo_thread = None

    # -- page execution ----------------------------------------------------

    def _execute_page(self, spec: TenantSpec, page) -> FieldResults:
        from nice_tpu_torch.ops import engine

        range_ = FieldSize(page.start, page.end)
        if spec.mode == "detailed":
            return engine.process_range_detailed(
                range_, page.base, device=self.device, backend=spec.backend,
                batch_size=spec.batch_size, **self.mesh_args)
        takes_batch = engine.niceonly_takes_batch(page.base, spec.backend)
        return engine.process_range_niceonly(
            range_, page.base, device=self.device, backend=spec.backend,
            batch_size=spec.batch_size if takes_batch else None,
            **self.mesh_args)

    def _preempt_reason(self, spec: TenantSpec, turn_started: float) -> str:
        """Why the incumbent should yield at this page boundary, or ''."""
        if (
            self.quantum_secs > 0
            and self._clock() - turn_started >= self.quantum_secs
        ):
            return "quantum"
        if self.policy != "rr":
            mine = self.effective_priority(spec)
            with self._lock:
                burning = [
                    name for name, boost in self._boost.items()
                    if boost > 0 and name != spec.name
                    and name not in self._exhausted
                ]
            for name in burning:
                other = self.registry.get(name)
                if (
                    self.effective_priority(other) > mine
                    and self.table.has_pages(name)
                ):
                    return "slo_boost"
        return ""

    def _run_turn(self, spec: TenantSpec) -> None:
        turn_started = self._clock()
        while True:
            nxt = self.table.next_page(spec.name)
            if nxt is None:
                if not self._ensure_work(spec):
                    return  # tenant drained mid-turn
                continue
            work, page = nxt
            t0 = self._clock()
            results = self._execute_page(spec, page)
            busy = self._clock() - t0
            drained = self.table.fold(work, page, results)
            with self._lock:
                self.pages_run[spec.name] += 1
            SCHED_PAGES.labels(spec.name).inc()
            SCHED_PAGE_SECONDS.labels(spec.name).observe(busy)
            self.meter.add_busy(spec.name, busy)
            self.history.add(
                f'nice_sched_page_seconds{{tenant="{spec.name}"}}',
                busy, ts=self._wall(),
            )
            if drained:
                with self._lock:
                    self.fields_done[spec.name] += 1
                SCHED_FIELDS.labels(spec.name).inc()
                self.source.complete(spec, work.field_key, work.result())
            self._slo_tick()
            reason = self._preempt_reason(spec, turn_started)
            if reason:
                # Only a preemption if the tenant actually had more work
                # queued — draining out on the same boundary is a clean
                # turn end.
                if self.table.has_pages(spec.name):
                    with self._lock:
                        self.preemptions[spec.name] += 1
                    SCHED_PREEMPTIONS.labels(spec.name, reason).inc()
                    flight.record(
                        "sched_preemption", tenant=spec.name, reason=reason,
                        field=work.field_key, cursor=work.cursor,
                    )
                return

    # -- main loop ---------------------------------------------------------

    def run(self, max_rounds: Optional[int] = None) -> dict:
        """Dispatch until every tenant drains (or max_rounds turns ran).
        Returns the stats() summary. A device the process cannot use
        raises before any build or claim."""
        from nice_tpu_torch.ops import engine

        engine.resolve_device(self.device)
        self.warm()
        self.meter.start(self._clock())
        try:
            while max_rounds is None or self.rounds < max_rounds:
                runnable = self._runnable()
                if not runnable:
                    break
                chosen = self._pick(runnable)
                with self._lock:
                    for s in runnable:
                        if s.name == chosen.name:
                            self._skipped[s.name] = 0
                        else:
                            self._skipped[s.name] += 1
                self._run_turn(chosen)
                self.rounds += 1
                self._publish_occupancy()
        finally:
            self.meter.stop(self._clock())
            self._publish_occupancy()
        return self.stats()

    def _publish_occupancy(self) -> None:
        now = self._clock()
        for tenant, share in self.meter.shares().items():
            SCHED_OCCUPANCY.labels(tenant).set(share)
        SCHED_MESH_OCCUPANCY.set(self.meter.occupancy(now))

    def stats(self) -> dict:
        with self._lock:
            per_tenant = {
                s.name: {
                    "pages": self.pages_run[s.name],
                    "fields": self.fields_done[s.name],
                    "preemptions": self.preemptions[s.name],
                    "starved": self.starved[s.name],
                    "busy_secs": self.meter.busy_secs(s.name),
                    "priority": s.priority,
                    "boost": self._boost[s.name],
                }
                for s in self.registry
            }
        return {
            "policy": self.policy,
            "rounds": self.rounds,
            "occupancy": self.meter.occupancy(self._clock()),
            "busy_secs": self.meter.busy_secs(),
            "wall_secs": self.meter.wall_secs(self._clock()),
            "tenants": per_tenant,
        }
