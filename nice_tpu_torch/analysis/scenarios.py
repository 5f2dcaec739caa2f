"""Targeted schedex scenarios for the port's threads (the twin of
nice_tpu/analysis/scenarios.py, cut to the scenarios that apply to the
port, plus one of its own).

Each scenario names the two (or more) thread roots it crosses, builds
the shared objects (the port's real objects where practical, faithful
models otherwise), and states the invariant that every interleaving
must preserve.  Scenarios come in pairs where a race was fixed:

* the real-code scenario (``expect = "pass"``) drives the port's
  functions and must hold under *every* explored schedule — the
  regression test the ``nicelint: allow R5`` comment in
  client/api_client.py points at;
* a ``*_prefix`` twin (``expect = "race"``) replays the pre-fix body
  against the same invariant and must FAIL under at least one schedule
  within the k<=2 preemption bound — proving the explorer can actually
  see the window the fix closed.

``racy_counter`` is the permanently-racy calibration fixture: if the
explorer ever stops catching it, the explorer is broken, not the code.
"""

from __future__ import annotations

from nice_tpu_torch.analysis import schedex
from nice_tpu_torch.utils import lockdep


class Scenario:
    scenario_name = "?"
    expect = "pass"  # or "race" for pre-fix twins / calibration fixtures

    def build(self, sched: schedex.Scheduler):
        raise NotImplementedError

    def check(self) -> None:
        pass

    def cleanup(self) -> None:
        pass


# ---------------------------------------------------------------------------
# mesh cache: feed/dispatch rebuild vs. elastic downshift
# (threads crossed: a field's dispatch vs. the downshift path of another)


class _MeshCacheBase(Scenario):
    """Shared wiring: the port's real ops.engine mesh-cache globals with
    the module lock swapped for a schedex lock and make_mesh stubbed.

    The stubbed make_mesh stamps each mesh with the cache generation at
    build time, so the invariant can state exactly what the fix
    guarantees: a store never survives an invalidation that happened
    mid-build (an entry whose build-gen predates the final generation
    is the downshift-masking bug).  A dispatch whose *argument* tuple
    is stale but whose build started after the downshift is the
    caller's live_devices re-read to catch, not the cache's."""

    def _wire(self, sched: schedex.Scheduler):
        from nice_tpu_torch.ops import engine
        from nice_tpu_torch.parallel import mesh as pmesh
        self._engine = engine
        self._pmesh = pmesh
        engine._MESH_CACHE.clear()
        engine._MESH_CACHE_GEN = 0
        self._orig_lock = engine._mesh_cache_lock
        engine._mesh_cache_lock = schedex.Lock(
            sched, "ops.engine._mesh_cache_lock")
        self._orig_make = pmesh.make_mesh
        pmesh.make_mesh = lambda slices: (
            "mesh", tuple(slices), engine._MESH_CACHE_GEN)
        # Source of truth for which devices are alive; the downshift
        # marks deaths *before* invalidating, like the real engine.
        self.alive = {0, 1, 2, 3}
        self.survivors = (0, 1)

    def _downshift(self):
        self.alive = set(self.survivors)
        self._engine._invalidate_mesh_cache()
        self._engine._cached_mesh(tuple(sorted(self.alive)))

    def check(self) -> None:
        cache = dict(self._engine._MESH_CACHE)
        final_gen = self._engine._MESH_CACHE_GEN
        assert self.survivors in cache, (
            f"downshift rebuild lost: survivor mesh missing from {cache}")
        stale = {k: v for k, v in cache.items() if v[2] != final_gen}
        assert not stale, (
            f"entries built before an invalidation survived it "
            f"(final gen {final_gen}): {stale}")

    def cleanup(self) -> None:
        if getattr(self, "_engine", None) is None:
            return
        self._engine._mesh_cache_lock = self._orig_lock
        self._pmesh.make_mesh = self._orig_make
        self._engine._MESH_CACHE.clear()
        self._engine._MESH_CACHE_GEN = 0
        self._engine = None


class MeshCacheClearVsRebuild(_MeshCacheBase):
    """Real engine._cached_mesh vs. _invalidate_mesh_cache."""

    scenario_name = "mesh_cache_clear_vs_rebuild"
    expect = "pass"

    def build(self, sched):
        self._wire(sched)

        def dispatch():
            self._engine._cached_mesh(tuple(sorted(self.alive)))

        return [("nice-dispatch", dispatch), ("downshift", self._downshift)]


class MeshCachePreFix(_MeshCacheBase):
    """The pre-fix lru_cache shape: whatever was built gets stored, even
    if a downshift invalidated mid-build."""

    scenario_name = "mesh_cache_prefix"
    expect = "race"

    def build(self, sched):
        self._wire(sched)
        engine = self._engine

        def prefix_cached_mesh(devs):
            with engine._mesh_cache_lock:
                mesh = engine._MESH_CACHE.get(devs)
            if mesh is not None:
                return mesh
            built = self._pmesh.make_mesh(devs)
            with engine._mesh_cache_lock:
                return engine._MESH_CACHE.setdefault(devs, built)

        def dispatch():
            prefix_cached_mesh(tuple(sorted(self.alive)))

        return [("nice-dispatch", dispatch), ("downshift", self._downshift)]


# ---------------------------------------------------------------------------
# spool replay vs. claim expiry (modeled on crash-recovery redelivery: the
# client's faults/spool.py replaying while the server's sweep redelivers)


class SpoolReplayVsClaimExpiry(Scenario):
    """Crash-recovery spool replay racing the lease sweeper redelivering
    an expired claim for the same field: delivery must be exactly-once,
    which holds because mark-and-deliver is one atomic step."""

    scenario_name = "spool_replay_vs_claim_expiry"
    expect = "pass"

    def build(self, sched):
        self.lock = schedex.Lock(sched, "model.delivery_ledger")
        self.delivered: dict[str, str] = {}
        self.duplicates: list[tuple[str, str]] = []

        def deliver(fid, src):
            with self.lock:
                if fid in self.delivered:
                    self.duplicates.append((fid, src))
                    return
                self.delivered[fid] = src

        def replay():
            for fid in ("field-1", "field-2"):
                deliver(fid, "spool-replay")

        def expiry():
            deliver("field-1", "lease-expiry")

        return [("spool-replayer", replay), ("lease-sweeper", expiry)]

    def check(self) -> None:
        assert not self.duplicates or all(
            f in self.delivered for f, _ in self.duplicates), "ledger corrupt"
        assert set(self.delivered) == {"field-1", "field-2"}, (
            f"lost fields: delivered={self.delivered}")


# ---------------------------------------------------------------------------
# client failover cursor: success store vs. concurrent rotation
# (threads crossed: the nice-api pool's requests vs. the telemetry reporter
# — the regression the ``nicelint: allow R5`` in client/api_client.py
# points at)


class _FailoverCursorBase(Scenario):
    """Models the port's api_client._failover_idx / _failover_gen
    (failover_request): a request reads the cursor under
    the lock, runs its HTTP call outside it, then stores the index that
    worked.  A concurrent thread that rotated away from a now-dead
    server must not have its rotation clobbered by the older success."""

    def _wire(self, sched):
        self._sched = sched
        self.lock = schedex.Lock(sched, "client.api_client._failover_lock")
        self.idx = {"k": 0}
        self.gen = {"k": 0}
        # Source of truth the modeled HTTP call reads: which server answers.
        self.alive = {1: True, 2: True}

    def _pick(self) -> int:
        # The request itself: the first live server answers.
        return 1 if self.alive[1] else 2

    def _rotator(self):
        # Another thread's request just failed over: server 1 is dead,
        # server 2 answered.  Newer knowledge stores atomically and bumps
        # the generation (the invalidate_status_cache role in this pair).
        self.alive[1] = False
        self._sched.yield_point("rotator:dead")
        with self.lock:
            self.idx["k"] = 2
            self.gen["k"] += 1

    def check(self) -> None:
        assert self.idx["k"] == 2, (
            f"rotation away from the dead server was lost: cursor points "
            f"at {self.idx['k']} (gen={self.gen['k']})")


class FailoverCursorRotateVsStore(_FailoverCursorBase):
    """Generation-checked store: the stale success (server 1, observed
    before it died) can never overwrite the newer rotation to server 2."""

    scenario_name = "failover_cursor_rotate_vs_store"
    expect = "pass"

    def build(self, sched):
        self._wire(sched)

        def requester():
            # Success observed on whichever server was live at call time;
            # the gen check decides whether that (possibly stale) success
            # may stick once the request returns to store it.
            with self.lock:
                g = self.gen["k"]
            sched.yield_point("requester:pick")
            target = self._pick()
            sched.yield_point("requester:http")
            with self.lock:
                if self.gen["k"] == g:
                    self.idx["k"], self.gen["k"] = target, g + 1

        return [("requester", requester), ("rotator", self._rotator)]


class FailoverCursorPreFix(_FailoverCursorBase):
    """Unconditional store: a preemption between the requester's read
    and its store lets the stale success bury the rotation."""

    scenario_name = "failover_cursor_prefix"
    expect = "race"

    def build(self, sched):
        self._wire(sched)

        def requester():
            with self.lock:
                self.idx["k"] % 3
            target = self._pick()
            sched.yield_point("requester:http")
            with self.lock:
                self.idx["k"] = target

        return [("requester", requester), ("rotator", self._rotator)]


# ---------------------------------------------------------------------------
# per-base build: the prefetch warm vs. the field's first load_plan
# (threads crossed: nice-prefetch vs. the field's dispatch thread, on the
# port's real ops/cuda_build.load_plan with nvcc stubbed)


class PlanBuildPrefetchVsFirstUse(Scenario):
    """The client's prefetch thread warms a base's per-base library while
    the running field's first launch at that base loads it too: both call
    the real cuda_build.load_plan on one generated header. Its locks (the
    module lock and the per-header lock it mints) are schedex locks, nvcc
    is a stub that yields mid-build and writes the library file, and the
    loader returns one handle a path. Invariant: one nvcc build, and both
    callers hold the same library."""

    scenario_name = "plan_build_prefetch_vs_first_use"
    expect = "pass"
    header = "// a generated plan header (the scenario's)\n"

    def build(self, sched):
        import tempfile
        import types

        from nice_tpu_torch.ops import cuda_build
        self._cb = cuda_build
        self.builds: list[str] = []
        self.got: dict[str, object] = {}
        handles: dict[str, object] = {}
        self._saved = {name: getattr(cuda_build, name) for name in (
            "BUILD_DIR", "find_nvcc", "nvcc_library", "ctypes", "bind",
            "_lock")}
        self._tmp = tempfile.mkdtemp(prefix="schedex-plan-build-")

        def nvcc_library(lib_path, sources, csrc=None, include=()):
            self.builds.append(lib_path)
            sched.yield_point("nvcc")
            with open(lib_path, "wb") as f:  # nicelint: allow A1 (the stub's stand-in library)
                f.write(b"\0")
            return {"path": lib_path, "seconds": 1.0, "ptxas": ""}

        cuda_build.BUILD_DIR = self._tmp
        cuda_build.find_nvcc = lambda: "nvcc-stub"
        cuda_build.nvcc_library = nvcc_library
        cuda_build.ctypes = types.SimpleNamespace(
            PyDLL=lambda path: handles.setdefault(path, object()))
        cuda_build.bind = lambda lib: None
        # The per-header lock is minted inside load_plan: keep the factory
        # hook on for the run, so that it is a schedex lock too.
        self._window = schedex.instrument(sched)
        self._window.__enter__()
        cuda_build._lock = lockdep.make_lock("ops.cuda_build._lock")

        def load(who):
            self.got[who] = cuda_build.load_plan(self.header)

        return [("nice-prefetch", lambda: load("prefetch")),
                ("field-dispatch", lambda: load("field"))]

    def check(self) -> None:
        assert len(self.builds) == 1, (
            f"the header was built {len(self.builds)} times: {self.builds}")
        assert set(self.got) == {"prefetch", "field"}, self.got
        assert self.got["prefetch"] is self.got["field"], (
            "the prefetch warm and the field hold different libraries")

    def cleanup(self) -> None:
        if getattr(self, "_cb", None) is None:
            return
        import shutil

        self._window.__exit__(None, None, None)
        for name, value in self._saved.items():
            setattr(self._cb, name, value)
        self._cb._plan_locks.pop(self.header, None)
        self._cb.PLAN_BUILDS.pop(self.header, None)
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._cb = None


# ---------------------------------------------------------------------------
# calibration: a permanently-racy lost-update counter


class RacyCounter(Scenario):
    """Unlocked read-modify-write; any single preemption between the
    read and the write loses an update.  Must always be caught."""

    scenario_name = "racy_counter"
    expect = "race"

    def build(self, sched):
        self.state = {"n": 0}

        def bump(tag):
            for i in range(2):
                v = self.state["n"]
                sched.yield_point(f"{tag}:rmw{i}")
                self.state["n"] = v + 1

        return [("bump-a", lambda: bump("a")), ("bump-b", lambda: bump("b"))]

    def check(self) -> None:
        assert self.state["n"] == 4, (
            f"lost update: counter is {self.state['n']}, want 4")


SCENARIOS: dict[str, type[Scenario]] = {
    cls.scenario_name: cls
    for cls in (
        MeshCacheClearVsRebuild,
        MeshCachePreFix,
        SpoolReplayVsClaimExpiry,
        FailoverCursorRotateVsStore,
        FailoverCursorPreFix,
        PlanBuildPrefetchVsFirstUse,
        RacyCounter,
    )
}
