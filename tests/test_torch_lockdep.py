"""The port's runtime lockdep (nice_tpu_torch/utils/lockdep.py) held against
the JAX package's (nice_tpu/utils/lockdep.py) on the CPU, and the port's
threaded paths run under it.

Parity, exact: the same seeded acquire/release sequences (one thread after
another, so an ABBA is recorded, never deadlocked) give both packages the
same order graph and the same violations, order cycles and long holds; the
reference is switched on through its environment variable, the port through
configure(). Off, both factories give the plain stdlib locks.

The lockdep guard (a fixture of this file, the twin of the reference's
conftest guard) switches the port's lockdep on, rebuilds the port's
module-level locks instrumented for the test, and fails a test that
records an order cycle. It runs here over the port's feed, collector, MSD
threads, mesh and scheduler on the CPU, each field held against the JAX
package's scalar oracle. Last, the CLI's CPU exercise in a subprocess:
exit 0, no cycle, and no edge that the committed lockorder.json lacks.
"""

import importlib
import json
import os
import random
import subprocess
import sys
import threading
import time

import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import scalar as jscalar
from nice_tpu.utils import lockdep as jlockdep
from nice_tpu_torch.analysis import threadspec
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.ops import adaptive_floor, engine
from nice_tpu_torch.parallel import mesh as pmesh
from nice_tpu_torch.utils import lockdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "nice_tpu" + "_torch"
LOCKORDER = os.path.join(REPO, PKG, "analysis", "lockorder.json")
B40_START = 1916284264916  # b40's range start (the extra-large field's)


@pytest.fixture
def both_on(monkeypatch):
    """Both packages' lockdep on and empty; off and empty afterwards."""
    monkeypatch.setenv("NICE_TPU_LOCKDEP", "1")
    monkeypatch.delenv("NICE_TPU_LOCKDEP_HOLD_SECS", raising=False)
    jlockdep.reset()
    lockdep.reset()
    lockdep.configure("on")
    yield
    lockdep.configure("off")
    lockdep.reset()
    jlockdep.reset()


def _drive(mod, script):
    """Run the script's threads one after another against ``mod``'s
    lockdep; each thread takes its locks in order, holds each for its
    seconds, and releases them in reverse."""
    locks = {}
    for entry in script:
        for name in entry["order"]:
            if name not in locks:
                locks[name] = mod.make_lock(name)

    for i, entry in enumerate(script):
        def run(entry=entry):
            if entry.get("loop"):
                mod.mark_loop_thread()
            for name in entry["order"]:
                locks[name].acquire()
                time.sleep(entry.get("hold", 0.0))
            for name in reversed(entry["order"]):
                locks[name].release()

        t = threading.Thread(target=run, name=entry.get("name", f"t{i}"))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), f"thread {t.name} did not finish"
    return mod.order_edges(), _violations(mod)


def _violations(mod):
    out = []
    for v in mod.violations():
        if v["kind"] == "order-cycle":
            out.append((v["kind"], tuple(v["edge"]), tuple(v["held"]),
                        v["thread"]))
        else:
            out.append((v["kind"], v["lock"], v["thread"]))
    return out


def _script(seed: int):
    rng = random.Random(seed)
    names = [f"t.L{i}" for i in range(5)]
    return [{"order": rng.sample(names, rng.randint(1, 4)),
             "name": f"seq{i}"} for i in range(12)]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequences_equal_the_reference(both_on, seed):
    script = _script(seed)
    want = _drive(jlockdep, script)
    got = _drive(lockdep, script)
    assert got == want
    assert want[0]  # the sequences nest: the graph is not empty


def test_abba_is_caught_without_deadlocking(both_on):
    script = [{"order": ["t.A", "t.B"], "name": "ab"},
              {"order": ["t.B", "t.A"], "name": "ba"}]
    want = _drive(jlockdep, script)
    got = _drive(lockdep, script)
    assert got == want
    assert got[1] == [("order-cycle", ("t.B", "t.A"), ("t.B",), "ba")]


def test_long_holds_on_loop_threads_equal_the_reference(both_on, monkeypatch):
    monkeypatch.setenv("NICE_TPU_LOCKDEP_HOLD_SECS", "0.005")
    lockdep.configure("on", hold_secs=0.005)
    # A long hold counts on a loop thread only.
    script = [{"order": ["t.slow"], "hold": 0.02, "name": "plain"},
              {"order": ["t.slow", "t.inner"], "hold": 0.02,
               "name": "loop-slow", "loop": True}]
    want = _drive(jlockdep, script)
    got = _drive(lockdep, script)
    assert got == want
    assert got[1] == [("long-hold", "t.inner", "loop-slow"),
                      ("long-hold", "t.slow", "loop-slow")]


def test_strict_mode_and_its_switch(monkeypatch):
    monkeypatch.setenv("NICE_TPU_LOCKDEP", "strict")
    try:
        lockdep.configure("strict", hold_secs=1.5)
        assert lockdep.enabled() and lockdep.strict()
        assert jlockdep.enabled() and jlockdep.strict()
        assert lockdep._hold_secs == 1.5
        lockdep.configure("on")
        assert lockdep.enabled() and not lockdep.strict()
    finally:
        lockdep.configure("off")
    with pytest.raises(ValueError):
        lockdep.configure("1")
    with pytest.raises(ValueError):
        lockdep.configure("on", hold_secs=-1)


def test_off_gives_the_plain_stdlib_locks(monkeypatch):
    monkeypatch.delenv("NICE_TPU_LOCKDEP", raising=False)
    assert not lockdep.enabled() and lockdep.factory_hook() is None
    for mod in (lockdep, jlockdep):
        assert type(mod.make_lock("t.off")) is type(threading.Lock())
        assert type(mod.make_rlock("t.roff")) is type(threading.RLock())
    lockdep.mark_loop_thread()  # a no-op off
    assert lockdep._loop_thread_ids == set()


def test_rlock_recursion_records_no_edge(both_on):
    for mod in (jlockdep, lockdep):
        r = mod.make_rlock("t.R")
        with r:
            with r:
                pass
    assert lockdep.order_edges() == jlockdep.order_edges() == {}


def test_the_port_builds_its_locks_through_the_factory():
    # Every label of the port's LockSpecs that names a module-level lock is
    # a plain lock here (lockdep was off when the modules were imported).
    found = 0
    for spec in threadspec.LOCK_SPECS:
        target = _module_lock(spec.label)
        if target is not None:
            module, attr = target
            assert type(getattr(module, attr)) is type(threading.Lock())
            found += 1
    assert found >= 15


def test_dump_graph_merges_and_never_forgets(both_on, tmp_path):
    path = tmp_path / "lockorder.json"
    path.write_text(json.dumps({"edges": {"t.outer": ["t.inner"]}}))
    _drive(lockdep, [{"order": ["t.x", "t.y"]}])
    edges = lockdep.dump_graph(str(path))
    assert edges == {"t.outer": ["t.inner"], "t.x": ["t.y"]}
    assert json.loads(path.read_text())["edges"] == edges
    lockdep.reset()
    assert lockdep.dump_graph(str(path), merge=False) == {}


# --------------------------------------------------------------------------
# The lockdep guard over the port's threaded paths
# --------------------------------------------------------------------------

def _module_lock(label):
    """(module, attribute) of a label naming a module-level lock of the
    port, or None (instance locks, the per-header lock table, closures)."""
    mod_path, _, attr = label.rpartition(".")
    try:
        module = importlib.import_module(f"{PKG}.{mod_path}")
    except ImportError:
        return None
    value = getattr(module, attr, None)
    if value is None or not hasattr(value, "acquire"):
        return None
    return module, attr


class _Guard:
    """Lockdep on for one test, the port's module-level locks and the locks
    of its import-time singletons (the metrics registry and its series, the
    flight recorder) rebuilt instrumented; check() fails on any order cycle
    recorded. Locks built during the test are instrumented anyway."""

    def __init__(self, monkeypatch):
        from nice_tpu_torch.obs import flight, metrics

        lockdep.reset()
        lockdep.configure("on")
        for spec in threadspec.LOCK_SPECS:
            target = _module_lock(spec.label)
            if target is not None:
                monkeypatch.setattr(target[0], target[1],
                                    lockdep.make_lock(spec.label))
        singletons = [(metrics.REGISTRY, "obs.metrics.Registry._lock"),
                      (flight.RECORDER, "obs.flight.FlightRecorder._lock")]
        singletons += [(m, "obs.metrics._Metric._lock")
                       for m in metrics.REGISTRY._metrics.values()]
        for obj, label in singletons:
            monkeypatch.setattr(obj, "_lock", lockdep.make_lock(label))

    def check(self):
        cycles = [v for v in lockdep.violations()
                  if v["kind"] == "order-cycle"]
        assert not cycles, f"lockdep recorded order cycles: {cycles}"

    def close(self):
        lockdep.configure("off")
        lockdep.reset()
        adaptive_floor.reset_for_tests()


@pytest.fixture
def lockdep_guard(monkeypatch):
    guard = _Guard(monkeypatch)
    try:
        yield guard
        guard.check()
    finally:
        guard.close()
        faults.reset()
        pmesh.heal_devices()
        engine._invalidate_mesh_cache()


def _pairs(results):
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _oracle(mode, lo, hi, base):
    fn = (jscalar.process_range_detailed if mode == "detailed"
          else jscalar.process_range_niceonly)
    return _pairs(fn(JFieldSize(lo, hi), base))


NEAR_MISS = (3621949312977 - 3000, 3621949312977 + 3000)


@pytest.mark.parametrize("lo,hi", [(B40_START, B40_START + 20000), NEAR_MISS])
@pytest.mark.parametrize("depth", [0, 2])
def test_guarded_detailed_pipeline_equals_the_oracle(lockdep_guard, lo, hi,
                                                     depth):
    # The feed thread (depth 2) and the collector, with a checkpoint ticker.
    states = []
    got = engine.process_range_detailed(
        FieldSize(lo, hi), 40, device="cpu", batch_size=512, segment=2,
        feed_depth=depth, checkpoint_cb=states.append, checkpoint_batches=1)
    assert _pairs(got) == _oracle("detailed", lo, hi, 40)
    assert states
    assert isinstance(engine._mesh_cache_lock, lockdep._DepLock)


def test_guarded_niceonly_pipeline_equals_the_oracle(lockdep_guard):
    # The MSD producer thread, its pool and the niceonly collector.
    lo, hi = B40_START, B40_START + 50000
    got = engine.process_range_niceonly(FieldSize(lo, hi), 40, device="cpu")
    assert _pairs(got) == _oracle("niceonly", lo, hi, 40)


def test_guarded_mesh_drill_equals_the_oracle(lockdep_guard):
    # Four slices, one lost mid-field: the mesh cache, the dead-slice set
    # and the fault plan's locks under lockdep.
    lo, hi = B40_START, B40_START + 40000
    faults.configure("mesh.dispatch:dead:1@3")
    got = engine.process_range_detailed(FieldSize(lo, hi), 40, device="cpu",
                                        devices=["cpu"] * 4, batch_size=256,
                                        segment=1)
    stats = dict(engine.LAST_FEED_STATS)
    assert _pairs(got) == _oracle("detailed", lo, hi, 40)
    assert stats["reshards"] == 1 and stats["n_dev_end"] == 3
    edges = lockdep.order_edges()
    assert "faults.injector.FaultPlan._lock" in edges


def test_guarded_scheduler_with_its_slo_thread(lockdep_guard):
    from nice_tpu_torch.sched import (MultiTenantScheduler, StaticSource,
                                      TenantRegistry, TenantSpec)

    lo, hi = B40_START, B40_START + 8192
    source = StaticSource({"canon": [("canon", 40, lo, hi)],
                           "nice": [("nice", 40, lo, hi)]})
    specs = [TenantSpec(name="canon", mode="detailed", base=40, priority=3,
                        batch_size=512),
             TenantSpec(name="nice", mode="niceonly", base=40, priority=1,
                        batch_size=512)]
    scheduler = MultiTenantScheduler(TenantRegistry(specs), source,
                                     device="cpu", page_batches=1)
    scheduler.start_slo_thread(interval=0.01)
    try:
        scheduler.run()
        scheduler._slo_tick()
    finally:
        scheduler.stop_slo_thread()
    assert _pairs(source.results["canon"]["canon"]) == _oracle(
        "detailed", lo, hi, 40)
    assert _pairs(source.results["nice"]["nice"]) == _oracle(
        "niceonly", lo, hi, 40)
    assert "sched.scheduler.MultiTenantScheduler._lock" in \
        lockdep.order_edges()


def test_the_guard_fails_a_test_that_records_a_cycle(monkeypatch):
    guard = _Guard(monkeypatch)
    try:
        a = lockdep.make_lock("t.guard.A")
        b = lockdep.make_lock("t.guard.B")
        for first, second in ((a, b), (b, a)):
            t = threading.Thread(target=lambda f=first, s=second: (
                f.acquire(), s.acquire(), s.release(), f.release()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with pytest.raises(AssertionError, match="order cycles"):
            guard.check()
    finally:
        guard.close()


# --------------------------------------------------------------------------
# The exercise's b98 field, and the CLI's exercise on the CPU
# --------------------------------------------------------------------------

SURVIVE_FLOOR = 4096  # the MSD floor pinned for the draws below
SURVIVE_SIZE = 65536


@pytest.fixture
def pinned_floor():
    adaptive_floor.reset_for_tests(pinned=SURVIVE_FLOOR)
    yield
    adaptive_floor.reset_for_tests()


def _draws(base, size, seed, n):
    from nice_tpu_torch.ops.limbs import get_plan

    plan = get_plan(base)
    n_fields = (plan.range_end - plan.range_start) // size
    rng = random.Random(seed)
    return [plan.range_start + rng.randrange(n_fields) * size
            for _ in range(n)]


def _jax_filter_keeps(start, size):
    from nice_tpu.ops import msd_filter as jmsd

    return bool(jmsd.get_valid_ranges(
        JFieldSize(start, start + size), 98, min_range_size=SURVIVE_FLOOR,
        max_depth=engine._msd_depth_for(size, SURVIVE_FLOOR)))


def test_surviving_field_is_the_first_draw_the_filter_keeps(pinned_floor):
    field = engine.surviving_field(98, SURVIVE_SIZE, 0, device="cpu")
    assert engine.LAST_NICEONLY_STATS["runs"] > 0  # the dense loop ran
    starts = _draws(98, SURVIVE_SIZE, 0, 1000)
    k = starts.index(field.range_start)
    assert k > 0 and field.size() == SURVIVE_SIZE
    # The JAX package's filter prunes every earlier draw whole, and keeps
    # part of this one.
    assert not any(_jax_filter_keeps(s, SURVIVE_SIZE) for s in starts[:k])
    assert _jax_filter_keeps(field.range_start, SURVIVE_SIZE)


def test_surviving_field_raises_when_every_draw_is_pruned(pinned_floor):
    starts = _draws(98, SURVIVE_SIZE, 2, 50)
    assert not any(_jax_filter_keeps(s, SURVIVE_SIZE) for s in starts)
    with pytest.raises(RuntimeError, match="survives the MSD filter"):
        engine.surviving_field(98, SURVIVE_SIZE, 2, device="cpu", tries=50)


def test_cpu_exercise_adds_no_edge_the_committed_graph_lacks(tmp_path):
    graph, results = tmp_path / "graph.json", tmp_path / "run.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.utils.lockdep", "--device", "cpu",
         "--size", "65536", "--batch-size", "512", "--checkpoint-batches",
         "1", "--drill", "mesh.dispatch:dead:1@3", "--no-merge",
         "--dump-graph", str(graph), "--results", str(results)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    run = json.loads(results.read_text())
    assert run["ran"] == ["samplers", "detailed+prefetch", "mid-range",
                          "niceonly", "b98-surviving", "mesh-drill", "sched",
                          "metrics-scrape"]
    assert not [v for v in run["violations"] if v["kind"] == "order-cycle"]
    assert run["mesh"] == {"n_dev_start": 4, "n_dev_end": 3}
    assert run["results"]["mid-range"][1]  # the near miss: K2's path
    assert run["results"]["mesh-drill"] == run["results"]["extra-large"]
    assert run["results"]["sched-canon"] == run["results"]["extra-large"]
    assert (run["results"]["sched-nice"]
            == run["results"]["extra-large-niceonly"])
    observed = json.loads(graph.read_text())["edges"]
    committed = json.loads(open(LOCKORDER).read())["edges"]
    assert observed
    missing = {f"{a}->{b}" for a, bs in observed.items() for b in bs
               if b not in committed.get(a, ())}
    assert not missing, f"edges missing from lockorder.json: {missing}"
