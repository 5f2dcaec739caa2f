"""The port's thread analysis (nice_tpu_torch/analysis/: X1, threadspec,
racerules R1-R3/R5, schedex, scenarios; scripts/racelint.py and
racecheck.py) held against the JAX package's on the CPU, exactly.

* X1: the reference's fixture pairs (tests/test_nicelint.py) laid out under
  each package's prefix give the same keys from both rules.
* R1, R2, R3, R5: the reference's fixtures (tests/test_racelint.py), with
  the same synthetic registries built from each package's threadspec
  classes, give the same keys from both.
* schedex: each scenario the packages share (the mesh cache and its pre-fix
  twin on each package's real engine, the failover cursor pair, the spool
  replay, the racy counter) explores to the same verdict, schedule count,
  baseline switch points, first failing schedule and traces; replay is
  byte for byte, a random seed is deterministic, a deadlock is caught, the
  instrument window restores the hook, and the port's own scenario (the
  prefetch build against the field's first load_plan) holds.
* The tree: racelint and nicelint --strict exit 0, the baseline is empty,
  no bare threading lock is built outside lockdep and schedex, and
  racecheck passes every scenario with a plain lock on the off path.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from nice_tpu.analysis import core as jcore
from nice_tpu.analysis import scenarios as jscen
from nice_tpu.analysis import schedex as jschedex
from nice_tpu.analysis import threadspec as jspec
from nice_tpu.analysis.racerules import context as jcontext
from nice_tpu.analysis.racerules import run_race_rules as jrun_race_rules
from nice_tpu_torch.analysis import core, schedex, threadspec
from nice_tpu_torch.analysis import scenarios as scen
from nice_tpu_torch.analysis.racerules import context, run_race_rules
from nice_tpu_torch.utils import lockdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "nice_tpu" + "_torch"


def _layout(root, files, prefix, module):
    """Write the fixture files with PKG/ and PKG. replaced by the package's
    path prefix and module name."""
    for rel, text in files.items():
        path = root / rel.replace("PKG/", prefix + "/")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).replace("PKG.", module + "."))


def _to_ref(key):
    return key.replace(f"{PKG}/", "nice_tpu/")


def _spec_objects(spec_mod, prefix, roots, locks, shared):
    return (tuple(spec_mod.ThreadRoot(**{**r, "path": r["path"].replace(
                "PKG/", prefix + "/")}) for r in roots),
            tuple(spec_mod.LockSpec(**lk) for lk in locks),
            tuple(spec_mod.SharedState(**{**d, "path": d["path"].replace(
                "PKG/", prefix + "/")}) for d in shared))


def race_keys(tmp_path, monkeypatch, files, rule, roots=(), locks=(),
              shared=(), lockorder=None):
    """(reference keys with its prefix, the port's keys mapped to it): one
    R-rule over the same fixture under each package, with the same
    synthetic registry."""
    out = []
    for name, prefix, module, spec_mod, core_mod, ctx_mod, run in (
            ("jax", "nice_tpu", "nice_tpu", jspec, jcore, jcontext,
             jrun_race_rules),
            ("port", PKG, PKG, threadspec, core, context, run_race_rules)):
        root = tmp_path / name
        _layout(root, files, prefix, module)
        r, lk, sh = _spec_objects(spec_mod, prefix, roots, locks, shared)
        monkeypatch.setattr(spec_mod, "THREAD_ROOTS", r)
        monkeypatch.setattr(spec_mod, "LOCK_SPECS", lk)
        monkeypatch.setattr(spec_mod, "SHARED_STATE", sh)
        project = core_mod.Project(str(root))
        ctx = ctx_mod.build_context(
            str(root), project,
            lockorder_path=lockorder or str(root / "no-lockorder.json"))
        found = run(project, ctx, only=[rule])
        keys = sorted(v.key for v in found[0])
        out.append(keys if name == "jax" else sorted(map(_to_ref, keys)))
    return out


PUMP_ROOTS = (
    dict(name="pump-run", path="PKG/pump.py", spawn_scope="Pump.__init__",
         entries=("Pump._run",), role="helper"),
    dict(name="pump-poke", path="PKG/pump.py", spawn_scope="Pump.__init__",
         entries=("Pump.poke",), role="helper"),
)
PUMP_BAD = """
    import threading

    class Pump:
        def __init__(self):
            self._t = threading.Thread(target=self._run)
            self._u = threading.Thread(target=self.poke)

        def _run(self):
            self._count = 1

        def poke(self):
            self._count = 2
"""
PUMP_GOOD = """
    import threading
    from PKG.utils import lockdep

    class Pump:
        def __init__(self):
            self._lock = lockdep.make_lock("test.pump")
            self._t = threading.Thread(target=self._run)
            self._u = threading.Thread(target=self.poke)

        def _run(self):
            with self._lock:
                self._count = 1

        def poke(self):
            with self._lock:
                self._count = 2
"""
CACHE_BAD = """
    from PKG.utils import lockdep

    class Cache:
        def __init__(self):
            self._lock = lockdep.make_lock("t.cache")
            self._d = {}

        def get_or_build(self, k):
            with self._lock:
                v = self._d.get(k)
            if v is not None:
                return v
            v = object()
            with self._lock:
                self._d[k] = v
            return v
"""
COUNT_LOCK = dict(path="PKG/pump.py", scope="Pump", attr="_count",
                  ownership="lock:test.pump")
NOBLOCK = """
    import threading
    import time

    def boot():
        threading.Thread(target=work).start()

    def work():
        time.sleep(1)
"""
UNDER_LOCK = """
    import time
    from PKG.utils import lockdep
    _L = lockdep.make_lock("t.cachelock")

    def f():
        with _L:
            time.sleep(1)
"""
LOCK_PAIR = """
    from PKG.utils import lockdep
    A = lockdep.make_lock("t.A")
    B = lockdep.make_lock("t.B")

    def fwd():
        with A:
            with B:
                pass
"""

# (rule, files, roots, locks, shared, the finding the reference's test
# pins, or None for a clean fixture)
CASES = {
    "r1_unregistered_spawn": (
        "R1", {"PKG/foo.py": """
            import threading

            def boot():
                threading.Thread(target=print).start()
        """}, (), (), (), "unregistered-thread:boot"),
    "r1_stale_root": (
        "R1", {"PKG/foo.py": "def f():\n    pass\n"},
        (dict(name="ghost", path="PKG/foo.py", spawn_scope="gone",
              entries=(), role="helper"),), (), (), "stale-root:ghost"),
    "r1_multi_root_write": (
        "R1", {"PKG/pump.py": PUMP_BAD}, PUMP_ROOTS, (), (),
        "shared:Pump._count"),
    "r1_common_lock": ("R1", {"PKG/pump.py": PUMP_GOOD}, PUMP_ROOTS, (), (),
                       None),
    "r1_declared": (
        "R1", {"PKG/pump.py": PUMP_BAD}, PUMP_ROOTS, (),
        (dict(COUNT_LOCK, ownership="owner:pump-run"),), None),
    "r2_unlocked_write": (
        "R2", {"PKG/pump.py": PUMP_BAD}, PUMP_ROOTS, (), (COUNT_LOCK,),
        "unlocked:Pump._count:_run"),
    "r2_locked_write": (
        "R2", {"PKG/pump.py": PUMP_GOOD}, PUMP_ROOTS,
        (dict(label="test.pump", guards="fixture"),), (COUNT_LOCK,),
        "missing-lockorder"),
    "r2_owner": (
        "R2", {"PKG/pump.py": PUMP_BAD}, PUMP_ROOTS, (),
        (dict(COUNT_LOCK, ownership="owner:pump-run"),),
        "foreign-write:Pump._count:poke"),
    "r2_immutable": (
        "R2", {"PKG/pump.py": PUMP_BAD}, PUMP_ROOTS, (),
        (dict(COUNT_LOCK, ownership="immutable-after-init"),),
        "mutated-immutable:Pump._count"),
    "r2_inventory": (
        "R2", {"PKG/x.py": """
            from PKG.utils import lockdep
            _L = lockdep.make_lock("t.mystery")
        """}, (), (dict(label="t.gone", guards="nothing"),), (),
        "undeclared-lock:t.mystery"),
    "r3_noblock_root": (
        "R3", {"PKG/foo.py": NOBLOCK},
        (dict(name="no-sleeper", path="PKG/foo.py", spawn_scope="boot",
              entries=("work",), role="helper", may_block=False),), (), (),
        "noblock:no-sleeper:work->time.sleep"),
    "r3_under_lock": (
        "R3", {"PKG/foo.py": UNDER_LOCK}, (),
        (dict(label="t.cachelock", guards="c"),), (),
        "block-under:t.cachelock:time.sleep"),
    "r3_serializing_lock": (
        "R3", {"PKG/foo.py": UNDER_LOCK}, (),
        (dict(label="t.cachelock", guards="c", may_block_under=True),), (),
        None),
    "r5_check_then_act": (
        "R5", {"PKG/cache.py": CACHE_BAD}, (), (), (),
        "check-then-act:get_or_build:self._d"),
    "r5_setdefault": (
        "R5", {"PKG/cache.py": CACHE_BAD.replace(
            "self._d[k] = v", "v = self._d.setdefault(k, v)")}, (), (), (),
        None),
    "r5_allow": (
        "R5", {"PKG/cache.py": CACHE_BAD.replace(
            "self._d[k] = v", "self._d[k] = v  # nicelint: allow R5 (t)")},
        (), (), (), None),
    "r5_lru_clear": (
        "R5", {"PKG/cache.py": """
            import functools

            @functools.lru_cache
            def build(x):
                return x

            def reset():
                build.cache_clear()
        """}, (), (), (), "lru-clear:build"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_race_rule_keys_equal_the_reference(tmp_path, monkeypatch, case):
    rule, files, roots, locks, shared, pinned = CASES[case]
    want, got = race_keys(tmp_path, monkeypatch, files, rule, roots, locks,
                          shared)
    assert got == want
    details = [k.split("|", 2)[2] for k in got]
    if pinned is None:
        assert details == []
    else:
        assert pinned in details


def test_r2_static_runtime_divergence_equals_the_reference(tmp_path,
                                                           monkeypatch):
    lockorder = tmp_path / "lockorder.json"
    lockorder.write_text(json.dumps({"edges": {"t.B": ["t.A"]}}))
    want, got = race_keys(
        tmp_path, monkeypatch, {"PKG/locks.py": LOCK_PAIR}, "R2",
        locks=(dict(label="t.A", guards="a"), dict(label="t.B", guards="b")),
        lockorder=str(lockorder))
    assert got == want
    assert any("|order-divergence:" in k for k in got)


# --------------------------------------------------------------------------
# X1
# --------------------------------------------------------------------------

X1_CASES = {
    "bare_lock": {"PKG/server/cache.py": """
        import threading

        _lock = threading.Lock()
    """},
    "abba": {"PKG/server/cache.py": """
        from PKG.utils import lockdep

        A = lockdep.make_lock("cache.A")
        B = lockdep.make_lock("cache.B")

        def f():
            with A:
                with B:
                    pass

        def g():
            with B:
                with A:
                    pass
    """},
    "consistent": {"PKG/server/cache.py": """
        from PKG.utils import lockdep

        A = lockdep.make_lock("cache.A")
        B = lockdep.make_lock("cache.B")

        def f():
            with A:
                with B:
                    pass

        def g():
            with A:
                with B:
                    pass
    """},
    "cross_module": {
        "PKG/server/db.py": """
            from PKG.utils import lockdep

            class Db:
                def __init__(self):
                    self._lock = lockdep.make_lock("server.db.Db._lock")
        """,
        "PKG/server/writer.py": """
            from PKG.utils import lockdep

            class Writer:
                def __init__(self, db):
                    self._lock = lockdep.make_lock("server.writer._lock")
                    self.db = db

                def flush(self):
                    with self._lock:
                        with self.db._lock:
                            pass
        """},
}


@pytest.mark.parametrize("case", sorted(X1_CASES))
def test_x1_keys_equal_the_reference(tmp_path, case):
    files = X1_CASES[case]
    _layout(tmp_path / "jax", files, "nice_tpu", "nice_tpu")
    _layout(tmp_path / "port", files, PKG, PKG)
    want = sorted(v.key for v in jcore.run_rules(
        jcore.Project(str(tmp_path / "jax")), only=["X1"]))
    kept, _, _ = core.run_rules_tracked(core.Project(str(tmp_path / "port")),
                                        only=["X1"])
    got = sorted(_to_ref(v.key) for v in kept)
    assert got == want
    assert bool(got) == (case in ("bare_lock", "abba"))


def test_x1_static_graphs_equal_the_reference(tmp_path):
    from nice_tpu.analysis.rules import x1_lock_order as jx1
    from nice_tpu_torch.analysis.rules import x1_lock_order as x1

    files = dict(X1_CASES["cross_module"])
    files["PKG/server/more.py"] = X1_CASES["consistent"][
        "PKG/server/cache.py"]
    _layout(tmp_path / "jax", files, "nice_tpu", "nice_tpu")
    _layout(tmp_path / "port", files, PKG, PKG)
    want = jx1.lock_graph(jcore.Project(str(tmp_path / "jax")))
    got = x1.lock_graph(core.Project(str(tmp_path / "port")))
    assert got == want == {"server.writer._lock": {"server.db.Db._lock"},
                           "cache.A": {"cache.B"}}


# --------------------------------------------------------------------------
# schedex
# --------------------------------------------------------------------------

SHARED_SCENARIOS = ("mesh_cache_clear_vs_rebuild", "mesh_cache_prefix",
                    "failover_cursor_rotate_vs_store", "failover_cursor_prefix",
                    "spool_replay_vs_claim_expiry", "racy_counter")


@pytest.mark.parametrize("name", SHARED_SCENARIOS)
def test_scenario_exploration_equals_the_reference(name):
    ref, port = jscen.SCENARIOS[name], scen.SCENARIOS[name]
    assert port.expect == ref.expect
    kw = dict(seeds=4, preemptions=2, max_schedules=64,
              stop_on_failure=(ref.expect == "race"))
    want = jschedex.explore(ref, **kw)
    got = schedex.explore(port, **kw)
    assert (got.ok, got.schedules_run, got.baseline_switch_points,
            got.truncated) == (want.ok, want.schedules_run,
                               want.baseline_switch_points, want.truncated)
    assert got.ok == (port.expect == "pass")
    assert [f.schedule_id for f in got.failing] == [
        f.schedule_id for f in want.failing]
    # The lock labels are the same in both packages: the traces are equal
    # as they stand.
    assert [f.trace for f in got.failing] == [f.trace for f in want.failing]
    a = schedex.run_schedule(port, schedex.policy_for("rand:3"))
    b = jschedex.run_schedule(ref, jschedex.policy_for("rand:3"))
    assert (a.trace, a.ok) == (b.trace, b.ok)


def test_schedex_replay_is_byte_for_byte():
    report = schedex.explore(scen.RacyCounter, seeds=2, preemptions=1,
                             max_schedules=32, stop_on_failure=True)
    first = report.first_failing()
    a = schedex.replay(scen.RacyCounter, first.schedule_id)
    b = schedex.replay(scen.RacyCounter, first.schedule_id)
    assert a.trace == first.trace == b.trace
    assert not a.ok and not b.ok


def test_schedex_random_seed_is_deterministic():
    a = schedex.run_schedule(scen.RacyCounter, schedex.RandomPolicy(7))
    b = schedex.run_schedule(scen.RacyCounter, schedex.RandomPolicy(7))
    c = schedex.run_schedule(scen.RacyCounter, schedex.RandomPolicy(8))
    assert a.trace == b.trace and a.ok == b.ok
    assert c.schedule_id != a.schedule_id


def test_schedex_deadlock_is_detected():
    class Deadlock(scen.Scenario):
        scenario_name = "deadlock_fixture"

        def build(self, sched):
            la = schedex.Lock(sched, "t.a")
            lb = schedex.Lock(sched, "t.b")

            def one():
                with la:
                    sched.yield_point("one:mid")
                    with lb:
                        pass

            def two():
                with lb:
                    sched.yield_point("two:mid")
                    with la:
                        pass

            return [("one", one), ("two", two)]

    res = schedex.run_schedule(Deadlock, schedex.PreemptPolicy((1,)))
    assert not res.ok
    assert any("deadlock" in f.lower() for f in res.failures)


def test_instrument_window_installs_and_restores_hook():
    sched = schedex.Scheduler(schedex.FIFOPolicy())
    assert lockdep.factory_hook() is None
    with schedex.instrument(sched):
        minted = lockdep.make_lock("windowed.fixture")
        assert isinstance(minted, schedex.Lock)
        rm = lockdep.make_rlock("windowed.rfixture")
        assert isinstance(rm, schedex.Lock) and rm._re
    assert lockdep.factory_hook() is None
    assert type(lockdep.make_lock("after.fixture")) is type(threading.Lock())


def test_schedex_defaults_are_the_reference_knobs():
    from nice_tpu.utils import knobs

    assert (schedex.DEFAULT_SEEDS, schedex.DEFAULT_PREEMPTIONS,
            schedex.DEFAULT_MAX_SCHEDULES, schedex.DEFAULT_TIMEOUT_SECS) == (
        knobs.SCHEDEX_SEEDS.default, knobs.SCHEDEX_PREEMPTIONS.default,
        knobs.SCHEDEX_MAX_SCHEDULES.default,
        knobs.SCHEDEX_TIMEOUT_SECS.default)


def test_plan_build_scenario_holds_and_restores_the_module():
    from nice_tpu_torch.ops import cuda_build

    saved = (cuda_build._lock, cuda_build.nvcc_library, cuda_build.BUILD_DIR)
    report = schedex.explore(scen.PlanBuildPrefetchVsFirstUse, seeds=4,
                             preemptions=2, max_schedules=64)
    assert report.ok, [f.failures for f in report.failing]
    assert report.baseline_switch_points > 4
    assert (cuda_build._lock, cuda_build.nvcc_library,
            cuda_build.BUILD_DIR) == saved
    assert scen.PlanBuildPrefetchVsFirstUse.header not in cuda_build._plan_locks
    assert lockdep.factory_hook() is None


def test_scenarios_are_the_ported_set():
    assert set(scen.SCENARIOS) == set(SHARED_SCENARIOS) | {
        "plan_build_prefetch_vs_first_use"}
    for name in SHARED_SCENARIOS:
        assert name in jscen.SCENARIOS


# --------------------------------------------------------------------------
# The port's tree
# --------------------------------------------------------------------------

def _cli(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.scripts.{name}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=240)


def test_port_tree_is_racelint_clean_strict():
    proc = _cli("racelint", "--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "runtime edges 0" not in proc.stdout
    assert core.load_baseline(REPO) == {}


def test_port_tree_is_nicelint_clean_strict_with_x1():
    from nice_tpu_torch.analysis import core as ncore

    assert "X1" in ncore.all_rules()
    proc = _cli("nicelint", "--strict", "--rules", "X1")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_bare_lock_outside_lockdep_and_schedex():
    # Calls, read from the AST (the rules' own text names them too).
    from nice_tpu_torch.analysis import astutil

    allowed = {f"{PKG}/utils/lockdep.py", f"{PKG}/analysis/schedex.py"}
    found = []
    for src in core.Project(REPO).python_files(f"{PKG}/"):
        for node in ast.walk(src.tree()):
            if isinstance(node, ast.Call) and astutil.call_name(node) in (
                    "threading.Lock", "threading.RLock"):
                found.append((src.relpath, node.lineno))
    assert [f for f in found if f[0] not in allowed] == []
    assert {f[0] for f in found} <= allowed


def test_every_spawn_of_the_port_is_registered():
    proj = core.Project(REPO)
    ctx = context.build_context(REPO, proj)
    registered = threadspec.roots_by_site()
    sites = {(s.path, s.scope, s.kind) for s in ctx.spawn_sites}
    assert sites and sites <= set(registered)
    labels = {spec.label for spec in threadspec.LOCK_SPECS}
    assert set(ctx.lock_labels) == labels


def test_racecheck_cli_passes_every_scenario(tmp_path):
    out = tmp_path / "racecheck.json"
    proc = _cli("racecheck", "--seeds", "2", "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["ok"]
    assert set(report["scenarios"]) == set(scen.SCENARIOS)
    for name, entry in report["scenarios"].items():
        assert entry["verdict"] == "OK", name
        if scen.SCENARIOS[name].expect == "race":
            assert entry["replay"]["trace_identical"]
            assert entry["replay"]["still_failing"]
    bench = report["bench_schedex_off"]
    assert bench["hook_installed"] is False and bench["minted_is_plain"]
    assert bench["minted_type"] == "lock"
