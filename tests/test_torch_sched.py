"""The port's multi-tenant scheduler (nice_tpu_torch/sched/) on the CPU,
held against the JAX package's (nice_tpu/sched/, jnp backend) on the same
inputs, and the twins of tests/test_sched.py's contracts on the port's
engine: the same (tenant, page) sequence and stats under each policy, an
interleaved run byte-identical to solo runs, a preempted field resuming
byte-identically through resume_state, the starvation bound, the page
table's packing, the SLO boost, page_quantum, the --tenants grammar, the
client's --tenants run against the JAX server and the tuning report.

Every comparison is exact (field results are integers and the schedules
are sequences); there is no tolerance. The size is tests/test_sched.py's:
b17 at batch 256 and segment 2 (512-number segments), the segment set by a
tuned winner in a winners table of the test's own (the port's counterpart
of the JAX tests' NICE_TPU_MEGALOOP_SEGMENT pin).
"""

import itertools
import json
import sqlite3
import threading

import pytest

from nice_tpu import sched as jsched
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.server import app as server_app
from nice_tpu.server import db as jdb
from nice_tpu.server.db import Db
from nice_tpu_torch import sched
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import FieldResults, FieldSize
from nice_tpu_torch.obs.history import HistoryStore
from nice_tpu_torch.ops import autotune, engine

BASE = 17
BATCH = 256
SEGMENT = 2
RANGE_A = (5541, 9541)
RANGE_B = (9541, 13541)
QUIET = ("--telemetry-secs", "0", "--pyprof-hz", "0", "--memwatch-secs", "0",
         "--history-secs", "0")


@pytest.fixture(autouse=True)
def _small_pages(monkeypatch, tmp_path):
    """Both packages at batch 256 x segment 2: the JAX engine through its
    segment knob, the port through tuned winners (detailed and niceonly at
    b10, b17 and b40 on the CPU) in a table of this test's own. JAX's warm
    is patched out as tests/test_sched.py does; the port's runs (on the
    CPU it builds only the host library of the MSD filter)."""
    monkeypatch.setenv("NICE_TPU_MEGALOOP_SEGMENT", str(SEGMENT))
    monkeypatch.setattr(jsched.MultiTenantScheduler, "warm", lambda self: None)
    monkeypatch.setattr(autotune, "WINNERS_PATH", str(tmp_path / "w.json"))
    autotune.reset_for_tests()
    for base in (10, BASE, 40):
        for mode in ("detailed", "niceonly"):
            autotune.record(mode, base, "cpu",
                            {"batch_size": BATCH, "megaloop": SEGMENT})
    yield
    autotune.reset_for_tests()


def _spec(name, mode, priority=1, slo=0.0):
    return sched.TenantSpec(name=name, mode=mode, base=BASE, priority=priority,
                            slo_page_secs=slo, batch_size=BATCH)


def _jspec(name, mode, priority=1, slo=0.0):
    return jsched.TenantSpec(name=name, mode=mode, base=BASE,
                             priority=priority, slo_page_secs=slo,
                             backend="jnp", batch_size=BATCH)


def _sched(registry, source, **kw):
    kw.setdefault("policy", "deficit")
    kw.setdefault("page_batches", 1)
    # An always-elapsed quantum preempts at EVERY page boundary.
    kw.setdefault("quantum_secs", 1e-9)
    return sched.MultiTenantScheduler(registry, source, device="cpu", **kw)


def _solo(mode, rng):
    process = (engine.process_range_detailed if mode == "detailed"
               else engine.process_range_niceonly)
    return process(FieldSize(*rng), BASE, device="cpu")


def _jsolo(mode, rng):
    process = (jengine.process_range_detailed if mode == "detailed"
               else jengine.process_range_niceonly)
    return process(JFieldSize(*rng), BASE, backend="jnp", batch_size=BATCH)


def _pairs(results) -> tuple:
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _record_pages(scheduler) -> list:
    """Wrap one scheduler's _execute_page to record (tenant, page.seq,
    page.start) in execution order."""
    seen = []
    real = scheduler._execute_page

    def execute(spec, page):
        seen.append((spec.name, page.field_key, page.seq, page.start))
        return real(spec, page)

    scheduler._execute_page = execute
    return seen


# -- scheduler against scheduler ---------------------------------------------

_FIELDS = {
    "det": [("det/f0", RANGE_A[0], RANGE_A[0] + 2048),
            ("det/f1", RANGE_A[0] + 2048, RANGE_A[1])],
    "nice": [("nice/f0", RANGE_B[0], RANGE_B[1])],
}


@pytest.mark.parametrize("policy", ["deficit", "priority", "rr"])
def test_scheduler_equals_jax_scheduler(policy):
    """The same two tenants (a detailed one with two fields, a niceonly one
    with one), the same policy, page_batches and a counting clock (one tick
    a call, so quantum 2.5 preempts after the second page of a turn): the
    executed (tenant, field, page, start) sequence, the stats' pages,
    fields, preemptions and starved counts and every assembled field equal
    the JAX scheduler's."""
    runs = {}
    for pkg in ("jax", "port"):
        mod, spec = (jsched, _jspec) if pkg == "jax" else (sched, _spec)
        reg = mod.TenantRegistry([spec("det", "detailed", priority=3),
                                  spec("nice", "niceonly", priority=0)])
        source = mod.StaticSource({
            name: [(key, BASE, lo, hi) for key, lo, hi in fields]
            for name, fields in _FIELDS.items()})
        ticks = itertools.count()
        kw = dict(policy=policy, page_batches=1, quantum_secs=2.5,
                  starvation_rounds=3, clock=lambda: float(next(ticks)),
                  wall=lambda: 1_000_000.0)
        scheduler = (mod.MultiTenantScheduler(reg, source, **kw)
                     if pkg == "jax" else
                     mod.MultiTenantScheduler(reg, source, device="cpu", **kw))
        seen = _record_pages(scheduler)
        stats = scheduler.run()
        runs[pkg] = (seen, stats, source.results)
    (jseen, jstats, jres), (seen, stats, res) = runs["jax"], runs["port"]
    assert seen == jseen
    assert len(seen) == 8 + 8  # 512-number pages of 2 x 2000 and 4000
    assert stats["rounds"] == jstats["rounds"]
    for name in _FIELDS:
        for key in ("pages", "fields", "preemptions", "starved", "priority",
                    "boost"):
            assert stats["tenants"][name][key] == jstats["tenants"][name][key]
        assert set(res[name]) == {key for key, _, _ in _FIELDS[name]}
        for key in res[name]:
            assert _pairs(res[name][key]) == _pairs(jres[name][key])
    if policy == "priority":
        assert stats["tenants"]["nice"]["starved"] > 0
    else:
        assert all(t["preemptions"] > 0 for t in stats["tenants"].values())


# -- two-tenant byte-equivalence ----------------------------------------------


@pytest.mark.parametrize("policy", ["deficit", "priority", "rr"])
def test_interleaved_byte_identical_to_solo_runs(policy):
    """A detailed and a niceonly tenant interleaved page by page on the
    port's engine assemble exactly the results each gives alone (and the
    JAX engine gives alone)."""
    reg = sched.TenantRegistry([_spec("det", "detailed", priority=2),
                                _spec("nice", "niceonly", priority=1)])
    source = sched.StaticSource({
        "det": [("det/f0", BASE, *RANGE_A)],
        "nice": [("nice/f0", BASE, *RANGE_B)],
    })
    scheduler = _sched(reg, source, policy=policy)
    stats = scheduler.run()
    got_det = source.results["det"]["det/f0"]
    got_nice = source.results["nice"]["nice/f0"]
    assert got_det == _solo("detailed", RANGE_A)
    assert got_nice == _solo("niceonly", RANGE_B)
    assert got_nice.distribution == ()
    assert _pairs(got_det) == _pairs(_jsolo("detailed", RANGE_A))
    assert _pairs(got_nice) == _pairs(_jsolo("niceonly", RANGE_B))
    assert stats["tenants"]["det"]["pages"] == 8
    if policy != "priority":
        assert stats["tenants"]["det"]["preemptions"] > 0
        assert stats["tenants"]["nice"]["preemptions"] > 0
    assert scheduler.table.check_invariants() == []


# -- preemption resume via the checkpoint contract -----------------------------


def test_preempted_detailed_field_resumes_byte_identical():
    """Fold a strict prefix of a field's pages, export resume_state() and
    finish through the engine's resume= path: the stitched result equals
    the uninterrupted run, and the JAX engine takes the same state."""
    table = sched.PageTable(page_batches=1, device="cpu")
    work = table.add_field(_spec("det", "detailed"), "det/f0", BASE, *RANGE_A)
    assert len(work.pages) > 2
    for page in work.pages[:3]:
        work.fold(page, engine.process_range_detailed(
            FieldSize(page.start, page.end), BASE, device="cpu"))
    state = work.resume_state()
    assert state["cursor"] == work.pages[2].end
    assert state["remaining"] == [[work.pages[2].end, RANGE_A[1]]]
    got = engine.process_range_detailed(FieldSize(*RANGE_A), BASE,
                                        device="cpu", resume=state)
    assert got == _solo("detailed", RANGE_A)
    jgot = jengine.process_range_detailed(JFieldSize(*RANGE_A), BASE,
                                          backend="jnp", batch_size=BATCH,
                                          resume=state)
    assert _pairs(jgot) == _pairs(got)


def test_preempted_niceonly_field_resumes_byte_identical():
    table = sched.PageTable(page_batches=1, device="cpu")
    work = table.add_field(_spec("nice", "niceonly"), "nice/f0", BASE,
                           *RANGE_B)
    page = work.pages[0]
    work.fold(page, engine.process_range_niceonly(
        FieldSize(page.start, page.end), BASE, device="cpu"))
    got = engine.process_range_niceonly(FieldSize(*RANGE_B), BASE,
                                        device="cpu",
                                        resume=work.resume_state())
    assert got == _solo("niceonly", RANGE_B)


# -- starvation bound ----------------------------------------------------------


def test_starvation_bound_under_greedy_high_priority_tenant():
    """Pure priority and a priority-5 tenant with a deep queue: the
    priority-0 tenant still finishes because the skipped-rounds bound
    forces it onto the device."""
    reg = sched.TenantRegistry([_spec("greedy", "detailed", priority=5),
                                _spec("meek", "niceonly", priority=0)])
    step = 1024
    greedy = [(f"greedy/f{i}", BASE, RANGE_A[0] + i * step,
               RANGE_A[0] + (i + 1) * step) for i in range(3)]
    source = sched.StaticSource({
        "greedy": greedy,
        "meek": [("meek/f0", BASE, RANGE_B[0], RANGE_B[0] + 1024)],
    })
    stats = _sched(reg, source, policy="priority", starvation_rounds=2).run()
    assert stats["tenants"]["meek"]["fields"] == 1
    assert stats["tenants"]["meek"]["starved"] > 0
    assert stats["tenants"]["greedy"]["fields"] == len(greedy)


def test_starvation_bound_disabled_priority_runs_greedy_first():
    reg = sched.TenantRegistry([_spec("greedy", "detailed", priority=5),
                                _spec("meek", "niceonly", priority=0)])
    source = sched.StaticSource({
        "greedy": [("greedy/f0", BASE, RANGE_A[0], RANGE_A[0] + 2048)],
        "meek": [("meek/f0", BASE, RANGE_B[0], RANGE_B[0] + 1024)],
    })
    scheduler = _sched(reg, source, policy="priority", starvation_rounds=0)
    seen = _record_pages(scheduler)
    stats = scheduler.run()
    assert stats["tenants"]["meek"]["starved"] == 0
    assert stats["tenants"]["meek"]["fields"] == 1  # still drains at the end
    assert [name for name, *_ in seen] == ["greedy"] * 4 + ["meek"] * 2


# -- page-table packing invariants ---------------------------------------------


def test_pagetable_packing_invariants():
    """Pages align to each tenant's own segment quantum, cover fields
    exactly and never mix limb plans; a field pages once and folds in
    order. The quanta equal the JAX page table's."""
    table = sched.PageTable(page_batches=2, device="cpu")
    lo = sched.TenantSpec(name="lo", mode="detailed", base=10, batch_size=256)
    hi = sched.TenantSpec(name="hi", mode="detailed", base=40, batch_size=128)
    w1 = table.add_field(lo, "lo/f0", 10, 1000, 6000)
    w2 = table.add_field(hi, "hi/f0", 40, 7000, 8000)
    assert table.check_invariants() == []
    assert table.quantum_for(lo) == 1024  # 2 x 256 x 2
    assert table.quantum_for(hi) == 512  # 2 x 128 x 2
    jtable = jsched.PageTable(page_batches=2)
    for spec in (lo, hi):
        jspec = jsched.TenantSpec(name=spec.name, mode=spec.mode,
                                  base=spec.base, backend="jnp",
                                  batch_size=spec.batch_size)
        assert table.quantum_for(spec) == jtable.quantum_for(jspec)
    assert all(p.size == 1024 for p in w1.pages[:-1])
    assert all(p.tenant == "lo" and p.base == 10 for p in w1.pages)
    assert all(p.tenant == "hi" and p.base == 40 for p in w2.pages)
    assert w1.pages[0].start == 1000 and w1.pages[-1].end == 6000
    with pytest.raises(ValueError, match="already paged"):
        table.add_field(lo, "lo/f0", 10, 1000, 6000)
    with pytest.raises(ValueError, match="out of order"):
        w1.fold(w1.pages[1], FieldResults(distribution=(), nice_numbers=()))


def test_pagetable_rejects_empty_field_and_zero_batches():
    table = sched.PageTable(page_batches=1, device="cpu")
    with pytest.raises(ValueError, match="empty field"):
        table.add_field(_spec("t", "detailed"), "t/f0", BASE, 100, 100)
    with pytest.raises(ValueError, match="page_batches"):
        sched.PageTable(page_batches=0, device="cpu")


# -- SLO-burn priority boost -----------------------------------------------------


def test_slo_burn_boosts_priority_and_preempts():
    """A tenant blowing its page budget earns a warn-level boost that raises
    its effective priority above an idle incumbent and surfaces as a
    slo_boost preemption at the incumbent's next boundary."""
    now = 1_000_000.0
    slow = _spec("slow", "detailed", priority=0, slo=0.01)
    calm = _spec("calm", "detailed", priority=1)
    reg = sched.TenantRegistry([slow, calm])
    source = sched.StaticSource({
        "slow": [("slow/f0", BASE, RANGE_A[0], RANGE_A[0] + 1024)],
        "calm": [("calm/f0", BASE, RANGE_B[0], RANGE_B[0] + 1024)],
    })
    hist = HistoryStore()
    scheduler = _sched(reg, source, slo_boost=2, history=hist,
                       wall=lambda: now, quantum_secs=0.0)
    # bad_fraction 1.0 against a 0.25 objective burns 4x on both windows:
    # warn -> boost 1 x 2.
    for i in range(10):
        hist.add('nice_sched_page_seconds{tenant="slow"}', 1.0, ts=now - i)
    scheduler._slo_tick(now=now)
    assert scheduler.effective_priority(slow) == 0 + 2
    assert scheduler.effective_priority(calm) == 1
    assert scheduler._ensure_work(slow)
    assert scheduler._preempt_reason(calm, turn_started=0.0) == "slo_boost"
    # An override that lifts the budget above every page ends the boost.
    lifted = _sched(reg, sched.StaticSource({}), slo_boost=2, history=hist,
                    wall=lambda: now,
                    slo_overrides={"TENANT_SLOW_THRESHOLD": 5.0})
    lifted._slo_tick(now=now)
    assert lifted.effective_priority(slow) == 0


def test_no_budget_no_boost():
    spec = _spec("free", "detailed")  # slo_page_secs=0: no SLO spec at all
    scheduler = _sched(sched.TenantRegistry([spec]),
                       sched.StaticSource({"free": []}), slo_boost=2)
    scheduler._slo_tick(now=123.0)
    assert scheduler.effective_priority(spec) == spec.priority
    assert scheduler.slo.specs == []


def test_unknown_policy_and_missing_card_raise():
    reg = sched.TenantRegistry([_spec("t", "detailed")])
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        _sched(reg, sched.StaticSource({}), policy="fifo")
    on_card = sched.MultiTenantScheduler(
        reg, sched.StaticSource({"t": [("t/f0", BASE, *RANGE_A)]}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        on_card.run()


# -- page_quantum ----------------------------------------------------------------


def test_page_quantum_explicit_and_tuned():
    """batch x clamp_segment(segment, batch): from the explicit batch with
    the tuned segment, from the tuned winner alone, and from the defaults
    where no winner exists (b50, untuned here)."""
    assert engine.page_quantum("detailed", BASE, device="cpu",
                               batch_size=1024) == 1024 * SEGMENT
    assert engine.page_quantum("detailed", BASE, device="cpu") == BATCH * SEGMENT
    assert engine.page_quantum("niceonly", BASE, device="cpu") == BATCH * SEGMENT
    assert engine.page_quantum("detailed", 50, device="cpu") == \
        engine.DEFAULT_BATCH_SIZE * engine.MEGALOOP_SEGMENT_DEFAULT
    # A segment past the int32 flush bound is clamped as the loop clamps it.
    autotune.record("detailed", 50, "cpu",
                    {"batch_size": 1 << 20, "megaloop": 4096})
    assert engine.page_quantum("detailed", 50, device="cpu") == \
        (1 << 20) * engine.clamp_segment(4096, 1 << 20)
    assert engine.clamp_segment(4096, 1 << 20) < 4096
    # The scalar oracle has no segment: a page is one batch.
    assert engine.page_quantum("detailed", BASE, device="cpu",
                               backend="scalar", batch_size=300) == 300


def test_page_boundaries_fall_on_segment_boundaries():
    """Every page boundary of a field is a segment boundary of the field's
    uninterrupted detailed loop (the progress callback's `done` after each
    dispatched segment)."""
    quantum = engine.page_quantum("detailed", BASE, device="cpu")
    table = sched.PageTable(page_batches=3, device="cpu")
    work = table.add_field(_spec("det", "detailed"), "det/f0", BASE, *RANGE_A)
    done = set()
    engine.process_range_detailed(FieldSize(*RANGE_A), BASE, device="cpu",
                                  progress=lambda d, _t: done.add(d))
    assert len(done) == -(-(RANGE_A[1] - RANGE_A[0]) // quantum)
    for page in work.pages:
        assert page.end - RANGE_A[0] in done
        assert (page.start - RANGE_A[0]) % quantum == 0


# -- grammar against grammar --------------------------------------------------------

_EXAMPLE = "canon:detailed:40:prio=3:slo=5;mining:near-miss:40;sweep:hi-base:520"
_FIELDS_COMPARED = ("name", "mode", "base", "priority", "slo_page_secs",
                    "base_min", "base_max", "batch_size", "kind")


@pytest.mark.parametrize("text", [
    _EXAMPLE,
    " a:niceonly:98:bases=90-100:batch=4096 ; b:detailed:10:bases=12 ;",
    "c:NICEONLY:50:prio=-1:slo=0.25:",
    "",
])
def test_parse_tenants_equals_jax(text):
    """The port's parse_tenants gives the JAX package's specs (every field
    but backend, whose default is the port's "device" where JAX's is
    "jax"), and the claim windows."""
    got, want = sched.parse_tenants(text), jsched.parse_tenants(text)
    assert [tuple(getattr(s, f) for f in _FIELDS_COMPARED) for s in got] == \
        [tuple(getattr(s, f) for f in _FIELDS_COMPARED) for s in want]
    assert [(s.claim_base_min, s.claim_base_max) for s in got] == \
        [(s.claim_base_min, s.claim_base_max) for s in want]
    assert all(s.backend == "device" for s in got)


@pytest.mark.parametrize("text,match", [
    ("a:detailed", "want name:mode:base"),
    ("a:detailed:forty", "base must be an integer"),
    ("a:sideways:40", "mode must be one of"),
    ("a b:detailed:40", "bad tenant name"),
    ("a:detailed:3", "base 3 < 4"),
    ("a:hi-base:510", "hi-base sweep needs base > 510"),
    ("a:detailed:40:bases=50-45", "is empty"),
    ("a:detailed:40:colour=red", "unknown option"),
])
def test_parse_tenants_errors_equal_jax(text, match):
    with pytest.raises(ValueError, match=match):
        jsched.parse_tenants(text)
    with pytest.raises(ValueError, match=match):
        sched.parse_tenants(text)


def test_registry_and_backends():
    reg = sched.TenantRegistry(sched.parse_tenants(_EXAMPLE))
    assert reg.names() == ["canon", "mining", "sweep"]
    assert reg.slo_pairs() == [("canon", 5.0), ("mining", 0.0),
                               ("sweep", 0.0)]
    assert reg.get("mining").priority == 0
    with pytest.raises(ValueError, match="duplicate"):
        reg.add(sched.near_miss_tenant(40, name="canon"))
    flipped = reg.replace(sched.TenantSpec(name="canon", mode="detailed",
                                           base=40, priority=9))
    assert reg.get("canon") is flipped
    assert sched.hi_base_sweep_tenant().base == 520
    for backend in ("device", "scalar", "native"):
        assert sched.parse_tenants(f"t:detailed:40:backend={backend}")[0] \
            .backend == backend
    with pytest.raises(ValueError, match="backend must be one of"):
        sched.parse_tenants("t:detailed:40:backend=jnp")


def test_tenant_report_rows():
    rows = autotune.tenant_report([("canon", "detailed", BASE, "device"),
                                   ("wide", "niceonly", 50, "device")], "cpu")
    assert rows == [
        {"tenant": "canon", "key": f"detailed|b{BASE}|cpu", "tuned": True,
         "batch_size": BATCH, "megaloop": SEGMENT, "use_mxu": 0,
         "page_quantum": BATCH * SEGMENT},
        {"tenant": "wide", "key": "niceonly|b50|cpu", "tuned": False,
         "batch_size": engine.DEFAULT_BATCH_SIZE,
         "megaloop": engine.MEGALOOP_SEGMENT_DEFAULT, "use_mxu": 0,
         "page_quantum": engine.DEFAULT_BATCH_SIZE
         * engine.MEGALOOP_SEGMENT_DEFAULT},
    ]


# -- the client's --tenants against the JAX server -----------------------------------

FIELD = 1 << 12
SEED_START = 3621949312977 - FIELD - 700  # b40, a near miss in field 2


@pytest.fixture()
def server(tmp_path, monkeypatch):
    """The JAX server over six b40 fields of 2^12 in one chunk (as
    tests/test_torch_block_client.py seeds its server), and the port
    transport's module state reset around the test."""

    def reset():
        with api_client._epoch_lock:
            api_client._last_epoch = 0
        with api_client._failover_lock:
            api_client._failover_idx.clear()
            api_client._failover_gen.clear()
        with api_client._dead_hosts_lock:
            api_client._dead_hosts.clear()
        api_client.close_connections()

    reset()
    real = jdb.base_range.get_base_range
    db_path = str(tmp_path / "nice.db")
    with monkeypatch.context() as m:
        m.setattr(jdb.base_range, "get_base_range",
                  lambda b: (SEED_START, SEED_START + 6 * FIELD) if b == 40
                  else real(b))
        m.setattr(jdb.generate_chunks, "group_fields_into_chunks",
                  lambda fields: [JFieldSize(fields[0].range_start,
                                             fields[-1].range_end)])
        db = Db(db_path)
        db.seed_base(40, field_size=FIELD)
        db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0,
                             prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", db_path
    reset()
    httpd.shutdown()


def _query(db_path, sql, params=()):
    conn = sqlite3.connect(db_path)
    conn.row_factory = sqlite3.Row
    try:
        return conn.execute(sql, params).fetchall()
    finally:
        conn.close()


def test_tenants_client_against_jax_server(server):
    """`--tenants` with a detailed, a niceonly and a near-miss tenant on
    the CPU: one claim each, stamped with the tenant's name and drawn from
    its base, and each submission accepted and equal to the JAX scheduler
    (jnp backend) on the same claimed fields."""
    api, db_path = server
    rc = client.main([
        "--api-base", api, "--username", "tenanty", "--device", "cpu",
        "--tenants", "canon:detailed:40:prio=3;nice:niceonly:40:prio=1;"
        "mining:near-miss:40", "--sched-page-batches", "1",
        "--sched-quantum-secs", "1e-9", "--max-retries", "0", *QUIET])
    assert rc == 0
    claims = _query(db_path, "SELECT c.id, c.tenant, f.base_id AS base, "
                    "f.range_start, f.range_end FROM claims c JOIN fields f "
                    "ON f.id = c.field_id ORDER BY c.id")
    assert sorted(r["tenant"] for r in claims) == ["canon", "mining", "nice"]
    jfields = {}
    for r in claims:
        assert r["base"] == 40
        subs = _query(db_path, "SELECT distribution, numbers FROM submissions "
                      "WHERE claim_id = ?", (r["id"],))
        assert len(subs) == 1, f"claim {r['id']} has no submission"
        jfields[r["tenant"]] = (int(r["range_start"]), int(r["range_end"]),
                                subs[0])
    jreg = jsched.TenantRegistry([
        jsched.TenantSpec(name="canon", mode="detailed", base=40,
                          priority=3, backend="jnp", batch_size=BATCH),
        jsched.TenantSpec(name="nice", mode="niceonly", base=40,
                          backend="jnp", batch_size=BATCH),
        jsched.TenantSpec(name="mining", mode="detailed", base=40,
                          priority=0, backend="jnp", batch_size=BATCH,
                          kind="near_miss")])
    jsource = jsched.StaticSource({
        name: [(name, 40, lo, hi)] for name, (lo, hi, _) in jfields.items()})
    jsched.MultiTenantScheduler(jreg, jsource, page_batches=1,
                                quantum_secs=1e-9).run()
    for name, (_lo, _hi, sub) in jfields.items():
        want = jsource.results[name][name]
        dist = sorted((int(d["num_uniques"]), int(d["count"]))
                      for d in json.loads(sub["distribution"] or "[]"))
        nums = sorted((int(n["number"]), int(n["num_uniques"]))
                      for n in json.loads(sub["numbers"]))
        assert (dist, nums) == _pairs(want), name


def test_tenants_client_rejects_empty_spec(server):
    api, _ = server
    assert client.main(["--api-base", api, "--device", "cpu", "--tenants",
                        " ; ", *QUIET]) == 2


def test_scheduler_flags():
    """The reference's knobs as flags: their defaults, and --slo-override
    items parsed into the overrides the SLO specs take."""
    args = client.build_parser().parse_args([])
    assert (args.sched_policy, args.sched_page_batches,
            args.sched_quantum_secs, args.sched_starvation_rounds,
            args.sched_slo_boost, args.slo_window_scale) == \
        ("deficit", 4, 5.0, 8, 2, 1.0)
    args = client.build_parser().parse_args(
        ["--slo-override", "tenant_canon_threshold=2",
         "--slo-override", "TENANT_CANON_OBJECTIVE=0.5"])
    assert dict(args.slo_override) == {"TENANT_CANON_THRESHOLD": 2.0,
                                       "TENANT_CANON_OBJECTIVE": 0.5}
    for bad in ("TENANT_CANON=2", "TENANT_CANON_THRESHOLD=two"):
        with pytest.raises(SystemExit):
            client.build_parser().parse_args(["--slo-override", bad])
