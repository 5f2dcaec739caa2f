"""The port's observability layer (nice_tpu_torch/obs) against the JAX
package's (nice_tpu/obs) on the CPU: byte-equal Prometheus text for the same
updates, the series declarations, trace ids and traceparents, the journal
buffer, history tiers and pyprof's folded stacks on the same synthetic
samples; and the port's own pieces: the span sink, the flight recorder,
memwatch on torch.cuda (stubbed here), the local metrics endpoint, the
torch.profiler hook and the JSON log sink. Every test restores both
packages' process state."""

import json
import logging
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nice_tpu import obs as jobs
from nice_tpu.obs import history as jhistory
from nice_tpu.obs import journal as jjournal
from nice_tpu.obs import metrics as jmetrics
from nice_tpu.obs import pyprof as jpyprof
from nice_tpu_torch import obs
from nice_tpu_torch.obs import (
    flight,
    history,
    journal,
    logsink,
    memwatch,
    metrics,
    pyprof,
    series,
    serve,
    trace,
)


def _save_jax_obs():
    """A restore() of the JAX layer's process state this file touches: the
    registry's values, the journal buffer and pyprof's tables."""
    values = {}
    for name, m in jobs.REGISTRY.metrics().items():
        with m._lock:
            if isinstance(m, jmetrics.Histogram):
                values[name] = {k: (list(st.counts), st.sum, st.count)
                                for k, st in m._states.items()}
            else:
                values[name] = dict(m._values)
    with jjournal._client_lock:
        events = list(jjournal._client_events)
    with jpyprof._lock:
        prof = ({r: dict(t) for r, t in jpyprof._tables.items()},
                dict(jpyprof._root_samples), jpyprof._total_samples,
                jpyprof._distinct_stacks)

    def restore():
        for name, m in jobs.REGISTRY.metrics().items():
            saved = values.get(name)
            with m._lock:
                if isinstance(m, jmetrics.Histogram):
                    m._states.clear()
                    for k, (counts, total, count) in (saved or {}).items():
                        st = jmetrics._HistState(len(m.buckets))
                        st.counts, st.sum, st.count = list(counts), total, count
                        m._states[k] = st
                else:
                    m._values.clear()
                    m._values.update(saved or {})
        with jjournal._client_lock:
            jjournal._client_events[:] = events
        with jpyprof._lock:
            jpyprof._tables.clear()
            jpyprof._tables.update(prof[0])
            jpyprof._root_samples.clear()
            jpyprof._root_samples.update(prof[1])
            jpyprof._total_samples, jpyprof._distinct_stacks = prof[2:]

    return restore


@pytest.fixture(autouse=True)
def _isolated():
    restore = _save_jax_obs()
    obs.reset()
    yield
    obs.reset()
    restore()


# --- the registry ----------------------------------------------------------


def _drive(reg_mod, registry, seed: int) -> None:
    """A seeded sequence of counter, gauge and histogram updates."""
    rng = np.random.default_rng(seed)
    c = reg_mod.counter("t_requests_total", "Requests.", ("endpoint",),
                        registry=registry)
    c0 = reg_mod.counter("t_plain_total", "No labels.", registry=registry)
    g = reg_mod.gauge("t_depth", "Depth.", ("queue", "shard"),
                      registry=registry)
    h = reg_mod.histogram("t_latency_seconds", "Latency.", ("path",),
                          registry=registry)
    h2 = reg_mod.histogram("t_sizes", "", (), buckets=(1.0, 4.0, 16.0),
                           registry=registry)
    for _ in range(200):
        op = int(rng.integers(5))
        if op == 0:
            c.labels(f"e{int(rng.integers(3))}").inc(float(rng.integers(1, 9)))
        elif op == 1:
            c0.inc(float(rng.random()))
        elif op == 2:
            g.labels(f"q{int(rng.integers(2))}", str(int(rng.integers(3)))).set(
                float(rng.normal()) * 1e3)
        elif op == 3:
            h.labels(f"p{int(rng.integers(2))}").observe(
                float(rng.exponential(0.05)))
        else:
            h2.observe(float(rng.integers(0, 40)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_is_byte_equal_for_the_same_updates(seed):
    mine, theirs = metrics.Registry(), jmetrics.Registry()
    _drive(metrics, mine, seed)
    _drive(jmetrics, theirs, seed)
    assert mine.render() == theirs.render()
    assert mine.render().count("\n") > 20


def test_observe_many_equals_observe_in_turn():
    values = np.random.default_rng(5).exponential(0.01, 300).tolist()
    a, b = metrics.Registry(), metrics.Registry()
    for v in values:
        a.histogram("x_seconds", "x", ("k",)).labels("1").observe(v)
    b.histogram("x_seconds", "x", ("k",)).labels("1").observe_many(values)
    assert a.render() == b.render()


def test_registry_reset_keeps_declared_series_at_zero():
    r = metrics.Registry()
    r.counter("a_total", "a", ("m",)).labels("x").inc(3)
    r.histogram("b_seconds", "b").observe(0.2)
    r.reset()
    fresh = metrics.Registry()
    fresh.counter("a_total", "a", ("m",)).labels("x")
    fresh.histogram("b_seconds", "b")
    assert r.render() == fresh.render()


def test_port_series_match_their_jax_declarations():
    declared = metrics.REGISTRY.metrics()
    assert len(declared) >= 50
    for name, m in declared.items():
        ref = jobs.REGISTRY.get(name)
        assert ref is not None, f"{name} is not a JAX series"
        assert (m.kind, m.help, m.labelnames) == \
            (ref.kind, ref.help, ref.labelnames), name
        if m.kind == "histogram":
            assert m.buckets == ref.buckets, name
    for name in ("nice_pallas_dispatch_seconds", "nice_mesh_devices",
                 "nice_mesh_feed_idle_seconds",
                 "nice_mesh_reshard_events_total",
                 "nice_engine_backend_downgrades_total",
                 "nice_autotune_events_total", "nice_stepprof_phase_seconds",
                 "nice_daemon_heartbeat_timestamp_seconds"):
        assert name in declared
    assert series.MESH_DEVICES.value() == 1
    assert set(series.KERNELS) == set(
        k for (k,) in series.PALLAS_DISPATCH_SECONDS.label_sums())


# --- trace ids -------------------------------------------------------------


def test_trace_ids_and_traceparents_equal_the_reference():
    rng = np.random.default_rng(11)
    for claim in [0, 1, 42, *rng.integers(1, 1 << 40, 20).tolist()]:
        tid = obs.claim_trace_id(int(claim))
        assert tid == jobs.claim_trace_id(int(claim))
        span_id = os.urandom(8).hex()
        header = obs.make_traceparent(tid, span_id)
        assert header == jobs.make_traceparent(tid, span_id)
        assert obs.parse_traceparent(header) == tid
    for bad in (None, "", "garbage", "00-short-beef-01",
                "00-" + "g" * 32 + "-" + "0" * 16 + "-01",
                "00-" + "a" * 32 + "-" + "0" * 15 + "-01",
                "  00-" + "A" * 32 + "-" + "0" * 16 + "-01  "):
        assert obs.parse_traceparent(bad) == jobs.parse_traceparent(bad)


def test_trace_context_is_thread_local_and_restores():
    assert obs.current_trace_id() is None
    with obs.trace_context("a" * 32):
        assert obs.parse_traceparent(obs.current_traceparent()) == "a" * 32
        seen = []
        t = threading.Thread(target=lambda: seen.append(obs.current_trace_id()))
        t.start()
        t.join()
        assert seen == [None]
    assert obs.current_traceparent() is None


def test_span_sink_writes_begin_and_end_and_rotates(tmp_path):
    sink = tmp_path / "trace.jsonl"
    trace.configure(str(sink), max_bytes=600)
    with obs.trace_context("b" * 32):
        with obs.span("outer", base=40):
            with obs.span("inner"):
                pass
    rows = [json.loads(x) for x in sink.read_text().splitlines()]
    rows += [json.loads(x) for x in (tmp_path / "trace.jsonl.1").read_text(
    ).splitlines()] if (tmp_path / "trace.jsonl.1").exists() else []
    names = {(r["name"], r["event"]) for r in rows}
    assert {("outer", "begin"), ("inner", "begin"), ("inner", "end"),
            ("outer", "end")} <= names
    assert all(r["trace_id"] == "b" * 32 for r in rows)
    inner_end = next(r for r in rows if r["name"] == "inner"
                     and r["event"] == "end")
    assert inner_end["parent"] == "outer" and inner_end["status"] == "ok"
    assert (tmp_path / "trace.jsonl.1").exists()  # 600 bytes rotated
    assert trace.sink_path() == str(sink)
    # The span histogram counts with or without a sink.
    trace.configure(None)
    with obs.span("outer"):
        pass
    assert series.TRACE_SPAN_SECONDS.label_sums()[("outer",)][1] == 2


def test_unopenable_trace_sink_raises(tmp_path):
    with pytest.raises(OSError):
        trace.configure(str(tmp_path / "no" / "such" / "dir.jsonl"))


def test_profiler_writes_a_chrome_trace_and_is_a_noop_without_a_dir(tmp_path):
    with obs.profiler("nothing"):
        pass
    assert not list(tmp_path.iterdir())
    trace.configure(profile_dir=str(tmp_path / "prof"))
    with obs.profiler("field"):
        torch.arange(1000).sum()
    (path,) = (tmp_path / "prof").iterdir()
    assert path.name.startswith(f"field-{os.getpid()}-")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)


# --- flight recorder and journal ----------------------------------------------


def test_flight_ring_is_bounded_and_dumps_atomically(tmp_path):
    flight.configure(str(tmp_path), capacity=16)
    for i in range(40):
        flight.record("retry", attempt=i)
    ring = flight.snapshot()
    assert len(ring) == 16 and ring[0]["attempt"] == 24
    assert [r["seq"] for r in ring] == list(range(25, 41))
    path = flight.dump(reason="manual")
    assert path == str(tmp_path / f"nice-flight-{os.getpid()}-manual.json")
    dumped = json.loads(open(path).read())
    assert dumped["total_recorded"] == 40 and dumped["capacity"] == 16
    assert series.FLIGHT_EVENTS.labels("retry").value() == 40
    assert series.FLIGHT_DUMPS.labels("manual").value() == 1
    flight.configure(capacity=4)  # at least 16
    assert flight.RECORDER.capacity == 16


def test_journal_buffer_matches_the_reference():
    rng = np.random.default_rng(3)
    for i in range(300):  # past the 256-event cap
        claim = int(rng.integers(1, 99))
        detail = {"secs": round(float(rng.random()), 6), "i": i}
        journal.record_client_event("claim_rtt", claim_id=claim, **detail)
        jobs.journal.record_client_event("claim_rtt", claim_id=claim,
                                         **detail)
    journal.record_client_event("phases")
    jobs.journal.record_client_event("phases")
    mine, theirs = journal.drain_client_events(), \
        jobs.journal.drain_client_events()
    assert mine == theirs and len(mine) == 256
    assert journal.drain_client_events() == []
    assert set(journal.CLIENT_EVENT_KINDS) <= set(jobs.journal.CLIENT_EVENT_KINDS)


# --- history and pyprof ----------------------------------------------------


def test_history_tiers_match_the_reference():
    rng = np.random.default_rng(7)
    mine = history.HistoryStore(tier1_secs=5.0, tier2_secs=20.0)
    theirs = jhistory.HistoryStore(tier1_secs=5.0, tier2_secs=20.0)
    regs = (metrics.Registry(), jmetrics.Registry())
    for mod, reg in zip((metrics, jmetrics), regs):
        mod.counter("h_total", "h", ("k",), registry=reg)
        mod.histogram("h_seconds", "h", registry=reg)
    ts = 1_700_000_000.0
    for step in range(120):
        ts += float(rng.uniform(0.5, 2.0))
        k = f"k{int(rng.integers(2))}"
        v = float(rng.exponential(0.1))
        for mod, reg in zip((metrics, jmetrics), regs):
            reg.counter("h_total", "h", ("k",)).labels(k).inc(1)
            reg.histogram("h_seconds", "h").observe(v)
        mine.add("raw_series", v, ts)
        theirs.add("raw_series", v, ts)
        mine.sample_registries([regs[0]], ts)
        theirs.sample_registries([regs[1]], ts)
    assert mine.series_names() == theirs.series_names()
    for name in mine.series_names():
        assert mine.query(name) == theirs.query(name), name
    assert mine.query("raw_series")["1m"], "no coarse tier was filled"
    for q in ("", "series=raw_series", "series=raw_series&tier=1m,15m",
              "series=h_seconds_p95&since=1700000050", "series=nope",
              "series=raw_series&since=x", "series=raw_series&tier=bad",
              'series=h_total{k="k0"},h_total'):
        assert history.handle_query(mine, q) == \
            jhistory.handle_query(theirs, q), q


def test_pyprof_folded_stacks_match_the_reference(monkeypatch):
    frame = sys._getframe()
    assert pyprof._fold(frame, 24) == jpyprof._fold(frame, 24)
    assert pyprof._fold(frame, 2) == jpyprof._fold(frame, 2)
    rng = np.random.default_rng(9)
    tables, samples = {}, {}
    for _ in range(60):
        root = ["main", "engine-feed", "unattributed"][int(rng.integers(3))]
        stack = ";".join(f"f{int(x)}.py:g{int(x)}"
                         for x in rng.integers(0, 4, int(rng.integers(1, 4))))
        tables.setdefault(root, {})
        tables[root][stack] = tables[root].get(stack, 0) + 1
        samples[root] = samples.get(root, 0) + 1
    # A JAX sampler thread (started by a JAX client run in this worker)
    # waits on this lock while the JAX tables hold the synthetic samples.
    lock = threading.RLock()
    monkeypatch.setattr(jpyprof, "_lock", lock)
    with lock:
        for mod in (pyprof, jpyprof):
            monkeypatch.setattr(mod, "_tables",
                                {r: dict(t) for r, t in tables.items()})
            monkeypatch.setattr(mod, "_root_samples", dict(samples))
            monkeypatch.setattr(mod, "_total_samples", 60)
        assert pyprof.render_folded() == jpyprof.render_folded()
        assert pyprof.top_stacks(5) == jpyprof.top_stacks(5)
        assert pyprof.snapshot(3)["roots"] == jpyprof.snapshot(3)["roots"]
        for q in ("fmt=folded", "fmt=bogus"):
            assert pyprof.handle_query(q) == jpyprof.handle_query(q)


def test_pyprof_attributes_port_threads_and_off_starts_nothing():
    assert pyprof.attribute("MainThread") == "main"
    assert pyprof.attribute("nice-api_0") == "nice-api"
    assert pyprof.attribute("detailed-collect") == "detailed-collect"
    assert pyprof.attribute("Thread-3") is None
    pyprof.configure(hz=0)
    assert pyprof.maybe_start() is False
    done = threading.Event()
    t = threading.Thread(target=done.wait, name="engine-feed")
    t.start()
    try:
        assert pyprof.take_sample() >= 1
    finally:
        done.set()
        t.join()
    snap = pyprof.snapshot()
    assert snap["roots"]["engine-feed"]["samples"] == 1
    assert "main" not in snap["roots"]  # the calling thread is never sampled


# --- memwatch ----------------------------------------------------------------


def test_memwatch_reports_no_device_before_cuda_is_initialized(tmp_path):
    (tmp_path / "spool").mkdir()
    (tmp_path / "spool" / "a.json").write_bytes(b"x" * 100)
    (tmp_path / "spool" / "b.json.rejected").write_bytes(b"y" * 30)
    memwatch.watch_path("spool", str(tmp_path / "spool"))
    memwatch.watch_path("ckpt", None)
    out = memwatch.sample()
    assert "devices" not in out and "live_arrays" not in out
    assert out["rss_bytes"] > 0 and out["rss_peak_bytes"] > 0
    assert out["disk_bytes"] == {"spool": 130, "quarantine": 30}
    assert memwatch.summary() == out
    assert series.MEM_SAMPLES.value() == 1
    assert memwatch.maybe_start_sampler(0) is False


def test_memwatch_reads_torch_cuda_in_the_reference_keys(monkeypatch):
    stats = {"allocated_bytes.all.current": 1000,
             "allocated_bytes.all.peak": 5000,
             "active.all.current": 7, "active_bytes.all.current": 1200}
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: calls.append(("stats", i)) or stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: calls.append(("info", i)) or (10, 80000))
    out = memwatch.sample()
    assert out["devices"] == {"0": {"in_use": 1000, "peak": 5000,
                                    "limit": 80000}}
    assert (out["live_arrays"], out["live_array_bytes"]) == (7, 1200)
    assert calls == [("stats", 0), ("info", 0)]
    assert series.MEM_DEVICE_LIMIT_BYTES.labels("0").value() == 80000


# --- the local endpoint and the log sink -----------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_local_endpoint_serves_metrics_flight_history_profile():
    srv = obs.maybe_serve_metrics(0)
    assert obs.maybe_serve_metrics(0) is srv  # once a process
    port = srv.server_address[1]
    assert series.METRICS_BOUND_PORT.value() == port
    base = f"http://127.0.0.1:{port}"
    flight.record("claim", claim=3)
    status, ctype, body = _get(base + "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    assert f"nice_metrics_bound_port {port}" in body.decode()
    _, _, body = _get(base + "/debug/flight")
    assert json.loads(body)["events"][-1]["claim"] == 3
    history.STORE.sample_registries([metrics.REGISTRY])
    _, _, body = _get(base + "/history")
    assert "nice_client_numbers_total" in json.loads(body)["series"]
    _, _, body = _get(base + "/debug/profile?fmt=json")
    assert json.loads(body)["samples"] == 0
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/nope")
    assert err.value.code == 404
    assert json.loads(err.value.read())["known"][0] == "/metrics"
    assert obs.maybe_serve_metrics(None) is None


def test_a_port_that_cannot_be_bound_raises():
    holder = serve.serve_metrics(0)
    try:
        serve.stop()
        with pytest.raises(OSError):
            obs.maybe_serve_metrics(holder.server_address[1])
    finally:
        holder.shutdown()
        holder.server_close()


def test_json_log_lines_carry_the_trace_id(tmp_path):
    path = tmp_path / "client.log"
    root = logging.getLogger()
    level = root.level
    try:
        logsink.install("debug", str(path))
        with obs.trace_context("c" * 32):
            logging.getLogger("nice_tpu_torch.test").info("hello %d", 7)
        logsink.install("info")  # re-points: the file handler goes
        logging.getLogger("nice_tpu_torch.test").info("not in the file")
    finally:
        for h in logsink._installed:
            root.removeHandler(h)
        logsink._installed.clear()
        root.setLevel(level)
    (line,) = path.read_text().splitlines()
    rec = json.loads(line)
    assert rec["msg"] == "hello 7" and rec["trace_id"] == "c" * 32
    assert rec["level"] == "info" and rec["logger"] == "nice_tpu_torch.test"


def test_install_arms_the_crash_and_sigusr2_dumps(tmp_path):
    """In a process of its own: the hooks are the process's (the command
    line's entry arms them), so this process keeps its handlers."""
    import subprocess

    code = (
        "import os, signal, sys, time\n"
        "from nice_tpu_torch.obs import flight\n"
        f"flight.configure({str(tmp_path)!r}, 16)\n"
        "flight.install()\n"
        "flight.install()\n"
        "flight.record('claim', claim=5)\n"
        "os.kill(os.getpid(), signal.SIGUSR2)\n"
        "time.sleep(0.2)\n"
        "print(os.getpid(), flush=True)\n"
        "raise RuntimeError('boom')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 1 and "boom" in proc.stderr
    pid = int(proc.stdout.split()[0])
    live = json.loads((tmp_path / f"nice-flight-{pid}-sigusr2.json").read_text())
    assert [e["kind"] for e in live["events"]] == ["claim"]
    crash = json.loads((tmp_path / f"nice-flight-{pid}-crash.json").read_text())
    assert [e["kind"] for e in crash["events"]] == ["claim", "crash"]
    assert crash["events"][-1]["type"] == "RuntimeError"


def test_registry_loses_no_update_under_many_threads():
    """More threads than cores, a short switch interval: every counter
    increment and histogram observation from every thread is counted."""
    r = metrics.Registry()
    c = r.counter("s_total", "s", ("k",))
    h = r.histogram("s_seconds", "s")
    n_threads, n = 2 * (os.cpu_count() or 4), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(n):
                c.labels(str(i % 3)).inc()
                h.observe_many((0.001 * (j % 7),) * 2)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sum(c.values().values()) == n_threads * n
    assert h.label_sums()[()][1] == 2 * n_threads * n
