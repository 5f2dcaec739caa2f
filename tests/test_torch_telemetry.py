"""The port's fleet telemetry (nice_tpu_torch/obs/telemetry.py and the
client's heartbeat) against the JAX package on the CPU: the snapshot's wire
format beside the JAX client's; the JAX coordination server (in this
process) takes the port's snapshot on POST /telemetry and shows the client
in /status `fleet`; a port client's submission carries the snapshot, whose
journal events (the phases event included) land on the field's
/fields/<id>/timeline; the heartbeat posts and learns the server list.
Every test restores both packages' process state."""

import json
import threading
import time
import urllib.request

import pytest

from nice_tpu import obs as jobs
from nice_tpu.client import api_client as japi
from nice_tpu.obs import memwatch as jmemwatch
from nice_tpu.obs import metrics as jmetrics
from nice_tpu.obs import pyprof as jpyprof
from nice_tpu.obs import stepprof as jstepprof
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch import obs
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import DataToServer
from nice_tpu_torch.obs import memwatch, pyprof, series, stepprof, telemetry


def _save_jax_state():
    """A restore() of the JAX state these tests touch: the registry's
    values, stepprof, memwatch's summary, pyprof's tables, the journal
    buffer and the transport's module state."""
    values = {}
    for name, m in jobs.REGISTRY.metrics().items():
        with m._lock:
            if isinstance(m, jmetrics.Histogram):
                values[name] = {k: (list(st.counts), st.sum, st.count)
                                for k, st in m._states.items()}
            else:
                values[name] = dict(m._values)
    prof = (jstepprof._fence_count, jstepprof.cumulative(),
            dict(jstepprof.LAST_BREAKDOWN))
    mem = jmemwatch.summary()
    with jpyprof._lock:
        pyp = ({r: dict(t) for r, t in jpyprof._tables.items()},
               dict(jpyprof._root_samples), jpyprof._total_samples,
               jpyprof._distinct_stacks)
    events = list(jobs.journal._client_events)
    transport = (japi._last_epoch, dict(japi._failover_idx),
                 dict(japi._failover_gen), dict(japi._dead_hosts),
                 japi._backoff_rng.getstate())

    def restore():
        for name, m in jobs.REGISTRY.metrics().items():
            saved = values.get(name) or {}
            with m._lock:
                if isinstance(m, jmetrics.Histogram):
                    m._states.clear()
                    for k, (counts, total, count) in saved.items():
                        st = jmetrics._HistState(len(m.buckets))
                        st.counts, st.sum, st.count = list(counts), total, count
                        m._states[k] = st
                else:
                    m._values.clear()
                    m._values.update(saved)
        jstepprof.reset()
        jstepprof._fence_count = prof[0]
        jstepprof._cumulative.update(prof[1])
        jstepprof.LAST_BREAKDOWN.update(prof[2])
        jmemwatch.reset_for_tests()
        jmemwatch._last_summary.update(mem)
        with jpyprof._lock:
            jpyprof._tables.clear()
            jpyprof._tables.update(pyp[0])
            jpyprof._root_samples.clear()
            jpyprof._root_samples.update(pyp[1])
            jpyprof._total_samples, jpyprof._distinct_stacks = pyp[2:]
        jobs.journal._client_events[:] = events
        japi._last_epoch = transport[0]
        japi._failover_idx.clear()
        japi._failover_idx.update(transport[1])
        japi._failover_gen.clear()
        japi._failover_gen.update(transport[2])
        japi._dead_hosts.clear()
        japi._dead_hosts.update(transport[3])
        japi._backoff_rng.setstate(transport[4])

    return restore


@pytest.fixture(autouse=True)
def _isolated():
    restore = _save_jax_state()
    obs.reset()
    api_client.reset()
    yield
    api_client.reset()
    obs.reset()
    restore()


@pytest.fixture()
def server(tmp_path):
    """The JAX package's coordination server in this process, over b10's
    three fields of 20 (the fixture of the reference's fleet tests)."""
    db_path = str(tmp_path / "fleet-test.db")
    db = Db(db_path)
    db.seed_base(10, field_size=20)  # [47,100) -> 3 fields
    db.close()
    srv = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base_url = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base_url, db_path
    api_client.close_connections()
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _fleet_client(base_url, client_id, deadline=10.0):
    stop = time.monotonic() + deadline
    while True:
        clients = _get(base_url + "/status")["fleet"]["clients"]
        mine = [c for c in clients if c["client_id"] == client_id]
        if mine or time.monotonic() > stop:
            return mine[0] if mine else None
        time.sleep(0.1)


def _stock_both():
    """The same observations in both packages: a profiled field, a memwatch
    sample, a pyprof sample, a journal event and a field's counters."""
    for mod in (stepprof, jstepprof):
        prof = mod.StepProfiler("detailed", 40, "cuda", True)
        prof.add("device_compute", 0.5)
        prof.finish(1.0)
    memwatch.sample()
    jmemwatch.sample()
    done = threading.Event()
    other = threading.Thread(target=done.wait, name="engine-feed")
    other.start()  # a thread to sample (the caller never samples itself)
    try:
        assert pyprof.take_sample() >= 1 and jpyprof.take_sample() >= 1
    finally:
        done.set()
        other.join()
    obs.journal.record_client_event("claim_rtt", claim_id=1, secs=0.1)
    jobs.journal.record_client_event("claim_rtt", claim_id=1, secs=0.1)
    series.CLIENT_NUMBERS.inc(1000)
    series.CLIENT_FIELDS.labels("detailed").inc()


def test_snapshot_wire_format_matches_the_reference():
    # Start the JAX side from what this test stocks alone (the fixture
    # puts back what other tests left).
    jstepprof.reset()
    jobs.journal.drain_client_events()
    _stock_both()
    mine = telemetry.snapshot("alice", "device", 2, "0.1.0")
    theirs = jobs.telemetry.snapshot("alice", "jnp", 2, "t")
    assert set(mine) == set(theirs)
    assert mine["v"] == theirs["v"] == telemetry.SNAPSHOT_VERSION == 1
    assert set(mine["mesh"]) == set(theirs["mesh"])
    assert mine["mesh"]["devices"] == 1 and mine["mesh"]["reshards"] == 0
    assert mine["downgrades"] == {} and mine["downgrades_total"] == 0
    assert set(mine["pyprof"]) == set(theirs["pyprof"])
    assert set(mine["mem"]) <= set(theirs["mem"])
    assert mine["phase_breakdown"] == theirs["phase_breakdown"]
    assert mine["events"] == theirs["events"]
    assert mine["numbers"] == 1000 and mine["fields"] == {"detailed": 1}
    # Drained, and omitted when empty; the rate is over the interval.
    again = telemetry.snapshot("alice")
    assert "events" not in again and again["numbers_per_sec"] == 0.0
    obs.reset()
    bare = telemetry.snapshot("alice")
    assert not {"phase_breakdown", "mem", "pyprof", "events"} & set(bare)


def test_client_id_takes_the_username_and_reads_no_environment(monkeypatch):
    monkeypatch.setenv("USER", "someone-else")
    assert telemetry.client_id("alice").startswith("alice@")
    assert telemetry.client_id("").startswith("anonymous@")
    assert telemetry.client_id("alice").endswith(f"/{__import__('os').getpid()}")


def test_port_snapshot_shows_in_the_fleet_block(server):
    base_url, _ = server
    series.CLIENT_NUMBERS.inc(4321)
    series.CLIENT_FIELDS.labels("niceonly").inc(2)
    snap = telemetry.snapshot("porter", "device", 0, "0.1.0")
    api_client.post_telemetry(base_url, snap)
    row = _fleet_client(base_url, snap["client_id"])
    assert row is not None
    assert row["numbers_total"] == "4321" and row["fields_niceonly"] == 2
    assert row["backend"] == "device" and row["mesh_devices"] == 1
    assert series.CLIENT_REQUEST_SECONDS.label_sums()[("telemetry",)][1] == 1


def test_submission_carries_the_snapshot_and_its_events_reach_the_timeline(
        server):
    base_url, db_path = server
    args = client.build_parser().parse_args(
        ["detailed", "--api-base", base_url, "--username", "porter",
         "--device", "cpu", "--stepprof", "--pyprof-hz", "0",
         "--memwatch-secs", "0", "--history-secs", "0"])
    client.configure_obs(args)
    data, sub, resp = client.run_single_iteration(args)
    assert resp["status"] == "OK"
    assert sub.telemetry["v"] == 1 and sub.telemetry["phase_breakdown"]
    kinds = {e["kind"] for e in sub.telemetry["events"]}
    assert {"claim_rtt", "phases"} <= kinds
    # submit_id was stamped before the snapshot was attached.
    bare = DataToServer.from_json({k: v for k, v in sub.to_json().items()
                                   if k != "telemetry"})
    assert client.compile_results(data, client.FieldResults(
        tuple(sub.unique_distribution), tuple(sub.nice_numbers)),
        client.SearchMode.DETAILED, "porter").submit_id == bare.submit_id
    db = Db(db_path)
    try:
        field_id = db.get_claim_by_id(data.claim_id).field_id
    finally:
        db.close()
    deadline = time.monotonic() + 10
    while True:  # the server journals through its writer, asynchronously
        events = _get(f"{base_url}/fields/{field_id}/timeline")["events"]
        kinds = [e["kind"] for e in events]
        if "client_phases" in kinds or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert "client_phases" in kinds and "client_claim_rtt" in kinds
    phases = events[kinds.index("client_phases")]
    assert phases["trace_id"] == obs.claim_trace_id(data.claim_id)
    assert phases["detail"]["device_compute"] > 0
    row = _fleet_client(base_url, sub.telemetry["client_id"])
    assert int(row["numbers_total"]) == data.range_size


def test_heartbeat_posts_and_learns_the_server_list(server, tmp_path,
                                                   monkeypatch):
    base_url, _ = server
    learned = []
    monkeypatch.setattr(client, "_save_known_servers",
                        lambda d, servers: learned.append((d, servers)))
    args = client.build_parser().parse_args(
        ["--api-base", base_url, "--username", "beater", "--telemetry-secs",
         "0.2", "--checkpoint-dir", str(tmp_path / "ck")])
    with client.telemetry_beat(args):
        row = _fleet_client(base_url, telemetry.client_id("beater"))
        deadline = time.monotonic() + 10
        while len(learned) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    assert row is not None and row["username"] == "beater"
    assert len(learned) >= 2  # every beat reads /status
    assert all(d == str(tmp_path / "ck") for d, _ in learned)
    args.telemetry_secs = 0
    with client.telemetry_beat(args) as beat:
        assert beat is None  # off: no thread


def test_heartbeat_flag_takes_the_jax_clients_default():
    from nice_tpu.client import main as jclient

    mine = client.build_parser().parse_args([])
    theirs = jclient.build_parser().parse_args([])
    assert mine.telemetry_secs == theirs.telemetry_secs == 60.0
