"""The port's fault injection (nice_tpu_torch/faults/injector.py) against the
JAX package's on the CPU: the same spec and seed fire the same sequence;
the http.<endpoint> sites retry and count as the JAX transport does, against
a stub server that checks each request's traceparent; a duplicate reply is
logged in the reference's words; engine.dispatch raises
out of a field; ckpt.write:truncate leaves a snapshot read_snapshot
rejects. Every test restores both packages' process state."""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from nice_tpu import faults as jfaults
from nice_tpu import obs as jobs
from nice_tpu.client import api_client as japi
from nice_tpu.core.types import DataToServer as JDataToServer
from nice_tpu.obs import metrics as jmetrics
from nice_tpu_torch import obs
from nice_tpu_torch.ckpt import FieldCheckpointer
from nice_tpu_torch.ckpt.snapshot import SnapshotError, read_snapshot
from nice_tpu_torch.client import api_client
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    FieldSize,
    SearchMode,
)
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.obs import series
from nice_tpu_torch.ops import engine


def _save_jax_state():
    """A restore() of the JAX state these tests touch: the registry's
    values, the fault plan and the transport's module state."""
    values = {}
    for name, m in jobs.REGISTRY.metrics().items():
        with m._lock:
            if isinstance(m, jmetrics.Histogram):
                values[name] = {k: (list(st.counts), st.sum, st.count)
                                for k, st in m._states.items()}
            else:
                values[name] = dict(m._values)
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
        jfaults.reset()
        japi._last_epoch = transport[0]
        japi._failover_idx.clear()
        japi._failover_idx.update(transport[1])
        japi._failover_gen.clear()
        japi._failover_gen.update(transport[2])
        japi._dead_hosts.clear()
        japi._dead_hosts.update(transport[3])
        japi._backoff_rng.setstate(transport[4])
        japi.close_connections()

    return restore


@pytest.fixture(autouse=True)
def _isolated():
    restore = _save_jax_state()
    obs.reset()
    faults.reset()
    api_client.reset()
    yield
    faults.reset()
    api_client.reset()
    obs.reset()
    restore()


SPECS = [
    "http.submit:drop_response@0.3",
    "http.claim:503@2,http.submit:conn_error",
    "engine.dispatch:raise@batch=7",
    "http.submit:500@0.5,http.submit:drop_response@0.5,ckpt.write:truncate@3",
    "engine.dispatch:raise@1e-1",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 42])
def test_the_same_spec_and_seed_fire_the_same_sequence(spec, seed):
    faults.configure(spec, seed)
    jfaults.configure(spec, seed)
    rng = np.random.default_rng(seed)
    sites = sorted({rule.split(":")[0] for rule in spec.split(",")}) + \
        ["http.renew"]
    mine, theirs = [], []
    for call in range(200):
        site = sites[int(rng.integers(len(sites)))]
        ctx = {"batch": call % 11, "attempt": 0}
        mine.append(faults.fire(site, **ctx))
        theirs.append(jfaults.fire(site, **ctx))
    assert mine == theirs
    assert any(a is not None for a in mine)
    assert series.FAULTS_INJECTED.values() and sum(
        series.FAULTS_INJECTED.values().values()) == sum(
        a is not None for a in mine)


@pytest.mark.parametrize("bad", ["http.submit", "http.submit:", ":raise",
                                 "engine.dispatch:raise@0",
                                 "engine.dispatch:raise@x",
                                 "http.submit:500@1.5"])
def test_malformed_specs_raise_in_both_packages(bad):
    with pytest.raises(faults.FaultSpecError):
        faults.parse_spec(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.parse_spec(bad)


@pytest.mark.parametrize("spec", ["mesh.dispatch:teleport",
                                  "http.submit:teleport",
                                  "engine.dispatch:truncate",
                                  "ckpt.write:raise", "http.:raise"])
def test_configure_refuses_a_fault_the_port_cannot_fire(spec):
    faults.configure("http.claim:503")
    with pytest.raises(faults.FaultSpecError):
        faults.configure(spec)
    assert faults.active_sites() == ("http.claim",)  # left as it was
    jfaults.parse_spec(spec)  # the reference parses it and never fires


class _Stub(BaseHTTPRequestHandler):
    """POST /submit: records the request's traceparent, answers `reply`."""

    seen: list = []
    reply: dict = {"status": "OK"}

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n))
        type(self).seen.append((self.path, self.headers.get("traceparent"),
                                body["claim_id"]))
        payload = json.dumps(type(self).reply).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *a):
        pass


@pytest.fixture()
def stub():
    _Stub.seen = []
    _Stub.reply = {"status": "OK"}
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _submission(mod, claim_id: int):
    return mod(claim_id=claim_id, username="u", client_version="t",
               unique_distribution=None, nice_numbers=[], submit_id="s")


@pytest.mark.parametrize("action,reached", [("drop_response", 2), ("503", 1)])
def test_http_faults_retry_and_count_as_the_jax_transport(stub, monkeypatch,
                                                          action, reached):
    monkeypatch.setattr(api_client, "MAX_BACKOFF_SECS", 0)
    monkeypatch.setattr(japi, "MAX_BACKOFF_SECS", 0)
    spec = f"http.submit:{action}@1"
    faults.configure(spec, 0)
    jfaults.configure(spec, 0)
    retries0 = jobs.series.CLIENT_RETRIES.labels("submit").value()
    assert api_client.submit_field_to_server(
        stub, _submission(DataToServer, 71))["status"] == "OK"
    port_seen, _Stub.seen = _Stub.seen, []
    assert japi.submit_field_to_server(
        stub, _submission(JDataToServer, 71))["status"] == "OK"
    # The injected 503 never reaches the server; a dropped response does,
    # and the retry sends it again.
    assert len(port_seen) == len(_Stub.seen) == reached
    assert series.CLIENT_RETRIES.labels("submit").value() == 1
    assert jobs.series.CLIENT_RETRIES.labels("submit").value() - retries0 == 1
    assert series.CLIENT_REQUEST_SECONDS.label_sums()[("submit",)][1] == 2
    for path, header, claim in port_seen:
        assert path == "/submit" and claim == 71
        assert obs.parse_traceparent(header) == obs.claim_trace_id(71)
    assert [h.split("-")[1] for _, h, _ in port_seen] == \
        [h.split("-")[1] for _, h, _ in _Stub.seen]
    assert series.FAULTS_INJECTED.labels("http.submit", action).value() == 1
    assert obs.flight.snapshot()[0]["kind"] == "fault"
    assert any(e["kind"] == "retry" for e in obs.flight.snapshot())


def test_a_duplicate_reply_is_logged_by_both_transports(stub, caplog):
    # {"duplicate": true}: a retried submit had already been accepted. The
    # exactly-once evidence the chaos drill counts in the client's log.
    _Stub.reply = {"status": "OK", "duplicate": True}
    with caplog.at_level(logging.INFO):
        assert api_client.submit_field_to_server(
            stub, _submission(DataToServer, 71))["duplicate"] is True
        assert japi.submit_field_to_server(
            stub, _submission(JDataToServer, 71))["duplicate"] is True
    logged = {r.name: r.getMessage() for r in caplog.records
              if "was a duplicate" in r.getMessage()}
    want = ("submit for claim 71 was a duplicate: a retried request had "
            "already been accepted")
    assert logged == {api_client.log.name: want, japi.log.name: want}


def test_retries_that_run_out_keep_the_injected_status(stub, monkeypatch):
    monkeypatch.setattr(api_client, "MAX_BACKOFF_SECS", 0)
    faults.configure("http.submit:503", 0)
    with pytest.raises(api_client.ApiError) as err:
        api_client.submit_field_to_server(stub, _submission(DataToServer, 5),
                                          max_retries=2)
    assert err.value.status == 503 and _Stub.seen == []
    assert series.CLIENT_RETRIES.labels("submit").value() == 2


def test_engine_dispatch_fault_raises_out_of_the_field(monkeypatch):
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1024)
    faults.configure("engine.dispatch:raise@batch=2", 0)
    with pytest.raises(RuntimeError, match="injected engine.dispatch fault"):
        engine.process_range_detailed(FieldSize(5000, 12000), 17,
                                      device="cpu", segment=2)
    assert series.FAULTS_INJECTED.labels("engine.dispatch", "raise").value() == 1
    assert series.ENGINE_NUMBERS.labels("detailed").value() == 0
    # The scalar oracle's chunks are dispatches too.
    faults.configure("engine.dispatch:raise@2", 0)
    with pytest.raises(RuntimeError, match="injected"):
        engine.process_range_detailed(
            FieldSize(5000, 9000), 17, backend="scalar",
            batch_size=1000, checkpoint_cb=lambda st: None)


def test_ckpt_write_truncate_is_rejected_on_read(tmp_path):
    data = DataToClient(claim_id=9, base=17, range_start=5000,
                        range_end=6000, range_size=1000)
    ck = FieldCheckpointer(str(tmp_path), data, SearchMode.DETAILED,
                           "device", None, "cpu")
    state = {"cursor": 5500, "hist": np.zeros(19, dtype=np.int64),
             "nice_numbers": [], "remaining": [[5500, 6000]]}
    ck.save(state)
    assert ck.load()["cursor"] == 5500
    faults.configure("ckpt.write:truncate", 0)
    ck.save(state)
    with pytest.raises(SnapshotError) as err:
        read_snapshot(ck.path)
    assert err.value.reason == "corrupt"
    assert ck.load() is None  # rejected and removed
    assert series.CKPT_REJECTED.labels("corrupt").value() == 1
    assert series.CKPT_WRITES.value() == 2
    kinds = [e["kind"] for e in obs.journal.drain_client_events()]
    assert kinds == ["ckpt_save", "ckpt_resume", "ckpt_save"]
