"""The port's multi-server failover and epoch fencing
(nice_tpu_torch/client/api_client.py) against the JAX package's replicated
server pair, as tests/test_repl.py holds the JAX client to it: rotation past
a dead endpoint, one server as plain retry, split_servers as JAX splits, a
promoted standby fencing the deposed primary through the port's
X-Nice-Epoch stamp, and servers.json read across the two packages.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from nice_tpu.client import api_client as japi
from nice_tpu.client import main as jclient
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import SearchMode


def _reset_port_client():
    with api_client._epoch_lock:
        api_client._last_epoch = 0
    with api_client._failover_lock:
        api_client._failover_idx.clear()
        api_client._failover_gen.clear()
    with api_client._dead_hosts_lock:
        api_client._dead_hosts.clear()
    api_client.close_connections()


@pytest.fixture(autouse=True)
def _client_state():
    """Neither transport's module state (epoch, failover cursors, dead
    hosts, backoff RNG, pooled sockets) outlives a test: a stale epoch 2
    would fence a fresh epoch-1 server, and the JAX client's own tests
    share the process."""
    with japi._epoch_lock:
        saved = (japi._last_epoch, dict(japi._failover_idx),
                 dict(japi._failover_gen), dict(japi._dead_hosts),
                 japi._backoff_rng.getstate())
    _reset_port_client()
    yield
    _reset_port_client()
    with japi._epoch_lock:
        japi._last_epoch = saved[0]
    with japi._failover_lock:
        japi._failover_idx.clear()
        japi._failover_idx.update(saved[1])
        japi._failover_gen.clear()
        japi._failover_gen.update(saved[2])
    with japi._dead_hosts_lock:
        japi._dead_hosts.clear()
        japi._dead_hosts.update(saved[3])
    japi._backoff_rng.setstate(saved[4])
    japi.close_connections()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(db_path, port, standby_of=None, advertise=None):
    srv = server_app.serve(db_path, host="127.0.0.1", port=port,
                           prefill=(standby_of is None),
                           standby_of=standby_of, advertise=advertise)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, body=None):
    req = urllib.request.Request(
        url, data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _wait(predicate, timeout=15.0, interval=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    """A live primary and hot standby of the JAX package (test_repl.py's
    pair), both advertising their URLs."""
    monkeypatch.setenv("NICE_TPU_REPL_POLL_SECS", "0.05")
    p_port, s_port = _free_port(), _free_port()
    purl = f"http://127.0.0.1:{p_port}"
    surl = f"http://127.0.0.1:{s_port}"
    p_path = str(tmp_path / "primary.db")
    db = Db(p_path)
    db.seed_base(10, field_size=20)  # [47, 100) -> 3 fields
    db.close()
    s_path = str(tmp_path / "standby.db")
    primary = _start(p_path, p_port, advertise=purl)
    standby = _start(s_path, s_port, standby_of=purl, advertise=surl)
    yield {"primary": primary, "standby": standby, "purl": purl,
           "surl": surl}
    # Pooled keep-alive sockets would hold the servers' shutdown.
    api_client.close_connections()
    japi.close_connections()
    for srv in (primary, standby):
        srv.shutdown()
        srv.context.close()


def _applied_seq(surl) -> int:
    return int(_get(f"{surl}/status")["repl"].get("applied_seq") or 0)


def test_failover_request_rotates_past_dead_server(pair):
    purl = pair["purl"]
    dead = f"http://127.0.0.1:{_free_port()}"
    api_base = f"{dead},{purl}"
    status = api_client.failover_request(api_base, "/status", max_retries=0)
    assert status["status"] == "ok"
    # The cursor sticks to the server that answered, as the JAX client's.
    servers = api_client.split_servers(api_base)
    with api_client._failover_lock:
        idx = api_client._failover_idx[",".join(servers)]
    assert servers[idx] == purl
    japi.failover_request(api_base, "/status", max_retries=0)
    with japi._failover_lock:
        assert japi._failover_idx[",".join(japi.split_servers(api_base))] == idx
    # The dead endpoint is marked for every thread's pool.
    assert ("http", dead.split("//", 1)[1]) in api_client._dead_hosts


def test_failover_request_single_server_is_plain_retry(pair):
    status = api_client.failover_request(pair["purl"], "/status",
                                         max_retries=0)
    assert status["status"] == "ok" and status["epoch"] == 1
    with api_client._failover_lock:
        assert api_client._failover_idx == {}
    # The reply taught the epoch, as retry_request's would.
    assert api_client.last_seen_epoch() == 1


@pytest.mark.parametrize("raw", [
    " http://a:1/ ,http://b:2,, ", "http://a:1", "", ",,", "http://a:1/,",
    "https://x.example:8443/api/, http://127.0.0.1:9 ",
])
def test_split_servers_equals_jax(raw):
    assert api_client.split_servers(raw) == japi.split_servers(raw)


def test_promotion_fences_deposed_primary_through_port_epoch(pair):
    purl, surl = pair["purl"], pair["surl"]
    target = _get(f"{purl}/status")["repl"]["seq"]
    assert _wait(lambda: _applied_seq(surl) >= target)

    api_client.retry_request(f"{purl}/status", max_retries=0)
    assert api_client.last_seen_epoch() == 1
    assert _post(f"{surl}/repl/promote")["epoch"] == 2

    # The promoted server teaches the port epoch 2 ...
    data = api_client.get_field_from_server(SearchMode.DETAILED, surl,
                                            "tester", max_retries=0)
    assert data.claim_id > 0 and api_client.last_seen_epoch() == 2
    assert api_client._headers(None)["X-Nice-Epoch"] == "2"
    # ... whose stamp fences the old primary: 410, and sticky.
    with pytest.raises(api_client.ApiError) as exc:
        api_client.get_field_from_server(SearchMode.DETAILED, purl, "tester",
                                         max_retries=0)
    assert exc.value.status == 410
    with pytest.raises(urllib.error.HTTPError) as bare:
        urllib.request.urlopen(f"{purl}/claim/niceonly?username=bare",
                               timeout=10)
    assert bare.value.code == 410
    assert _get(f"{purl}/status")["repl"]["fenced"] is True
    # A failover list headed by the deposed primary rotates past the fence.
    data = api_client.get_field_from_server(
        SearchMode.NICEONLY, f"{purl},{surl}", "tester", max_retries=0)
    assert data.claim_id > 0


def test_servers_json_read_across_packages(pair, tmp_path):
    purl, surl = pair["purl"], pair["surl"]
    assert _wait(lambda: surl in _get(f"{purl}/status")["repl"]["servers"])
    # The port learns the list from /status at startup and writes it ...
    port_dir = str(tmp_path / "port-ckpt")
    args = client.build_parser().parse_args(
        ["--api-base", purl, "--checkpoint-dir", port_dir])
    client._learn_servers(args)
    assert set(jclient._load_known_servers(port_dir)) == {purl, surl}
    assert client._load_known_servers(port_dir) == \
        jclient._load_known_servers(port_dir)
    # ... and reads what the JAX client wrote.
    jax_dir = str(tmp_path / "jax-ckpt")
    jclient._save_known_servers(jax_dir, [surl + "/", purl, surl])
    assert client._load_known_servers(jax_dir) == [surl, purl]
    with open(tmp_path / "jax-ckpt" / "servers.json", "w") as f:
        f.write("{not json")
    assert client._load_known_servers(jax_dir) == []
    assert client._load_known_servers(None) == []


def test_dead_host_mark_evicts_pooled_socket(pair):
    purl = pair["purl"]
    api_client.retry_request(f"{purl}/status", max_retries=0)
    key = ("http", purl.split("//", 1)[1])
    stale = api_client._conn_pool()[key]
    api_client._mark_host_dead(key)
    api_client.retry_request(f"{purl}/status", max_retries=0)
    fresh = api_client._conn_pool()[key]
    assert fresh is not stale
    assert fresh._nice_born > api_client._dead_hosts[key]
