"""The port's block-lease client on the CPU (nice_tpu_torch/client/main.py
--claim-block) against the JAX package's server in this process, seeded
with six b40 fields of 2^16 around the near miss 3621949312977: a block
iteration of 3 fields in each mode, every member equal to the JAX client's
process_field (jnp backend) on the same field; the fallback to per-field
claims on a 404; a mixed accept/reject reply retiring every snapshot;
retries that run out spooling every member, replayed exactly once; one
block heartbeat renewing every member; a leftover per-field snapshot
drained before the block claim; and the prefetch hook.
"""

import socket
import sqlite3
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from nice_tpu.client import main as jclient
from nice_tpu.core.types import DataToClient as JDataToClient
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.core.types import SearchMode as JSearchMode
from nice_tpu.server import app as server_app
from nice_tpu.server import db as jdb
from nice_tpu.server.db import Db
from nice_tpu_torch import ckpt
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import DataToClient, SearchMode
from nice_tpu_torch.faults import spool as spool_mod
from nice_tpu_torch.ops import engine

# In-process client runs start no sampler thread and no telemetry beat:
# those would outlive the test in this worker and post to its JAX server.
QUIET = ("--telemetry-secs", "0", "--pyprof-hz", "0", "--memwatch-secs", "0",
         "--history-secs", "0")

FIELD = 1 << 16
NEAR_MISS = 3621949312977  # num_uniques 37 at b40, in the second field
SEED_START = NEAR_MISS - FIELD - 4000
BATCH = 8192  # one segment (x 8) a field


@pytest.fixture(autouse=True)
def _client_state():
    """The port transport's module state does not outlive a test."""

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
    yield
    reset()


@pytest.fixture()
def server(tmp_path, monkeypatch):
    """The JAX server over six b40 fields of 2^16 in one chunk: seed_base
    cut to a stretch of the range (b40's whole range would be 7e7 such
    fields), its fields in one chunk as a real base's are (the detailed
    "thin" claim takes a block from one chunk)."""
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
    api_client.close_connections()
    httpd.shutdown()


def _args(api: str, mode: str, *extra: str):
    return client.build_parser().parse_args(
        [mode, "--api-base", api, "--username", "blocky", "--device", "cpu",
         "--claim-block", "3", "--batch-size", str(BATCH), "--renew-secs",
         "0", "--max-retries", "0", "--no-prefetch", *extra])


def _query(db_path, sql, params=()):
    conn = sqlite3.connect(db_path)
    conn.row_factory = sqlite3.Row
    try:
        return conn.execute(sql, params).fetchall()
    finally:
        conn.close()


class _RecordingApi(api_client.AsyncApi):
    """The real AsyncApi, keeping each block claim and block submit."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.blocks, self.block_submits = [], []

    def claim_block_async(self, mode, count):
        fut = super().claim_block_async(mode, count)
        self.blocks.append(fut)
        return fut

    def submit_block_async(self, block_id, submissions):
        fut = super().submit_block_async(block_id, submissions)
        self.block_submits.append((block_id, submissions, fut))
        return fut


@pytest.mark.parametrize("mode", ["detailed", "niceonly"])
def test_block_iteration_matches_jax_client(server, mode, monkeypatch):
    api, db_path = server
    # The server's strategy roll and pivot at their lowest: the detailed
    # "thin" claim from the chunk's first field, so the block is whole (a
    # pivot past the chunk's fourth field would give a partial block).
    monkeypatch.setattr(server_app.random, "randint", lambda a, b: a)
    smode = SearchMode.DETAILED if mode == "detailed" else SearchMode.NICEONLY
    rec = _RecordingApi(api, "blocky", max_retries=0)
    try:
        assert client.run_block_iteration(_args(api, mode), rec, smode)
    finally:
        rec.shutdown()
    (block,) = rec.blocks
    block_id, fields = block.result()
    ((sub_block, subs, fut),) = rec.block_submits
    resp = fut.result()
    assert sub_block == block_id and len(fields) == len(subs) == 3
    assert resp["accepted"] == 3 and resp["rejected"] == 0
    # One block lease covers the three claims.
    rows = _query(db_path, "SELECT id FROM claims WHERE block_id = ?",
                  (block_id,))
    assert sorted(r["id"] for r in rows) == sorted(f.claim_id for f in fields)
    jmode = JSearchMode.DETAILED if mode == "detailed" else JSearchMode.NICEONLY
    near_misses = 0
    for data, sub in zip(fields, subs):
        jdata = JDataToClient.from_json(data.to_json())
        jres, _ = jclient.process_field(jdata, jmode, "jnp", BATCH)
        want = jclient.compile_results(jdata, jres, jmode, "blocky").to_json()
        assert sub.to_json() == want
        near_misses += len(want["nice_numbers"])
        stored = _query(db_path, "SELECT submit_id FROM submissions WHERE "
                        "claim_id = ?", (data.claim_id,))
        assert [r["submit_id"] for r in stored] == [sub.submit_id]
    if mode == "detailed":  # the field holding NEAR_MISS reports it
        held = sum(f.range_start <= NEAR_MISS < f.range_end for f in fields)
        assert near_misses >= held


def test_claim_404_falls_back_to_per_field(server, monkeypatch):
    api, db_path = server

    def no_blocks(*a, **kw):
        raise api_client.ApiError("HTTP 404 from /claim_block", status=404)

    monkeypatch.setattr(api_client, "claim_block_from_server", no_blocks)
    assert client.main(["niceonly", "--api-base", api, "--username", "fb",
                        "--device", "cpu", "--claim-block", "3",
                        "--renew-secs", "0", "--max-retries", "0",
                        *QUIET]) == 0
    rows = _query(db_path, "SELECT c.block_id FROM submissions s JOIN claims "
                  "c ON c.id = s.claim_id WHERE s.username = 'fb'")
    assert [r["block_id"] for r in rows] == [None]


def _claim_block_and_compute(api: str, mode=SearchMode.NICEONLY):
    block_id, fields = api_client.claim_block_from_server(
        mode, api, "blocky", 3, max_retries=0)
    args = _args(api, "niceonly")
    subs = []
    for data in fields:
        results, _ = client.process_field(data, args, mode=mode)
        subs.append(client.compile_results(data, results, mode, "blocky"))
    return block_id, fields, subs


def _snapshots(tmp_path, fields):
    """A real snapshot a member (cursor at its start)."""
    out = []
    for data in fields:
        ck = ckpt.FieldCheckpointer(str(tmp_path / "ckpt"), data,
                                    SearchMode.NICEONLY, "device", None,
                                    "cpu")
        ck.save({"cursor": data.range_start, "hist": None,
                 "nice_numbers": []})
        out.append(ck)
    return out


def test_mixed_reply_retires_every_snapshot(server, tmp_path):
    api, _ = server
    block_id, fields, subs = _claim_block_and_compute(api)
    subs[1].claim_id = 999_999  # unknown claim: rejected item
    subs[1].submit_id = None
    cks = _snapshots(tmp_path, fields)
    assert len(list((tmp_path / "ckpt").glob("claim-*.ckpt"))) == 3
    live = api_client.AsyncApi(api, "blocky", max_retries=0)
    try:
        resp = client._await_block_submit(
            live.submit_block_async(block_id, subs), list(zip(subs, cks)),
            None)
    finally:
        live.shutdown()
    assert (resp["accepted"], resp["rejected"]) == (2, 1)
    assert resp["results"][1]["status"] == "error"
    assert list((tmp_path / "ckpt").glob("claim-*.ckpt")) == []


def _dead_api() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"  # nobody listens


def test_exhausted_retries_spool_every_member_replayed_once(server, tmp_path):
    api, db_path = server
    block_id, fields, subs = _claim_block_and_compute(api)
    spool = spool_mod.SubmissionSpool(str(tmp_path / "spool"))
    dead = api_client.AsyncApi(_dead_api(), "blocky", max_retries=0)
    try:
        resp = client._await_block_submit(
            dead.submit_block_async(block_id, subs),
            [(s, None) for s in subs], spool)
    finally:
        dead.shutdown()
    assert resp is None and len(spool.pending()) == 3
    assert spool.replay(api) == {"delivered": 3, "rejected": 0, "deferred": 0}
    assert spool.replay(api) == {"delivered": 0, "rejected": 0, "deferred": 0}
    for sub in subs:  # exactly once: a resend is a duplicate
        again = api_client.submit_field_to_server(api, sub, max_retries=0)
        assert again.get("duplicate") is True
        n = _query(db_path, "SELECT COUNT(*) AS n FROM submissions WHERE "
                   "submit_id = ?", (sub.submit_id,))[0]["n"]
        assert n == 1


def test_renew_block_bumps_every_member(server):
    api, db_path = server
    block_id, fields = api_client.claim_block_from_server(
        SearchMode.NICEONLY, api, "blocky", 3, max_retries=0)
    before = {r["t"] for r in _query(
        db_path, "SELECT f.last_claim_time AS t FROM fields f JOIN claims c "
        "ON c.field_id = f.id WHERE c.block_id = ?", (block_id,))}
    with client._BlockRenewer(api, block_id, 0.05) as renewer:
        deadline = time.monotonic() + 30
        while renewer.renewals < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    assert renewer.renewals >= 2 and not renewer._thread.is_alive()
    rows = _query(db_path, "SELECT f.last_claim_time AS t FROM fields f JOIN "
                  "claims c ON c.field_id = f.id WHERE c.block_id = ?",
                  (block_id,))
    after = {r["t"] for r in rows}
    assert len(rows) == 3 and len(after) == 1  # one stamp for all three
    assert min(after) > max(before)


def test_leftover_snapshot_drained_before_block_claim(server, tmp_path):
    api, db_path = server
    args = _args(api, "detailed", "--checkpoint-dir", str(tmp_path / "ckpt"))
    single = api_client.get_field_from_server(SearchMode.DETAILED, api,
                                              "blocky", max_retries=0)
    ck = client._new_checkpointer(args, single, SearchMode.DETAILED)
    ck.save({"cursor": single.range_start, "hist": np.zeros(42, np.int64),
             "nice_numbers": [],
             "remaining": [[single.range_start, single.range_end]]})
    rec = _RecordingApi(api, "blocky", max_retries=0)
    try:
        assert client.run_block_iteration(args, rec, SearchMode.DETAILED)
    finally:
        rec.shutdown()
    assert list((tmp_path / "ckpt").glob("claim-*.ckpt")) == []
    (block,) = rec.blocks
    block_id, fields = block.result()
    assert single.claim_id not in {f.claim_id for f in fields}
    rows = _query(db_path, "SELECT s.claim_id, c.block_id FROM submissions s "
                  "JOIN claims c ON c.id = s.claim_id")
    assert {r["claim_id"]: r["block_id"] for r in rows} == {
        single.claim_id: None, **{f.claim_id: block_id for f in fields}}


def _profiled_thread_calls(target):
    """Run target() on a thread named nice-prefetch and return the torch
    functions it called (Python frames in the torch package and C
    functions of torch's modules)."""
    import torch

    root = torch.__file__.rsplit("/", 1)[0]
    calls = []

    def prof(frame, event, arg):
        if event == "call" and frame.f_code.co_filename.startswith(root):
            calls.append(frame.f_code.co_name)
        elif event == "c_call" and (getattr(arg, "__module__", None)
                                    or "").startswith("torch"):
            calls.append(arg.__name__)

    def run():
        sys.setprofile(prof)
        try:
            target()
        finally:
            sys.setprofile(None)

    t = threading.Thread(target=run, name="nice-prefetch")
    t.start()
    t.join(60)
    return calls


def test_prefetch_warms_each_base_size_once_on_its_thread(monkeypatch):
    warmed = []

    def rec(kind):
        def warm(base, size=0, **kw):
            warmed.append((kind, base, size, threading.current_thread().name,
                           kw))
        return warm

    monkeypatch.setattr(engine, "warm_detailed", rec("detailed"))
    monkeypatch.setattr(engine, "warm_niceonly", rec("niceonly"))
    fields = [DataToClient(1, 40, 10, 20, 10), DataToClient(2, 40, 20, 30, 10),
              DataToClient(3, 50, 30, 50, 20), DataToClient(4, 40, 50, 70, 20)]
    args = client.build_parser().parse_args(["--device", "cpu"])
    for mode, want in (
            (SearchMode.NICEONLY, [("niceonly", 40, 10), ("niceonly", 50, 20),
                                   ("niceonly", 40, 20)]),
            (SearchMode.DETAILED, [("detailed", 40, 0), ("detailed", 50, 0)])):
        warmed.clear()
        fut = Future()
        client._prefetch_on_claim(fut, args, mode)
        fut.set_result(("block", fields))
        for t in threading.enumerate():
            if t.name == "nice-prefetch":
                t.join(10)
        assert [w[:3] for w in warmed] == want
        assert {w[3] for w in warmed} == {"nice-prefetch"}
        # A niceonly warm also gets the field's start and the host route's
        # limit (the --host-niceonly-max flag, None: the engine's default);
        # every warm gets the --devices list (None: not given).
        starts = {(40, 10): 10, (50, 20): 30, (40, 20): 50}
        for kind, base, size, _, kw in warmed:
            extra = ({"field_start": starts[(base, size)],
                      "host_niceonly_max": None} if kind == "niceonly" else {})
            assert kw == {"device": "cpu", "backend": "device",
                          "devices": None, **extra}
    # --no-prefetch: no hook; a failed claim: no warm.
    warmed.clear()
    off = client.build_parser().parse_args(["--no-prefetch"])
    fut = Future()
    client._prefetch_on_claim(fut, off, SearchMode.DETAILED)
    fut.set_result(fields[0])
    failed = Future()
    client._prefetch_on_claim(failed, args, SearchMode.DETAILED)
    failed.set_exception(api_client.ApiError("down"))
    time.sleep(0.05)
    assert warmed == []


def test_prefetch_warm_makes_no_torch_call(monkeypatch):
    # The real warms of a strided and a dense niceonly field and a detailed
    # one, on the prefetch thread: host setup only, no torch call.
    args = client.build_parser().parse_args(["--device", "cpu"])
    s = 3621949312977
    fields = [DataToClient(1, 40, s, s + FIELD, FIELD),
              DataToClient(2, 98, 413428759798923141071530212209627033363,
                           413428759798923141071530212209627033363 + FIELD,
                           FIELD)]
    for mode in (SearchMode.NICEONLY, SearchMode.DETAILED):
        calls = _profiled_thread_calls(
            lambda: [client._warm_field(d, mode, args) for d in fields])
        assert calls == [], calls


def test_failed_warm_is_logged_and_the_field_still_raises(monkeypatch, caplog):
    from nice_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found (put it on PATH)")

    monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "_lib", None)
    args = client.build_parser().parse_args([])  # the card
    data = DataToClient(1, 40, 3621949312977, 3621949312977 + FIELD, FIELD)
    with caplog.at_level("WARNING"):
        client._warm_field(data, SearchMode.DETAILED, args)
    assert "prefetch warm failed for base 40" in caplog.text
    with pytest.raises(RuntimeError, match="nvcc not found"):
        engine.warm_detailed(40)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.process_field(data, args)
