"""The port's snapshot files, checkpoint manager and submission spool
(nice_tpu_torch/ckpt, nice_tpu_torch/faults/spool.py) against the JAX
package's: files written by either package read identically in the other,
corrupt files raise SnapshotError, manifests match for the same state, the
port's manager rejects a JAX-runtime snapshot with reason "signature", and
the spool journals a submit the server never took and replays it once.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from nice_tpu.ckpt import manager as jmanager
from nice_tpu.ckpt import snapshot as jsnapshot
from nice_tpu.core.types import DataToClient as JDataToClient
from nice_tpu.core.types import SearchMode as JSearchMode
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch import ckpt
from nice_tpu_torch.ckpt import manager, snapshot
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    FieldResults,
    NiceNumberSimple,
    SearchMode,
    UniquesDistributionSimple,
)
from nice_tpu_torch.faults import spool as spool_mod

FIELD = {"claim_id": 7, "base": 60, "range_start": 2**70 + 5,
         "range_end": 2**70 + 1_000_005, "range_size": 1_000_000}
STATE = {
    "cursor": 2**70 + 400_005,
    "hist": np.arange(62, dtype=np.int64) * 3,
    "nice_numbers": [(2**70 + 17, 55), (2**70 + 399_000, 56)],
    "remaining": [(2**70 + 400_005, 2**70 + 600_005),
                  (2**70 + 800_005, 2**70 + 1_000_005)],
}


def _same(a, b):
    (ma, aa), (mb, ab) = a, b
    assert ma == mb
    assert sorted(aa) == sorted(ab)
    for k in aa:
        assert aa[k].dtype == ab[k].dtype and np.array_equal(aa[k], ab[k])


@pytest.mark.parametrize("writer,reader", [(jsnapshot, snapshot),
                                           (snapshot, jsnapshot)])
def test_snapshot_files_read_in_both_packages(tmp_path, writer, reader):
    manifest = {"cursor": str(STATE["cursor"]), "field": FIELD,
                "nice_numbers": [["123", 4]]}
    arrays = {"hist": STATE["hist"]}
    path = str(tmp_path / "claim-7.ckpt")
    n = writer.write_snapshot(path, manifest, arrays)
    assert n == os.path.getsize(path)
    _same(reader.read_snapshot(path), writer.read_snapshot(path))
    m, a = reader.read_snapshot(path)
    assert m["format_version"] == 1 and np.array_equal(a["hist"],
                                                       STATE["hist"])
    assert (snapshot.MAGIC, snapshot.FORMAT_VERSION) == (
        jsnapshot.MAGIC, jsnapshot.FORMAT_VERSION)


@pytest.mark.parametrize("damage", ["truncate", "flip", "magic"])
def test_corrupt_snapshots_raise(tmp_path, damage):
    path = str(tmp_path / "claim-7.ckpt")
    snapshot.write_snapshot(path, {"cursor": "5"}, {"hist": STATE["hist"]})
    blob = bytearray(open(path, "rb").read())
    if damage == "truncate":
        blob = blob[: len(blob) // 2]
    elif damage == "flip":
        blob[len(blob) // 2] ^= 0x40
    else:
        blob[:8] = b"NOTACKPT"
    with open(path, "wb") as f:
        f.write(bytes(blob))
    for mod in (snapshot, jsnapshot):
        with pytest.raises(mod.SnapshotError):
            mod.read_snapshot(path)
    with pytest.raises(FileNotFoundError):
        snapshot.read_snapshot(str(tmp_path / "absent.ckpt"))


def test_manifests_match_the_reference_for_the_same_state():
    for state in (STATE, dict(STATE, remaining=None, hist=None),
                  dict(STATE, hist=None, filtered=True)):
        m, a = manager._state_to_snapshot(state)
        jm, ja = jmanager._state_to_snapshot(state)
        assert m == jm
        _same((m, a), (jm, ja))
        back = manager._snapshot_to_state(m, a)
        jback = jmanager._snapshot_to_state(jm, ja)
        assert set(back) == set(jback)
        for k in back:
            if k == "hist":
                assert (back[k] is None) == (jback[k] is None)
                assert back[k] is None or np.array_equal(back[k], jback[k])
            else:
                assert back[k] == jback[k]


def test_checkpointer_round_trip_and_signature(tmp_path):
    data = DataToClient.from_json(FIELD)
    ck = ckpt.FieldCheckpointer(str(tmp_path), data, SearchMode.DETAILED,
                                "device", None, "cpu")
    assert ck.signature == {
        "mode": "detailed", "base": 60, "backend": "device",
        "batch_size": None, "runtime": f"torch-{torch.__version__}-cpu",
        "state": 3}
    ck.save(STATE)
    state = ck.load()
    assert state["cursor"] == STATE["cursor"]
    assert state["nice_numbers"] == STATE["nice_numbers"]
    assert state["remaining"] == STATE["remaining"]
    assert np.array_equal(state["hist"], STATE["hist"])
    found = ckpt.find_resumable(str(tmp_path), SearchMode.DETAILED, "device",
                                None, "cpu")
    assert found is not None and found[0] == data
    assert found[1]["cursor"] == STATE["cursor"]
    # Another configuration leaves the file alone; scalar is "host".
    assert ckpt.find_resumable(str(tmp_path), SearchMode.NICEONLY, "device",
                               None, "cpu") is None
    assert manager.plan_signature(SearchMode.DETAILED, 60, "scalar",
                                  None)["runtime"] == "host"
    assert os.path.exists(ck.path)
    ck.delete()
    assert ck.load() is None


def test_jax_runtime_snapshot_is_rejected_with_reason_signature(tmp_path):
    jdata = JDataToClient.from_json(FIELD)
    jck = jmanager.FieldCheckpointer(str(tmp_path), jdata,
                                     JSearchMode.DETAILED, "jnp", None)
    jck.save(STATE)
    manifest, _ = snapshot.read_snapshot(jck.path)  # the file reads
    assert manifest["signature"]["runtime"].startswith("jax-")
    # The startup scan leaves it for a configuration that matches it.
    assert ckpt.find_resumable(str(tmp_path), SearchMode.DETAILED, "device",
                               None, "cpu") is None
    assert os.path.exists(jck.path)
    ck = ckpt.FieldCheckpointer(str(tmp_path), DataToClient.from_json(FIELD),
                                SearchMode.DETAILED, "device", None, "cpu")
    assert ck.path == jck.path
    assert ck.mismatch(manifest) == "signature"
    assert ck.load() is None and not os.path.exists(ck.path)
    # The same plan under another state contract is "state_version".
    ck.save(STATE)
    manifest, _ = snapshot.read_snapshot(ck.path)
    manifest["signature"]["state"] = 2
    assert ck.mismatch(manifest) == "state_version"


# --------------------------------------------------------------------------
# The spool
# --------------------------------------------------------------------------

def _serve(tmp_path, base: int, field_size: int):
    db_path = str(tmp_path / "nice.db")
    db = Db(db_path)
    db.seed_base(base, field_size=field_size)
    db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", db_path


def _dead_api() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"  # nobody listens


def test_spool_journals_and_replays_once(tmp_path, monkeypatch):
    monkeypatch.setattr(api_client.time, "sleep", lambda s: None)
    httpd, api, db_path = _serve(tmp_path, 10, 1_000)
    try:
        data = api_client.get_field_from_server(SearchMode.NICEONLY, api, "u")
        results = FieldResults(
            distribution=(), nice_numbers=(NiceNumberSimple(69, 10),))
        sub = client.compile_results(data, results, SearchMode.NICEONLY, "u")
        spool = spool_mod.maybe_spool(None, str(tmp_path / "ckpt"))
        assert spool.dir == str(tmp_path / "ckpt" / "spool")
        dead = api_client.AsyncApi(_dead_api(), "u", max_retries=1)
        try:
            resp = client._await_submit(dead.submit_async(sub), sub, spool)
        finally:
            dead.shutdown()
        assert resp is None and len(spool.pending()) == 1
        entry = json.load(open(spool.pending()[0]))
        assert DataToServer.from_json(entry).to_json() == sub.to_json()
        assert spool.replay(_dead_api(), max_retries=0) == {
            "delivered": 0, "rejected": 0, "deferred": 1}
        assert spool.replay(api) == {"delivered": 1, "rejected": 0,
                                     "deferred": 0}
        assert spool.pending() == []
        assert spool.replay(api) == {"delivered": 0, "rejected": 0,
                                     "deferred": 0}
    finally:
        httpd.shutdown()
    db = Db(db_path)
    try:
        rec = db.get_submission_by_submit_id(sub.submit_id)
    finally:
        db.close()
    assert rec is not None and rec.claim_id == data.claim_id


def test_spool_rejected_entry_is_quarantined_and_4xx_raises(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(api_client.time, "sleep", lambda s: None)
    httpd, api, _ = _serve(tmp_path, 10, 1_000)
    try:
        bogus = DataToServer(
            claim_id=999_999, username="u", client_version="0",
            unique_distribution=[UniquesDistributionSimple(1, 1)],
            nice_numbers=[])
        live = api_client.AsyncApi(api, "u", max_retries=0)
        spool = spool_mod.SubmissionSpool(str(tmp_path / "spool"))
        try:
            with pytest.raises(api_client.ApiError) as err:
                client._await_submit(live.submit_async(bogus), bogus, spool)
        finally:
            live.shutdown()
        assert 400 <= err.value.status < 500 and spool.pending() == []
        spool.add(bogus)
        assert spool.replay(api)["rejected"] == 1
        names = os.listdir(spool.dir)
        assert len(names) == 1 and names[0].endswith(".json.rejected")
    finally:
        httpd.shutdown()


def test_quarantine_retention_bounds(tmp_path):
    spool = spool_mod.SubmissionSpool(str(tmp_path), quarantine_max_bytes=10,
                                      quarantine_max_age_secs=0)
    for i in range(3):
        with open(tmp_path / f"e{i}.json.rejected", "w") as f:
            f.write("x" * 8)
        os.utime(tmp_path / f"e{i}.json.rejected", (i + 1, i + 1))
    assert spool.prune_quarantine() == {"entries": 2, "bytes": 16}
    assert os.listdir(tmp_path) == ["e2.json.rejected"]
