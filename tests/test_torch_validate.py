"""The port's --validate (nice_tpu_torch/client/main.py run_validate) on the
CPU against the JAX package's server in this process: the canon is the JAX
client's submission made canonical by the jobs runner (jobs.run_all); the
port's recomputation returns 0 on it and 1 on a copy of the ledger whose
canonical distribution was tampered with; --base picks the base, and a base
without a canonical field raises.
"""

import json
import sqlite3
import threading

import pytest

from nice_tpu.client import api_client as japi
from nice_tpu.client import main as jclient
from nice_tpu.core.types import SearchMode as JSearchMode
from nice_tpu.jobs import main as jobs_main
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import ValidationData


@pytest.fixture(autouse=True)
def _client_state():
    """Neither transport's module state outlives a test."""
    with japi._epoch_lock:
        saved = (japi._last_epoch, dict(japi._failover_idx),
                 dict(japi._failover_gen), japi._backoff_rng.getstate())
    yield
    for mod in (api_client, japi):
        with mod._epoch_lock:
            mod._last_epoch = 0
        mod.close_connections()
    with japi._epoch_lock:
        japi._last_epoch = saved[0]
    with japi._failover_lock:
        japi._failover_idx.clear()
        japi._failover_idx.update(saved[1])
        japi._failover_gen.clear()
        japi._failover_gen.update(saved[2])
    japi._backoff_rng.setstate(saved[3])


def _serve(db_path: str):
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0,
                             prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    """A ledger of b10 (one field) and b17 (two fields), every field
    submitted once by the JAX client and made canonical by the jobs
    runner, and b22 (one field) left unclaimed."""
    db_path = str(tmp_path_factory.mktemp("validate") / "nice.db")
    db = Db(db_path)
    db.seed_base(10, field_size=100)
    db.seed_base(17, field_size=4_000)
    db.seed_base(22, field_size=1_000_000)
    db.close()
    httpd, api = _serve(db_path)
    try:
        done = set()
        while {10, 17} - {b for b, _ in done} or len(done) < 3:
            data = japi.get_field_from_server(JSearchMode.DETAILED, api,
                                              "canon", max_retries=0)
            if data.base == 22:
                continue  # left without a canon
            res, _ = jclient.process_field(data, JSearchMode.DETAILED,
                                           "scalar", None)
            sub = jclient.compile_results(data, res, JSearchMode.DETAILED,
                                          "canon")
            japi.submit_field_to_server(api, sub, max_retries=0)
            done.add((data.base, data.range_start))
    finally:
        japi.close_connections()
        httpd.shutdown()
    db = Db(db_path)
    jobs_main.run_all(db)
    db.close()
    return db_path


def _validate(api: str, *extra: str) -> int:
    return client.main(["--validate", "--api-base", api, "--username", "v",
                        "--device", "cpu", "--max-retries", "0", *extra])


def test_validate_passes_on_the_canon(canon, caplog):
    httpd, api = _serve(canon)
    try:
        for base in (17, 10):
            vdata = api_client.get_validation_data_from_server(api, "v", base)
            assert isinstance(vdata, ValidationData) and vdata.base == base
            assert sum(d.count for d in vdata.unique_distribution) == \
                vdata.range_size
            caplog.clear()
            with caplog.at_level("INFO"):
                assert _validate(api, "--base", str(base)) == 0
            assert f"base {base}, range" in caplog.text
            assert "validation passed" in caplog.text
        assert _validate(api) == 0
    finally:
        api_client.close_connections()
        httpd.shutdown()


def test_validate_fails_on_a_tampered_canon(canon, tmp_path, caplog):
    copy = str(tmp_path / "tampered.db")
    src, dst = sqlite3.connect(canon), sqlite3.connect(copy)
    src.backup(dst)
    src.close()
    # Move one count between two bins of every canonical b17 distribution:
    # the bins still sum to the field size, so the server serves it.
    rows = dst.execute(
        "SELECT s.id, s.distribution FROM submissions s JOIN fields f ON "
        "f.canon_submission_id = s.id WHERE f.base_id = 17").fetchall()
    assert len(rows) == 2
    for sid, dist in rows:
        dist = json.loads(dist)
        full = [d for d in dist if d["count"] > 0]
        full[0]["count"] -= 1
        full[1]["count"] += 1
        dst.execute("UPDATE submissions SET distribution = ? WHERE id = ?",
                    (json.dumps(dist), sid))
    dst.commit()
    dst.close()
    httpd, api = _serve(copy)
    try:
        with caplog.at_level("ERROR"):
            assert _validate(api, "--base", "17") == 1
        assert "distribution mismatch" in caplog.text
        assert "validation FAILED" in caplog.text
        assert _validate(api, "--base", "10") == 0  # b10 was not touched
    finally:
        api_client.close_connections()
        httpd.shutdown()


def test_validate_base_without_canon_raises(canon):
    httpd, api = _serve(canon)
    try:
        with pytest.raises(api_client.ApiError) as err:
            _validate(api, "--base", "22")
        assert err.value.status == 404
    finally:
        api_client.close_connections()
        httpd.shutdown()


def test_validate_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.main(["--validate", "--api-base", "http://127.0.0.1:9"])
