"""Checkpoint and resume of the port's scalar backend and of ranges wholly
outside a base's valid range (ops/engine.py _chunked_host_scan), on the CPU:
the port's list of states equals the JAX engine's _chunked_host_scan list on
the same range and chunk, a run stopped after a checkpoint resumes to the
uninterrupted result, states resume across the two packages, and the
client's --backend scalar --checkpoint-dir writes snapshots, resumes from
them and spools under that directory.
"""

import glob
import os
import threading

import numpy as np
import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch import ckpt
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import engine

# In-process client runs start no sampler thread and no telemetry beat:
# those would outlive the test in this worker and post to its JAX server.
QUIET = ("--telemetry-secs", "0", "--pyprof-hz", "0", "--memwatch-secs", "0",
         "--history-secs", "0")

B40_MID = sum(base_range.get_base_range(40)) // 2

# (mode, base, start, end, chunk): b10 with slivers on both sides of its
# range [47, 100) and 69 inside; b17 with near misses; a b40 slice.
CASES = [
    ("detailed", 10, 40, 130, 10),
    ("niceonly", 10, 40, 130, 10),
    ("detailed", 17, 4900, 6900, 256),
    ("niceonly", 40, B40_MID, B40_MID + 40_000, 8192),
]
IDS = [f"{m}-b{b}" for m, b, *_ in CASES]


class _Stop(Exception):
    pass


def _process(mode):
    return (engine.process_range_detailed if mode == "detailed"
            else engine.process_range_niceonly)


def _jprocess(mode):
    return (jengine.process_range_detailed if mode == "detailed"
            else jengine.process_range_niceonly)


def _pairs(results):
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _plain(state):
    out = dict(state)
    if out["hist"] is not None:
        out["hist"] = np.asarray(out["hist"]).tolist()
    out["nice_numbers"] = [tuple(x) for x in out["nice_numbers"]]
    out["remaining"] = [list(x) for x in out["remaining"]]
    return out


def _port_states(mode, base, s, e, chunk, **kw):
    states = []
    got = _process(mode)(FieldSize(s, e), base, batch_size=chunk,
                         checkpoint_cb=states.append, checkpoint_batches=1,
                         checkpoint_secs=0, **kw)
    return got, states


def _jax_states(mode, base, s, e, chunk, backend="scalar"):
    states = []
    got = _jprocess(mode)(JFieldSize(s, e), base, backend=backend,
                          batch_size=chunk, checkpoint_cb=states.append,
                          checkpoint_batches=1, checkpoint_secs=0)
    return got, states


@pytest.mark.parametrize("mode,base,s,e,chunk", CASES, ids=IDS)
def test_scalar_states_equal_jax_chunked_scan(mode, base, s, e, chunk):
    got, states = _port_states(mode, base, s, e, chunk, backend="scalar")
    want, jstates = _jax_states(mode, base, s, e, chunk)
    assert _pairs(got) == _pairs(want)
    assert got == _process(mode)(FieldSize(s, e), base, backend="scalar")
    assert len(states) == -(-(e - s) // chunk) >= 4
    assert [_plain(st) for st in states] == [_plain(st) for st in jstates]
    assert states[-1]["cursor"] == e and states[-1]["remaining"] == []
    if mode == "detailed":
        assert sum(states[-1]["hist"]) == e - s
    if base == 10:
        assert (69, 10) in _pairs(got)[1]


@pytest.mark.parametrize("mode,base,s,e,chunk", CASES, ids=IDS)
def test_scalar_run_stopped_after_a_checkpoint_resumes(mode, base, s, e,
                                                       chunk):
    full = _process(mode)(FieldSize(s, e), base, backend="scalar")
    states = []

    def stop_after_second(st):
        states.append(st)
        if len(states) == 2:
            raise _Stop

    with pytest.raises(_Stop):
        _process(mode)(FieldSize(s, e), base, backend="scalar",
                       batch_size=chunk, checkpoint_cb=stop_after_second,
                       checkpoint_batches=1, checkpoint_secs=0)
    assert states[1]["cursor"] == s + 2 * chunk
    resumed_states = []
    got = _process(mode)(FieldSize(s, e), base, backend="scalar",
                         batch_size=chunk, resume=states[1],
                         checkpoint_cb=resumed_states.append,
                         checkpoint_batches=1, checkpoint_secs=0)
    assert got == full
    assert resumed_states[0]["cursor"] == s + 3 * chunk


@pytest.mark.parametrize("mode,base,s,e,chunk", CASES, ids=IDS)
def test_states_resume_across_packages(mode, base, s, e, chunk):
    full, states = _port_states(mode, base, s, e, chunk, backend="scalar")
    _, jstates = _jax_states(mode, base, s, e, chunk)
    for i in (0, len(states) // 2, len(states) - 1):
        # A JAX state on the port, and a port state on the JAX engine.
        got = _process(mode)(FieldSize(s, e), base, backend="scalar",
                             batch_size=chunk, resume=jstates[i])
        assert got == full
        want = _jprocess(mode)(JFieldSize(s, e), base, backend="scalar",
                               batch_size=chunk, resume=states[i])
        assert _pairs(want) == _pairs(full)


@pytest.mark.parametrize("mode", ["detailed", "niceonly"])
def test_out_of_range_field_checkpoints(mode):
    # [5, 40) lies wholly below b10's range: the device path scans it on the
    # oracle in chunks, as the JAX device path does (its jnp backend here).
    got, states = _port_states(mode, 10, 5, 40, 8, device="cpu")
    want, jstates = _jax_states(mode, 10, 5, 40, 8, backend="jnp")
    assert _pairs(got) == _pairs(want)
    assert len(states) == 5
    assert [_plain(st) for st in states] == [_plain(st) for st in jstates]
    for st in states[:-1]:
        assert _process(mode)(FieldSize(5, 40), 10, device="cpu",
                              batch_size=8, resume=st) == got


@pytest.fixture
def server(tmp_path):
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
    db_path = str(tmp_path / "nice.db")
    db = Db(db_path)
    db.seed_base(17, field_size=4_000)
    db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    reset()
    httpd.shutdown()


def test_client_scalar_checkpoint_dir_snapshots_and_resumes(server, tmp_path,
                                                            monkeypatch):
    # The first run is interrupted after its second snapshot (as ^C would
    # stop it) and leaves that snapshot under D; the second run resumes the
    # claim from it, submits and retires it. D/spool is the default spool.
    ckpt_dir = str(tmp_path / "ckpt")
    argv = ["detailed", "--api-base", server, "--backend", "scalar",
            "--checkpoint-dir", ckpt_dir, "--checkpoint-batches", "1",
            "--batch-size", "500", "--renew-secs", "0", "--max-retries", "1",
            *QUIET]
    saved = []
    real_save = ckpt.FieldCheckpointer.save

    def save(self, state):
        real_save(self, state)
        saved.append(state["cursor"])
        if len(saved) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.FieldCheckpointer, "save", save)
    assert client.main(argv) == 0
    snaps = glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt"))
    assert len(snaps) == 1 and os.path.isdir(os.path.join(ckpt_dir, "spool"))
    data, state, _ = ckpt.find_resumable(ckpt_dir, client.SearchMode.DETAILED,
                                         "scalar", 500, "cuda")
    assert state["cursor"] == saved[1] == data.range_start + 1000
    assert [list(seg) for seg in state["remaining"]] == [
        [data.range_start + 1000, data.range_end]]

    monkeypatch.setattr(ckpt.FieldCheckpointer, "save", real_save)
    submitted = []
    real_submit = client.compile_results
    monkeypatch.setattr(client, "compile_results", lambda *a: submitted.append(
        real_submit(*a)) or submitted[-1])
    assert client.main(argv) == 0
    assert glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")) == []
    (sub,) = submitted
    assert sub.claim_id == data.claim_id
    want = engine.process_range_detailed(data.to_field_size(), 17,
                                         backend="scalar")
    assert sub.unique_distribution == list(want.distribution)
    assert sub.nice_numbers == list(want.nice_numbers)
