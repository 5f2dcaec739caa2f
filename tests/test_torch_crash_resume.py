"""The port's crash-safe client on the CPU (nice_tpu_torch/client/main.py,
nice_tpu_torch/daemon): a client SIGKILLed mid-field resumes the claim it
died holding from its snapshot and submits an accepted result equal to a
scalar rerun (the pattern of scripts/crash_resume_smoke.py, against the JAX
package's server in this process); --repeat claims field N+1 before it
submits N; the lease renewer posts /renew_claim; the daemon spawns the
port's client.
"""

import glob
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import Future

import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import scalar as jscalar
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch.ckpt import read_snapshot
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import SearchMode
from nice_tpu_torch.daemon import main as daemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(tmp_path, base: int, field_size: int):
    db_path = str(tmp_path / "nice.db")
    db = Db(db_path)
    db.seed_base(base, field_size=field_size)
    db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", db_path


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "2"  # the plain versions' torch threads
    return env


def _renewals(api: str) -> float:
    with urllib.request.urlopen(f"{api}/metrics", timeout=10) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith("nice_server_claim_renewals_total"):
                return float(line.split()[-1])
    return 0.0


def test_sigkilled_client_resumes_its_claim(tmp_path):
    # b22's whole range, [234256, 656395), is one field of the server's.
    httpd, api, db_path = _serve(tmp_path, 22, 1_000_000)
    ckpt_dir = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "nice_tpu_torch.client", "detailed",
           "--api-base", api, "--checkpoint-dir", ckpt_dir,
           "--device", "cpu", "--batch-size", "2048",
           "--checkpoint-batches", "1", "--renew-secs", "2",
           "--username", "crash-test",
           # no heartbeat: it would count in this process's server series
           "--telemetry-secs", "0"]
    try:
        with open(tmp_path / "run1.log", "wb") as log1:
            proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=log1,
                                    stderr=subprocess.STDOUT)
            deadline = time.monotonic() + 120
            snap = []
            while not snap and proc.poll() is None \
                    and time.monotonic() < deadline:
                snap = glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt"))
                time.sleep(0.005)
            alive = proc.poll() is None
            proc.send_signal(signal.SIGKILL)  # no cleanup: a real crash
            proc.wait(timeout=30)
        run1 = open(tmp_path / "run1.log").read()
        assert snap and alive, run1[-3000:]
        manifest, _ = read_snapshot(snap[0])
        claim_id = int(manifest["field"]["claim_id"])
        kill_cursor = int(manifest["cursor"])
        assert 234256 < kill_cursor < 656395

        run2 = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True,
                              text=True, timeout=180)
        assert run2.returncode == 0, run2.stderr[-3000:]
        m = re.search(r"resuming claim (\d+) from checkpoint: .* cursor (\d+)",
                      run2.stderr)
        assert m, run2.stderr[-3000:]
        assert int(m.group(1)) == claim_id
        assert int(m.group(2)) == kill_cursor  # the snapshot it died with
        assert f"submitted claim {claim_id}" in run2.stderr
        assert glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")) == []
        assert _renewals(api) >= 1
    finally:
        httpd.shutdown()

    db = Db(db_path)
    try:
        claim = db.get_claim_by_id(claim_id)
        subs = db.get_detailed_submissions_by_field(claim.field_id)
        field = db.get_field_by_id(claim.field_id)
    finally:
        db.close()
    assert len(subs) == 1 and subs[0].claim_id == claim_id
    ref = jscalar.process_range_detailed(
        JFieldSize(field.range_start, field.range_end), field.base)
    assert {d.num_uniques: d.count for d in subs[0].distribution} == \
        {d.num_uniques: d.count for d in ref.distribution}
    assert {(n.number, n.num_uniques) for n in subs[0].numbers} == \
        {(n.number, n.num_uniques) for n in ref.nice_numbers}
    assert ref.nice_numbers


class _StopLoop(Exception):
    pass


class _RecordingApi(api_client.AsyncApi):
    """The real AsyncApi, recording the order of its calls; the third claim
    fails, which ends the loop."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def claim_async(self, mode):
        if sum(1 for c in self.calls if c[0] == "claim") == 2:
            self.calls.append(("claim", None))
            fut = Future()
            fut.set_exception(_StopLoop())
            return fut
        fut = super().claim_async(mode)
        self.calls.append(("claim", fut))
        return fut

    def submit_async(self, data):
        self.calls.append(("submit", data))
        return super().submit_async(data)


def test_repeat_claims_ahead_and_submits_behind(tmp_path):
    httpd, api, db_path = _serve(tmp_path, 17, 2_000)
    try:
        args = client.build_parser().parse_args(
            ["detailed", "--repeat", "--api-base", api, "--device", "cpu",
             "--batch-size", "512", "--renew-secs", "0",
             "--checkpoint-dir", str(tmp_path / "ckpt")])
        rec = _RecordingApi(api, "loop-test")
        try:
            with pytest.raises(_StopLoop):
                client.run_pipelined_loop(args, rec, SearchMode.DETAILED)
        finally:
            rec.shutdown()
    finally:
        httpd.shutdown()
    kinds = [c[0] for c in rec.calls]
    # claim 1 | claim 2 while 1 is processed | submit 1 | claim 3 while 2 is
    # processed | submit 2 | (claim 3 fails).
    assert kinds == ["claim", "claim", "submit", "claim", "submit"]
    first, second = (c[1].result().claim_id for c in rec.calls[:2])
    subs = [c[1] for c in rec.calls if c[0] == "submit"]
    assert [s.claim_id for s in subs] == [first, second]
    db = Db(db_path)
    try:
        for sub in subs:  # both accepted, under their own claims
            assert db.get_submission_by_submit_id(
                sub.submit_id).claim_id == sub.claim_id
    finally:
        db.close()
    # Field 1's snapshot was retired once its submit was owned; field 2's
    # stays until its submit is settled (the loop ended before that).
    left = os.listdir(tmp_path / "ckpt")
    assert f"claim-{first}.ckpt" not in left


def test_renewer_posts_renew_claim(tmp_path):
    httpd, api, _ = _serve(tmp_path, 17, 2_000)
    try:
        data = api_client.get_field_from_server(SearchMode.DETAILED, api, "u")
        with client._ClaimRenewer(api, data.claim_id, 0.05) as renewer:
            deadline = time.monotonic() + 30
            while renewer.renewals < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
        assert renewer.renewals >= 2
        assert _renewals(api) >= 2
        assert not renewer._thread.is_alive()
    finally:
        httpd.shutdown()


def test_client_flags_match_the_jax_client():
    from nice_tpu.client import main as jclient

    mine = client.build_parser()
    theirs = jclient.build_parser()
    for flag in ("--repeat", "--checkpoint-dir", "--checkpoint-secs",
                 "--spool-dir", "--renew-secs", "--max-retries",
                 "--batch-size", "--progress-secs", "--log-level"):
        a = next(x for x in mine._actions if flag in x.option_strings)
        b = next(x for x in theirs._actions if flag in x.option_strings)
        assert a.default == b.default or (flag, a.default) == (
            "--max-retries", 10), flag
    args = mine.parse_args(["--checkpoint-batches", "16"])
    assert args.checkpoint_batches == 16
    assert mine.parse_args([]).checkpoint_batches == 256


def test_daemon_spawns_the_port_client(tmp_path):
    args = daemon.build_parser().parse_args(
        ["--checkpoint-dir", str(tmp_path), "--", "--benchmark", "base-ten",
         "--device", "cpu"])
    client_args = daemon.client_args_of(args)
    assert client_args == ["--benchmark", "base-ten", "--device", "cpu",
                           "--checkpoint-dir", str(tmp_path)]
    assert daemon.client_args_of(daemon.build_parser().parse_args([])) == \
        ["--repeat"]
    pm = daemon.ProcessManager(client_args, healthy_secs=60)
    assert pm.command()[:3] == [sys.executable, "-m", "nice_tpu_torch.client"]
    pm.start()
    try:
        pm.proc.wait(timeout=120)
    finally:
        pm.stop()
    assert pm.reap() and pm.consecutive_crashes == 0 and pm.starts == 1
    # A client that dies at once is held back by the crash-loop backoff.
    bad = daemon.ProcessManager(["--no-such-flag"], healthy_secs=60)
    bad.start()
    bad.proc.wait(timeout=120)
    assert bad.reap() and bad.consecutive_crashes == 1
    assert bad.restart_delay() > 0
