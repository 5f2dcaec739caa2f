"""Chaos drill of the port's client (the twin of scripts/chaos_smoke.py): a
real coordination server and real block-lease clients under a seeded fault
schedule and a genuine mid-run server SIGKILL, after which every field must
have been accepted exactly once, equal to a fault-free recomputation.

    python -m nice_tpu_torch.scripts.chaos_smoke [workdir] [--device cuda|cpu]

The server is the JAX package's (`python -m nice_tpu.server`, which runs
without jax), seeded with BASE in fields of FIELD_SIZE (6 fields); its
sqlite ledger is read with the stdlib. The canonical results are the port's
scalar oracle on each field's range as the ledger holds it, computed before
any chaos. The clients are `python -m nice_tpu_torch.client detailed
--claim-block 2` (3 runs, one block each) on --device, with snapshots after
every segment in one checkpoint directory and --log-level debug (the
engine's per-field line counts the K1 segments each field ran).

Fault schedule (--faults, seed FAULT_SEED: every run draws the same drops):
  * HTTP_FAULTS: /submit_block and /submit replies dropped at 0.4: the
    server takes the submit, the client sees a network error and retries,
    so every member rides the exactly-once submit_id replay;
  * the server is SIGKILLed once run 2's block claim has landed, held down
    OUTAGE_SECS and restarted on the same port and ledger, so run 2's
    submit retries ride through a real outage;
  * engine.dispatch:raise@N in run FAULTED_RUN only. The port has no
    downgrade chain: the fault raises out of the field. A bare-int selector
    fires once a process, so in every run it would fail each resume again.
    N is the predicted first member's dispatches plus 2
    (engine.detailed_dispatches at BATCH_SIZE), so the raise comes in the
    block's second member, after that member's first snapshot: raised in
    the first, the second would sit unprocessed under a live lease until
    the server's claim expiry. BATCH_SIZE gives every field at least three
    dispatches (at the engine's default shape a field is one).
    The run must exit non-zero with the fault in its log, leaving a
    finished snapshot of the first member and one of the second with a
    cursor past its start. Reruns with HTTP_FAULTS only and the same
    checkpoint directory, batch size and device (find_resumable matches on
    them) then resume the snapshots, one a run, through the per-field path
    (claim, process, /submit): a block rerun would drain them and then
    claim a new block, which the server's possibly-active fallback fills
    with fields already accepted: a second accepted submission each.

Asserted: every run exits 0 but the faulted one, and so does every rerun;
after a fault-free spool replay the spool is empty; every field has
exactly one accepted submission, whose distribution and near misses equal
the oracle's; a response was dropped; a duplicate replay was logged ("was
a duplicate" / "were duplicates"); the dispatch fault fired and its claim
was resumed from its snapshot's cursor; "failed mid-field" (the
reference's downgrade) is in no log. Prints one JSON line; exit code 0
only when ok.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import socket
import sqlite3
import subprocess
import sys
import tempfile
import time

BASE = 22  # full valid range [234256, 656395)
FIELD_SIZE = 75_000  # -> 6 fields over the base range
BLOCK = 2  # fields per claim_block lease -> 3 client runs cover the base
HTTP_FAULTS = "http.submit_block:drop_response@0.4,http.submit:drop_response@0.4"
FAULT_SEED = "2"  # pinned: same drops every run; a later attempt delivers
RUN_TIMEOUT = 300
OUTAGE_SECS = 2.5
POLL_SECS = 0.05
# Lanes a batch: with the default segment of 8, 16,384 numbers a dispatch,
# so 5 dispatches a full field and 3 for the last (47,139 numbers).
BATCH_SIZE = 2048
MIN_DISPATCHES = 3
FAULTED_RUN = 3  # 1-based

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The engine's debug line at the end of a detailed field (ops/engine.py).
_FIELD_LINE = re.compile(
    r"detailed b\d+ \[\d+, \d+\) on (\S+) \(batch \d+ x \d+, use_mxu (\d), "
    r"feed depth \d+\): [\d.]+s, (\d+) segments")
_RESUMED = re.compile(r"resuming claim (\d+) from checkpoint: .*?cursor (\d+)")


def _pick_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(cmd: list, log_path: str) -> subprocess.Popen:
    """cmd from the repository root, its output appended to log_path."""
    # nicelint: allow A1 (a process log, not state)
    with open(log_path, "ab") as log_f:
        return subprocess.Popen(cmd, cwd=REPO, stdout=log_f,
                                stderr=subprocess.STDOUT)


def _start_server(db_path: str, port: int, log_path: str,
                  seed: bool) -> subprocess.Popen:
    init = (["--init-base", str(BASE), "--field-size", str(FIELD_SIZE)]
            if seed else [])
    return _spawn([sys.executable, "-m", "nice_tpu.server", "--db", db_path,
                   *init, "--host", "127.0.0.1", "--port", str(port)],
                  log_path)


def _wait_listening(port: int, proc: subprocess.Popen,
                    timeout: float = 60) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return False
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            time.sleep(POLL_SECS)
    return False


def _wait(proc: subprocess.Popen) -> int:
    """A client's exit code within RUN_TIMEOUT (-9: killed at it)."""
    try:
        return proc.wait(timeout=RUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return -9


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _query(db_path: str, sql: str, params=()) -> list:
    conn = sqlite3.connect(db_path, timeout=30)
    try:
        return conn.execute(sql, params).fetchall()
    finally:
        conn.close()


def ledger_fields(db_path: str) -> list:
    """[(field_id, FieldSize)] of BASE as the ledger holds them, by id."""
    from nice_tpu_torch.core.types import FieldSize

    return [(int(i), FieldSize(int(s), int(e))) for i, s, e in _query(
        db_path, "SELECT id, range_start, range_end FROM fields "
        "WHERE base_id = ? ORDER BY id", (BASE,))]


def unclaimed_fields(db_path: str) -> list:
    """The fields no claim row holds yet, by id: the block the server hands
    the next run (its possibly-active fallback orders by check level, claim
    time and id)."""
    held = {int(r[0]) for r in _query(db_path, "SELECT field_id FROM claims")}
    return [(i, f) for i, f in ledger_fields(db_path) if i not in held]


def fault_index(member1, device: str, batch_size: int = BATCH_SIZE) -> int:
    """N of engine.dispatch:raise@N: the first member's dispatches (the
    engine's segment plan at batch_size) plus 2, the second member's second
    dispatch."""
    from nice_tpu_torch.ops import engine

    return engine.detailed_dispatches(member1, BASE, device=device,
                                      batch_size=batch_size) + 2


def canonical(fields: list) -> dict:
    """{field_id: (distribution, near misses)} of the scalar oracle."""
    from nice_tpu_torch.ops import scalar

    out = {}
    for fid, f in fields:
        r = scalar.process_range_detailed(f, BASE)
        out[fid] = ({d.num_uniques: d.count for d in r.distribution},
                    {(n.number, n.num_uniques) for n in r.nice_numbers})
    return out


def accepted(db_path: str, field_id: int) -> list:
    """The field's accepted detailed submissions as (distribution, near
    misses), oldest first."""
    out = []
    for dist, nums in _query(
            db_path, "SELECT distribution, numbers FROM submissions WHERE "
            "field_id = ? AND search_mode = 'detailed' AND disqualified = 0 "
            "ORDER BY id", (field_id,)):
        out.append(({int(d["num_uniques"]): int(d["count"])
                     for d in json.loads(dist or "[]")},
                    {(int(n["number"]), int(n["num_uniques"]))
                     for n in json.loads(nums or "[]")}))
    return out


def snapshots(ckpt_dir: str) -> list:
    """[(DataToClient, cursor)] of every snapshot in ckpt_dir."""
    from nice_tpu_torch.ckpt import read_snapshot
    from nice_tpu_torch.core.types import DataToClient

    out = []
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt"))):
        manifest, _ = read_snapshot(path)
        out.append((DataToClient.from_json(manifest["field"]),
                    int(manifest["cursor"])))
    return out


def k1_segments(text: str) -> dict:
    """K1 segments (use_mxu 0) by device over the engine's field lines."""
    out: dict = {}
    for dev, mxu, n in _FIELD_LINE.findall(text):
        if mxu == "0":
            out[dev] = out.get(dev, 0) + int(n)
    return out


def client_cmd(api_base: str, device: str, ckpt_dir: str, faults: str,
               block: bool) -> list:
    return [sys.executable, "-m", "nice_tpu_torch.client", "detailed",
            "--api-base", api_base, "--device", device,
            *(("--claim-block", str(BLOCK)) if block else ()),
            "--batch-size", str(BATCH_SIZE), "--checkpoint-batches", "1",
            "--checkpoint-dir", ckpt_dir, "--max-retries", "12",
            "--renew-secs", "5", "--username", "chaos-smoke",
            "--log-level", "debug", "--faults", faults,
            "--faults-seed", FAULT_SEED]


def _read(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()


def run_drill(workdir: str, device: str) -> dict:
    """The drill in workdir (module doc): its JSON line."""
    from nice_tpu_torch.client import api_client
    from nice_tpu_torch.faults.spool import SubmissionSpool
    from nice_tpu_torch.ops import engine

    t_start = time.monotonic()
    engine.resolve_device(device)  # no card: raise before anything starts
    db_path = os.path.join(workdir, "chaos.db")
    ckpt_dir = os.path.join(workdir, "ckpt")
    server_log = os.path.join(workdir, "server.log")
    port = _pick_port()
    api_base = f"http://127.0.0.1:{port}"
    failures: list = []
    line: dict = {"workdir": workdir, "device": device,
                  "batch_size": BATCH_SIZE, "server_killed": False}
    procs: list = []
    server = _start_server(db_path, port, server_log, seed=True)
    try:
        if not _wait_listening(port, server):
            raise RuntimeError("server never listened:\n"
                               + _read(server_log)[-2000:])
        fields = ledger_fields(db_path)
        line["fields"] = len(fields)
        canon = canonical(fields)
        plan = {fid: engine.detailed_dispatches(f, BASE, device=device,
                                                batch_size=BATCH_SIZE)
                for fid, f in fields}
        line["dispatches_by_field"] = plan
        if min(plan.values()) < MIN_DISPATCHES:
            failures.append(f"a field has fewer than {MIN_DISPATCHES} "
                            f"dispatches at batch {BATCH_SIZE}: {plan}")

        def claims_count() -> int:
            return int(_query(db_path, "SELECT COUNT(*) FROM claims")[0][0])

        run_logs, rcs = [], []
        for run in range(1, len(fields) // BLOCK + 1):
            faults = HTTP_FAULTS
            if run == FAULTED_RUN:
                block = unclaimed_fields(db_path)
                if len(block) != BLOCK:
                    raise RuntimeError(f"run {run} finds {len(block)} "
                                       f"unclaimed fields, not {BLOCK}")
                line["faulted_block"] = [fid for fid, _ in block]
                line["fault_index"] = fault_index(block[0][1], device)
                faults += f",engine.dispatch:raise@{line['fault_index']}"
            log_path = os.path.join(workdir, f"client-run{run}.log")
            run_logs.append(log_path)
            proc = _spawn(client_cmd(api_base, device, ckpt_dir, faults, True),
                          log_path)
            procs.append(proc)
            if run == 2:
                # Once run 2's block claim has landed (it is processing),
                # SIGKILL the server, hold an outage, restart it on the same
                # port and ledger: run 2's submit rides the retries.
                before = (run - 1) * BLOCK  # claims minted by earlier blocks
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    if claims_count() > before or proc.poll() is not None:
                        break
                    time.sleep(POLL_SECS)
                if claims_count() > before:
                    server.send_signal(signal.SIGKILL)
                    server.wait()
                    line["server_killed"] = True
                    time.sleep(OUTAGE_SECS)
                    server = _start_server(db_path, port, server_log,
                                           seed=False)
                    if not _wait_listening(port, server):
                        failures.append("server did not come back after kill")
                else:
                    failures.append(
                        "run 2 never claimed its block; kill drill skipped")
            rc = _wait(proc)
            rcs.append(rc)
            if (rc != 0) != (run == FAULTED_RUN):
                failures.append(f"client run {run} exited {rc}; tail: "
                                + _read(log_path)[-2000:])
        line["run_rcs"] = rcs

        # The faulted run's snapshots: its first member finished, its
        # second past its start.
        faulted_log = _read(run_logs[FAULTED_RUN - 1])
        if "injected engine.dispatch fault" not in faulted_log:
            failures.append(f"run {FAULTED_RUN} did not raise the injected "
                            "dispatch fault")
        snaps = snapshots(ckpt_dir)
        part = [(d, c) for d, c in snaps if d.range_start < c < d.range_end]
        done = [(d, c) for d, c in snaps if c >= d.range_end]
        faulted = None
        if len(snaps) != BLOCK or len(part) != 1 or len(done) != 1:
            failures.append(f"after run {FAULTED_RUN}: snapshots "
                            f"{[(d.claim_id, c) for d, c in snaps]}, want one "
                            "finished and one past its start")
        else:
            faulted, cursor = part[0]
            line["faulted_claim"] = faulted.claim_id
            line["faulted_cursor"] = cursor
            second = dict(fields)[line["faulted_block"][1]]
            if (faulted.range_start, faulted.range_end) != (
                    second.start(), second.end()):
                failures.append("the dispatch fault did not fire in the "
                                "block's second member")

        # Reruns, one a snapshot, through the per-field path.
        rerun_rcs = []
        for i in range(BLOCK):
            if not glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")):
                break
            log_path = os.path.join(workdir, f"client-rerun{i + 1}.log")
            run_logs.append(log_path)
            proc = _spawn(client_cmd(api_base, device, ckpt_dir, HTTP_FAULTS,
                                     False), log_path)
            procs.append(proc)
            rc = _wait(proc)
            rerun_rcs.append(rc)
            if rc != 0:
                failures.append(f"rerun {i + 1} exited {rc}; tail: "
                                + _read(log_path)[-2000:])
        line["rerun_rcs"] = rerun_rcs
        resumed = {}
        for path in run_logs[len(fields) // BLOCK:]:
            for claim, cur in _RESUMED.findall(_read(path)):
                resumed[int(claim)] = int(cur)
        line["resumed_claims"] = resumed
        if faulted is not None and resumed.get(faulted.claim_id) != \
                line["faulted_cursor"]:
            failures.append(f"claim {faulted.claim_id} was not resumed from "
                            f"its snapshot's cursor: {resumed}")
        if glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")):
            failures.append("snapshots outlived the reruns")

        logs_text = "".join(_read(p) for p in run_logs)
        # A spooled submission (an outage past the retry budget) goes by a
        # fault-free replay: the recovery path, not another chaos run.
        spool = SubmissionSpool(os.path.join(ckpt_dir, "spool"))
        if spool.pending():
            spool.replay(api_base)
            api_client.close_connections()
        if spool.pending():
            failures.append("spooled submissions remained undeliverable")

        # Exactly once, equal to the oracle.
        total = 0
        for fid, _ in fields:
            subs = accepted(db_path, fid)
            total += len(subs)
            if len(subs) != 1:
                failures.append(f"field {fid} has {len(subs)} accepted "
                                "submissions, expected exactly 1")
            elif subs[0][0] != canon[fid][0]:
                failures.append(f"field {fid}: distribution != the oracle's")
            elif subs[0][1] != canon[fid][1]:
                failures.append(f"field {fid}: near misses != the oracle's")
        line["submissions"] = total

        # The faults demonstrably fired.
        line["dropped_responses"] = logs_text.count("response dropped")
        if line["dropped_responses"] < 1:
            failures.append("no submit response was dropped (fault never "
                            "fired)")
        line["duplicate_replays"] = (logs_text.count("was a duplicate")
                                     + logs_text.count("were duplicates"))
        if not line["duplicate_replays"]:
            failures.append("no duplicate-submit replay observed "
                            "(exactly-once path unused)")
        line["dispatch_faults"] = logs_text.count(
            "injected fault at engine.dispatch")
        if line["dispatch_faults"] < 1:
            failures.append("no engine dispatch fault fired")
        if "failed mid-field" in logs_text:
            failures.append("a downgrade was logged: the port has none")
        line["k1_segments"] = k1_segments(logs_text)
        if not line["k1_segments"].get(device):
            failures.append(f"no K1 segment ran on {device}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _stop(server)
    line["ok"] = not failures
    line["failures"] = failures
    line["elapsed_secs"] = time.monotonic() - t_start
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=None,
                    help="keep the ledger, logs and snapshots here (default: "
                    "a temporary directory, removed when the drill passes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        workdir, cleanup = args.workdir, False
    else:
        workdir, cleanup = tempfile.mkdtemp(prefix="chaos-smoke-"), True
    line = run_drill(workdir, args.device)
    print(json.dumps(line), flush=True)
    if cleanup and line["ok"]:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
