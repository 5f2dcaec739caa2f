"""nice-tpu-torch search client CLI (the port's cut of nice_tpu/client/main.py).

  * single shot: claim one field (detailed or niceonly) from --api-base,
    process it on the card, submit it; niceonly takes every base, b10-b97
    through the strided pipeline and b98 and up through the dense loop;
  * --repeat: the 3-stage pipeline — claim N+1 and submit N-1 overlap
    processing N, until interrupted;
  * --checkpoint-dir: crash-safe snapshots of the field being scanned
    (ckpt/), written on the engine's checkpoint ticker; a restarted client
    resumes the claim it died holding from its newest snapshot, and a
    snapshot is deleted only once its submit is owned (accepted or spooled);
  * --spool-dir (default <checkpoint-dir>/spool): submissions whose retries
    ran out are journaled (faults/spool.py) and replayed at startup and at
    every loop boundary;
  * --renew-secs: a lease heartbeat (/renew_claim) while a field scans;
  * --benchmark <field>: process a built-in benchmark field offline and
    print one JSON summary line (the JAX client's keys).

The default device is cuda; --device cpu runs the kernels' plain PyTorch
versions, and --backend scalar the Python-int oracle (which neither
checkpoints nor resumes). Every knob is a flag: the port reads no
environment variable. Left out against the JAX client: multi-server
failover (--servers), claim blocks, tenants, --validate, --threads and
telemetry.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import sys
import threading
import time
from contextlib import nullcontext
from typing import Optional

from nice_tpu_torch import CLIENT_VERSION
from nice_tpu_torch import ckpt
from nice_tpu_torch.client import api_client
from nice_tpu_torch.core import number_stats
from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    FieldResults,
    SearchMode,
)
from nice_tpu_torch.faults import spool as spool_mod
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops.limbs import get_plan

log = logging.getLogger("nice_tpu_torch.client")

_LOG_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
               "info": logging.INFO, "warn": logging.WARNING,
               "error": logging.ERROR}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nice-tpu-torch-client",
        description="Distributed search client for square-cube pandigitals "
        "(PyTorch/CUDA)",
    )
    p.add_argument("mode", nargs="?", default="detailed",
                   choices=["detailed", "niceonly"],
                   help="search mode: detailed (histogram and near misses) or "
                   "niceonly (nice numbers only: strided up to b97, dense "
                   "from b98)")
    p.add_argument("--api-base", default="https://api.nicenumbers.net",
                   help="API base URL")
    p.add_argument("--username", default="anonymous",
                   help="username credited with submissions")
    p.add_argument("--max-retries", type=int,
                   default=api_client.DEFAULT_MAX_RETRIES,
                   help="HTTP retry ceiling")
    p.add_argument("--repeat", action="store_true",
                   help="run until interrupted, with the 3-stage pipeline "
                   "(claim N+1 and submit N-1 while N is processed)")
    p.add_argument("--backend", default="device", choices=list(engine.BACKENDS),
                   help="device: the kernels (or their plain versions with "
                   "--device cpu); scalar: the Python-int oracle")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the device backend runs")
    p.add_argument("--batch-size", type=lambda v: int(v) or None, default=None,
                   help="lanes per batch of the detailed and dense loops; 0 "
                   "= the tuned winner, else "
                   f"{engine.DEFAULT_BATCH_SIZE} (the strided pipeline "
                   "takes its shapes from the MSD floor)")
    p.add_argument("--progress-secs", type=float, default=5.0,
                   help="seconds between in-field progress lines; 0 disables")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for crash-safe field-scan snapshots; "
                   "enables periodic checkpointing and auto-resume of an "
                   "interrupted claim on startup")
    p.add_argument("--spool-dir", default=None,
                   help="directory journaling submissions whose HTTP retries "
                   "were exhausted, for replay at the next loop iteration / "
                   "startup; defaults to <checkpoint-dir>/spool when "
                   "checkpointing is on")
    p.add_argument("--checkpoint-secs", type=float,
                   default=engine.CKPT_EVERY_SECS,
                   help="seconds between snapshots while scanning")
    p.add_argument("--checkpoint-batches", type=int,
                   default=engine.CKPT_EVERY_BATCHES,
                   help="dispatched segments, runs or descriptor groups "
                   "between snapshots (whichever of this and "
                   "--checkpoint-secs fires first; 0 disables this trigger)")
    p.add_argument("--renew-secs", type=float, default=900.0,
                   help="seconds between claim-lease renewal heartbeats to "
                   "/renew_claim; 0 disables")
    p.add_argument("--benchmark", default=None,
                   choices=[m.value for m in BenchmarkMode],
                   help="process a benchmark field offline")
    p.add_argument("--log-level", default="info", choices=list(_LOG_LEVELS),
                   help="log verbosity")
    return p


def _mode(args) -> SearchMode:
    return (SearchMode.DETAILED if args.mode == "detailed"
            else SearchMode.NICEONLY)


def _progress_logger(every_secs: float):
    """Throttled in-field progress callback: % done, live n/s, ETA.
    Thread-safe: the engine may call it from a pipeline worker thread."""
    if not every_secs or every_secs <= 0:
        return None
    t0 = time.monotonic()
    state = {"last": t0}
    lock = threading.Lock()

    def cb(done: int, total: int) -> None:
        now = time.monotonic()
        with lock:
            if now - state["last"] < every_secs or done <= 0 or done >= total:
                return
            state["last"] = now
        rate = done / max(now - t0, 1e-9)
        eta = (total - done) / rate if rate > 0 else float("inf")
        log.info(
            "progress %5.1f%% (%s / %s) %s numbers/sec, ETA %.0fs",
            100.0 * done / total, f"{done:,}", f"{total:,}", f"{rate:,.0f}", eta,
        )

    return cb


def process_field(data: DataToClient, args, *, checkpointer=None,
                  resume=None) -> tuple[FieldResults, float]:
    """Process one field in args.mode; returns results and elapsed seconds.

    checkpointer: an optional ckpt.FieldCheckpointer whose save() becomes
    the engine's checkpoint_cb (on the ticker of args.checkpoint_batches /
    args.checkpoint_secs); resume: a validated state from its load() or
    find_resumable, to continue from instead of restarting the scan."""
    kwargs = {"device": args.device, "backend": args.backend,
              "progress": _progress_logger(args.progress_secs)}
    if checkpointer is not None or resume is not None:
        kwargs.update(checkpoint_cb=(checkpointer.save if checkpointer
                                     else None),
                      resume=resume, checkpoint_batches=args.checkpoint_batches,
                      checkpoint_secs=args.checkpoint_secs)
    if args.mode == "detailed":
        process = engine.process_range_detailed
        kwargs["batch_size"] = args.batch_size
    else:
        process = engine.process_range_niceonly
        if get_plan(data.base).limbs_n > 4:  # the dense loop's runs
            kwargs["batch_size"] = args.batch_size
    t0 = time.monotonic()
    results = process(data.to_field_size(), data.base, **kwargs)
    elapsed = time.monotonic() - t0
    rate = data.range_size / elapsed if elapsed > 0 else float("inf")
    log.info("processed %s numbers in %.2fs (%s numbers/sec)",
             f"{data.range_size:,}", elapsed, f"{rate:,.0f}")
    return results, elapsed


def compile_results(data: DataToClient, results: FieldResults,
                    mode: SearchMode, username: str) -> DataToServer:
    """The submission payload (no distribution in niceonly mode), stamped
    with the exactly-once submit_id (claim id + content hash), computed as
    the JAX client computes it."""
    payload = DataToServer(
        claim_id=data.claim_id,
        username=username,
        client_version=CLIENT_VERSION,
        unique_distribution=(list(results.distribution)
                             if mode == SearchMode.DETAILED else None),
        nice_numbers=list(results.nice_numbers),
    )
    content = json.dumps(payload.to_json(), sort_keys=True).encode()
    payload.submit_id = (
        f"{data.claim_id}-{hashlib.sha256(content).hexdigest()[:16]}"
    )
    return payload


def run_benchmark(args) -> int:
    bench = BenchmarkMode(args.benchmark)
    data = get_benchmark_field(bench)
    log.info("benchmark %s: base %d, range [%d, %d) (%s numbers), backend %s "
             "on %s", bench.value, data.base, data.range_start, data.range_end,
             f"{data.range_size:,}", args.backend, args.device)
    results, elapsed = process_field(data, args)
    summary = {
        "benchmark": bench.value,
        "base": data.base,
        "range_size": data.range_size,
        "mode": args.mode,
        "backend": args.backend,
        "device": args.device,
        "elapsed_secs": round(elapsed, 4),
        "numbers_per_sec": round(data.range_size / elapsed, 1),
        "nice_count": sum(
            1 for n in results.nice_numbers if n.num_uniques == data.base
        ),
        "near_miss_cutoff": number_stats.get_near_miss_cutoff(data.base),
        "near_misses": len(results.nice_numbers),
    }
    print(json.dumps(summary), flush=True)
    return 0


class _ClaimRenewer:
    """Background lease heartbeat for one claim: POSTs /renew_claim
    immediately on entry (a resumed claim may be near expiry) and then every
    every_secs. Failures are logged and swallowed — a missed heartbeat is
    recoverable, killing the scan over one is not."""

    def __init__(self, api_base: str, claim_id: int, every_secs: float):
        self.api_base = api_base
        self.claim_id = claim_id
        self.every_secs = every_secs
        self.renewals = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="claim-renew", daemon=True
        )

    def _renew_once(self) -> None:
        try:
            api_client.renew_claim(self.api_base, self.claim_id)
            self.renewals += 1
            log.debug("renewed claim %d lease", self.claim_id)
        except Exception as e:  # noqa: BLE001 — a missed heartbeat is logged
            log.warning("claim %d lease renewal failed: %s", self.claim_id, e)

    def _run(self) -> None:
        self._renew_once()
        while not self._stop.wait(self.every_secs):
            self._renew_once()

    def __enter__(self) -> "_ClaimRenewer":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _maybe_renewer(args, claim_id: int):
    if args.renew_secs and args.renew_secs > 0 and claim_id > 0:
        return _ClaimRenewer(args.api_base, claim_id, args.renew_secs)
    return nullcontext()


def _new_checkpointer(args, data: DataToClient, mode: SearchMode):
    if not args.checkpoint_dir:
        return None
    return ckpt.FieldCheckpointer(args.checkpoint_dir, data, mode,
                                  args.backend, args.batch_size, args.device)


def _resume_or_claim(args, api: api_client.AsyncApi, mode: SearchMode):
    """(data, resume_state, checkpointer): the newest matching snapshot in
    --checkpoint-dir if one exists (same claim, no re-claim round-trip), else
    a fresh server claim."""
    if args.checkpoint_dir:
        found = ckpt.find_resumable(args.checkpoint_dir, mode, args.backend,
                                    args.batch_size, args.device)
        if found is not None:
            data, state, ckptr = found
            log.info(
                "resuming claim %d from checkpoint: base %d, range [%d, %d), "
                "cursor %d",
                data.claim_id, data.base, data.range_start, data.range_end,
                state["cursor"],
            )
            return data, state, ckptr
    data = api.claim_async(mode).result()
    log.info("claimed field (claim %d): base %d, range [%d, %d)",
             data.claim_id, data.base, data.range_start, data.range_end)
    return data, None, _new_checkpointer(args, data, mode)


def _await_submit(future, submission: DataToServer, spool) -> Optional[dict]:
    """Confirm a submit, journaling to the spool when the server stayed
    unreachable past the retry budget; returns the server's reply, or None
    when spooled. A 4xx rejection always raises — a replay of a rejected
    payload can never succeed. Once this returns, delivery is OWNED
    (accepted, already-accepted duplicate, or spooled), so the field's
    snapshot may be retired."""
    try:
        resp = future.result()
    except api_client.ApiError as e:
        if spool is None or (e.status is not None and 400 <= e.status < 500):
            raise
        spool.add(submission)
        return None
    log.info("submitted claim %d%s", submission.claim_id,
             " (duplicate)" if resp.get("duplicate") else "")
    return resp


def run_single_iteration(args, api: Optional[api_client.AsyncApi] = None,
                         mode: Optional[SearchMode] = None, spool=None):
    """Claim (or resume) one field of args.mode, process it, submit it;
    returns the field, the submission and the server's reply (None when the
    submission was spooled). Without `api` it makes its own and shuts it
    down."""
    own = api is None
    if own:
        api = api_client.AsyncApi(args.api_base, args.username,
                                  args.max_retries)
    mode = mode if mode is not None else _mode(args)
    try:
        data, resume, ckptr = _resume_or_claim(args, api, mode)
        with _maybe_renewer(args, data.claim_id):
            results, _ = process_field(data, args, checkpointer=ckptr,
                                       resume=resume)
        submission = compile_results(data, results, mode, args.username)
        resp = _await_submit(api.submit_async(submission), submission, spool)
    finally:
        if own:
            api.shutdown()
    # Only an owned submit (confirmed or spooled) retires the snapshot; any
    # failure before this point leaves it on disk for the next startup.
    if ckptr is not None:
        ckptr.delete()
    return data, submission, resp


def run_pipelined_loop(args, api: api_client.AsyncApi, mode: SearchMode,
                       spool=None) -> None:
    """claim N+1 || process N || submit N-1, until interrupted or a claim
    fails."""
    pending_submit = None  # (future, checkpointer, submission)
    data, resume, ckptr = _resume_or_claim(args, api, mode)
    while True:
        if spool is not None:
            # Loop-boundary replay: a no-op when empty, and the natural
            # moment to drain journaled submissions once the server is back.
            spool.replay(args.api_base)
        next_claim = api.claim_async(mode)  # overlap with processing
        with _maybe_renewer(args, data.claim_id):
            results, _ = process_field(data, args, checkpointer=ckptr,
                                       resume=resume)
        if pending_submit is not None:
            # Settle the previous submit before queueing the next one; only
            # an owned submit (confirmed or spooled) retires its snapshot.
            prev_future, prev_ckptr, prev_sub = pending_submit
            _await_submit(prev_future, prev_sub, spool)
            if prev_ckptr is not None:
                prev_ckptr.delete()
        submission = compile_results(data, results, mode, args.username)
        pending_submit = (api.submit_async(submission), ckptr, submission)
        data = next_claim.result()
        resume = None
        ckptr = _new_checkpointer(args, data, mode)
        log.info("claimed field (claim %d): base %d, size %s",
                 data.claim_id, data.base, f"{data.range_size:,}")


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=_LOG_LEVELS[args.log_level],
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    if args.benchmark:
        return run_benchmark(args)
    if args.checkpoint_dir and args.backend == "scalar":
        # The oracle scans in one call and has no cursor to snapshot.
        log.warning("--checkpoint-dir is not supported with backend "
                    "'scalar'; checkpointing disabled")
        args.checkpoint_dir = None
    mode = _mode(args)
    api = api_client.AsyncApi(args.api_base, args.username, args.max_retries)
    spool = spool_mod.maybe_spool(args.spool_dir, args.checkpoint_dir)
    try:
        if spool is not None:
            # Startup replay: deliver anything journaled by a previous run
            # before claiming new work.
            spool.replay(args.api_base)
        if args.repeat:
            run_pipelined_loop(args, api, mode, spool=spool)
        else:
            run_single_iteration(args, api, mode, spool=spool)
    except KeyboardInterrupt:
        log.info("interrupted; shutting down")
    finally:
        api.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
