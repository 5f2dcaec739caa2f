"""On-disk submission spool: graceful degradation for the submit path (the
port's copy of nice_tpu/faults/spool.py, with its metrics, journal events
and flight-recorder records; its retention bounds are arguments).

When a submit exhausts its HTTP retries (server down for longer than the
backoff budget), the client journals the full DataToServer payload here —
one JSON file per submission, written atomically — and moves on. At the
next loop iteration or startup, replay() re-sends every spooled entry
through the port's api_client:

  * accepted (or {"duplicate": true} — the original request had landed
    after all): the entry is deleted; exactly-once is the server's job via
    submit_id, the spool just has to keep trying;
  * definitively rejected (4xx, e.g. the claim lease expired and the field
    was re-issued): the entry is renamed to <name>.rejected and kept for
    post-mortem — replaying it again can never succeed;
  * still unreachable: the entry stays for the next replay.

Entries are keyed by submit_id, so re-journaling the same submission (crash
between journal and replay) overwrites rather than duplicates.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Optional

from nice_tpu_torch.client import api_client
from nice_tpu_torch.core.types import DataToServer
from nice_tpu_torch.obs import flight, journal
from nice_tpu_torch.obs.series import (
    SPOOL_JOURNALED,
    SPOOL_QUARANTINE_PRUNED,
    SPOOL_REPLAYS,
)
from nice_tpu_torch.utils import fsio

log = logging.getLogger(__name__)

_SUFFIX = ".json"
_UNSAFE = re.compile(r"[^A-Za-z0-9._-]")

# Retention of quarantined (.rejected) entries: the reference's defaults.
QUARANTINE_MAX_BYTES = 64 * 1024 * 1024
QUARANTINE_MAX_AGE_SECS = 7 * 24 * 3600.0


class SubmissionSpool:
    """A directory of journaled submissions awaiting delivery."""

    def __init__(self, dir_path: str,
                 quarantine_max_bytes: int = QUARANTINE_MAX_BYTES,
                 quarantine_max_age_secs: float = QUARANTINE_MAX_AGE_SECS):
        self.dir = dir_path
        self.quarantine_max_bytes = quarantine_max_bytes
        self.quarantine_max_age_secs = quarantine_max_age_secs
        os.makedirs(dir_path, exist_ok=True)

    def _path_for(self, data: DataToServer) -> str:
        key = data.submit_id or f"claim-{data.claim_id}"
        return os.path.join(self.dir, _UNSAFE.sub("_", key) + _SUFFIX)

    def add(self, data: DataToServer) -> str:
        """Atomically journal a submission; returns the entry path."""
        path = self._path_for(data)
        fsio.atomic_write_json(path, data.to_json(), sort_keys=True)
        SPOOL_JOURNALED.inc()
        flight.record("spool", claim=data.claim_id, path=path)
        log.warning(
            "journaled undeliverable submission for claim %d to %s "
            "(will replay)", data.claim_id, path,
        )
        return path

    def pending(self) -> list[str]:
        """Journaled entry paths, oldest first (stable mtime-then-name)."""
        try:
            names = [
                n for n in os.listdir(self.dir) if n.endswith(_SUFFIX)
            ]
        except FileNotFoundError:
            return []
        paths = [os.path.join(self.dir, n) for n in names]
        return sorted(paths, key=lambda p: (os.path.getmtime(p), p))

    def replay(
        self, api_base: str, max_retries: int = 2
    ) -> dict[str, int]:
        """Attempt delivery of every pending entry; returns outcome counts
        {"delivered": n, "rejected": n, "deferred": n}.

        max_retries is deliberately small: the spool is itself the retry
        mechanism, so each replay pass should fail fast and yield to the
        caller's main loop rather than sit in a deep backoff."""
        counts = {"delivered": 0, "rejected": 0, "deferred": 0}
        # Age-based quarantine retention keeps sweeping even when nothing
        # new gets rejected.
        self.prune_quarantine()
        for path in self.pending():
            outcome = self._replay_one(path, api_base, max_retries)
            counts[outcome] += 1
            SPOOL_REPLAYS.labels(outcome).inc()
        if sum(counts.values()):
            log.info(
                "spool replay: %d delivered, %d rejected, %d deferred",
                counts["delivered"], counts["rejected"], counts["deferred"],
            )
        return counts

    def _replay_one(
        self, path: str, api_base: str, max_retries: int
    ) -> str:
        t0 = time.monotonic()
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = DataToServer.from_json(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            log.error("unreadable spool entry %s: %s", path, e)
            self._quarantine(path)
            return "rejected"
        try:
            resp = api_client.submit_field_to_server(
                api_base, data, max_retries=max_retries
            )
        except api_client.ApiError as e:
            if e.status is not None and 400 <= e.status < 500:
                log.error(
                    "spooled submission for claim %d rejected by the server "
                    "(%s); keeping %s.rejected for post-mortem",
                    data.claim_id, e, path,
                )
                self._quarantine(path)
                journal.record_client_event(
                    "spool_replay", claim_id=data.claim_id,
                    outcome="rejected", status=e.status,
                    secs=round(time.monotonic() - t0, 6),
                )
                return "rejected"
            log.warning(
                "spooled submission for claim %d still undeliverable (%s); "
                "will retry next replay", data.claim_id, e,
            )
            return "deferred"
        log.info(
            "delivered spooled submission for claim %d%s", data.claim_id,
            " (duplicate: the original had landed)"
            if resp.get("duplicate") else "",
        )
        self._remove(path)
        # secs is the replay round trip only; the time the submission sat
        # spooled on disk shows in the journal as the gap before the event.
        journal.record_client_event(
            "spool_replay", claim_id=data.claim_id, outcome="delivered",
            duplicate=bool(resp.get("duplicate")),
            secs=round(time.monotonic() - t0, 6),
        )
        return "delivered"

    @staticmethod
    def _remove(path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def _quarantine(self, path: str) -> None:
        try:
            os.replace(path, path + ".rejected")
        except OSError:
            pass
        # A definitively rejected submission is when the preceding event
        # history matters: dump the flight ring next to the wreckage.
        flight.record("quarantine", path=path + ".rejected")
        flight.dump(reason="quarantine")
        self.prune_quarantine()

    def prune_quarantine(self) -> dict:
        """Retention sweep over quarantined (.rejected) entries, which
        would otherwise accumulate forever: delete entries older than
        quarantine_max_age_secs, then oldest-first until the survivors fit
        quarantine_max_bytes (either bound at 0 disables it). Returns
        {"entries": n, "bytes": n} pruned."""
        max_bytes = int(self.quarantine_max_bytes or 0)
        max_age = float(self.quarantine_max_age_secs or 0.0)
        if max_bytes <= 0 and max_age <= 0:
            return {"entries": 0, "bytes": 0}
        try:
            names = [
                n for n in os.listdir(self.dir) if n.endswith(".rejected")
            ]
        except OSError:
            return {"entries": 0, "bytes": 0}
        entries = []  # (mtime, path, size), oldest first
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                st = os.lstat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, path, st.st_size))
        entries.sort()
        now = time.time()
        doomed = []
        kept = []
        for mtime, path, size in entries:
            if max_age > 0 and now - mtime > max_age:
                doomed.append((path, size))
            else:
                kept.append((path, size))
        if max_bytes > 0:
            total = sum(size for _p, size in kept)
            while kept and total > max_bytes:
                path, size = kept.pop(0)  # oldest survivor goes first
                doomed.append((path, size))
                total -= size
        pruned_entries = 0
        pruned_bytes = 0
        for path, size in doomed:
            try:
                os.remove(path)
            except OSError:
                continue
            pruned_entries += 1
            pruned_bytes += size
        if pruned_entries:
            SPOOL_QUARANTINE_PRUNED.inc(pruned_bytes)
            flight.record(
                "quarantine_pruned", dir=self.dir,
                entries=pruned_entries, bytes=pruned_bytes,
            )
            log.info(
                "pruned %d quarantined spool entries (%d bytes) under the"
                " retention bounds", pruned_entries, pruned_bytes,
            )
        return {"entries": pruned_entries, "bytes": pruned_bytes}


def maybe_spool(
    spool_dir: Optional[str], checkpoint_dir: Optional[str] = None
) -> Optional[SubmissionSpool]:
    """Spool for the client: an explicit dir wins; otherwise co-locate with
    the checkpoint dir (both are 'survive a crash' state); no dir, no spool."""
    if spool_dir:
        return SubmissionSpool(spool_dir)
    if checkpoint_dir:
        return SubmissionSpool(os.path.join(checkpoint_dir, "spool"))
    return None
