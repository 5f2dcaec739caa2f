"""Crash flight recorder: a bounded in-process ring of recent structured
events, dumped atomically to disk when something goes wrong (the port's copy
of nice_tpu/obs/flight.py; the dump directory and the ring's capacity are
arguments of configure(), the client's --flight-dir and --flight-events).

Metrics say how often things happen; the flight recorder says what the last
N of them were. The client records claims, HTTP retries and failovers,
injected faults, checkpoint writes and restores, and spool journal and
quarantine transitions: one deque append under a lock.

Dump triggers:
  * crash: ``install()`` chains onto ``sys.excepthook``;
  * SIGUSR2: operator-triggered dump of a live process;
  * spool quarantine (faults/spool.py calls ``dump(reason="quarantine")``);
  * ``GET /debug/flight`` on the local metrics server reads the live ring
    without dumping.

Dumps are atomic JSON files under the configured directory (default: the
system temp dir), named ``nice-flight-<pid>-<reason>.json``; a repeated
trigger with the same reason overwrites.
"""

from __future__ import annotations

import collections
import logging
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Optional

from nice_tpu_torch.utils import fsio

from .series import FLIGHT_DUMPS, FLIGHT_EVENTS

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = ["FlightRecorder", "configure", "record", "snapshot", "dump",
           "install", "reset"]

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Thread-safe bounded ring of {seq, ts, kind, **fields} events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 out_dir: Optional[str] = None):
        self.capacity = capacity
        self.out_dir = out_dir
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        rec = {"seq": 0, "ts": time.time(), "kind": kind}
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._events.append(rec)
        FLIGHT_EVENTS.labels(kind).inc()

    def snapshot(self) -> list[dict]:
        """Copy of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> Optional[str]:
        """Atomically write the ring to disk; returns the path (None when the
        write failed — dumping must never take the process down with it)."""
        events = self.snapshot()
        if path is None:
            out_dir = self.out_dir or tempfile.gettempdir()
            try:
                os.makedirs(out_dir, exist_ok=True)
            except OSError:
                return None
            path = os.path.join(
                out_dir, f"nice-flight-{os.getpid()}-{reason}.json"
            )
        payload = {
            "dumped_at": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "argv": sys.argv,
            "total_recorded": self.total_recorded(),
            "capacity": self.capacity,
            "events": events,
        }
        try:
            fsio.atomic_write_json(path, payload, default=repr)
        except OSError as exc:
            log.warning("flight-recorder dump to %s failed: %s", path, exc)
            return None
        FLIGHT_DUMPS.labels(reason).inc()
        log.info("flight recorder dumped %d events to %s (reason=%s)",
                 len(events), path, reason)
        return path


RECORDER = FlightRecorder()


def configure(out_dir: Optional[str] = None,
              capacity: int = DEFAULT_CAPACITY) -> None:
    """A fresh ring of `capacity` events (at least 16) dumping into
    `out_dir` (the system temp dir when None)."""
    global RECORDER
    RECORDER = FlightRecorder(max(16, int(capacity)), out_dir)


def reset() -> None:
    """An empty ring of the default capacity (tests)."""
    configure()


def record(kind: str, **fields) -> None:
    RECORDER.record(kind, **fields)


def snapshot() -> list[dict]:
    return RECORDER.snapshot()


def dump(reason: str = "manual", path: Optional[str] = None) -> Optional[str]:
    return RECORDER.dump(reason, path)


_installed = False
_install_lock = threading.Lock()


def install() -> None:
    """Arm the crash/SIGUSR2 dump triggers (idempotent).

    Chains the previous sys.excepthook; the SIGUSR2 handler is only
    installed from the main thread on platforms that have the signal, and
    never clobbers a non-default handler someone else installed."""
    global _installed
    with _install_lock:
        if _installed:
            return
        _installed = True

    prev_hook = sys.excepthook

    def _crash_hook(exc_type, exc, tb):
        record("crash", error=repr(exc), type=exc_type.__name__)
        dump(reason="crash")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _crash_hook

    if (
        hasattr(signal, "SIGUSR2")
        and threading.current_thread() is threading.main_thread()
    ):
        try:
            existing = signal.getsignal(signal.SIGUSR2)
            if existing in (signal.SIG_DFL, signal.SIG_IGN, None):
                signal.signal(
                    signal.SIGUSR2,
                    lambda signum, frame: dump(reason="sigusr2"),
                )
        except (OSError, ValueError):
            pass  # e.g. restricted environments; crash hook still armed
