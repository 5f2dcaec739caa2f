"""Client-side fleet telemetry snapshot (the port's copy of
nice_tpu/obs/telemetry.py, in its /telemetry wire format, SNAPSHOT_VERSION
1).

``snapshot()`` condenses this process's metrics registry into the compact,
JSON-safe dict the coordination server aggregates: throughput, backend,
downgrades (none: the port has no downgrade chain), checkpoint restores,
injected faults and spool depth, plus a per-call rate sample (numbers/sec
since the previous snapshot). It reads the same counters the local /metrics
endpoint renders.

Two transports carry it (client/api_client.py): piggybacked on every
submission under ``DataToServer.telemetry``, and the ``POST /telemetry``
heartbeat (client --telemetry-secs). ``client_id`` is stable for the life of
the process: <username>@<host>/<pid>, the username the client's --username
(the reference falls back on the USER variable; the port reads none).
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

from nice_tpu_torch.utils import lockdep

from . import journal, memwatch, pyprof, series, stepprof

__all__ = ["snapshot", "client_id", "SNAPSHOT_VERSION", "reset"]

SNAPSHOT_VERSION = 1

_lock = lockdep.make_lock("obs.telemetry._lock")
_prev_numbers = 0.0
_prev_time: Optional[float] = None


def client_id(username: str = "") -> str:
    """Process-stable fleet identity: user@host/pid."""
    host = socket.gethostname() or "unknown-host"
    return f"{username or 'anonymous'}@{host}/{os.getpid()}"


def _sum(counter) -> float:
    return sum(counter.values().values())


def reset() -> None:
    """Forget the previous rate sample (tests)."""
    global _prev_numbers, _prev_time
    with _lock:
        _prev_numbers = 0.0
        _prev_time = None


def snapshot(
    username: str = "",
    backend: str = "",
    spool_depth: int = 0,
    client_version: str = "",
) -> dict:
    """Current registry condensed to the /telemetry wire format."""
    global _prev_numbers, _prev_time
    now = time.time()
    numbers = _sum(series.CLIENT_NUMBERS)
    with _lock:
        if _prev_time is None or now <= _prev_time:
            rate = 0.0
        else:
            rate = max(0.0, (numbers - _prev_numbers) / (now - _prev_time))
        _prev_numbers = numbers
        _prev_time = now
    fields = {
        mode: int(v)
        for (mode,), v in series.CLIENT_FIELDS.values().items()
        if v
    }
    downgrades = {
        f"{frm}->{to}": int(v)
        for (frm, to), v in series.ENGINE_BACKEND_DOWNGRADES.values().items()
        if v
    }
    idle = series.MESH_FEED_IDLE.label_sums()
    mesh = {
        "devices": int(series.MESH_DEVICES.value()),
        "reshards": int(_sum(series.MESH_RESHARDS)),
        "feed_idle_sum": round(sum(s for s, _ in idle.values()), 6),
        "feed_idle_count": int(sum(c for _, c in idle.values())),
    }
    # The device-step profiler's cumulative per-(mode|base|backend) table,
    # empty — and omitted from the wire — when the profiler never ran.
    phase_breakdown = {
        key: {k: round(v, 6) if isinstance(v, float) else v
              for k, v in entry.items()}
        for key, entry in stepprof.cumulative().items()
    }
    out = {
        "v": SNAPSHOT_VERSION,
        "client_id": client_id(username),
        "username": username,
        "client_version": client_version,
        "backend": backend,
        "ts": now,
        "numbers": int(numbers),
        "numbers_per_sec": round(rate, 3),
        "fields": fields,
        "downgrades": downgrades,
        "downgrades_total": int(_sum(series.ENGINE_BACKEND_DOWNGRADES)),
        "restores": int(series.CKPT_RESTORES.value()),
        "faults": int(_sum(series.FAULTS_INJECTED)),
        "spool_depth": int(spool_depth),
        "mesh": mesh,
    }
    if phase_breakdown:
        out["phase_breakdown"] = phase_breakdown
    # The latest memwatch sample and the profiler's per-root sample totals
    # and top-K folded stacks, each omitted while its sampler is off.
    mem = memwatch.summary()
    if mem:
        out["mem"] = mem
    if pyprof.sample_count() > 0:
        prof = pyprof.snapshot(top_k=0)
        out["pyprof"] = {
            "samples": prof["samples"],
            "roots": {
                root: entry["samples"]
                for root, entry in prof["roots"].items()
            },
            "top": pyprof.top_stacks(),
        }
    # Client-side journal events (omitted when there are none).
    events = journal.drain_client_events()
    if events:
        out["events"] = events
    return out
