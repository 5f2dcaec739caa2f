"""Statistical wall-clock profiler with thread-root attribution (the port's
copy of nice_tpu/obs/pyprof.py; its rate, depth, table bound and top-K are
arguments of configure(), the client's --pyprof-hz, default 5).

A sampler thread walks ``sys._current_frames()`` hz times a second and
attributes every sampled stack to its owning **thread root**, the name the
port gives each long-lived thread (THREAD_ROOTS), so profiles come out
labelled ``engine-feed``, ``detailed-collect``, ``telemetry-report``, …
instead of ``Thread-7``. The main thread profiles as ``main``; a thread no
root names lands in ``unattributed``.

Aggregation is a bounded folded-stack table per root (frame labels are
``file:function`` — no line numbers, so loops don't explode the key
space); past ``max_stacks`` distinct stacks, new shapes collapse into the
per-root ``(other)`` bucket. ``GET /debug/profile?fmt=folded|json`` on the
local metrics port serves it, and the top-K stacks ride on every telemetry
snapshot.

hz = 0 means off: no sampler thread is created and ``sample_count()`` stays
0. The sampler makes no torch call and no ctypes call.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from .series import PYPROF_OVERFLOW, PYPROF_SAMPLES, PYPROF_STACKS

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = [
    "THREAD_ROOTS",
    "configure",
    "sample_count",
    "attribute",
    "take_sample",
    "maybe_start",
    "snapshot",
    "render_folded",
    "top_stacks",
    "handle_query",
    "reset",
]

DEFAULT_HZ = 5.0
DEFAULT_DEPTH = 24
DEFAULT_MAX_STACKS = 2000
DEFAULT_TOPK = 10

# The names of the port's long-lived threads (pools name their workers
# "<root>_<n>", hence the prefix match in attribute()).
THREAD_ROOTS = (
    "engine-feed", "detailed-collect", "dense-collect", "niceonly-collect",
    "niceonly-msd", "nice-native", "nice-api", "nice-prefetch",
    "claim-renew", "block-renew", "telemetry-report", "nice-history",
    "nice-memwatch", "nice-pyprof", "nice-metrics",
)

_lock = threading.Lock()
_tables: Dict[str, Dict[str, int]] = {}  # root -> folded stack -> samples
_root_samples: Dict[str, int] = {}
_total_samples = 0
_distinct_stacks = 0
_settings = {"hz": DEFAULT_HZ, "depth": DEFAULT_DEPTH,
             "max_stacks": DEFAULT_MAX_STACKS, "top_k": DEFAULT_TOPK}

_started_lock = threading.Lock()
_started = False

_OTHER = "(other)"
MAIN_ROOT = "main"
UNATTRIBUTED = "unattributed"

_ROOTS_LONGEST_FIRST = tuple(sorted(THREAD_ROOTS, key=len, reverse=True))


def configure(hz: float = DEFAULT_HZ, depth: int = DEFAULT_DEPTH,
              max_stacks: int = DEFAULT_MAX_STACKS,
              top_k: int = DEFAULT_TOPK) -> None:
    """The sampling rate (<= 0: off), the frames a folded stack keeps, the
    bound on distinct stacks, and the stacks a telemetry snapshot carries."""
    _settings.update(hz=float(hz), depth=max(1, int(depth)),
                     max_stacks=max(1, int(max_stacks)),
                     top_k=max(1, int(top_k)))


def hz() -> float:
    return _settings["hz"]


def sample_count() -> int:
    """Total stacks sampled this process. Stays 0 whenever the profiler is
    disabled — the zero-overhead-off guarantee, testable."""
    return _total_samples


def attribute(thread_name: str) -> Optional[str]:
    """Owning thread root for a runtime thread name; "main" for the main
    thread; None for a thread no root names."""
    if thread_name == "MainThread":
        return MAIN_ROOT
    for name in _ROOTS_LONGEST_FIRST:
        if thread_name == name or thread_name.startswith(name):
            return name
    return None


def _fold(frame, depth: int) -> str:
    """Folded-stack key, outermost first: "file:func;file:func;...". No
    line numbers on purpose — a hot loop should be ONE key."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < depth:
        co = f.f_code
        parts.append(f"{os.path.basename(co.co_filename)}:{co.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def take_sample() -> int:
    """Walk every live thread's current frame once; returns stacks sampled.
    Called by the sampler thread, and directly by tests. The calling thread
    is never sampled."""
    global _total_samples, _distinct_stacks
    depth = _settings["depth"]
    max_stacks = _settings["max_stacks"]
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    sampled = 0
    overflowed = 0
    per_root: Dict[str, int] = {}
    frames = sys._current_frames()
    try:
        for ident, frame in frames.items():
            if ident == me:
                continue  # never profile the profiler
            root = attribute(names.get(ident, "")) or UNATTRIBUTED
            folded = _fold(frame, depth)
            with _lock:
                table = _tables.setdefault(root, {})
                if folded not in table and _distinct_stacks >= max_stacks:
                    table[_OTHER] = table.get(_OTHER, 0) + 1
                    overflowed += 1
                else:
                    if folded not in table:
                        _distinct_stacks += 1
                    table[folded] = table.get(folded, 0) + 1
                _root_samples[root] = _root_samples.get(root, 0) + 1
                _total_samples += 1
            per_root[root] = per_root.get(root, 0) + 1
            sampled += 1
    finally:
        del frames  # drop frame references promptly
    for root, n in per_root.items():
        PYPROF_SAMPLES.labels(root).inc(n)
    if overflowed:
        PYPROF_OVERFLOW.inc(overflowed)
    with _lock:
        PYPROF_STACKS.set(_distinct_stacks)
    return sampled


def maybe_start() -> bool:
    """Start the sampler thread once per process at the configured rate;
    hz <= 0 creates no thread at all."""
    global _started
    r = hz()
    if r <= 0:
        return False
    interval = 1.0 / r
    with _started_lock:
        if _started:
            return True
        _started = True

    def _run():
        while True:
            time.sleep(interval)
            try:
                take_sample()
            except Exception:  # noqa: BLE001 — keep sampling
                log.exception("pyprof sample failed")

    threading.Thread(target=_run, name="nice-pyprof", daemon=True).start()
    log.info("pyprof sampler started (%.1f Hz)", r)
    return True


# --- reporting ------------------------------------------------------------


def snapshot(top_k: Optional[int] = None) -> dict:
    """JSON-shaped profile: per-root sample totals + the hottest stacks
    (all stacks when top_k is None)."""
    with _lock:
        tables = {root: dict(t) for root, t in _tables.items()}
        root_samples = dict(_root_samples)
        total = _total_samples
    roots = {}
    for root, table in sorted(tables.items()):
        stacks = sorted(table.items(), key=lambda kv: (-kv[1], kv[0]))
        if top_k is not None:
            stacks = stacks[:top_k]
        roots[root] = {
            "samples": root_samples.get(root, 0),
            "stacks": [{"stack": s, "count": c} for s, c in stacks],
        }
    return {"hz": hz(), "samples": total, "roots": roots}


def render_folded() -> str:
    """flamegraph.pl-compatible folded stacks, the root name as the base
    frame: "root;file:func;file:func count"."""
    with _lock:
        tables = {root: dict(t) for root, t in _tables.items()}
    lines = []
    for root in sorted(tables):
        for stack, count in sorted(tables[root].items()):
            lines.append(f"{root};{stack} {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def top_stacks(k: Optional[int] = None) -> List[dict]:
    """The k hottest stacks fleet-rollup style: [{root, stack, count}],
    hottest first (k: the configured top_k when None)."""
    if k is None:
        k = _settings["top_k"]
    with _lock:
        flat = [
            {"root": root, "stack": stack, "count": count}
            for root, table in _tables.items()
            for stack, count in table.items()
        ]
    flat.sort(key=lambda e: (-e["count"], e["root"], e["stack"]))
    return flat[:k]


def handle_query(query: str) -> Tuple[int, bytes, str]:
    """GET /debug/profile on the local metrics endpoint: (status, body,
    content-type). fmt=folded|json."""
    fmt = (parse_qs(query or "").get("fmt") or ["json"])[0]
    if fmt == "folded":
        return 200, render_folded().encode("utf-8"), "text/plain"
    if fmt == "json":
        body = json.dumps(snapshot(top_k=50)).encode("utf-8")
        return 200, body, "application/json"
    body = json.dumps(
        {"error": f"unknown fmt {fmt!r}", "known": ["folded", "json"]}
    ).encode("utf-8")
    return 400, body, "application/json"


def reset() -> None:
    """Clear aggregated samples and restore the default settings (NOT the
    started-thread guard)."""
    global _total_samples, _distinct_stacks
    with _lock:
        _tables.clear()
        _root_samples.clear()
        _total_samples = 0
        _distinct_stacks = 0
    configure()
