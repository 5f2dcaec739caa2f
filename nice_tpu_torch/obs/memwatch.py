"""Resource watch: device memory, host RSS, and on-disk footprints (the port's
cut of nice_tpu/obs/memwatch.py: its sampler, watched paths and summary;
the leak-trend and exhaustion forecasts stay with the server's anomaly
engine, which reads the series this module feeds).

A sample reads

* **device memory**, from torch.cuda, per device: ``in_use`` and ``peak``
  from ``torch.cuda.memory_stats(i)`` (``allocated_bytes.all.current`` and
  ``.peak``), ``limit`` the total of ``torch.cuda.mem_get_info(i)``, and the
  reference's ``live_arrays`` / ``live_array_bytes`` keys from the caching
  allocator's ``active.all.current`` / ``active_bytes.all.current``, summed
  over devices, so the server's fleet view reads them unchanged. Strictly
  opportunistic, as the reference: a sample never creates a CUDA context,
  so before torch has initialized CUDA in this process it reports no
  device;
* **host RSS** — utils/resources.py (/proc -> psutil -> rusage peak);
* **disk** — recursive footprints of every path registered with
  :func:`watch_path` (spool, quarantined spool entries, checkpoint dir,
  trace sink) and the free bytes of the filesystem holding them.

Samples land in the ``nice_mem_*`` / ``nice_disk_*`` series. The client
and the daemon run a "nice-memwatch" thread (:func:`maybe_start_sampler`,
--memwatch-secs, default 30; 0 = off: no thread, and
``nice_mem_samples_total`` stays 0). A sample makes one memory_stats and
one mem_get_info call a device, and no other torch call.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, Optional

from nice_tpu_torch.utils import resources

from .series import (
    DISK_FREE_BYTES,
    DISK_USAGE_BYTES,
    MEM_DEVICE_BYTES,
    MEM_DEVICE_LIMIT_BYTES,
    MEM_DEVICE_PEAK_BYTES,
    MEM_LIVE_ARRAY_BYTES,
    MEM_LIVE_ARRAYS,
    MEM_RSS_BYTES,
    MEM_RSS_PEAK_BYTES,
    MEM_SAMPLES,
)

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = [
    "DEFAULT_INTERVAL_SECS",
    "watch_path",
    "watched",
    "device_memory",
    "sample",
    "summary",
    "maybe_start_sampler",
    "reset",
]

DEFAULT_INTERVAL_SECS = 30.0

_lock = threading.Lock()
_watched: Dict[str, str] = {}
_last_summary: Dict[str, object] = {}

_sampler_lock = threading.Lock()
_sampler_started = False


def watch_path(what: str, path: Optional[str]) -> None:
    """Register a directory/file under a stable label ("spool", "ckpt",
    "trace", ...). None/empty paths are ignored so call sites can pass
    their maybe-configured dirs unconditionally."""
    if not path:
        return
    with _lock:
        _watched[what] = path


def watched() -> Dict[str, str]:
    with _lock:
        return dict(_watched)


# --- one sample -----------------------------------------------------------


def device_memory() -> dict:
    """Device-memory view of every CUDA device, or nothing before torch has
    initialized CUDA in this process (a sample never creates a context)."""
    out: dict = {"devices": {}, "live_arrays": None, "live_array_bytes": None}
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out
    live = live_bytes = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out["devices"][str(i)] = {
            "in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak": int(stats.get("allocated_bytes.all.peak", 0)),
            "limit": int(total),
        }
        live += int(stats.get("active.all.current", 0))
        live_bytes += int(stats.get("active_bytes.all.current", 0))
    out["live_arrays"] = live
    out["live_array_bytes"] = live_bytes
    return out


def _quarantine_bytes(spool_dir: str) -> Optional[int]:
    """Footprint of .rejected entries inside the spool dir (they are
    excluded from the spool's own pending() listing, so they get their own
    watermark)."""
    try:
        names = os.listdir(spool_dir)
    except OSError:
        return None
    total = 0
    for n in names:
        if not n.endswith(".rejected"):
            continue
        try:
            total += os.lstat(os.path.join(spool_dir, n)).st_size
        except OSError:
            continue
    return total


def sample() -> dict:
    """Take one resource sample: refresh every nice_mem_* / nice_disk_*
    gauge and return (and retain, see summary()) a compact dict."""
    now = time.time()
    out: dict = {"ts": now}

    rss = resources.rss_bytes()
    if rss is not None:
        MEM_RSS_BYTES.set(rss)
        out["rss_bytes"] = rss
    peak = resources.peak_rss_bytes()
    if peak is not None:
        MEM_RSS_PEAK_BYTES.set(peak)
        out["rss_peak_bytes"] = peak

    dev = device_memory()
    if dev["live_arrays"] is not None:
        MEM_LIVE_ARRAYS.set(dev["live_arrays"])
        MEM_LIVE_ARRAY_BYTES.set(dev["live_array_bytes"])
        out["live_arrays"] = dev["live_arrays"]
        out["live_array_bytes"] = dev["live_array_bytes"]
    if dev["devices"]:
        out["devices"] = dev["devices"]
        for dev_id, entry in dev["devices"].items():
            MEM_DEVICE_BYTES.labels(dev_id).set(entry["in_use"])
            MEM_DEVICE_PEAK_BYTES.labels(dev_id).set(entry["peak"])
            MEM_DEVICE_LIMIT_BYTES.labels(dev_id).set(entry["limit"])

    disk: Dict[str, int] = {}
    free: Optional[int] = None
    for what, path in sorted(watched().items()):
        nbytes = resources.dir_bytes(path)
        if nbytes is not None:
            DISK_USAGE_BYTES.labels(what).set(nbytes)
            disk[what] = nbytes
        if what == "spool":
            q = _quarantine_bytes(path)
            if q is not None:
                DISK_USAGE_BYTES.labels("quarantine").set(q)
                disk["quarantine"] = q
        if free is None:
            free = resources.fs_free_bytes(path)
    if disk:
        out["disk_bytes"] = disk
    if free is not None:
        DISK_FREE_BYTES.set(free)
        out["disk_free_bytes"] = free

    MEM_SAMPLES.inc()
    with _lock:
        _last_summary.clear()
        _last_summary.update(out)
    return out


def summary() -> dict:
    """The most recent sample (empty before the first one) — telemetry
    piggybacks this."""
    with _lock:
        return dict(_last_summary)


def maybe_start_sampler(interval: float = DEFAULT_INTERVAL_SECS) -> bool:
    """Start the background sampling thread once per process (client and
    daemon). Returns True when the sampler is running. interval <= 0 means
    off: no thread is created at all."""
    global _sampler_started
    if not interval or interval <= 0:
        return False
    with _sampler_lock:
        if _sampler_started:
            return True
        _sampler_started = True

    def _run():
        while True:
            time.sleep(interval)
            try:
                sample()
            except Exception:  # noqa: BLE001 — keep sampling
                log.exception("memwatch sample failed")

    threading.Thread(target=_run, name="nice-memwatch", daemon=True).start()
    log.info("memwatch sampler started (every %.1fs)", interval)
    return True


def reset() -> None:
    """Drop registered paths + the last summary (NOT the started-thread
    guard: threads are process-lifetime)."""
    with _lock:
        _watched.clear()
        _last_summary.clear()
