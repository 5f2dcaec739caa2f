"""Portable resource sampling (the port's cut of nice_tpu/utils/resources.py:
its CPU, host-memory and disk halves, unchanged).

CPU, for the daemon: /proc/stat jiffy deltas where available (Linux, no
deps), then ``psutil.cpu_percent`` if psutil is importable (macOS/Windows),
then a 1-minute loadavg estimate (any POSIX), then a constant-idle stub.

Host memory and disk, for obs/memwatch.py and the bench's memory axis:
this process's resident set (/proc -> psutil -> rusage peak), its lifetime
peak, and the footprint and free space of watched paths.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

__all__ = ["read_cpu_times", "pick_cpu_backend", "CpuMonitor",
           "pick_rss_backend", "rss_bytes", "peak_rss_bytes", "dir_bytes",
           "fs_free_bytes"]


def read_cpu_times() -> tuple[int, int]:
    """(idle, total) jiffies from /proc/stat (Linux backend)."""
    with open("/proc/stat") as f:
        parts = f.readline().split()
    values = [int(v) for v in parts[1:]]
    idle = values[3] + (values[4] if len(values) > 4 else 0)  # idle + iowait
    return idle, sum(values)


def pick_cpu_backend() -> str:
    """Best available whole-machine CPU sampler for this platform.

    Deliberately does NOT call read_cpu_times() (only stats the path) so
    tests can stub the reader with a finite sequence of readings.
    """
    if os.path.exists("/proc/stat"):
        return "proc"
    try:
        import psutil  # noqa: F401

        return "psutil"
    except ImportError:
        pass
    return "loadavg" if hasattr(os, "getloadavg") else "none"


class CpuMonitor:
    """Rolling CPU utilization sampler.

    backend: "proc" (jiffy deltas), "psutil" (cpu_percent), "loadavg"
    (1-min load / cores, clipped to 1.0), or "none" (always idle — the
    daemon degrades to an unconditional supervisor rather than refusing to
    run). Default: pick_cpu_backend(). ``reader`` replaces the "proc"
    reader (the daemon routes it through its own module global).
    """

    def __init__(self, interval_secs: float = 5.0, backend: str | None = None,
                 reader: Optional[Callable[[], tuple]] = None):
        self.interval = interval_secs
        self.backend = backend or pick_cpu_backend()
        self._reader = reader or read_cpu_times
        if self.backend == "proc":
            self._last = self._reader()
        elif self.backend == "psutil":
            import psutil

            self._psutil = psutil
            psutil.cpu_percent(interval=None)  # prime the rolling window

    def sample(self) -> float:
        """Blocking sample: CPU usage fraction over the interval."""
        time.sleep(self.interval)
        if self.backend == "proc":
            idle, total = self._reader()
            last_idle, last_total = self._last
            self._last = (idle, total)
            d_total = total - last_total
            if d_total <= 0:
                return 0.0
            return 1.0 - (idle - last_idle) / d_total
        if self.backend == "psutil":
            return self._psutil.cpu_percent(interval=None) / 100.0
        if self.backend == "loadavg":
            try:
                load1 = os.getloadavg()[0]
            except OSError:
                return 0.0
            return min(1.0, load1 / (os.cpu_count() or 1))
        return 0.0  # "none": report idle; spawning is the safe default


# --- memory ---------------------------------------------------------------


def pick_rss_backend() -> str:
    """Best available resident-set reader for this platform. Mirrors
    pick_cpu_backend: stat the proc path, never read it, so tests can stub
    the file contents independently of selection."""
    if os.path.exists("/proc/self/status"):
        return "proc"
    try:
        import psutil  # noqa: F401

        return "psutil"
    except ImportError:
        pass
    try:
        import resource  # noqa: F401

        return "rusage"
    except ImportError:
        return "none"


def _rusage_scale() -> int:
    # ru_maxrss is KiB on Linux, bytes on macOS.
    return 1 if sys.platform == "darwin" else 1024


def rss_bytes(backend: str | None = None) -> Optional[int]:
    """Current resident set size of THIS process in bytes, or None when no
    backend can answer. The "rusage" fallback reports the lifetime PEAK
    (the kernel keeps no current-RSS counter there) — still monotone
    evidence for leak trends, just conservative."""
    backend = backend or pick_rss_backend()
    if backend == "proc":
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024
        except (OSError, ValueError, IndexError):
            return None
        return None
    if backend == "psutil":
        try:
            import psutil

            return int(psutil.Process().memory_info().rss)
        except Exception:  # noqa: BLE001 — process table races
            return None
    if backend == "rusage":
        return peak_rss_bytes()
    return None


def peak_rss_bytes() -> Optional[int]:
    """Lifetime peak resident set of this process (getrusage; POSIX)."""
    try:
        import resource

        return int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            * _rusage_scale()
        )
    except Exception:  # noqa: BLE001 — non-POSIX
        return None


# --- disk -----------------------------------------------------------------


def dir_bytes(path: str) -> Optional[int]:
    """Recursive on-disk footprint of ``path`` in bytes (0 for an empty
    dir, the file's size for a plain file, None when the path is absent).
    Files that vanish mid-walk are skipped, not errors."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    if not os.path.isdir(path):
        return int(st.st_size)
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for name in filenames:
            try:
                total += os.lstat(os.path.join(dirpath, name)).st_size
            except OSError:
                continue
    return total


def fs_free_bytes(path: str) -> Optional[int]:
    """Free bytes (non-root-reserved) on the filesystem holding ``path``."""
    try:
        sv = os.statvfs(path)
    except (OSError, AttributeError):
        return None
    return int(sv.f_bavail) * int(sv.f_frsize)
