"""Portable whole-machine CPU sampling for the daemon (the port's cut of
nice_tpu/utils/resources.py: its CPU half, unchanged).

/proc/stat jiffy deltas where available (Linux, no deps), then
``psutil.cpu_percent`` if psutil is importable (macOS/Windows), then a
1-minute loadavg estimate (any POSIX), then a constant-idle stub.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

__all__ = ["read_cpu_times", "pick_cpu_backend", "CpuMonitor"]


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
