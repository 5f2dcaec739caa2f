"""Occupancy accounting for the multi-tenant scheduler (the port's copy of
OccupancyMeter from nice_tpu/parallel/mesh.py). The reference's mesh,
dispatch and elastic downshift are multi-device and not ported here."""

from __future__ import annotations

import threading


class OccupancyMeter:
    """Accumulates device-busy wall time against an observation window so
    the multi-tenant scheduler can report occupancy (busy/wall) per tenant
    and overall. Busy intervals are attributed by tenant label;
    thread-safe because the scheduler's page loop and its SLO periodic
    both read it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._busy: dict[str, float] = {}
        self._started: float | None = None
        self._stopped: float | None = None

    def start(self, now: float) -> None:
        with self._lock:
            if self._started is None:
                self._started = now
            self._stopped = None

    def stop(self, now: float) -> None:
        with self._lock:
            self._stopped = now

    def add_busy(self, tenant: str, secs: float) -> None:
        if secs <= 0:
            return
        with self._lock:
            self._busy[tenant] = self._busy.get(tenant, 0.0) + secs

    def busy_secs(self, tenant: str | None = None) -> float:
        with self._lock:
            if tenant is not None:
                return self._busy.get(tenant, 0.0)
            return sum(self._busy.values())

    def wall_secs(self, now: float | None = None) -> float:
        with self._lock:
            if self._started is None:
                return 0.0
            end = self._stopped if self._stopped is not None else now
            if end is None:
                return 0.0
            return max(0.0, end - self._started)

    def occupancy(self, now: float | None = None) -> float:
        """Overall busy/wall in [0, 1]; 0 before the window opens."""
        wall = self.wall_secs(now)
        if wall <= 0:
            return 0.0
        return min(1.0, self.busy_secs() / wall)

    def shares(self) -> dict[str, float]:
        """Each tenant's fraction of total busy time (sums to ~1)."""
        with self._lock:
            total = sum(self._busy.values())
            if total <= 0:
                return {t: 0.0 for t in self._busy}
            return {t: b / total for t, b in self._busy.items()}
