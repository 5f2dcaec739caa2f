"""Device-step profiler: phase-attributed wall time per engine field (the
port's copy of nice_tpu/obs/stepprof.py, its fence on CUDA events; it is
turned on by configure(enabled=True), the client's --stepprof).

Buckets each field's wall time into
``{compile, h2d_feed, device_compute, fold, readback, host_other}``.

1. **Nothing on the hot path when off.** Off (the default) means no fence,
   no torch.cuda.Event and no timestamp beyond what the engine already
   takes; each hook is guarded by one attribute check (``prof.enabled``).
   ``fence_count()`` proves it: it stays 0 for a run with the profiler off.
2. **Fences only at existing boundaries.** With the profiler on, the one new
   sync is a fence after each dispatch (one megaloop segment or dense run):
   ``fence(x)`` records a torch.cuda.Event on the current stream and
   synchronizes on it, so the host waits for the kernel, as the reference's
   ``block_until_ready``, and the wait is added to ``device_compute``. The
   fence serializes the pipeline; that is what makes the buckets partition
   the wall time (``host_other = wall - the rest >= 0``). ``fold`` and
   ``readback`` are timed around the collector's existing transfers.
3. **Cross-thread attribution.** The dispatcher and the collector run in
   different threads; ``add()`` is lock-guarded. ``compile`` takes the
   seconds of a build of the port's libraries (ops/cuda_build.py) made on a
   thread bound to the profiler (``note_compile``): the field's caller and
   its collector. A prefetch thread's warm is not the running field's.

Per-(mode, base, backend) phase totals go to the
``nice_stepprof_phase_seconds`` histogram on ``finish()``, to
``LAST_BREAKDOWN`` (the most recent field) and to the cumulative table that
obs/telemetry.py puts on the wire and the bench diffs per case.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = [
    "PHASES",
    "StepProfiler",
    "configure",
    "enabled",
    "fence_count",
    "note_compile",
    "cumulative",
    "finished",
    "reset",
    "LAST_BREAKDOWN",
]

PHASES = (
    "compile",        # builds of the port's libraries (cuda_build)
    "h2d_feed",       # waiting on the host->device feed (_SliceFeed.get)
    "device_compute", # dispatch enqueue + on-device execution (fenced)
    "fold",           # device->host accumulator folds (stats transfers)
    "readback",       # near-miss / count readbacks + survivor extraction
    "host_other",     # wall - sum(above): host loop, slicing, bookkeeping
)

_state_lock = threading.Lock()
_enabled = False
_fence_count = 0
_finished = 0
_cumulative: Dict[str, Dict[str, float]] = {}
LAST_BREAKDOWN: Dict[str, object] = {}

_tls = threading.local()


def configure(enabled: bool = False) -> None:
    """Turn the profiler on or off for the fields that start from now."""
    global _enabled
    _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


def fence_count() -> int:
    """Total profiler-inserted device fences this process. Stays 0 whenever
    the profiler is disabled — the no-extra-syncs guarantee, testable."""
    return _fence_count


def finished() -> int:
    """Profiled fields finished this process: a caller that reads it before
    and after a field knows whether LAST_BREAKDOWN is that field's."""
    return _finished


def reset() -> None:
    """Turn the profiler off and clear its cumulative state (tests, bench
    A/B runs)."""
    global _fence_count, _enabled, _finished
    with _state_lock:
        _enabled = False
        _fence_count = 0
        _finished = 0
        _cumulative.clear()
        LAST_BREAKDOWN.clear()


def cumulative() -> Dict[str, Dict[str, float]]:
    """Copy of {"mode|b<base>|backend": {phase: secs, "wall": secs,
    "fields": n}} accumulated since process start (or reset())."""
    with _state_lock:
        return {k: dict(v) for k, v in _cumulative.items()}


def _current() -> Optional["StepProfiler"]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def note_compile(secs: float) -> None:
    """Called by cuda_build around a build: attribute its seconds to the
    profiler bound to this thread, if any."""
    prof = _current()
    if prof is not None and prof.enabled:
        prof.add("compile", secs)


class StepProfiler:
    """Per-field phase accumulator. Construct one per engine field pass;
    engine hot loops guard every hook with ``if prof.enabled`` so the
    disabled path costs one attribute load."""

    __slots__ = ("mode", "base", "backend", "enabled", "_buckets", "_lock",
                 "_t_start", "_finished")

    def __init__(self, mode: str, base: int, backend: str,
                 enabled_override: Optional[bool] = None):
        self.mode = mode
        self.base = int(base)
        self.backend = backend
        self.enabled = enabled() if enabled_override is None else bool(
            enabled_override
        )
        self._buckets = {p: 0.0 for p in PHASES} if self.enabled else None
        self._lock = threading.Lock() if self.enabled else None
        self._t_start = time.perf_counter() if self.enabled else 0.0
        self._finished = False

    # -- hooks -------------------------------------------------------------

    def add(self, phase: str, secs: float) -> None:
        if not self.enabled or secs <= 0:
            return
        with self._lock:
            self._buckets[phase] += secs

    def fence(self, x) -> None:
        """Wait for the device work that produced tensor x, counted, ONLY
        when profiling: a torch.cuda.Event recorded on the current stream
        and synchronized on for a CUDA tensor; nothing to wait for on the
        CPU, where torch's ops run synchronously. None returns at once."""
        global _fence_count
        if not self.enabled or x is None:
            return
        t0 = time.perf_counter()
        if x.device.type == "cuda":
            import torch

            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(x.device))
            ev.synchronize()
        with _state_lock:
            _fence_count += 1
        self.add("device_compute", time.perf_counter() - t0)

    def bind(self) -> None:
        """Make this the profiler of the calling thread (for note_compile)."""
        if self.enabled:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            stack.append(self)

    def unbind(self) -> None:
        if self.enabled:
            stack = getattr(_tls, "stack", None)
            if stack and stack[-1] is self:
                stack.pop()

    def __enter__(self) -> "StepProfiler":
        self.bind()
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self.unbind()
            self.finish()

    def start(self) -> "StepProfiler":
        """``__enter__`` alias for flows with multiple exit points (the
        engine loops); pair with ``stop()`` before every return/raise."""
        return self.__enter__()

    def stop(self) -> None:
        """``__exit__`` alias: pop the thread-local stack and finish()."""
        self.__exit__(None, None, None)

    # -- reporting ---------------------------------------------------------

    def breakdown(self) -> Optional[Dict[str, float]]:
        if not self.enabled:
            return None
        with self._lock:
            return dict(self._buckets)

    def finish(self, wall_secs: Optional[float] = None) -> Optional[dict]:
        """Close the field: derive host_other = wall - sum(phases), emit the
        phase histogram series, and fold into the cumulative table."""
        global _finished
        if not self.enabled or self._finished:
            return None
        self._finished = True
        wall = (
            wall_secs if wall_secs is not None
            else time.perf_counter() - self._t_start
        )
        with self._lock:
            b = dict(self._buckets)
        accounted = sum(v for p, v in b.items() if p != "host_other")
        b["host_other"] = max(0.0, wall - accounted)
        from .series import STEPPROF_PHASE_SECONDS

        for phase, secs in b.items():
            if secs > 0:
                STEPPROF_PHASE_SECONDS.labels(
                    self.mode, str(self.base), self.backend, phase
                ).observe(secs)
        key = f"{self.mode}|b{self.base}|{self.backend}"
        entry = dict(b)
        entry["wall"] = wall
        with _state_lock:
            cum = _cumulative.setdefault(
                key, {p: 0.0 for p in PHASES} | {"wall": 0.0, "fields": 0}
            )
            for p in PHASES:
                cum[p] += b[p]
            cum["wall"] += wall
            cum["fields"] += 1
            _finished += 1
            LAST_BREAKDOWN.clear()
            LAST_BREAKDOWN.update(
                {"key": key, "mode": self.mode, "base": self.base,
                 "backend": self.backend, **entry}
            )
        return entry

