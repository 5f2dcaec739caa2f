"""Zero-dependency metrics registry rendering Prometheus text exposition (the
port's copy of nice_tpu/obs/metrics.py; it renders byte for byte what the
reference renders for the same updates).

The client's local metrics port and the engine's instrumentation share one
process-wide registry. Everything here is stdlib-only and thread-safe: an
HTTP thread may render while the client updates.

Metric names follow Prometheus conventions (`*_total` counters, `*_seconds`
histograms). Registration is idempotent get-or-create: calling
``counter("x", ...)`` twice returns the same object, so modules can declare
their series at import time without coordinating order. Declared metrics
render even with zero observations — a scrape of a fresh process shows every
series at 0.

Two additions against the reference: ``Histogram.observe_many`` takes one
lock for a list of values (the engine folds a field's per-segment times at
the field's end, not a lock a segment), and ``Registry.reset`` zeroes every
declared series in place (tests).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "render",
]

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)

LabelKey = Tuple[str, ...]


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: LabelKey, extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labelvalues: Sequence[str]) -> LabelKey:
        vals = tuple(str(v) for v in labelvalues)
        if len(vals) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {vals}"
            )
        return vals

    def render(self) -> Iterable[str]:  # pragma: no cover - overridden
        return ()

    def reset(self) -> None:  # pragma: no cover - overridden
        pass


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, labelnames)
        self._values: Dict[LabelKey, float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def labels(self, *labelvalues) -> "_BoundCounter":
        key = self._key(labelvalues)
        with self._lock:
            self._values.setdefault(key, 0.0)
        return _BoundCounter(self, key)

    def inc(self, amount: float = 1.0, labelvalues: LabelKey = ()) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labelvalues)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labelvalues: LabelKey = ()) -> float:
        key = self._key(labelvalues)
        with self._lock:
            return self._values.get(key, 0.0)

    def values(self) -> Dict[LabelKey, float]:
        """Snapshot of every label combination's value (telemetry reads the
        registry instead of keeping a second set of books)."""
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            for key in self._values:
                self._values[key] = 0.0

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items:
            yield f"{self.name}{_label_str(self.labelnames, key)} {_fmt_value(val)}"


class _BoundCounter:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Counter, key: LabelKey):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric.inc(amount, self._key)

    def value(self) -> float:
        return self._metric.value(self._key)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, labelnames)
        self._values: Dict[LabelKey, float] = {}
        if not self.labelnames:
            self._values[()] = 0.0

    def labels(self, *labelvalues) -> "_BoundGauge":
        key = self._key(labelvalues)
        with self._lock:
            self._values.setdefault(key, 0.0)
        return _BoundGauge(self, key)

    def set(self, value: float, labelvalues: LabelKey = ()) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, labelvalues: LabelKey = ()) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labelvalues: LabelKey = ()) -> float:
        key = self._key(labelvalues)
        with self._lock:
            return self._values.get(key, 0.0)

    def values(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            for key in self._values:
                self._values[key] = 0.0

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items:
            yield f"{self.name}{_label_str(self.labelnames, key)} {_fmt_value(val)}"


class _BoundGauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Gauge, key: LabelKey):
        self._metric = metric
        self._key = key

    def set(self, value: float) -> None:
        self._metric.set(value, self._key)

    def inc(self, amount: float = 1.0) -> None:
        self._metric.inc(amount, self._key)

    def value(self) -> float:
        return self._metric.value(self._key)


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # non-cumulative, per finite bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._states: Dict[LabelKey, _HistState] = {}
        if not self.labelnames:
            self._states[()] = _HistState(len(self.buckets))

    def labels(self, *labelvalues) -> "_BoundHistogram":
        key = self._key(labelvalues)
        with self._lock:
            self._states.setdefault(key, _HistState(len(self.buckets)))
        return _BoundHistogram(self, key)

    def observe(self, value: float, labelvalues: LabelKey = ()) -> None:
        self.observe_many((value,), labelvalues)

    def observe_many(self, values: Iterable[float],
                     labelvalues: LabelKey = ()) -> None:
        """observe() of each value in turn, under one lock. A value counts in
        the first bucket b with value <= b (bisect: the engine folds a
        field's hundreds of segment times at once)."""
        key = self._key(labelvalues)
        buckets = self.buckets
        n = len(buckets)
        with self._lock:
            st = self._states.setdefault(key, _HistState(n))
            for value in values:
                v = float(value)
                st.sum += v
                st.count += 1
                i = bisect.bisect_left(buckets, v)
                if i < n and v <= buckets[i]:  # NaN counts in no bucket
                    st.counts[i] += 1

    def label_sums(self) -> Dict[LabelKey, Tuple[float, int]]:
        """Per-label-combination (sum, count)."""
        with self._lock:
            return {k: (st.sum, st.count) for k, st in self._states.items()}

    def bucket_counts(self) -> Dict[LabelKey, Tuple[Tuple[int, ...], float, int]]:
        """Per-label-combination (per-bucket NON-cumulative counts, sum,
        count) snapshot. The history sampler diffs consecutive snapshots to
        derive windowed quantiles (obs/history.py); ``self.buckets`` gives
        the matching finite upper bounds, with overflow = count - sum(counts)."""
        with self._lock:
            return {
                k: (tuple(st.counts), st.sum, st.count)
                for k, st in self._states.items()
            }

    def reset(self) -> None:
        with self._lock:
            for key in self._states:
                self._states[key] = _HistState(len(self.buckets))

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(
                (k, list(st.counts), st.sum, st.count)
                for k, st in self._states.items()
            )
        for key, counts, total, count in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = f'le="{b}"'
                yield (
                    f"{self.name}_bucket"
                    f"{_label_str(self.labelnames, key, le)} {cum}"
                )
            inf = 'le="+Inf"'
            yield (
                f"{self.name}_bucket"
                f"{_label_str(self.labelnames, key, inf)} {count}"
            )
            yield (
                f"{self.name}_sum{_label_str(self.labelnames, key)}"
                f" {repr(float(total))}"
            )
            yield f"{self.name}_count{_label_str(self.labelnames, key)} {count}"


class _BoundHistogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Histogram, key: LabelKey):
        self._metric = metric
        self._key = key

    def observe(self, value: float) -> None:
        self._metric.observe(value, self._key)

    def observe_many(self, values: Iterable[float]) -> None:
        self._metric.observe_many(values, self._key)


class Registry:
    """Process-wide metric store. Registration is get-or-create: re-declaring
    a metric with the same name returns the existing object (labelnames must
    match)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as"
                        f" {existing.kind}, not {cls.kind}"
                    )
                if existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} labelnames mismatch:"
                        f" {existing.labelnames} vs {tuple(labelnames)}"
                    )
                return existing
            m = cls(name, help_, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_, labelnames)

    def gauge(self, name, help_="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labelnames)

    def histogram(
        self, name, help_="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> Dict[str, _Metric]:
        """Point-in-time copy of {name: metric} for iteration without holding
        the registry lock (the history sampler walks every series)."""
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        """Every declared series back to 0, its label combinations kept."""
        for m in self.metrics().values():
            m.reset()

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def counter(name, help_="", labelnames=(), registry: Registry = None) -> Counter:
    return (registry or REGISTRY).counter(name, help_, labelnames)


def gauge(name, help_="", labelnames=(), registry: Registry = None) -> Gauge:
    return (registry or REGISTRY).gauge(name, help_, labelnames)


def histogram(
    name, help_="", labelnames=(), buckets=DEFAULT_BUCKETS, registry: Registry = None
) -> Histogram:
    return (registry or REGISTRY).histogram(name, help_, labelnames, buckets)


def render(registry: Registry = None) -> str:
    return (registry or REGISTRY).render()
