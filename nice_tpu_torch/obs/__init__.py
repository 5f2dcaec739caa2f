"""nice_tpu_torch.obs — the port's observability layer (the client side of
nice_tpu/obs, with the reference's public names, series and wire formats).

- ``metrics``: the process-wide Prometheus-text registry (counters, gauges,
  histograms) behind the client's local /metrics port.
- ``series``: the well-known series names, declared once.
- ``trace``: ``span(name)`` / ``trace_event`` JSON trace events, the
  claim-derived ``trace_context`` carried as a W3C ``traceparent`` header,
  ``profiler``, a torch.profiler capture, and ``field``, the field record:
  a field whose entry finds a sink configured or torch's profiler recording
  (no flag of its own) keeps its spans, phase steps and the engine's
  per-item sums by name, in a bounded ring (``field_records``) and, with a
  sink, as one ``field`` event; under the profiler each is also a profiler
  range on the capture's clock.
- ``flight``: bounded in-process ring of recent structured events, dumped
  atomically on crash / SIGUSR2 / spool quarantine.
- ``journal``: the client-side lifecycle events that ride on telemetry.
- ``stepprof``: the device-step profiler bucketing each field's wall time
  into compile / h2d_feed / device_compute / fold / readback / host_other,
  fenced with CUDA events.
- ``memwatch``: device memory (torch.cuda), host RSS and watched paths.
- ``pyprof``: statistical wall-clock profiler over ``sys._current_frames()``.
- ``history``: ring-buffer time series over the registry behind /history.
- ``telemetry``: the per-client snapshot the server aggregates fleet-wide.
- ``logsink``: the JSON-line log formatter with trace-id injection.
- ``serve``: the local /metrics, /debug/flight, /history and
  /debug/profile endpoint.

- ``slo``: declarative SLOs with multi-window burn-rate states over a
  HistoryStore; the multi-tenant scheduler's per-tenant page-latency specs
  (sched/) are its user here.
- ``critpath``: the critical-path segments and ``phase_shares``, the fold
  of a stepprof table the bench reports and the regression gate diffs.

Every knob is an argument (the client's flags): no environment variable is
read. The server-side modules of the reference (anomaly, the rest of
critpath, stream) stay the JAX package's, as the server does.
"""

from . import (  # noqa: F401 — importing pre-seeds
    flight,
    history,
    journal,
    logsink,
    memwatch,
    pyprof,
    series,
    slo,
    stepprof,
    telemetry,
)
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    histogram,
    render,
)
from .serve import maybe_serve_metrics, serve_metrics  # noqa: F401
from .trace import (  # noqa: F401
    claim_trace_id,
    current_trace_id,
    current_traceparent,
    make_traceparent,
    parse_traceparent,
    profiler,
    span,
    trace_context,
    trace_enabled,
    trace_event,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "gauge",
    "histogram",
    "render",
    "series",
    "flight",
    "history",
    "slo",
    "stepprof",
    "telemetry",
    "journal",
    "memwatch",
    "pyprof",
    "logsink",
    "serve_metrics",
    "maybe_serve_metrics",
    "span",
    "trace_event",
    "trace_enabled",
    "trace_context",
    "current_trace_id",
    "current_traceparent",
    "claim_trace_id",
    "make_traceparent",
    "parse_traceparent",
    "profiler",
    "reset",
]


def reset() -> None:
    """Every piece of the layer's process state back to its start: the
    registry's values, the flight ring, the journal buffer, stepprof, the
    trace sink and profiler, memwatch's paths and summary, pyprof's table,
    the history store and the telemetry rate (tests)."""
    from . import serve, trace

    serve.stop()
    REGISTRY.reset()
    series.MESH_DEVICES.set(1)
    flight.reset()
    journal.reset()
    stepprof.reset()
    trace.reset()
    memwatch.reset()
    pyprof.reset()
    history.reset()
    telemetry.reset()
