"""Structured JSON trace spans, the distributed trace context, and the
torch.profiler hook (the port's copy of nice_tpu/obs/trace.py; the sink and
the profiler directory are arguments of configure(), not environment
variables).

``span(name)`` emits a *begin* event immediately (flushed) and an *end* event
with wall/process durations on exit, so a hang inside the span leaves a
begin-without-end record naming the stalled phase. Every span feeds the
nice_trace_span_seconds histogram whether or not a sink is configured.

Distributed tracing: spans and events stamped inside a ``trace_context``
carry a ``trace_id``. The id is derived from the claim id
(``claim_trace_id``), so the client and the coordination server agree on it
without negotiating: the client stamps a W3C ``traceparent`` header on its
requests and the server continues the same trace in its handler spans.

The sink (configure(sink=...), the client's --trace):
  None / "" / "0"   -> disabled (spans still feed the duration histogram)
  "1" or "stderr"   -> JSON lines on stderr
  anything else     -> append to that file path

File sinks are size-capped: past ``max_bytes`` (--trace-max-bytes, default
64 MiB; 0 disables) the file rotates to ``<path>.1`` (one backup kept).

``profiler(name)`` captures a block with torch.profiler (CPU activity, and
CUDA activity where torch sees a card) and writes a Chrome trace into the
directory configure(profile_dir=...) names (--profile-dir). Where the
reference degrades to a no-op with a warning when its profiler cannot start,
this one raises: a capture that was asked for either happens or fails.

The field record (``field(base, start, end)``): a field is recorded when,
at its entry, a sink is configured or torch's profiler is recording (any
capture: profiler() here, or a caller's own); no flag of its own turns it
on. Its FieldRecord holds seconds and a count under each name: the spans
that end on the field's thread inside it, its steps (``Steps``: phases
that tile a span) and the per-item sums the engine adds (waits, hand-offs,
launches). Under the profiler each span, step and named item is also a
profiler range of its name (_range: torch's function-scope range, which
leaves the device's timeline alone), so the program's phases sit in the
capture beside the device's records, on its clock; a range on another
thread than the capture's shows where the capture profiles all threads.
Finished records are kept in a bounded ring (``field_records``) and, with
a sink, written as one ``field`` event each. A field that records nothing
gets OFF, whose calls do nothing; a loop checks ``rec.on`` once an item.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import io
import itertools
import json
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Optional

from nice_tpu_torch.utils import lockdep

from .series import TRACE_SPAN_SECONDS as SPAN_SECONDS

__all__ = [
    "configure",
    "span",
    "trace_event",
    "trace_enabled",
    "profiler",
    "trace_context",
    "current_trace_id",
    "current_traceparent",
    "claim_trace_id",
    "make_traceparent",
    "parse_traceparent",
    "field",
    "field_records",
    "OFF",
    "reset",
]

DEFAULT_MAX_SINK_BYTES = 64 * 1024 * 1024

_lock = lockdep.make_lock("obs.trace._lock")
_sink_spec = ""
_max_bytes = DEFAULT_MAX_SINK_BYTES
_profile_dir = ""
_sink: Optional[io.TextIOBase] = None
_sink_bytes = 0  # current file-sink size (tracked to trigger rotation)
_local = threading.local()
_captures = itertools.count()
# The finished field records, newest last (field_records()).
FIELD_RECORDS_MAX = 4096
_records: deque = deque(maxlen=FIELD_RECORDS_MAX)


# --- trace context ---------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$"
)


def claim_trace_id(claim_id: int) -> str:
    """Deterministic 16-byte trace id for one claim's whole lifecycle (the
    server derives the same one from the claim id)."""
    return hashlib.sha256(f"nice-claim:{claim_id}".encode()).hexdigest()[:32]


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]):
    """Stamp every span/event in this thread with trace_id (None = no-op)."""
    prev = getattr(_local, "trace_id", None)
    _local.trace_id = trace_id
    try:
        yield
    finally:
        _local.trace_id = prev


def current_trace_id() -> Optional[str]:
    return getattr(_local, "trace_id", None)


def make_traceparent(trace_id: str, span_id: Optional[str] = None) -> str:
    """W3C traceparent header value for an outgoing request."""
    return f"00-{trace_id}-{span_id or os.urandom(8).hex()}-01"


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """trace_id from a traceparent header, or None when absent/malformed."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    return m.group(1) if m else None


def current_traceparent() -> Optional[str]:
    """Header value for the ambient trace context, or None outside one."""
    tid = current_trace_id()
    return make_traceparent(tid) if tid else None


# --- configuration and sink ------------------------------------------------


def _close_sink_locked() -> None:
    global _sink
    if _sink is not None and _sink is not sys.stderr:
        try:
            _sink.close()
        except OSError:
            pass
    _sink = None  # nicelint: allow R2 (configure holds _lock)


def configure(sink: Optional[str] = None,
              max_bytes: int = DEFAULT_MAX_SINK_BYTES,
              profile_dir: Optional[str] = None) -> None:
    """Point the span sink at `sink` (see the module note), cap a file sink
    at `max_bytes`, and arm profiler() with `profile_dir`. A file sink that
    cannot be opened raises."""
    global _sink_spec, _max_bytes, _profile_dir, _sink, _sink_bytes
    spec = sink or ""
    with _lock:
        _close_sink_locked()
        _sink_spec = spec
        _max_bytes = int(max_bytes)
        _profile_dir = profile_dir or ""
        if spec in ("", "0"):
            _sink = None
        elif spec in ("1", "stderr"):
            _sink = sys.stderr
        else:
            # nicelint: allow A1 (streaming append-only trace sink)
            _sink = open(spec, "a", encoding="utf-8")
            _sink_bytes = os.path.getsize(spec)


def reset() -> None:
    """Close the sink, disarm the profiler and drop the field records
    (tests)."""
    configure(None)
    _records.clear()


def sink_path() -> Optional[str]:
    """The file sink's path, None for stderr or no sink."""
    return _sink_spec if _sink_spec not in ("", "0", "1", "stderr") else None


def _rotate_locked() -> None:
    """Rotate the current file sink to <path>.1 and reopen. _lock held."""
    global _sink, _sink_bytes
    path = _sink_spec
    try:
        _sink.close()
    except OSError:
        pass
    try:
        os.replace(path, path + ".1")
    except OSError:
        pass  # rotation is best-effort; keep appending to the same file
    try:
        # nicelint: allow A1,R2 (streaming append-only trace sink; _emit holds _lock)
        _sink = open(path, "a", encoding="utf-8")
        _sink_bytes = 0  # nicelint: allow R2 (_emit holds _lock)
    except OSError as exc:
        print(f"nice_tpu_torch.obs: cannot reopen trace sink {path!r}: {exc}",
              file=sys.stderr)
        _sink = None  # nicelint: allow R2 (_emit holds _lock)


@atexit.register
def _flush_sink_at_exit() -> None:
    with _lock:
        if _sink is not None:
            try:
                _sink.flush()
                if _sink is not sys.stderr:
                    _sink.close()
            except (OSError, ValueError):
                pass


def trace_enabled() -> bool:
    return _sink is not None


def _emit(record: dict) -> None:
    global _sink_bytes
    sink = _sink
    if sink is None:
        return
    line = json.dumps(record, default=repr, separators=(",", ":"))
    with _lock:
        try:
            sink.write(line + "\n")
            sink.flush()  # hang evidence must hit the sink before the body
        except (OSError, ValueError):
            return
        if sink is not sys.stderr:
            _sink_bytes += len(line) + 1
            if _max_bytes > 0 and _sink_bytes >= _max_bytes:
                _rotate_locked()


def trace_event(name: str, event: str = "instant", **fields) -> None:
    """One flushed JSON line outside any span lifecycle."""
    rec = {"ts": time.time(), "name": name, "event": event}
    tid = current_trace_id()
    if tid:
        rec["trace_id"] = tid
    rec.update(fields)
    _emit(rec)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _profiling() -> bool:
    """Whether torch's profiler is recording: the module flag its start sets
    and its stop clears (one attribute read; False before torch is
    imported, when nothing can be recording)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _range(name: str):
    """A profiler range named `name`, to enter (torch is loaded: its
    profiler is recording). It is torch's function-scope range,
    _RecordFunctionFast: a user-scope record_function also annotates the
    device's timeline over the kernels launched inside it, which a reader
    of the capture's device records would count as device work."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name)


def _open_range(name: str):
    rng = _range(name)
    rng.__enter__()
    return rng


@contextlib.contextmanager
def span(name: str, **attrs):
    """Context manager: begin event now, end event (with wall_secs and
    process_secs) on exit. Nesting is tracked per-thread via parent/depth;
    span_id/parent_id give exact tree edges and trace_id joins the ambient
    distributed trace (see trace_context). The block gets a dict whose
    entries the end event carries (attributes known only at the end).
    Inside a recorded field on this thread the wall also goes into the
    field's record; under torch's profiler (the field's choice, or the
    profiler's state outside a field) the span is also a profiler range of
    the same name (_range), entered first and left last, so that it holds
    the span's own bookkeeping."""
    field_rec = getattr(_local, "field", None)
    rng = (_open_range(name) if (field_rec.profiling if field_rec is not None
                                  else _profiling()) else None)
    st = _stack()
    parent = st[-1] if st else None
    depth = len(st)
    enabled = trace_enabled()
    span_id = os.urandom(8).hex() if enabled else ""
    trace_id = current_trace_id()
    if enabled:
        rec = {
            "ts": time.time(),
            "name": name,
            "event": "begin",
            "depth": depth,
            "span_id": span_id,
        }
        if trace_id:
            rec["trace_id"] = trace_id
        if parent:
            rec["parent"] = parent[0]
            rec["parent_id"] = parent[1]
        if attrs:
            rec.update(attrs)
        _emit(rec)
    st.append((name, span_id))
    t0 = time.perf_counter()
    p0 = time.process_time() if enabled else 0.0
    status = "ok"
    end_attrs: dict = {}
    try:
        yield end_attrs
    except BaseException:
        status = "error"
        raise
    finally:
        wall = time.perf_counter() - t0
        st.pop()
        SPAN_SECONDS.observe(wall, (name,))
        if field_rec is not None:
            field_rec.add(name, wall)
        if enabled:
            rec = {
                "ts": time.time(),
                "name": name,
                "event": "end",
                "depth": depth,
                "span_id": span_id,
                "status": status,
                "wall_secs": wall,
                "process_secs": time.process_time() - p0,
                **end_attrs,
            }
            if trace_id:
                rec["trace_id"] = trace_id
            if parent:
                rec["parent"] = parent[0]
                rec["parent_id"] = parent[1]
            _emit(rec)
        if rng is not None:
            rng.__exit__(None, None, None)


# --- the field record ------------------------------------------------------

_NULL = contextlib.nullcontext()


class FieldRecord:
    """One recorded field: [seconds, count] under each name in ``spans``.
    The field's threads write it, each under its own names (the field's
    thread: its spans, steps and the dispatcher's sums; the collector: its
    items, waits and the rare path; the feed's producer: its blocks), and it
    is read once they are joined."""

    on = True

    def __init__(self, base: int, range_start: int, range_end: int,
                 trace_id: Optional[str], profiling: bool):
        self.base = base
        self.range_start = range_start
        self.range_end = range_end
        self.trace_id = trace_id
        self.profiling = profiling
        self.spans: dict = {}

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        a = self.spans.get(name)
        if a is None:
            self.spans[name] = [seconds, count]
        else:
            a[0] += seconds
            a[1] += count

    def range(self, name: str):
        """A profiler range named `name` around a block under the profiler,
        nothing otherwise (the caller times the block, if at all)."""
        return _range(name) if self.profiling else _NULL

    @contextlib.contextmanager
    def timed(self, name: str):
        """The block's wall added under `name` (one count), in a range."""
        with self.range(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def steps(self) -> "Steps":
        return Steps(self)

    def as_dict(self) -> dict:
        out = {"base": self.base, "range_start": self.range_start,
               "range_end": self.range_end,
               "spans": {k: [s, n] for k, (s, n) in self.spans.items()}}
        if self.trace_id:
            out["trace_id"] = self.trace_id
        return out


class Steps:
    """Steps that tile a stretch of a recorded field: to(name) ends the open
    step, if any, and starts `name` (None: none) at one clock read, so that
    no time falls between them; each is a range under the profiler. The
    caller ends the last one (to(None)) before the stretch ends."""

    def __init__(self, rec: FieldRecord):
        self._rec = rec
        self._open = None  # (name, its start, its range)

    def to(self, name: Optional[str]) -> None:
        t = time.perf_counter()
        if self._open is not None:
            prev, t0, rng = self._open
            self._rec.add(prev, t - t0)
            if rng is not None:
                rng.__exit__(None, None, None)
        self._open = (None if name is None else
                      (name, t, _open_range(name) if self._rec.profiling
                       else None))


class _Off:
    """The record of a field that records nothing: every call a no-op."""

    on = False
    profiling = False

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        pass

    def range(self, name: str):
        return _NULL

    timed = range

    def steps(self) -> "_Off":
        return self

    def to(self, name: Optional[str]) -> None:
        pass


OFF = _Off()


@contextlib.contextmanager
def field(base: int, range_start: int, range_end: int):
    """The record of the field run in this block: the thread's open one
    where an outer block opened it (the client's, around the engine's),
    else a FieldRecord when a sink is configured or torch's profiler is
    recording now, else OFF; decided once, here. A new record is kept in
    field_records() when the block ends and, with a sink, written as one
    `field` event."""
    outer = getattr(_local, "field", None)
    if outer is not None:
        yield outer
        return
    profiling = _profiling()
    rec = (FieldRecord(base, range_start, range_end, current_trace_id(),
                       profiling)
           if profiling or _sink is not None else OFF)
    _local.field = rec
    try:
        yield rec
    finally:
        _local.field = None
        if rec.on:
            _records.append(rec)
            if _sink is not None:
                _emit({"ts": time.time(), "name": "field",
                       "event": "instant", **rec.as_dict()})


def field_records() -> list:
    """The finished fields' records, oldest first (the last
    FIELD_RECORDS_MAX): {"base", "range_start", "range_end", "spans":
    {name: [seconds, count]}} and "trace_id" where the field ran in a trace
    context."""
    return [r.as_dict() for r in list(_records)]


@contextlib.contextmanager
def profiler(name: str):
    """torch.profiler capture of the block when a profile directory is
    configured, written as <dir>/<name>-<pid>-<n>.json (a Chrome trace);
    a no-op otherwise. A capture that cannot start or be written raises."""
    out_dir = _profile_dir
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(out_dir,
                        f"{name}-{os.getpid()}-{next(_captures)}.json")
    trace_event("profiler", "begin", span=name, dir=out_dir)
    try:
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    finally:
        trace_event("profiler", "end", span=name, dir=out_dir, path=path)
