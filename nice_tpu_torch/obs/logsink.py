"""JSON-line log sink with trace-id injection (the port's copy of
nice_tpu/obs/logsink.py; the level and the file are arguments, the client's
--log-level and --log-file).

install() configures the root logger with a JSON formatter that stamps
every record with the ambient ``trace_id`` (obs/trace.py context), so a
log line groups with the same claim's spans and journal events. Calling it
again replaces the handlers it installed before. Where the reference
replaces every root handler (basicConfig(force=True)), this leaves the
handlers others installed (a test harness's capture, a host program's own)
in place.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

from . import trace

__all__ = ["JsonFormatter", "install", "resolve_level"]

# "trace" is a client-CLI convention (extra-verbose debug), not a stdlib
# level — map it onto DEBUG.
_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def resolve_level(name: str = "info") -> int:
    return _LEVELS.get((name or "info").strip().lower(), logging.INFO)


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/msg, the ambient trace_id
    when a trace context is active, and a formatted traceback under "exc"
    for records carrying exc_info."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        tid = trace.current_trace_id()
        if tid:
            out["trace_id"] = tid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=repr, separators=(",", ":"))


class _StderrHandler(logging.StreamHandler):
    """A StreamHandler on whatever sys.stderr is when a record is written
    (a host that swaps sys.stderr keeps getting the lines)."""

    def __init__(self):
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value):
        pass


_installed: list[logging.Handler] = []


def install(level: str = "info", log_file: Optional[str] = None) -> None:
    """Point the root logger at the JSON sink: stderr, and `log_file` too
    when given (a file that cannot be opened raises)."""
    formatter = JsonFormatter()
    handlers: list[logging.Handler] = [_StderrHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file, encoding="utf-8"))
    root = logging.getLogger()
    for h in _installed:
        root.removeHandler(h)
        h.close()
    _installed[:] = handlers
    for h in handlers:
        h.setFormatter(formatter)
        root.addHandler(h)
    root.setLevel(resolve_level(level))
    # UTC everywhere, matching the trace sink and the ledger's timestamps.
    logging.Formatter.converter = time.gmtime
