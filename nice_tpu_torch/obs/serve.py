"""Local /metrics + /debug/flight + /history + /debug/profile HTTP endpoint
for the client and the daemon (the port's copy of nice_tpu/obs/serve.py;
the port is an argument, the client's --metrics-port).

A stdlib ThreadingHTTPServer on a localhost port makes the registry
scrapeable, the flight-recorder ring inspectable and the sampled history
queryable without signalling the process. Port 0 binds a free port; the
bound port is logged and exported as the ``nice_metrics_bound_port`` gauge.
Unknown paths get a real ``application/json`` 404 body. Where the reference
logs a warning for a port it cannot bind, maybe_serve_metrics() raises.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nice_tpu_torch.utils import lockdep

from . import flight, history, metrics, pyprof, series

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = ["serve_metrics", "maybe_serve_metrics", "stop"]

_started_lock = lockdep.make_lock("obs.serve._started_lock")
_started: Optional[ThreadingHTTPServer] = None


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        status = 200
        if path in ("/metrics", "/"):
            body = metrics.render().encode("utf-8")
            ctype = "text/plain; version=0.0.4"
        elif path == "/debug/flight":
            body = json.dumps(
                {
                    "pid": os.getpid(),
                    "capacity": flight.RECORDER.capacity,
                    "total_recorded": flight.RECORDER.total_recorded(),
                    "events": flight.snapshot(),
                },
                default=repr,
            ).encode("utf-8")
            ctype = "application/json"
        elif path == "/history":
            status, payload = history.handle_query(history.STORE, query)
            body = json.dumps(payload, default=repr).encode("utf-8")
            ctype = "application/json"
        elif path == "/debug/profile":
            status, body, ctype = pyprof.handle_query(query)
        else:
            status = 404
            body = json.dumps(
                {
                    "error": f"unknown path {path!r}",
                    "known": ["/metrics", "/debug/flight", "/history",
                              "/debug/profile"],
                }
            ).encode("utf-8")
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        log.debug("metrics server: " + fmt, *args)


def serve_metrics(port: int, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start a daemon-thread metrics server; returns the server (read the
    bound port from ``server.server_address[1]`` when port=0)."""
    server = ThreadingHTTPServer((host, port), _MetricsHandler)
    series.METRICS_BOUND_PORT.set(server.server_address[1])
    t = threading.Thread(
        target=server.serve_forever, name="nice-metrics", daemon=True
    )
    t.start()
    return server


def maybe_serve_metrics(port: Optional[int]) -> Optional[ThreadingHTTPServer]:
    """The process's local endpoint on `port` (0: a free port; None: no
    endpoint). Idempotent per process; a port that cannot be bound raises."""
    global _started
    if port is None:
        return None
    with _started_lock:
        if _started is None:
            _started = serve_metrics(int(port))
            log.info("serving /metrics on 127.0.0.1:%d",
                     _started.server_address[1])
        return _started


def stop() -> None:
    """Shut the endpoint down (tests, and a client run in process)."""
    global _started
    with _started_lock:
        if _started is not None:
            _started.shutdown()
            _started.server_close()
            _started = None
            series.METRICS_BOUND_PORT.set(0)
