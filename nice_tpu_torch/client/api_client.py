"""Client HTTP transport: claim, submit, lease renewal, block claims and
validation data, with retry, backoff and multi-server failover, and the
thread-backed AsyncApi of the pipelined loops (the port's cut of
nice_tpu/client/api_client.py).

Stdlib only. Network errors, 5xx and 429 retry with full-jitter exponential
backoff (uniform(0, min(2^attempt, cap)) seconds, or the server's
Retry-After when it sent one); any other 4xx raises at once with the
server's message.

Every request goes through a per-thread pool of keep-alive connections, one
a server, and stamps X-Nice-Epoch with the highest fencing epoch any reply
has carried, so a deposed primary learns it is fenced from the first client
that saw the promotion. An endpoint a thread found dead is marked for every
thread: sockets born before the mark are dropped on their next use instead
of each timing out in turn. api_base may be a comma-separated list of
servers (failover_request): each request rotates past servers that are
down, shed load or answer with the fence (410/421), and the process sticks
to the server that last answered.

Every attempt passes through the http.<endpoint> fault site
(faults/injector.py, the client's --faults): a synthesized 5xx, a
connection error, or drop_response, where the request reaches the server
and is processed but the client sees a network error and retries (the
exactly-once submit path). Each attempt's latency goes to
nice_client_request_seconds{endpoint}, each retry to
nice_client_retries_total and the flight recorder, each rotation to the
next server to nice_client_failovers_total; every request carries a W3C
traceparent header from the thread's trace context (obs.trace_context),
so the server's handler spans join the claim's trace.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from email.message import Message
from typing import Any, Callable, Optional
from urllib.parse import urlsplit

from nice_tpu_torch import obs
from nice_tpu_torch.core.constants import CLIENT_REQUEST_TIMEOUT_SECS
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    SearchMode,
    ValidationData,
)
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.obs.series import (
    CLIENT_FAILOVERS,
    CLIENT_REQUEST_SECONDS,
    CLIENT_RETRIES,
)
from nice_tpu_torch.utils import lockdep

log = logging.getLogger(__name__)

DEFAULT_MAX_RETRIES = 10
MAX_BACKOFF_SECS = 512

# Backoff jitter source; module-level so tests can reseed for determinism.
_backoff_rng = random.Random()

# Replication fencing: the highest epoch this process has seen in any server
# response, stamped on every request as X-Nice-Epoch (claim GETs mutate
# server state too, so every request carries it).
_epoch_lock = lockdep.make_lock("client.api_client._epoch_lock")
_last_epoch = 0


def reset() -> None:
    """Forget the fencing epoch, the failover cursors and the dead-host
    marks, and close this thread's pooled connections (tests)."""
    global _last_epoch
    with _epoch_lock:
        _last_epoch = 0
    with _failover_lock:
        _failover_idx.clear()
        _failover_gen.clear()
    with _dead_hosts_lock:
        _dead_hosts.clear()
    close_connections()


def _note_epoch(parsed: Any) -> None:
    """Learn the fencing epoch from a response body: top-level "epoch"
    (write replies, /status) or the nested /status repl block."""
    global _last_epoch
    if not isinstance(parsed, dict):
        return
    epoch = parsed.get("epoch")
    if epoch is None and isinstance(parsed.get("repl"), dict):
        epoch = parsed["repl"].get("epoch")
    try:
        epoch = int(epoch)
    except (TypeError, ValueError):
        return
    with _epoch_lock:
        if epoch > _last_epoch:
            _last_epoch = epoch


def last_seen_epoch() -> int:
    with _epoch_lock:
        return _last_epoch


class ApiError(Exception):
    """Non-retryable API failure. status: the HTTP status when the server
    answered definitively, None when retries ran out on transient errors
    (the request may still succeed later; the submission spool uses the
    distinction)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _inject_http_fault(action: str, url: str, body: Optional[dict],
                       timeout: float) -> Any:
    """Apply an http.<endpoint> fault action (configure() admits only
    these): raises for every one."""
    if action == "drop_response":
        # The server processes the request; the client never learns.
        _request_json(url, body, timeout)
        raise urllib.error.URLError(f"injected fault: response dropped for {url}")
    if action in ("conn_error", "raise"):
        raise urllib.error.URLError(f"injected fault: connection error for {url}")
    code = int(action)
    raise urllib.error.HTTPError(url, code, f"injected fault: HTTP {code}",
                                 Message(), io.BytesIO(b"injected fault"))


def _retry_after_secs(err: Exception) -> Optional[float]:
    """Delay-seconds from a server-sent Retry-After header, if any."""
    headers = getattr(err, "headers", None)
    value = headers.get("Retry-After") if headers is not None else None
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


# Per-thread keep-alive connections, keyed by (scheme, host:port):
# http.client connections are not thread-safe, and the AsyncApi pool and the
# renewer threads each need their own.
_conn_local = threading.local()

# Errors that mean a REUSED socket went stale (the server closed an idle
# keep-alive connection): retried once on a fresh socket. On a fresh
# connection they are real failures and go to retry_request's backoff.
_STALE_ERRORS = (
    http.client.BadStatusLine,
    http.client.RemoteDisconnected,
    BrokenPipeError,
    ConnectionResetError,
    ConnectionAbortedError,
)

# Endpoints a thread found dead, for every thread's pool: (scheme,
# host:port) -> the monotonic time of the failure.
_dead_hosts_lock = lockdep.make_lock("client.api_client._dead_hosts_lock")
_dead_hosts: dict = {}


def _mark_host_dead(key) -> None:
    with _dead_hosts_lock:
        _dead_hosts[key] = time.monotonic()


def _conn_pool() -> dict:
    pool = getattr(_conn_local, "pool", None)
    if pool is None:
        pool = _conn_local.pool = {}
    return pool


def _drop_connection(key) -> None:
    conn = _conn_pool().pop(key, None)
    if conn is not None:
        with contextlib.suppress(Exception):
            conn.close()


def close_connections(netloc: Optional[str] = None) -> None:
    """Close this thread's pooled connections: all of them, or only those to
    one host:port when netloc is given."""
    pool = _conn_pool()
    for key in list(pool):
        if netloc is not None and key[1] != netloc:
            continue
        conn = pool.pop(key)
        with contextlib.suppress(Exception):
            conn.close()


def _headers(body: Optional[dict]) -> dict:
    """The headers of one request: JSON, the traceparent of the thread's
    trace context, and the fencing epoch once one was seen."""
    headers = {"Accept": "application/json"}
    if body is not None:
        headers["Content-Type"] = "application/json"
    traceparent = obs.current_traceparent()
    if traceparent:
        headers["traceparent"] = traceparent
    epoch = last_seen_epoch()
    if epoch > 0:
        headers["X-Nice-Epoch"] = str(epoch)
    return headers


def _request_json(url: str, body: Optional[dict] = None,
                  timeout: float = CLIENT_REQUEST_TIMEOUT_SECS) -> Any:
    parts = urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise urllib.error.URLError(f"unsupported scheme in {url!r}")
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query
    data = None if body is None else json.dumps(body).encode()
    headers = _headers(body)
    method = "GET" if body is None else "POST"
    key = (parts.scheme, parts.netloc)
    pool = _conn_pool()
    for fresh_retry in (False, True):
        conn = pool.get(key)
        if conn is not None:
            # A socket born before another thread marked this endpoint dead
            # is dropped rather than probed through its own timeout.
            with _dead_hosts_lock:
                dead_mark = _dead_hosts.get(key)
            if dead_mark is not None and conn._nice_born <= dead_mark:
                _drop_connection(key)
                conn = None
        reused = conn is not None
        if conn is None:
            cls = (http.client.HTTPSConnection if parts.scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(parts.netloc, timeout=timeout)
            conn._nice_born = time.monotonic()
            pool[key] = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            conn.request(method, target, body=data, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        except _STALE_ERRORS as e:
            _drop_connection(key)
            if reused and not fresh_retry:
                continue
            # A fresh connection failing so means the endpoint is down.
            _mark_host_dead(key)
            raise urllib.error.URLError(f"{e.__class__.__name__}: {e}") from e
        except OSError:
            # Connect or socket failure: state unknown, never resent here.
            _drop_connection(key)
            _mark_host_dead(key)
            raise
        if resp.will_close:
            _drop_connection(key)
        if resp.status >= 400:
            raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                         resp.headers, io.BytesIO(payload))
        parsed = json.loads(payload) if payload else None
        _note_epoch(parsed)
        return parsed


def retry_request(url: str, body: Optional[dict] = None,
                  max_retries: int = DEFAULT_MAX_RETRIES,
                  timeout: float = CLIENT_REQUEST_TIMEOUT_SECS,
                  endpoint: str = "other") -> Any:
    """GET (body None) or POST JSON, retrying transient failures. endpoint
    labels the attempt latencies and retries (claim / submit / validate /
    renew / telemetry / ...) and names the fault site http.<endpoint>."""
    attempt = 0
    while True:
        t0 = time.monotonic()
        try:
            act = faults.fire(f"http.{endpoint}", url=url, attempt=attempt)
            if act is not None:
                result = _inject_http_fault(act, url, body, timeout)
            else:
                result = _request_json(url, body, timeout)
            CLIENT_REQUEST_SECONDS.labels(endpoint).observe(
                time.monotonic() - t0)
            return result
        except urllib.error.HTTPError as e:
            CLIENT_REQUEST_SECONDS.labels(endpoint).observe(
                time.monotonic() - t0)
            if e.code < 500 and e.code != 429:
                detail = e.read().decode(errors="replace")
                raise ApiError(f"HTTP {e.code} from {url}: {detail}",
                               status=e.code) from e
            err: Exception = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            CLIENT_REQUEST_SECONDS.labels(endpoint).observe(
                time.monotonic() - t0)
            err = e
        if attempt >= max_retries:
            # A definite server answer (429/5xx) keeps its status, so a
            # caller tells "rate limited" from a dead transport.
            raise ApiError(
                f"request to {url} failed after {attempt} retries: {err}",
                status=getattr(err, "code", None),
            )
        CLIENT_RETRIES.labels(endpoint).inc()
        obs.flight.record("retry", endpoint=endpoint, attempt=attempt,
                          error=str(err)[:200])
        hinted = _retry_after_secs(err)
        delay = (min(hinted, MAX_BACKOFF_SECS) if hinted is not None
                 else _backoff_rng.uniform(0, min(2**attempt, MAX_BACKOFF_SECS)))
        log.warning("request failed (%s); retry %d in %.2fs", err,
                    attempt + 1, delay)
        time.sleep(delay)
        attempt += 1


# Multi-server failover: one cursor a server list, shared by every thread,
# so that one failover reroutes the whole process; its generation is bumped
# on every store, so a store computed before a concurrent rotation does not
# undo it.
_failover_lock = lockdep.make_lock("client.api_client._failover_lock")
_failover_idx: dict = {}
_failover_gen: dict = {}

# Statuses that rotate to the next server (besides transport failures and
# 5xx): timeouts and load shedding clear elsewhere, and 410/421 are the
# epoch fence saying "not me: ask the promoted server".
_ROTATE_STATUSES = frozenset({408, 410, 421, 429})


def split_servers(api_base: str) -> list:
    """Endpoint list from an api_base that may be comma-separated."""
    return [s.strip().rstrip("/") for s in api_base.split(",") if s.strip()]


def failover_request(api_base: str, path: str, body: Optional[dict] = None,
                     max_retries: int = DEFAULT_MAX_RETRIES,
                     timeout: float = CLIENT_REQUEST_TIMEOUT_SECS,
                     endpoint: str = "other") -> Any:
    """retry_request over one or many servers.

    One server: exactly retry_request. Several: each cycle tries every
    server once, from the last one that answered, rotating on transport
    errors, 5xx and _ROTATE_STATUSES; any other 4xx raises at once (a
    definite answer from a live primary). A failed cycle sleeps the
    full-jitter backoff; after max_retries + 1 cycles the last ApiError is
    raised (its status None kept, so the spool still sees a dead
    transport)."""
    servers = split_servers(api_base)
    if len(servers) <= 1:
        base = servers[0] if servers else api_base.rstrip("/")
        return retry_request(base + path, body, max_retries=max_retries,
                             timeout=timeout, endpoint=endpoint)
    key = ",".join(servers)
    with _failover_lock:
        start = _failover_idx.get(key, 0) % len(servers)
        gen = _failover_gen.get(key, 0)
    last_err: Optional[ApiError] = None
    for cycle in range(max_retries + 1):
        for off in range(len(servers)):
            i = (start + off) % len(servers)
            try:
                result = retry_request(servers[i] + path, body, max_retries=0,
                                       timeout=timeout, endpoint=endpoint)
            except ApiError as e:
                last_err = e
                if (e.status is not None and e.status < 500
                        and e.status not in _ROTATE_STATUSES):
                    raise
                CLIENT_FAILOVERS.labels(endpoint).inc()
                obs.flight.record("failover", endpoint=endpoint,
                                  server=servers[i], status=e.status,
                                  cycle=cycle)
                log.warning("server %s failed %s (%s); rotating to next "
                            "endpoint", servers[i], path,
                            e.status if e.status is not None
                            else f"transport: {e}")
                continue
            with _failover_lock:
                # Only if no other thread moved the cursor meanwhile: a
                # concurrent rotation away from a dead server wins.
                if _failover_gen.get(key, 0) == gen:
                    # nicelint: allow R5 (gen-checked store; schedex failover_cursor_rotate_vs_store / failover_cursor_prefix replay its window)
                    _failover_idx[key], _failover_gen[key] = i, gen + 1
            return result
        if cycle >= max_retries:
            break
        delay = _backoff_rng.uniform(0, min(2**cycle, MAX_BACKOFF_SECS))
        log.warning("all %d servers failed %s; cycle %d backoff %.2fs",
                    len(servers), path, cycle + 1, delay)
        time.sleep(delay)
    assert last_err is not None
    raise last_err


def _mode_arg(mode: SearchMode) -> str:
    return "detailed" if mode == SearchMode.DETAILED else "niceonly"


def get_field_from_server(mode: SearchMode, api_base: str, username: str,
                          max_retries: int = DEFAULT_MAX_RETRIES,
                          tenant: str | None = None,
                          base_min: int | None = None,
                          base_max: int | None = None) -> DataToClient:
    """GET /claim/{detailed|niceonly}; the round trip, retries and backoff
    included, goes to the journal as the claim's claim_rtt.

    tenant / base_min / base_max are the multi-tenant scheduler's claim
    routing: the server stamps the claim row with the tenant name and draws
    the field from the tenant's base window (a server that predates them
    ignores the query parameters)."""
    path = (f"/claim/{_mode_arg(mode)}"
            f"?username={urllib.parse.quote(username)}")
    if tenant is not None:
        path += f"&tenant={urllib.parse.quote(tenant)}"
    if base_min is not None:
        path += f"&base_min={int(base_min)}"
    if base_max is not None:
        path += f"&base_max={int(base_max)}"
    t0 = time.monotonic()
    data = DataToClient.from_json(
        failover_request(api_base, path, max_retries=max_retries,
                         endpoint="claim"))
    obs.journal.record_client_event(
        "claim_rtt", claim_id=data.claim_id,
        secs=round(time.monotonic() - t0, 6))
    return data


def submit_field_to_server(api_base: str, submit_data: DataToServer,
                           max_retries: int = DEFAULT_MAX_RETRIES) -> dict:
    """POST /submit. {"duplicate": true} in the reply means a retried submit
    had already been accepted (exactly-once via submit_id): success. The
    span and the requests carry the claim's trace id (derived, since the
    AsyncApi's threads have no trace context), and the round trip goes to
    the journal as submit_rtt."""
    t0 = time.monotonic()
    with obs.trace_context(obs.claim_trace_id(submit_data.claim_id)), \
            obs.span("client.submit", claim=submit_data.claim_id):
        resp = failover_request(api_base, "/submit", submit_data.to_json(),
                                max_retries=max_retries, endpoint="submit")
    obs.journal.record_client_event(
        "submit_rtt", claim_id=submit_data.claim_id,
        secs=round(time.monotonic() - t0, 6))
    return resp if isinstance(resp, dict) else {"status": "OK"}


def renew_claim(api_base: str, claim_id: int, max_retries: int = 1) -> None:
    """POST /renew_claim — lease heartbeat while a long field scans.

    Low default retry budget on purpose: a missed heartbeat is harmless (the
    next one, or the submit itself, lands well inside the expiry window), so
    the renewer thread must never sit in a 10-deep backoff while the scan it
    protects finishes."""
    with obs.trace_context(obs.claim_trace_id(claim_id)):
        failover_request(api_base, "/renew_claim", {"claim_id": claim_id},
                         max_retries=max_retries, endpoint="renew")


def claim_block_from_server(mode: SearchMode, api_base: str, username: str,
                            count: int,
                            max_retries: int = DEFAULT_MAX_RETRIES,
                            ) -> tuple[str, list[DataToClient]]:
    """POST /claim_block — count fields per round trip under one block
    lease. Returns (block_id, fields); a partial block is success. A server
    without block leases answers 404, which callers take as "fall back to
    per-field claims"."""
    payload = {"mode": _mode_arg(mode), "count": count, "username": username}
    resp = failover_request(api_base, "/claim_block", payload,
                            max_retries=max_retries, endpoint="claim_block")
    return resp["block_id"], [DataToClient.from_json(f) for f in resp["fields"]]


def submit_block_to_server(api_base: str, block_id: str,
                           submissions: list[DataToServer],
                           telemetry: Optional[dict] = None,
                           max_retries: int = DEFAULT_MAX_RETRIES) -> dict:
    """POST /submit_block — a block's results at once, with the client's
    fleet snapshot when given. The reply has one result per submission, in
    order, and the accepted / duplicates / rejected counts; a duplicate is
    an exactly-once replay, a success."""
    body: dict = {"block_id": block_id,
                  "submissions": [s.to_json() for s in submissions]}
    if telemetry is not None:
        body["telemetry"] = telemetry
    with obs.span("client.submit_block", block=block_id, n=len(submissions)):
        resp = failover_request(api_base, "/submit_block", body,
                                max_retries=max_retries,
                                endpoint="submit_block")
    if isinstance(resp, dict) and resp.get("duplicates"):
        log.info("submit_block %s: %d of %d results were duplicates "
                 "(retried requests already accepted)", block_id,
                 resp["duplicates"], len(submissions))
    return resp if isinstance(resp, dict) else {"status": "OK"}


def renew_block(api_base: str, block_id: str, max_retries: int = 1) -> None:
    """POST /renew_claim {block_id} — one heartbeat re-arms every member of
    the block lease (the retry budget of renew_claim, for its reason)."""
    failover_request(api_base, "/renew_claim", {"block_id": block_id},
                     max_retries=max_retries, endpoint="renew")


def post_telemetry(api_base: str, snap: dict, max_retries: int = 1) -> None:
    """POST /telemetry — the fleet-visibility heartbeat. Best-effort by
    design (the retry budget of renew_claim, for its reason)."""
    failover_request(api_base, "/telemetry", snap, max_retries=max_retries,
                     endpoint="telemetry")


def get_validation_data_from_server(api_base: str, username: str,
                                    base: Optional[int] = None,
                                    max_retries: int = DEFAULT_MAX_RETRIES,
                                    ) -> ValidationData:
    """GET /claim/validate: a double-checked field and its canonical
    results, of one base when `base` is given."""
    path = f"/claim/validate?username={urllib.parse.quote(username)}"
    if base is not None:
        path += f"&base={base}"
    return ValidationData.from_json(
        failover_request(api_base, path, max_retries=max_retries,
                         endpoint="validate"))


class AsyncApi:
    """Thread-backed async facade so that claim N+1 and submit N-1 overlap
    processing N (the reference's 3-stage pipeline), per field or per
    block. telemetry: a callable returning the fleet snapshot a block
    submit carries (taken on the calling thread), or None."""

    def __init__(self, api_base: str, username: str,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 telemetry: Optional[Callable[[], dict]] = None):
        self.api_base = api_base
        self.username = username
        self.max_retries = max_retries
        self.telemetry = telemetry
        self._pool = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="nice-api")

    def claim_async(self, mode: SearchMode):
        return self._pool.submit(get_field_from_server, mode, self.api_base,
                                 self.username, self.max_retries)

    def submit_async(self, data: DataToServer):
        return self._pool.submit(submit_field_to_server, self.api_base, data,
                                 self.max_retries)

    def claim_block_async(self, mode: SearchMode, count: int):
        return self._pool.submit(claim_block_from_server, mode, self.api_base,
                                 self.username, count, self.max_retries)

    def submit_block_async(self, block_id: str,
                           submissions: list[DataToServer]):
        snap = self.telemetry() if self.telemetry is not None else None
        return self._pool.submit(submit_block_to_server, self.api_base,
                                 block_id, submissions, snap, self.max_retries)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
