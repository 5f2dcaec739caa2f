"""Client HTTP transport: claim and submit with retry and backoff (the
port's cut of nice_tpu/client/api_client.py:282-522).

Stdlib only. Network errors, 5xx and 429 retry with full-jitter exponential
backoff (uniform(0, min(2^attempt, cap)) seconds, or the server's
Retry-After when it sent one); any other 4xx raises at once with the
server's message. One server, no failover, epochs, journal or telemetry.
"""

from __future__ import annotations

import json
import logging
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from nice_tpu_torch.core.constants import CLIENT_REQUEST_TIMEOUT_SECS
from nice_tpu_torch.core.types import DataToClient, DataToServer, SearchMode

log = logging.getLogger(__name__)

DEFAULT_MAX_RETRIES = 10
MAX_BACKOFF_SECS = 512


class ApiError(Exception):
    """Non-retryable API failure. status: the HTTP status when the server
    answered definitively, None when retries ran out on transient errors."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _request_json(url: str, body: Optional[dict], timeout: float) -> Any:
    data = None
    headers = {"Accept": "application/json"}
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else None


def _retry_after_secs(err: Exception) -> Optional[float]:
    headers = getattr(err, "headers", None)
    value = headers.get("Retry-After") if headers is not None else None
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def retry_request(url: str, body: Optional[dict] = None,
                  max_retries: int = DEFAULT_MAX_RETRIES,
                  timeout: float = CLIENT_REQUEST_TIMEOUT_SECS,
                  rng: Optional[random.Random] = None) -> Any:
    """GET (body None) or POST JSON, retrying transient failures."""
    rng = rng or random.Random()
    attempt = 0
    while True:
        try:
            return _request_json(url, body, timeout)
        except urllib.error.HTTPError as e:
            if e.code < 500 and e.code != 429:
                detail = e.read().decode(errors="replace")
                raise ApiError(f"HTTP {e.code} from {url}: {detail}",
                               status=e.code) from e
            err: Exception = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            err = e
        if attempt >= max_retries:
            raise ApiError(
                f"request to {url} failed after {attempt} retries: {err}",
                status=getattr(err, "code", None),
            )
        hinted = _retry_after_secs(err)
        delay = (min(hinted, MAX_BACKOFF_SECS) if hinted is not None
                 else rng.uniform(0, min(2**attempt, MAX_BACKOFF_SECS)))
        log.warning("request failed (%s); retry %d in %.2fs", err,
                    attempt + 1, delay)
        time.sleep(delay)
        attempt += 1


def get_field_from_server(mode: SearchMode, api_base: str, username: str,
                          max_retries: int = DEFAULT_MAX_RETRIES) -> DataToClient:
    """GET /claim/{detailed|niceonly}."""
    endpoint = "detailed" if mode == SearchMode.DETAILED else "niceonly"
    url = (f"{api_base.rstrip('/')}/claim/{endpoint}"
           f"?username={urllib.parse.quote(username)}")
    return DataToClient.from_json(retry_request(url, max_retries=max_retries))


def submit_field_to_server(api_base: str, submit_data: DataToServer,
                           max_retries: int = DEFAULT_MAX_RETRIES) -> dict:
    """POST /submit. {"duplicate": true} in the reply means a retried submit
    had already been accepted (exactly-once via submit_id): success."""
    resp = retry_request(f"{api_base.rstrip('/')}/submit", submit_data.to_json(),
                         max_retries=max_retries)
    return resp if isinstance(resp, dict) else {"status": "OK"}
