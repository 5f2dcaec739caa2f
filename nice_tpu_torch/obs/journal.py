"""The client half of the field lifecycle journal (the port's cut of
nice_tpu/obs/journal.py; the server's journal rows stay the reference's).

Client-side events (checkpoint save and resume, spool replays, claim and
submit round trips, the per-field stepprof phases) cannot reach the
server's field_events table directly: they buffer here through
:func:`record_client_event`, ride on the next ``DataToServer.telemetry``
snapshot or telemetry heartbeat, and the server merges them into the
field's timeline with a ``client_`` kind prefix. They are keyed by claim
id; the server resolves claim -> field when it merges them.

The buffer is bounded: a client that cannot reach the server for a while
drops its oldest events first (the journal is diagnostic, not the ledger
of record).
"""

from __future__ import annotations

from typing import Optional

from nice_tpu_torch.utils import lockdep

__all__ = [
    "CLIENT_EVENT_KINDS",
    "record_client_event",
    "drain_client_events",
    "reset",
]

# Client-side kinds (the server prefixes them with "client_").
CLIENT_EVENT_KINDS = (
    "client_ckpt_save",
    "client_ckpt_resume",
    "client_downgrade",
    "client_spool_replay",
    "client_claim_rtt",
    "client_submit_rtt",
    "client_phases",
)

_CLIENT_BUFFER_CAP = 256
_client_lock = lockdep.make_lock("obs.journal._client_lock")
_client_events: list[dict] = []


def record_client_event(kind: str, *, claim_id: Optional[int] = None,
                        **detail) -> None:
    """Buffer one client-side lifecycle event for the next telemetry
    snapshot. kind is recorded without the client_ prefix (e.g.
    "ckpt_save"); the server prefixes it at merge time."""
    evt = {"kind": str(kind)}
    if claim_id is not None:
        evt["claim_id"] = int(claim_id)
    if detail:
        evt["detail"] = detail
    with _client_lock:
        _client_events.append(evt)
        if len(_client_events) > _CLIENT_BUFFER_CAP:
            del _client_events[: len(_client_events) - _CLIENT_BUFFER_CAP]


def drain_client_events() -> list[dict]:
    """Take (and clear) the buffered client events for a telemetry snapshot."""
    with _client_lock:
        events, _client_events[:] = list(_client_events), []
    return events


def reset() -> None:
    """Drop every buffered event (tests)."""
    drain_client_events()
