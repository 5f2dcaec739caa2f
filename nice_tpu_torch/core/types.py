"""Shared domain types (copy of nice_tpu/core/types.py, cut to the slice).

Field names match the server's wire format, so payloads are interchangeable
with the JAX package's client and server.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Iterator, Optional


class SearchMode(str, enum.Enum):
    DETAILED = "Detailed"
    NICEONLY = "Niceonly"

    def __str__(self) -> str:
        return "Detailed" if self is SearchMode.DETAILED else "Nice-only"


@dataclass(frozen=True)
class FieldSize:
    """Half-open search range [range_start, range_end)."""

    range_start: int
    range_end: int

    def __post_init__(self) -> None:
        if not self.range_start < self.range_end:
            raise ValueError(
                "Range has invalid bounds, range_start must be < range_end "
                "(half-open interval)"
            )

    def first(self) -> int:
        return self.range_start

    def last(self) -> int:
        return self.range_end - 1

    def start(self) -> int:
        return self.range_start

    def end(self) -> int:
        return self.range_end

    def size(self) -> int:
        return self.range_end - self.range_start

    def range_iter(self) -> Iterator[int]:
        return iter(range(self.range_start, self.range_end))


@dataclass(frozen=True)
class UniquesDistributionSimple:
    """One histogram bucket: count of numbers with num_uniques unique digits."""

    num_uniques: int
    count: int


@dataclass(frozen=True)
class NiceNumberSimple:
    number: int
    num_uniques: int


@dataclass
class ValidationData:
    """Field info plus canonical results for the self-check endpoint
    (/claim/validate)."""

    base: int
    field_id: int
    range_start: int
    range_end: int
    range_size: int
    unique_distribution: list[UniquesDistributionSimple]
    nice_numbers: list[NiceNumberSimple]

    @staticmethod
    def from_json(d: dict[str, Any]) -> "ValidationData":
        return ValidationData(
            base=int(d["base"]),
            field_id=int(d["field_id"]),
            range_start=int(d["range_start"]),
            range_end=int(d["range_end"]),
            range_size=int(d["range_size"]),
            unique_distribution=[
                UniquesDistributionSimple(int(x["num_uniques"]), int(x["count"]))
                for x in d["unique_distribution"]
            ],
            nice_numbers=[
                NiceNumberSimple(int(x["number"]), int(x["num_uniques"]))
                for x in d["nice_numbers"]
            ],
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "base": self.base,
            "field_id": self.field_id,
            "range_start": self.range_start,
            "range_end": self.range_end,
            "range_size": self.range_size,
            "unique_distribution": [
                {"num_uniques": d_.num_uniques, "count": d_.count}
                for d_ in self.unique_distribution
            ],
            "nice_numbers": [
                {"number": n.number, "num_uniques": n.num_uniques}
                for n in self.nice_numbers
            ],
        }


@dataclass(frozen=True)
class FieldResults:
    """Results of processing a field: bins 1..base and the near-miss list."""

    distribution: tuple[UniquesDistributionSimple, ...]
    nice_numbers: tuple[NiceNumberSimple, ...]


@dataclass
class DataToClient:
    """A field sent to the client for processing."""

    claim_id: int
    base: int
    range_start: int
    range_end: int
    range_size: int

    def to_field_size(self) -> FieldSize:
        return FieldSize(self.range_start, self.range_end)

    @staticmethod
    def from_json(d: dict[str, Any]) -> "DataToClient":
        return DataToClient(
            claim_id=int(d["claim_id"]),
            base=int(d["base"]),
            range_start=int(d["range_start"]),
            range_end=int(d["range_end"]),
            range_size=int(d["range_size"]),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "claim_id": self.claim_id,
            "base": self.base,
            "range_start": self.range_start,
            "range_end": self.range_end,
            "range_size": self.range_size,
        }


@dataclass
class DataToServer:
    """Compiled results sent to the server. submit_id (claim id + content
    hash) is the server's exactly-once idempotency key; telemetry
    piggybacks the client's fleet snapshot (obs.telemetry). Both are
    omitted from the JSON when unset. telemetry is attached AFTER submit_id
    is computed: it must never perturb the content hash (a recomputed
    submission would otherwise mint a new submit_id and defeat exactly-once
    dedup)."""

    claim_id: int
    username: str
    client_version: str
    unique_distribution: Optional[list[UniquesDistributionSimple]]
    nice_numbers: list[NiceNumberSimple]
    submit_id: Optional[str] = None
    telemetry: Optional[dict] = None

    def to_json(self) -> dict[str, Any]:
        out = {
            "claim_id": self.claim_id,
            "username": self.username,
            "client_version": self.client_version,
            "unique_distribution": None
            if self.unique_distribution is None
            else [
                {"num_uniques": d.num_uniques, "count": d.count}
                for d in self.unique_distribution
            ],
            "nice_numbers": [
                {"number": n.number, "num_uniques": n.num_uniques}
                for n in self.nice_numbers
            ],
        }
        if self.submit_id is not None:
            out["submit_id"] = self.submit_id
        if self.telemetry is not None:
            out["telemetry"] = dict(self.telemetry)
        return out

    @staticmethod
    def from_json(d: dict[str, Any]) -> "DataToServer":
        dist = d.get("unique_distribution")
        submit_id = d.get("submit_id")
        return DataToServer(
            claim_id=int(d["claim_id"]),
            username=str(d["username"]),
            client_version=str(d["client_version"]),
            unique_distribution=None
            if dist is None
            else [
                UniquesDistributionSimple(int(x["num_uniques"]), int(x["count"]))
                for x in dist
            ],
            nice_numbers=[
                NiceNumberSimple(int(x["number"]), int(x["num_uniques"]))
                for x in d.get("nice_numbers", [])
            ],
            submit_id=None if submit_id is None else str(submit_id),
            telemetry=d.get("telemetry"),
        )
