"""Field sources for the multi-tenant scheduler (the port's copy of
nice_tpu/sched/source.py).

A source answers two questions per tenant: "what field should this tenant
run next?" and "what happens to a finished field's results?". StaticSource
serves a pre-built local list and collects results (tests, bench);
ServerSource claims from a live coordination server with tenant routing
(the claim row carries the tenant name, the claim engine restricts to the
tenant's base window) and submits results through the ordinary ledger
path, so a scheduler field is indistinguishable from a single-workload
client's field downstream of /submit.
"""

from __future__ import annotations

import logging
from typing import Optional

from nice_tpu_torch.core.types import FieldResults, SearchMode
from nice_tpu_torch.sched.tenants import TenantSpec

log = logging.getLogger("nice_tpu_torch.sched")

# (field_key, base, range_start, range_end)
FieldHandle = tuple[str, int, int, int]


class StaticSource:
    """Local fields per tenant; completed results are collected for the
    caller to inspect. ``fields`` maps tenant name to a list of
    (field_key, base, start, end) tuples."""

    def __init__(self, fields: dict[str, list[FieldHandle]]):
        self._pending = {name: list(items) for name, items in fields.items()}
        self.results: dict[str, dict[str, FieldResults]] = {
            name: {} for name in fields
        }

    def next_field(self, spec: TenantSpec) -> Optional[FieldHandle]:
        queue = self._pending.get(spec.name)
        if not queue:
            return None
        return queue.pop(0)

    def complete(self, spec: TenantSpec, field_key: str,
                 results: FieldResults) -> None:
        self.results.setdefault(spec.name, {})[field_key] = results


class ServerSource:
    """Claims and submits against a live server, one claim per field.

    ``fields_per_tenant`` bounds how many fields each tenant will claim
    (None = until the server runs dry); a failed claim marks the tenant
    exhausted rather than crashing the scheduler — other tenants keep the
    device busy. A finished field is submitted through the client's
    compile_results and the transport's failover list."""

    def __init__(self, api_base: str, username: str,
                 fields_per_tenant: Optional[int] = None,
                 max_retries: int = 3):
        self.api_base = api_base
        self.username = username
        self.fields_per_tenant = fields_per_tenant
        self.max_retries = max_retries
        self._claims: dict[str, object] = {}
        self._claimed_count: dict[str, int] = {}
        self.submitted: dict[str, list[int]] = {}

    def _mode(self, spec: TenantSpec) -> SearchMode:
        return (
            SearchMode.DETAILED if spec.mode == "detailed"
            else SearchMode.NICEONLY
        )

    def next_field(self, spec: TenantSpec) -> Optional[FieldHandle]:
        from nice_tpu_torch.client import api_client

        taken = self._claimed_count.get(spec.name, 0)
        if (
            self.fields_per_tenant is not None
            and taken >= self.fields_per_tenant
        ):
            return None
        try:
            data = api_client.get_field_from_server(
                self._mode(spec), self.api_base, self.username,
                max_retries=self.max_retries,
                tenant=spec.name,
                base_min=spec.claim_base_min,
                base_max=spec.claim_base_max,
            )
        except api_client.ApiError as e:
            log.warning("tenant %s: claim failed (%s); marking exhausted",
                        spec.name, e)
            return None
        self._claimed_count[spec.name] = taken + 1
        field_key = f"{spec.name}/claim{data.claim_id}"
        self._claims[field_key] = data
        return field_key, data.base, data.range_start, data.range_end

    def complete(self, spec: TenantSpec, field_key: str,
                 results: FieldResults) -> None:
        from nice_tpu_torch.client import api_client
        from nice_tpu_torch.client.main import compile_results

        data = self._claims.pop(field_key)
        payload = compile_results(
            data, results, self._mode(spec), self.username
        )
        api_client.submit_field_to_server(
            self.api_base, payload, max_retries=self.max_retries
        )
        self.submitted.setdefault(spec.name, []).append(data.claim_id)
