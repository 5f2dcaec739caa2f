"""Tenant specs and the registry for the multi-tenant scheduler (the
port's copy of nice_tpu/sched/tenants.py).

A tenant is one named (mode, base) workload with its own priority, page-
latency SLO budget, optional base window (claim routing predicate), and its
own kernel-shape winners: the scheduler applies ``resolve_tuning`` per
tenant, so a hi-base detailed tenant and a low-base niceonly tenant each
run their tuned batch/megaloop shape while sharing one device.

Spec grammar (the client's --tenants): semicolon-separated entries

    name:mode:base[:opt...]

where mode is ``detailed``, ``niceonly``, or one of the two built-in
scenario kinds — ``near-miss`` (standing low-priority NEAR_MISS_CUTOFF
re-scan of canon fields, runs the detailed engine) and ``hi-base``
(bases>510 sweep exercising the widened histogram tile) — and opts are
``prio=N``, ``slo=SECS``, ``bases=LO-HI``, ``batch=N``, ``backend=NAME``
(the port's backends: ``device``, the default, ``scalar`` and ``native``;
a tenant runs on the scheduler's device).

Example::

    canon:detailed:40:prio=3:slo=5;mining:near-miss:40;sweep:hi-base:520
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

from nice_tpu_torch.ops.engine import BACKENDS

# Bases at or below this fit the reference's pre-widening histogram tile
# (4 rows of 128 bins); the hi-base sweep kind exists to exercise bases
# ABOVE it. The port's kernels hold up to cuda_engine.MAX_HIST_BINS bins,
# so the floor is the reference's, kept for the same grammar.
HI_BASE_FLOOR = 510

_MODES = ("detailed", "niceonly")
_KINDS = ("standard", "near_miss", "hi_base_sweep")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One named workload. ``base`` is the claim default (and the engine
    plan when the source runs local fields); ``base_min``/``base_max``
    widen the claim window for sweep tenants. ``slo_page_secs`` <= 0 means
    no latency objective (the tenant never earns an SLO boost)."""

    name: str
    mode: str
    base: int
    priority: int = 1
    slo_page_secs: float = 0.0
    base_min: Optional[int] = None
    base_max: Optional[int] = None
    backend: str = "device"
    batch_size: Optional[int] = None
    kind: str = "standard"

    def __post_init__(self) -> None:
        if not self.name or any(c in self.name for c in ":;= \t\n"):
            raise ValueError(f"bad tenant name {self.name!r}")
        if self.mode not in _MODES:
            raise ValueError(
                f"tenant {self.name}: mode must be one of {_MODES}, got"
                f" {self.mode!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"tenant {self.name}: backend must be one of {BACKENDS},"
                f" got {self.backend!r}"
            )
        if self.kind not in _KINDS:
            raise ValueError(f"tenant {self.name}: unknown kind {self.kind!r}")
        if self.base < 4:
            raise ValueError(f"tenant {self.name}: base {self.base} < 4")
        if self.kind == "hi_base_sweep" and self.base <= HI_BASE_FLOOR:
            raise ValueError(
                f"tenant {self.name}: hi-base sweep needs base >"
                f" {HI_BASE_FLOOR}, got {self.base}"
            )
        if (
            self.base_min is not None
            and self.base_max is not None
            and self.base_min > self.base_max
        ):
            raise ValueError(
                f"tenant {self.name}: bases window {self.base_min}-"
                f"{self.base_max} is empty"
            )

    @property
    def claim_base_min(self) -> int:
        """Claim routing lower bound: the window when set, else the pinned
        base (a tenant never drains another tenant's base inventory)."""
        return self.base if self.base_min is None else self.base_min

    @property
    def claim_base_max(self) -> int:
        return self.base if self.base_max is None else self.base_max


def near_miss_tenant(
    base: int, name: str = "near-miss", priority: int = 0,
    slo_page_secs: float = 0.0,
) -> TenantSpec:
    """The standing near-miss mining tenant: a low-priority detailed
    re-scan of canon fields whose value is the NEAR_MISS_CUTOFF list (the
    detailed engine already emits every number at or above the cutoff);
    priority 0 means it only runs when higher tenants leave the mesh
    idle under the deficit policy."""
    return TenantSpec(
        name=name, mode="detailed", base=base, priority=priority,
        slo_page_secs=slo_page_secs, kind="near_miss",
    )


def hi_base_sweep_tenant(
    base: int = 520, name: str = "hi-base", priority: int = 1,
    slo_page_secs: float = 0.0,
) -> TenantSpec:
    """The bases>510 sweep tenant: detailed scans above the pre-widening
    histogram-tile floor, exercising the widened (up to 16-row) tile."""
    return TenantSpec(
        name=name, mode="detailed", base=base, priority=priority,
        slo_page_secs=slo_page_secs, kind="hi_base_sweep",
    )


def _parse_one(entry: str) -> TenantSpec:
    parts = [p.strip() for p in entry.split(":")]
    if len(parts) < 3:
        raise ValueError(
            f"tenant entry {entry!r}: want name:mode:base[:opt...]"
        )
    name, mode_arg, base_arg = parts[0], parts[1].lower(), parts[2]
    try:
        base = int(base_arg)
    except ValueError:
        raise ValueError(f"tenant {name}: base must be an integer, got"
                         f" {base_arg!r}")
    opts: dict = {}
    for opt in parts[3:]:
        if not opt:
            continue
        key, _, val = opt.partition("=")
        if key == "prio":
            opts["priority"] = int(val)
        elif key == "slo":
            opts["slo_page_secs"] = float(val)
        elif key == "bases":
            lo, _, hi = val.partition("-")
            opts["base_min"] = int(lo)
            opts["base_max"] = int(hi) if hi else int(lo)
        elif key == "batch":
            opts["batch_size"] = int(val)
        elif key == "backend":
            opts["backend"] = val
        else:
            raise ValueError(f"tenant {name}: unknown option {key!r}")
    if mode_arg == "near-miss":
        opts.setdefault("priority", 0)
        return TenantSpec(name=name, mode="detailed", base=base,
                          kind="near_miss", **opts)
    if mode_arg == "hi-base":
        return TenantSpec(name=name, mode="detailed", base=base,
                          kind="hi_base_sweep", **opts)
    return TenantSpec(name=name, mode=mode_arg, base=base, **opts)


def parse_tenants(text: str) -> list[TenantSpec]:
    """Parse the --tenants grammar into specs (see module doc)."""
    specs = []
    for entry in text.split(";"):
        entry = entry.strip()
        if entry:
            specs.append(_parse_one(entry))
    return specs


class TenantRegistry:
    """Ordered set of uniquely-named tenants. Iteration order is
    registration order — the round-robin baseline every policy falls back
    to on ties."""

    def __init__(self, specs=()):
        self._specs: dict[str, TenantSpec] = {}
        for spec in specs:
            self.add(spec)

    def add(self, spec: TenantSpec) -> TenantSpec:
        if spec.name in self._specs:
            raise ValueError(f"duplicate tenant name {spec.name!r}")
        self._specs[spec.name] = spec
        return spec

    def replace(self, spec: TenantSpec) -> TenantSpec:
        """Swap in a new spec under an existing name (the mid-run priority
        flip sched_smoke exercises). The name must already be registered."""
        if spec.name not in self._specs:
            raise KeyError(f"no tenant {spec.name!r}")
        self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> TenantSpec:
        return self._specs[name]

    def names(self) -> list[str]:
        return list(self._specs)

    def __iter__(self) -> Iterator[TenantSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def slo_pairs(self) -> list[tuple[str, float]]:
        """(name, page budget secs) pairs for obs.slo.tenant_specs."""
        return [(s.name, s.slo_page_secs) for s in self]
