"""Declarative SLOs with multi-window burn-rate alerting over the history
(the port's copy of nice_tpu/obs/slo.py).

An ``SloSpec`` names an objective over sampled history (obs/history.py)
rather than instantaneous gauges, in one of two shapes:

* ``quantile`` — a latency-style bound: "no more than ``objective`` of
  sampled windows may see <series> above ``threshold``" (e.g. a tenant's
  page seconds against its budget). The series are the windowed
  ``*_pNN`` quantiles the history sampler derives from histogram deltas,
  or points a caller adds itself (the scheduler adds one a page).
* ``ratio`` — an error-budget bound over counter deltas: bad/total over the
  window must stay under ``objective``.

State follows the standard multi-window burn-rate scheme: with
``burn = bad_fraction / objective`` evaluated over a short and a long
window, ``page`` requires both windows to burn above ``page_burn`` (fast
AND sustained — a single bad sample can't page), ``warn`` likewise above
``warn_burn``; anything else (including no data) is ``ok``.

The reference's two knobs are arguments here: ``SloEngine(window_scale=)``
scales every window (the reference's NICE_TPU_SLO_WINDOW_SCALE, default
1.0), and ``overrides`` maps ``<NAME>_THRESHOLD`` / ``<NAME>_OBJECTIVE``
(the SLO's name upper-cased, the reference's NICE_TPU_SLO_* family without
its prefix) to a value that replaces the spec's own. In the port the
scheduler is the engine's one user (a client-side SloEngine over its page
seconds); the server's engine stays the JAX package's.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from . import flight
from .history import HistoryStore
from .series import SLO_STATE, SLO_TRANSITIONS

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = ["SloSpec", "SloEngine", "default_specs", "tenant_specs",
           "STATE_LEVELS"]

STATE_LEVELS = {"ok": 0, "warn": 1, "page": 2}


class SloSpec:
    """One objective. ``match`` selects history series by name (prefix plus
    an optional label substring); for ``ratio`` specs ``bad_filter``
    additionally selects the bad subset of the matched series."""

    def __init__(
        self,
        name: str,
        kind: str,  # "quantile" | "ratio"
        series_prefix: str,
        label_filter: str = "",
        bad_filter: Optional[Callable[[str], bool]] = None,
        threshold: float = 0.0,
        objective: float = 0.05,
        short_secs: float = 300.0,
        long_secs: float = 3600.0,
        warn_burn: float = 1.0,
        page_burn: float = 6.0,
        description: str = "",
        overrides: Optional[Dict[str, float]] = None,
    ):
        if kind not in ("quantile", "ratio"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        self.name = name
        self.kind = kind
        self.series_prefix = series_prefix
        self.label_filter = label_filter
        self.bad_filter = bad_filter
        overrides = overrides or {}
        key = name.upper()
        self.threshold = float(overrides.get(f"{key}_THRESHOLD", threshold))
        self.objective = max(
            float(overrides.get(f"{key}_OBJECTIVE", objective)), 1e-9)
        self.short_secs = short_secs
        self.long_secs = long_secs
        self.warn_burn = warn_burn
        self.page_burn = page_burn
        self.description = description

    def matches(self, series: str) -> bool:
        return series.startswith(self.series_prefix) and (
            self.label_filter in series
        )

    # -- evaluation --------------------------------------------------------

    def _points(self, store: HistoryStore, since: float):
        out = []
        for name in store.series_names():
            if not self.matches(name):
                continue
            snap = store.query(name, since=since, tiers=("raw",))
            if snap:
                out.append((name, snap.get("raw", [])))
        return out

    def bad_fraction(self, store: HistoryStore, since: float):
        """Fraction of the error budget's denominator that went bad in the
        window, or None when the window holds no data."""
        pts = self._points(store, since)
        if self.kind == "quantile":
            values = [v for _n, raw in pts for _t, v in raw]
            if not values:
                return None
            return sum(1 for v in values if v > self.threshold) / len(values)
        total = bad = 0.0
        for name, raw in pts:
            if len(raw) < 1:
                continue
            # Counters are cumulative: the window's delta is last - first.
            delta = max(0.0, raw[-1][1] - raw[0][1])
            total += delta
            if self.bad_filter is not None and self.bad_filter(name):
                bad += delta
        if total <= 0:
            return None
        return bad / total

    def evaluate(self, store: HistoryStore, now: float,
                 window_scale: float = 1.0) -> dict:
        scale = max(float(window_scale), 1e-6)
        short = self.bad_fraction(store, now - self.short_secs * scale)
        long_ = self.bad_fraction(store, now - self.long_secs * scale)
        if short is None:
            short = long_  # sparse data: fall back to the long window
        burn_short = (short / self.objective) if short is not None else None
        burn_long = (long_ / self.objective) if long_ is not None else None
        if burn_short is None or burn_long is None:
            state = "ok"
        elif burn_short >= self.page_burn and burn_long >= self.page_burn:
            state = "page"
        elif burn_short >= self.warn_burn and burn_long >= self.warn_burn:
            state = "warn"
        else:
            state = "ok"
        return {
            "slo": self.name,
            "kind": self.kind,
            "state": state,
            "level": STATE_LEVELS[state],
            "burn_short": burn_short,
            "burn_long": burn_long,
            "threshold": self.threshold,
            "objective": self.objective,
            "no_data": burn_long is None,
            "description": self.description,
        }


def default_specs(overrides: Optional[Dict[str, float]] = None
                  ) -> List[SloSpec]:
    """The reference's fleet SLOs, over the series its server samples."""
    return [
        SloSpec(
            "claim_p99", "quantile",
            series_prefix="nice_api_request_seconds_p99",
            label_filter='endpoint="/claim',
            threshold=0.5, objective=0.10,
            description="claim endpoints p99 <= 500ms for 90% of windows",
            overrides=overrides,
        ),
        SloSpec(
            "submit_success", "ratio",
            series_prefix="nice_api_requests_total",
            label_filter='endpoint="/submit',
            bad_filter=lambda s: 'status="5' in s,
            objective=0.01,
            description="submit 5xx ratio <= 1%",
            overrides=overrides,
        ),
        SloSpec(
            "feed_idle_p95", "quantile",
            series_prefix="nice_mesh_feed_idle_seconds_p95",
            threshold=0.05, objective=0.25,
            description="host->device feed idle p95 <= 50ms for 75% of "
                        "windows (chips should never starve)",
            overrides=overrides,
        ),
        SloSpec(
            "spot_check_fail", "ratio",
            series_prefix="nice_server_spot_checks_total",
            label_filter='verdict="',
            bad_filter=lambda s: 'verdict="fail"' in s,
            objective=0.05,
            description="spot-verification failure ratio <= 5%",
            overrides=overrides,
        ),
    ]


def tenant_specs(pairs, overrides: Optional[Dict[str, float]] = None
                 ) -> List[SloSpec]:
    """Per-tenant page-latency SLOs for the multi-tenant scheduler.

    ``pairs`` is an iterable of ``(tenant_name, page_budget_secs)``; tenants
    with a zero/negative budget get no spec. Windows are short (60s/300s)
    because the scheduler feeds one point per page and reacts at page
    granularity — the usual fleet-scale hour window would lag the
    preemption decision it exists to drive. Thresholds and objectives stay
    overridable through ``overrides`` like every other spec.
    """
    specs: List[SloSpec] = []
    for name, budget_secs in pairs:
        if budget_secs is None or budget_secs <= 0:
            continue
        specs.append(SloSpec(
            f"tenant_{name}", "quantile",
            series_prefix="nice_sched_page_seconds",
            label_filter=f'tenant="{name}"',
            threshold=float(budget_secs), objective=0.25,
            short_secs=60.0, long_secs=300.0,
            description=f"tenant {name}: page latency <= {budget_secs:g}s "
                        "for 75% of pages",
            overrides=overrides,
        ))
    return specs


class SloEngine:
    """Evaluates a spec list against a HistoryStore, tracking state
    transitions. Thread-safe: evaluate() runs on the scheduler's page loop
    and its sched-slo thread while last() may be read from another."""

    def __init__(self, store: HistoryStore,
                 specs: Optional[List[SloSpec]] = None,
                 window_scale: float = 1.0):
        self.store = store
        self.specs = specs if specs is not None else default_specs()
        self.window_scale = window_scale
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}
        self._last: List[dict] = []
        self.transitions = 0

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        now = time.time() if now is None else now
        results = []
        for spec in self.specs:
            try:
                res = spec.evaluate(self.store, now, self.window_scale)
            except Exception:  # noqa: BLE001 — one bad spec (a caller's
                # bad_filter) must not stop the others, as in the reference
                log.exception("SLO %s failed to evaluate", spec.name)
                continue
            results.append(res)
            SLO_STATE.labels(spec.name).set(res["level"])
            with self._lock:
                prev = self._states.get(spec.name, "ok")
                self._states[spec.name] = res["state"]
                if res["state"] != prev:
                    self.transitions += 1
                    SLO_TRANSITIONS.labels(spec.name, res["state"]).inc()
                    flight.record(
                        "slo_transition", slo=spec.name,
                        from_state=prev, to_state=res["state"],
                        burn_short=res["burn_short"],
                        burn_long=res["burn_long"],
                    )
        with self._lock:
            self._last = results
        return results

    def last(self) -> List[dict]:
        with self._lock:
            return list(self._last)
