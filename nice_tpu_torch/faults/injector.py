"""Deterministic, seeded fault injection (the port's copy of
nice_tpu/faults/injector.py; the spec and its seed are arguments of
configure(), the client's --faults and --faults-seed).

    --faults "http.submit:drop_response@0.3,engine.dispatch:raise@batch=7"
    --faults-seed 42

Grammar: comma-separated rules, each `site:action[@selector]`.

  site      dotted injection-point name
  action    what the site does when the rule fires
  selector  when the rule fires:
              @0.3       float -> independent per-call probability, drawn
                         from a per-rule RNG seeded by the seed (same seed
                         + same call sequence = same faults, and one
                         rule's draws never perturb another's)
              @2         bare int -> the Nth eligible call at the site,
                         exactly once
              @key=val   fires once, on the first call whose ctx has
                         str(ctx[key]) == val (e.g. engine.dispatch with
                         batch=7)
              (omitted)  every eligible call

The port's sites (SITES) and their actions:
  http.<endpoint>   drop_response (the request reaches the server, the
                    client sees a network error), conn_error / raise, or an
                    HTTP status code (client/api_client.py);
  engine.dispatch   raise: the field raises (there is no downgrade chain;
                    ops/engine.py);
  ckpt.write        truncate: the snapshot is written short
                    (ckpt/snapshot.py).

Where the reference lets an unknown site parse and never match, and passes
an unknown http action through to the real request, configure() raises on
either: a spec names only faults that can happen.

fire() costs one attribute check when no spec is configured.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass, field
from typing import Optional

from nice_tpu_torch.obs import flight
from nice_tpu_torch.obs.series import FAULTS_INJECTED

log = logging.getLogger("nice_tpu_torch.faults")

DEFAULT_SEED = 0

# site (or site prefix ending in ".") -> the actions it takes; "<status>" is
# any integer HTTP status.
SITES = {
    "http.": ("drop_response", "conn_error", "raise", "<status>"),
    "engine.dispatch": ("raise",),
    "ckpt.write": ("truncate",),
}


class FaultSpecError(ValueError):
    """Malformed fault spec, or one naming a site or action the port has
    not got."""


@dataclass
class _Rule:
    site: str
    action: str
    # Exactly one selector kind is set:
    probability: Optional[float] = None
    nth: Optional[int] = None
    match: Optional[tuple[str, str]] = None  # (ctx key, value as str)
    always: bool = False
    # Mutable firing state:
    calls: int = 0
    fired: bool = False
    rng: random.Random = field(default_factory=random.Random)

    def should_fire(self, ctx: dict) -> bool:
        self.calls += 1
        if self.probability is not None:
            return self.rng.random() < self.probability
        if self.nth is not None:
            if self.fired or self.calls != self.nth:
                return False
            self.fired = True
            return True
        if self.match is not None:
            if self.fired:
                return False
            key, want = self.match
            if key not in ctx or str(ctx[key]) != want:
                return False
            self.fired = True
            return True
        return self.always


def parse_spec(spec: str, seed: int = DEFAULT_SEED) -> list[_Rule]:
    """Parse a spec string into rules (see the module note); the grammar
    alone, sites and actions unchecked (configure() checks them)."""
    rules: list[_Rule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise FaultSpecError(
                f"fault rule {part!r} has no action (want site:action[@selector])"
            )
        site, rest = part.split(":", 1)
        site = site.strip()
        selector = None
        if "@" in rest:
            action, selector = rest.split("@", 1)
        else:
            action = rest
        action = action.strip()
        if not site or not action:
            raise FaultSpecError(f"fault rule {part!r} has an empty site or action")
        rule = _Rule(site=site, action=action)
        # Per-(site, rule-ordinal) RNG stream: probability draws are
        # reproducible per site regardless of interleaving with other sites.
        rule.rng = random.Random(f"{seed}:{site}:{len(rules)}")
        if selector is not None:
            selector = selector.strip()
            if "=" in selector:
                key, val = selector.split("=", 1)
                rule.match = (key.strip(), val.strip())
            elif "." in selector or "e" in selector.lower():
                try:
                    rule.probability = float(selector)
                except ValueError:
                    raise FaultSpecError(
                        f"fault rule {part!r}: bad probability {selector!r}"
                    )
                if not 0.0 <= rule.probability <= 1.0:
                    raise FaultSpecError(
                        f"fault rule {part!r}: probability must be in [0, 1]"
                    )
            else:
                try:
                    rule.nth = int(selector)
                except ValueError:
                    raise FaultSpecError(
                        f"fault rule {part!r}: bad selector {selector!r}"
                    )
                if rule.nth < 1:
                    raise FaultSpecError(
                        f"fault rule {part!r}: Nth-call selector must be >= 1"
                    )
        else:
            rule.always = True
        rules.append(rule)
    return rules


def check_rule(rule: _Rule) -> None:
    """Raise FaultSpecError unless the port has the rule's site and its
    site takes the rule's action."""
    for site, actions in SITES.items():
        if (rule.site.startswith(site) and len(rule.site) > len(site)
                if site.endswith(".") else rule.site == site):
            if rule.action in actions or (
                    "<status>" in actions and rule.action.isdigit()):
                return
            raise FaultSpecError(
                f"site {rule.site!r} has no action {rule.action!r} "
                f"(one of {', '.join(actions)})")
    raise FaultSpecError(f"the port has no fault site {rule.site!r} "
                         f"(sites: {', '.join(SITES)})")


class FaultPlan:
    """Active rule set, indexed by site. Thread-safe: fire() may be called
    concurrently from the dispatcher, the collector and the transport's
    threads."""

    def __init__(self, rules: list[_Rule]):
        self._lock = threading.Lock()
        self.by_site: dict[str, list[_Rule]] = {}
        for r in rules:
            self.by_site.setdefault(r.site, []).append(r)

    def fire(self, site: str, ctx: dict) -> Optional[str]:
        rules = self.by_site.get(site)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if rule.should_fire(ctx):
                    FAULTS_INJECTED.labels(site, rule.action).inc()
                    flight.record("fault", site=site, action=rule.action)
                    log.warning(
                        "injected fault at %s: action=%s ctx=%s (call %d)",
                        site, rule.action, ctx, rule.calls,
                    )
                    return rule.action
        return None


_EMPTY = FaultPlan([])
_plan: FaultPlan = _EMPTY
_plan_lock = threading.Lock()


def configure(spec: Optional[str] = None, seed: Optional[int] = None) -> None:
    """Install a fault plan. spec=None or "" clears every rule; a rule the
    port cannot fire raises FaultSpecError and leaves the plan as it was."""
    global _plan
    rules = parse_spec(spec, DEFAULT_SEED if seed is None else int(seed)) \
        if spec else []
    for rule in rules:
        check_rule(rule)
    with _plan_lock:
        _plan = FaultPlan(rules) if rules else _EMPTY
    if rules:
        log.warning("fault injection ACTIVE (--faults %r, seed %d)", spec,
                    DEFAULT_SEED if seed is None else int(seed))


def reset() -> None:
    """Drop the active plan (tests)."""
    configure(None)


def fire(site: str, **ctx) -> Optional[str]:
    """The injection hook: returns the action string when a rule fires at
    this site for this call, else None."""
    plan = _plan
    if not plan.by_site:
        return None
    return plan.fire(site, ctx)


def armed(site: str) -> bool:
    """Whether a rule is configured at `site`: a hot loop asks once and
    calls fire() only then."""
    return site in _plan.by_site


def active_sites() -> tuple[str, ...]:
    """Sites with at least one configured rule (diagnostics)."""
    return tuple(sorted(_plan.by_site))
