"""racelint of the port: thread-ownership race analysis (the R-rule family;
the twin of nice_tpu/analysis/racerules/).

nicelint reads the port's AST for its invariants and cudalint its kernel
specs; this family reads the AST AGAINST the declared threading contract
in ``analysis/threadspec.py``: who may touch which shared state from which
thread root. Same ratchet baseline (``analysis/baseline.json``), same
``# nicelint: allow`` escape grammar, same strict gate.

Rules:

* **R1 shared-mutation** — an attribute or module global mutated by code
  reachable from ≥2 registered thread roots with no common guarding lock
  and no ownership declaration; plus the coverage gate itself (an
  unregistered ``Thread(``/pool spawn, or a stale registry entry).
* **R2 lock-discipline** — every declared ``lock:<label>`` field is
  written only under that lock; owner-only fields only from their root's
  reachable set; immutable-after-init fields only from ``__init__``; the
  static X1 acquisition graph unioned with the runtime lockdep graph
  (``analysis/lockorder.json``) must stay acyclic, so a static/runtime
  order divergence is flagged before it deadlocks live.
* **R3 blocking-under-lock** — blocking calls (file I/O, subprocess,
  HTTP waits, ``Future.result``, ``queue.get`` without timeout,
  ``time.sleep``) reachable from a ``may_block=False`` root or lexically
  inside a lock whose LockSpec says ``may_block_under=False``.
* **R5 check-then-act** — a read of a shared dict/cache under a lock,
  an unlocked window, then a write under the same lock in one function
  (the ``_cached_mesh`` / failover-cursor shape), and any ``lru_cache``
  whose ``cache_clear`` is invoked at runtime (an unguardable
  clear/rebuild window).

R4 (the server's writer actor) stays the reference's: the port has no
server. Run ``python -m nice_tpu_torch.scripts.racelint``. The dynamic
half is ``analysis/schedex.py``: racelint proves discipline statically,
schedex replays the interleavings that motivated it
(``python -m nice_tpu_torch.scripts.racecheck``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from nice_tpu_torch.analysis import core

_RRULES: Dict[str, object] = {}


def rrule(rule_id: str):
    def deco(fn):
        _RRULES[rule_id] = fn
        return fn
    return deco


def all_rrules() -> Dict[str, object]:
    # Import side-effect registers every R-rule module exactly once.
    from nice_tpu_torch.analysis.racerules import (  # noqa: F401
        r1_shared_mutation, r2_lock_discipline, r3_blocking,
        r5_check_then_act,
    )
    return dict(_RRULES)


def run_race_rules(
    project: core.Project,
    ctx,
    only: Optional[Iterable[str]] = None,
):
    """(violations, used allow sites) over a built RaceContext, through the
    shared nicelint runner so inline escapes work identically."""
    registry = {
        rule_id: (lambda p, _fn=fn: _fn(p, ctx))
        for rule_id, fn in all_rrules().items()
    }
    return core.run_rules_tracked(project, only=only, registry=registry)
