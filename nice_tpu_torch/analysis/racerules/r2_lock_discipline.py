"""R2: lock discipline against the declared ownership contract.

* every ``lock:<label>`` SHARED_STATE field is written only while the
  named lock is lexically held;
* ``owner:<root>`` fields are written only by code reachable from that
  root (plus construction);
* ``immutable-after-init`` fields have no post-init writes at all;
* every ``lockdep.make_lock`` label in the tree has a LockSpec (and every
  LockSpec still names a live label) — the lock inventory is part of the
  contract;
* the static X1 acquisition graph unioned with the runtime lockdep graph
  (``analysis/lockorder.json``, exported by ``python -m
  nice_tpu_torch.utils.lockdep --dump-graph``) must stay acyclic: a cycle
  that only appears in the union is a static/runtime order divergence —
  two halves of the code each locally consistent, jointly a deadlock —
  flagged here before it can happen live.
"""

from __future__ import annotations

from typing import Dict, List, Set

from nice_tpu_torch.analysis import threadspec
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.racerules import rrule
from nice_tpu_torch.analysis.racerules.context import LOCKORDER_RELPATH
from nice_tpu_torch.analysis.rules.x1_lock_order import _find_cycle

THREADSPEC_PATH = "nice_tpu_torch/analysis/threadspec.py"


@rrule("R2")
def check(project: Project, ctx) -> List[Violation]:
    out: List[Violation] = []

    # 1. SHARED_STATE declarations vs observed write sites
    for decl in threadspec.SHARED_STATE:
        ident = (decl.path, decl.scope, decl.attr)
        sites = ctx.writes.get(ident, [])
        label = decl.lock_label
        owner = decl.owner_root
        if label is not None:
            for site in sites:
                if label not in site.held:
                    out.append(Violation(
                        "R2", site.path, site.line,
                        f"{decl.scope}.{decl.attr} is declared "
                        f"lock:{label} but this write in {site.func} does "
                        "not hold it",
                        detail=f"unlocked:{decl.scope}.{decl.attr}:"
                               f"{site.func.rsplit('.', 1)[-1]}",
                    ))
        elif owner is not None:
            for site in sites:
                roots = ctx.roots_reaching((site.path, site.func))
                foreign = roots - {owner}
                if foreign:
                    out.append(Violation(
                        "R2", site.path, site.line,
                        f"{decl.scope}.{decl.attr} is declared "
                        f"owner:{owner} but {site.func} is reachable from "
                        f"{', '.join(sorted(foreign))}",
                        detail=f"foreign-write:{decl.scope}.{decl.attr}:"
                               f"{site.func.rsplit('.', 1)[-1]}",
                    ))
        elif decl.ownership == "immutable-after-init":
            for site in sites:
                out.append(Violation(
                    "R2", site.path, site.line,
                    f"{decl.scope}.{decl.attr} is declared immutable-"
                    f"after-init but {site.func} writes it",
                    detail=f"mutated-immutable:{decl.scope}.{decl.attr}",
                ))
        # queue-transferred / atomic carry no static obligation

    # 2. lock inventory coverage
    for label, (path, line) in sorted(ctx.lock_labels.items()):
        if threadspec.lock_spec(label) is None:
            out.append(Violation(
                "R2", path, line,
                f"lock {label!r} has no LockSpec in "
                "analysis/threadspec.py — declare what it guards and "
                "whether blocking under it is legitimate",
                detail=f"undeclared-lock:{label}",
            ))
    for spec in threadspec.LOCK_SPECS:
        if spec.label not in ctx.lock_labels:
            out.append(Violation(
                "R2", THREADSPEC_PATH, 1,
                f"stale LockSpec {spec.label!r}: no make_lock with that "
                "label in the tree",
                detail=f"stale-lock:{spec.label}",
            ))

    # 3. static/runtime lock-order cross-check
    if not ctx.runtime_edges:
        out.append(Violation(
            "R2", THREADSPEC_PATH, 1,
            f"no runtime lock-order graph ({ctx.runtime_graph_path} missing "
            "or empty) — regenerate with `python -m nice_tpu_torch.utils."
            f"lockdep --device cuda --dump-graph {LOCKORDER_RELPATH}`",
            detail="missing-lockorder",
        ))
    else:
        union: Dict[str, Set[str]] = {
            k: set(v) for k, v in ctx.static_edges.items()}
        for outer, inners in ctx.runtime_edges.items():
            union.setdefault(outer, set()).update(inners)
        cycle = _find_cycle(union)
        if cycle and not _find_cycle(ctx.static_edges) \
                and not _find_cycle(ctx.runtime_edges):
            out.append(Violation(
                "R2", THREADSPEC_PATH, 1,
                "static/runtime lock-order divergence: the union of the "
                f"X1 static graph and {ctx.runtime_graph_path} contains the "
                "cycle " + " -> ".join(cycle) + " — two locally "
                "consistent orders that jointly deadlock",
                detail="order-divergence:" + "->".join(sorted(set(cycle))),
            ))
    return out
