"""R1: shared-attribute mutation across thread roots + the coverage gate.

Two checks:

1. **Coverage gate** — every ``Thread(`` / ``ThreadPoolExecutor(`` /
   ``ThreadingHTTPServer(`` construction in ``nice_tpu_torch/`` (but
   ``analysis/``) and ``chip_smoke.py`` must match a ThreadRegistry entry
   by (file, enclosing scope, kind); a registered root whose spawn site no
   longer exists is stale. The registry only stays the ground truth if
   drifting from it is a finding.

2. **Multi-root unguarded mutation** — an attribute or module global
   written by functions reachable from ≥2 registered roots, where the
   write sites share NO common lock label and the object carries no
   ownership declaration in ``threadspec.SHARED_STATE``. Declared objects
   are R2's job (checked against their declaration).
"""

from __future__ import annotations

from typing import List

from nice_tpu_torch.analysis import threadspec
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.racerules import rrule


@rrule("R1")
def check(project: Project, ctx) -> List[Violation]:
    out: List[Violation] = []

    # 1a. unregistered spawn sites
    registered = threadspec.roots_by_site()
    for site in ctx.spawn_sites:
        if (site.path, site.scope, site.kind) not in registered:
            out.append(Violation(
                "R1", site.path, site.line,
                f"unregistered {site.kind} spawn ({site.call}) in "
                f"{site.scope} — declare a ThreadRoot in "
                "analysis/threadspec.py so racelint knows its role, locks "
                "and blocking budget",
                detail=f"unregistered-{site.kind}:{site.scope}",
            ))

    # 1b. stale registry entries
    seen = {(s.path, s.scope, s.kind) for s in ctx.spawn_sites}
    for root in threadspec.THREAD_ROOTS:
        if (root.path, root.spawn_scope, root.kind) not in seen:
            out.append(Violation(
                "R1", root.path, 1,
                f"stale ThreadRoot {root.name!r}: no {root.kind} spawn in "
                f"{root.spawn_scope} — update analysis/threadspec.py",
                detail=f"stale-root:{root.name}",
            ))

    # 2. multi-root unguarded writes of undeclared state
    for (path, scope, attr), sites in sorted(ctx.writes.items()):
        if attr.startswith("__"):
            continue
        if threadspec.shared_state_for(path, scope, attr) is not None:
            continue  # declared: R2 verifies the declaration instead
        roots = set()
        for site in sites:
            roots |= ctx.roots_reaching((site.path, site.func))
        if len(roots) < 2:
            continue
        common = None
        for site in sites:
            common = site.held if common is None else (common & site.held)
        if common:
            continue
        first = min(sites, key=lambda s: s.line)
        out.append(Violation(
            "R1", path, first.line,
            f"{scope}.{attr} mutated from {len(roots)} thread roots "
            f"({', '.join(sorted(roots))}) with no common lock and no "
            "SHARED_STATE declaration — declare ownership in "
            "analysis/threadspec.py or guard every write",
            detail=f"shared:{scope}.{attr}",
        ))
    return out
