"""racelint of the port: thread-ownership race analysis of nice_tpu_torch/
and chip_smoke.py (the twin of scripts/racelint.py).

Checks the tree against the declared threading contract in
nice_tpu_torch/analysis/threadspec.py (ThreadRegistry, LockSpecs,
SHARED_STATE ownership): spawn-site coverage, multi-root unguarded
mutation (R1), lock discipline with the static/runtime order cross-check
against nice_tpu_torch/analysis/lockorder.json (R2), blocking under a lock
(R3) and check-then-act atomicity (R5). Shares the port's ratchet baseline,
escape grammar and S1 audit with nicelint and cudalint.

    python -m nice_tpu_torch.scripts.racelint               # vs the baseline
    python -m nice_tpu_torch.scripts.racelint --strict      # also fail stale
                                                            # baseline entries
    python -m nice_tpu_torch.scripts.racelint --update-baseline
    python -m nice_tpu_torch.scripts.racelint --json out.json
    python -m nice_tpu_torch.scripts.racelint --rules R1,R5
    python -m nice_tpu_torch.scripts.racelint --list-roots

Exit codes: 0 clean, 1 new violations (or stale baseline entries under
--strict), 2 usage or internal error.
"""

from __future__ import annotations

import os
import sys

from nice_tpu_torch.analysis import cli, core, racerules, threadspec
from nice_tpu_torch.analysis.racerules import context as racectx


def _list_roots() -> int:
    for root in threadspec.THREAD_ROOTS:
        locks = f" locks={','.join(root.locks)}" if root.locks else ""
        print(f"{root.name:24s} {root.kind:11s} {root.role:12s} "
              f"{root.path}:{root.spawn_scope}"
              f"{'' if root.may_block else ' no-block'}{locks}")
    print(f"{len(threadspec.THREAD_ROOTS)} roots, "
          f"{len(threadspec.LOCK_SPECS)} lock specs, "
          f"{len(threadspec.SHARED_STATE)} shared-state declarations")
    return 0


def main(argv=None) -> int:
    ap = cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--lockorder", metavar="PATH",
                    help="runtime lock-order graph for the R2 cross-check "
                         f"(default {racectx.LOCKORDER_RELPATH})")
    ap.add_argument("--list-roots", action="store_true",
                    help="print the ThreadRegistry and exit")
    args = ap.parse_args(argv)
    if args.list_roots:
        return _list_roots()

    root = os.path.abspath(args.root)
    ctx = racectx.build_context(root, core.Project(root),
                                lockorder_path=args.lockorder)
    print(f"racelint: {ctx.report['spawn_sites']} spawn sites, "
          f"{len(threadspec.THREAD_ROOTS)} registered roots, "
          f"{ctx.report['lock_labels']} locks, "
          f"{ctx.report['shared_write_identities']} write identities, "
          f"static edges {ctx.report['static_edges']}, "
          f"runtime edges {ctx.report['runtime_edges']}")
    extra = {"registry": {"roots": len(threadspec.THREAD_ROOTS),
                          "lock_specs": len(threadspec.LOCK_SPECS),
                          "shared_state": len(threadspec.SHARED_STATE)},
             "context": ctx.report}
    return cli.main(
        "racelint", args, set(racerules.all_rrules()),
        lambda project, only: racerules.run_race_rules(project, ctx, only),
        extra=extra)


if __name__ == "__main__":
    sys.exit(main())
