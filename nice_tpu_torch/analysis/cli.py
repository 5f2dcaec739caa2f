"""What the two linters' command lines share (scripts/nicelint.py and
scripts/cudalint.py): the ratchet flags, the S1 audit on full runs, the
baseline slice of the family, the report and the exit code.

Exit codes: 0 clean, 1 new violations (or stale baseline entries under
--strict), 2 usage or internal error.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional, Set, Tuple

from nice_tpu_torch.analysis import core
from nice_tpu_torch.utils import fsio

# The repository root: the directory that holds the nice_tpu_torch package.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RunFamily = Callable[[core.Project, Optional[List[str]]],
                     Tuple[List[core.Violation], List[core.Violation],
                           Set[core.AllowSite]]]


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--root", default=REPO_ROOT,
                    help="the tree to lint (the directory holding "
                         "nice_tpu_torch/)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite this family's slice of the shared "
                         "baseline to the current findings")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--rules", metavar="IDS",
                    help="comma-separated rule subset")
    return ap


def main(prog: str, args: argparse.Namespace, rule_ids: Set[str],
         run_family: RunFamily, extra: Optional[Dict] = None,
         show_allowed: bool = False) -> int:
    """Runs the family, ratchets it against its slice of the baseline and
    prints the result; returns the exit code. show_allowed also prints the
    findings an inline marker allows (cudalint's known domain findings)."""
    only = None
    if args.rules:
        only = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = sorted(set(only) - rule_ids)
        if unknown:
            print(f"{prog}: unknown rules {unknown} (family: "
                  f"{sorted(rule_ids)})")
            return 2
    root = os.path.abspath(args.root)
    project = core.Project(root)
    violations, allowed, used = run_family(project, only)
    if only is None:
        # the dead-suppression audit needs every rule's usage data, so it
        # runs on full invocations only
        dead, dead_allowed, _ = core.filter_allowed(
            project, core.dead_suppressions(project, rule_ids, used))
        violations = core.sort_violations(violations + dead)
        allowed = core.sort_violations(allowed + dead_allowed)
    family = rule_ids | {core.DEAD_SUPPRESSION_RULE}
    baseline = core.filter_baseline(core.load_baseline(root), family)
    if only:
        baseline = core.filter_baseline(baseline, set(only))
    new, stale = core.diff_against_baseline(violations, baseline)

    if args.update_baseline:
        old = core.load_baseline(root)
        # keep the other family's keys: the baseline file is shared
        entries = {k: v for k, v in old.items()
                   if k not in core.filter_baseline(old, family)}
        for v in violations:
            entries[v.key] = old.get(v.key, "TODO: justify or fix")
        core.save_baseline(root, entries)
        print(f"{prog}: baseline rewritten with {len(entries)} entries "
              f"({len(new)} new, {len(stale)} removed; other families "
              f"kept)")
        return 0

    if args.json:
        report = {
            "violations": [v.to_json() for v in violations],
            "new": [v.to_json() for v in new],
            "allowed": [v.to_json() for v in allowed],
            "stale_baseline_keys": stale,
            "baselined": len(violations) - len(new),
        }
        report.update(extra or {})
        fsio.atomic_write_text(
            args.json, json.dumps(report, indent=1, default=str) + "\n")

    for v in new:
        print(f"{v.path}:{v.line}: {v.rule}: {v.message}")
    for v in allowed if show_allowed else ():
        print(f"{v.path}:{v.line}: {v.rule} (allowed inline): {v.message}")
    if stale:
        print(f"{prog}: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed violations "
              "still listed — run --update-baseline to burn them down):")
        for key in stale:
            print(f"  stale: {key}")
    baselined = len(violations) - len(new)
    print(f"{prog}: {len(new)} new, {baselined} baselined, "
          f"{len(allowed)} allowed inline, {len(stale)} stale")
    if new:
        return 1
    if args.strict and stale:
        return 1
    return 0
