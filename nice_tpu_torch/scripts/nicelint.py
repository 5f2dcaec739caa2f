"""nicelint of the port: the project's invariants, checked on the AST of
nice_tpu_torch/ and chip_smoke.py (the twin of scripts/nicelint.py).

    python -m nice_tpu_torch.scripts.nicelint               # vs the baseline
    python -m nice_tpu_torch.scripts.nicelint --strict      # also fail stale
                                                            # baseline entries
    python -m nice_tpu_torch.scripts.nicelint --update-baseline
    python -m nice_tpu_torch.scripts.nicelint --json out.json
    python -m nice_tpu_torch.scripts.nicelint --rules D1,K1

Rules A1, D1, K1 and M1 (nice_tpu_torch/analysis/__init__.py), plus the S1
dead-suppression audit on full runs. Exit codes: 0 clean, 1 new violations
(or stale baseline entries under --strict), 2 usage or internal error.
"""

from __future__ import annotations

import sys

from nice_tpu_torch.analysis import cli, core


def main(argv=None) -> int:
    args = cli.parser(__doc__.splitlines()[0]).parse_args(argv)
    rule_ids = set(core.all_rules())
    return cli.main(
        "nicelint", args, rule_ids,
        lambda project, only: core.run_rules_tracked(project, only=only))


if __name__ == "__main__":
    sys.exit(main())
