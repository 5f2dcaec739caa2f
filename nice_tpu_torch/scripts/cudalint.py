"""cudalint of the port: the kernel-spec twin of scripts/jaxlint.py. Checks
the registry of K1-K5's contracts (nice_tpu_torch/analysis/kernelspec.py)
against the CUDA sources, the ctypes binding, the Python mirrors and the
plain versions, on the CPU: no card and no nvcc.

    python -m nice_tpu_torch.scripts.cudalint               # vs the baseline
    python -m nice_tpu_torch.scripts.cudalint --strict      # also fail stale
                                                            # baseline entries
    python -m nice_tpu_torch.scripts.cudalint --update-baseline
    python -m nice_tpu_torch.scripts.cudalint --json out.json
    python -m nice_tpu_torch.scripts.cudalint --rules C2
    python -m nice_tpu_torch.scripts.cudalint --bases 40,510

Rules C2 (int32 headroom) and C6 (spec drift), plus the S1 dead-suppression
audit on full runs (nice_tpu_torch/analysis/cudarules/__init__.py). --bases
sets the bases at which C6 runs the plain versions (default: the sweep,
kernelspec.SWEEP_BASES; "none" skips that check, which alone imports
torch). Findings an inline marker allows (C2's entry points that admit a
shape outside the spec's domain, ROADMAP queue 3) are printed, and do not
fail the run. Exit codes: 0 clean, 1 new violations (or stale baseline
entries under --strict), 2 usage or internal error.
"""

from __future__ import annotations

import sys

from nice_tpu_torch.analysis import cli, cudarules, kernelspec


def main(argv=None) -> int:
    ap = cli.parser(__doc__.splitlines()[0])
    ap.add_argument("--bases", metavar="LIST",
                    default=",".join(map(str, kernelspec.SWEEP_BASES)),
                    help="comma-separated bases of C6's plain runs, or none")
    args = ap.parse_args(argv)
    if args.bases.strip().lower() == "none":
        bases = ()
    else:
        try:
            bases = tuple(sorted({int(b) for b in args.bases.split(",")
                                  if b.strip()}))
        except ValueError:
            print(f"cudalint: bad --bases {args.bases!r}")
            return 2
        bad = [b for b in bases if kernelspec.plan_shape(b) is None]
        if not bases or bad:
            print(f"cudalint: --bases needs bases with a valid range, got "
                  f"{args.bases!r}")
            return 2
    ctx = cudarules.Context(bases)
    rule_ids = set(cudarules.all_crules())
    return cli.main(
        "cudalint", args, rule_ids,
        lambda project, only: cudarules.run_cuda_rules(project, ctx, only),
        extra={"context": ctx.report}, show_allowed=True)


if __name__ == "__main__":
    sys.exit(main())
