"""cudalint: the kernel-spec rules of the port (the C-rule family), the
twins of the reference's jaxlint J2 and J6 (nice_tpu/analysis/jaxrules/),
which trace jaxprs and so cannot read a CUDA kernel. The numbers are kept
so that a reader finds the counterpart:

* **C2 int32 headroom**: each bound the registry declares
  (``analysis/kernelspec.py``) is checked by integer arithmetic over the
  spec's static domain: K1's flush budget, K5's accumulator, lanes and
  shared memory, K3's and K4's counts, every scalar argument against its C
  type, and the entry points that admit a shape outside the domain.
* **C6 spec drift**: coverage of every C entry point a wrapper loads, the
  plain versions' output shapes and dtypes at the sweep bases, the
  constants and tier capacities written in Python and in CUDA, the tier
  predicates over a probe sweep that brackets each cap, and the ctypes
  binding against the C prototypes.

Of the reference's other J-rules: J3 (donation) maps to the specs'
in-place arguments, which C6 holds the plain versions to; J5 (recompile
surface) to the per-base libraries, whose static domain the specs declare;
J1 (dtype flow) and J4 (host transfers inside a traced step) have nothing
in CUDA to read.

Same ratchet baseline, escape grammar and S1 audit as nicelint; run
``python -m nice_tpu_torch.scripts.cudalint``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from nice_tpu_torch.analysis import core, kernelspec

_CRULES: Dict[str, object] = {}


def crule(rule_id: str):
    def deco(fn):
        _CRULES[rule_id] = fn
        return fn
    return deco


def all_crules() -> Dict[str, object]:
    # Import side-effect registers every C-rule module exactly once.
    from nice_tpu_torch.analysis.cudarules import (  # noqa: F401
        c2_headroom, c6_kernelspec,
    )
    return dict(_CRULES)


class Context:
    """What a cudalint run carries between its rules: the bases at which
    C6 runs the plain versions (none: that check is skipped, and torch is
    not imported) and the report the rules fill."""

    def __init__(self, bases: Tuple[int, ...] = kernelspec.SWEEP_BASES):
        self.bases = tuple(bases)
        self.report: Dict[str, object] = {}


def run_cuda_rules(project: core.Project, ctx: Context,
                   only: Optional[Iterable[str]] = None):
    """(violations, allowed, used allow sites) of the C-rules over the
    tree, through the shared runner so that inline escapes work alike."""
    registry = {rule_id: (lambda p, _fn=fn: _fn(p, ctx))
                for rule_id, fn in all_crules().items()}
    return core.run_rules_tracked(project, only=only, registry=registry)


def line_of(text: Optional[str], needle: str) -> int:
    """The first line of text holding needle (1 when none does)."""
    if text:
        at = text.find(needle)
        if at >= 0:
            return text.count("\n", 0, at) + 1
    return 1
