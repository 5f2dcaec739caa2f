"""R5: check-then-act atomicity on shared dicts and caches.

The canonical lost-update shape: read a cache under its lock, release the
lock to do expensive work (construct a mesh, make a request), re-acquire
and store — an invalidation landing in the unlocked window is silently
overwritten (the ``_cached_mesh`` / failover-cursor pattern). Statically:

* within one function, a read of object ``V`` (``V.get(...)``, ``V[k]``
  load, ``k in V``) inside a ``with <lock>`` span, followed by a write of
  the same ``V`` inside a LATER span of the SAME lock, with at least one
  unlocked line between the spans, is a finding. ``V.setdefault(...)``
  in the second span is the sanctioned atomic re-validation idiom and
  exempt; a generation-checked store is sanctioned via an inline
  ``# nicelint: allow R5 (...)`` whose honesty the schedex regression
  scenarios enforce dynamically.
* any ``functools.lru_cache`` function whose ``cache_clear()`` is called
  at runtime (outside tests) is flagged: the clear/rebuild window of an
  lru cache cannot be guarded at all — hold an explicit dict + lock +
  generation instead (what ops/engine's mesh cache does).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.racerules import rrule
from nice_tpu_torch.analysis.racerules.context import (
    MUTATOR_METHODS, TREE_PREFIXES,
)

ANALYSIS_PREFIX = "nice_tpu_torch/analysis/"

WRITE_METHODS = MUTATOR_METHODS - {"setdefault"}


def _accesses(fn: ast.AST) -> List[Tuple[int, str, str]]:
    """(line, 'read'|'write', dotted-object) container accesses in fn."""
    out: List[Tuple[int, str, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                obj = astutil.dotted(f.value)
                if not obj:
                    continue
                if f.attr == "get":
                    out.append((node.lineno, "read", obj))
                elif f.attr in WRITE_METHODS:
                    out.append((node.lineno, "write", obj))
        elif isinstance(node, ast.Subscript):
            obj = astutil.dotted(node.value)
            if not obj:
                continue
            kind = "read" if isinstance(node.ctx, ast.Load) else "write"
            out.append((node.lineno, kind, obj))
        elif isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                for cmp_ in node.comparators:
                    obj = astutil.dotted(cmp_)
                    if obj:
                        out.append((node.lineno, "read", obj))
    return out


def _check_then_act(ctx, path: str, qn: str,
                    fn: ast.AST) -> List[Violation]:
    spans = sorted(ctx.held_spans.get((path, qn), ()),
                   key=lambda s: s[0])
    if len(spans) < 2:
        return []
    accesses = _accesses(fn)
    out: List[Violation] = []
    seen: Set[str] = set()
    for i, (a0, a1, la) in enumerate(spans):
        for (b0, b1, lb) in spans[i + 1:]:
            if la != lb or b0 <= a1:
                continue
            if b0 - a1 < 2:
                continue  # no statement in between: no unlocked window
            reads = {obj for (ln, kind, obj) in accesses
                     if kind == "read" and a0 <= ln <= a1}
            writes = {(ln, obj) for (ln, kind, obj) in accesses
                      if kind == "write" and b0 <= ln <= b1}
            for ln, obj in sorted(writes):
                if obj in reads and obj not in seen:
                    seen.add(obj)
                    out.append(Violation(
                        "R5", path, ln,
                        f"check-then-act on {obj}: read under {la} at "
                        f"line {a0}, stored back under the same lock "
                        f"after an unlocked window — an invalidation in "
                        "the window is lost (use setdefault or a "
                        "generation-checked store + schedex scenario)",
                        detail=f"check-then-act:"
                               f"{qn.rsplit('.', 1)[-1]}:{obj}",
                    ))
    return out


@rrule("R5")
def check(project: Project, ctx) -> List[Violation]:
    out: List[Violation] = []

    # 1. locked read -> unlocked window -> locked write, per function
    for (path, qn), fn in sorted(ctx.functions.items()):
        if not path.startswith(TREE_PREFIXES) or \
                path.startswith(ANALYSIS_PREFIX):
            continue
        out.extend(_check_then_act(ctx, path, qn, fn))

    # 2. lru_cache with a runtime cache_clear
    lru_fns: Dict[str, Tuple[str, int]] = {}
    for src in project.python_files():
        if src.relpath.startswith(ANALYSIS_PREFIX):
            continue
        tree = src.tree()
        if tree is None:
            continue
        for qn, fn in astutil.iter_functions(tree):
            for deco in getattr(fn, "decorator_list", []):
                name = astutil.call_name(deco) if \
                    isinstance(deco, ast.Call) else astutil.dotted(deco)
                if name and name.rsplit(".", 1)[-1] == "lru_cache":
                    lru_fns[qn.rsplit(".", 1)[-1]] = (src.relpath,
                                                      fn.lineno)
    if lru_fns:
        for src in project.python_files():
            if src.relpath.startswith(ANALYSIS_PREFIX):
                continue
            tree = src.tree()
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = astutil.call_name(node)
                if not name or not name.endswith(".cache_clear"):
                    continue
                target = name.rsplit(".", 2)[-2]
                if target in lru_fns:
                    dpath, dline = lru_fns.pop(target)
                    out.append(Violation(
                        "R5", dpath, dline,
                        f"lru_cache on {target}() is cache_clear()ed at "
                        f"{src.relpath}:{node.lineno} — the clear/rebuild "
                        "window cannot be guarded; use an explicit dict "
                        "with a lock and a generation counter",
                        detail=f"lru-clear:{target}",
                    ))
    return out
