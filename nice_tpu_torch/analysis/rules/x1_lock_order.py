"""X1: static lock-order analysis of the port (the static half of its
runtime lockdep; the twin of nice_tpu/analysis/rules/x1_lock_order.py).

Two checks, over ``nice_tpu_torch/`` and ``chip_smoke.py``:

1. Every lock of the port must be constructed through ``lockdep.make_lock``
   / ``make_rlock``: a bare ``threading.Lock()`` escapes both the runtime
   instrumentation and this rule's graph.

2. The acquisition-order graph extracted from nested ``with`` statements
   must be acyclic. Lock identities are the dotted names passed to
   ``make_lock`` (the same names runtime lockdep reports), resolved from
   assignment sites: ``X = lockdep.make_lock("mod._lock")`` maps the
   module-level name or ``self.<attr>`` to that label. Cross-module
   acquisitions (``self.other._lock``, a lock of another class) resolve
   through the class-attribute table built from every file, keyed by the final
   ``<obj>.<attr>`` pair.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, Violation, rule

LOCKDEP_PATH = "nice_tpu_torch/utils/lockdep.py"
MAKE_FUNCS = ("make_lock", "make_rlock")


def _lock_label(node: ast.Call) -> Optional[str]:
    name = astutil.call_name(node) or ""
    if name.rsplit(".", 1)[-1] not in MAKE_FUNCS:
        return None
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return "<unnamed>"


def _collect_lock_maps(project: Project):
    """Per-module {expr -> label} plus a global {attr -> label} fallback
    for cross-module acquisitions like ``self.db._lock``."""
    per_module: Dict[str, Dict[str, str]] = {}
    # attr name -> set of labels assigned to a self.<attr> anywhere
    attr_labels: Dict[str, Set[str]] = {}
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        table: Dict[str, str] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            if not isinstance(node.value, ast.Call):
                continue
            label = _lock_label(node.value)
            if label is None:
                continue
            target = astutil.dotted(node.targets[0])
            if not target:
                continue
            table[target] = label  # "self._lock" or module-level "_lock"
            if target.startswith("self."):
                attr = target.split(".", 1)[1]
                attr_labels.setdefault(attr, set()).add(label)
        per_module[src.relpath] = table
    return per_module, attr_labels


def _resolve(expr: str, table: Dict[str, str],
             attr_labels: Dict[str, Set[str]]) -> Optional[str]:
    if expr in table:
        return table[expr]
    # "self.db._lock" / "ctx.db._lock": resolve by final attribute when the
    # project has exactly one lock with that attribute name on a class the
    # receiver plausibly is ("<...>.db._lock" matched against "x.db.*").
    attr = expr.rsplit(".", 1)[-1]
    candidates = attr_labels.get(attr, set())
    if len(candidates) == 1:
        return next(iter(candidates))
    if len(candidates) > 1:
        # disambiguate via the receiver's name: self.db._lock prefers the
        # label containing ".db.".
        parts = expr.split(".")
        if len(parts) >= 2:
            recv = parts[-2].lower()
            scored = [c for c in candidates if f".{recv}." in c.lower()]
            if len(scored) == 1:
                return scored[0]
    return None


def _walk_withs(body: List[ast.stmt], held: Tuple[str, ...],
                table: Dict[str, str], attr_labels: Dict[str, Set[str]],
                edges: Dict[str, Set[str]], sites: Dict[Tuple[str, str],
                                                        Tuple[str, int]],
                relpath: str) -> None:
    for stmt in body:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                expr = astutil.dotted(item.context_expr)
                label = _resolve(expr, table, attr_labels) if expr else None
                if label is None:
                    continue
                if new_held and new_held[-1] != label:
                    outer = new_held[-1]
                    edges.setdefault(outer, set()).add(label)
                    sites.setdefault((outer, label),
                                     (relpath, stmt.lineno))
                new_held = new_held + (label,)
            _walk_withs(stmt.body, new_held, table, attr_labels, edges,
                        sites, relpath)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def body runs later, not under the current holds
            _walk_withs(stmt.body, (), table, attr_labels, edges, sites,
                        relpath)
        elif isinstance(stmt, ast.ClassDef):
            _walk_withs(stmt.body, (), table, attr_labels, edges, sites,
                        relpath)
        else:
            for child_body in _stmt_bodies(stmt):
                _walk_withs(child_body, held, table, attr_labels, edges,
                            sites, relpath)


def _stmt_bodies(stmt: ast.stmt):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body


def _find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(edges) | {m for vs in edges.values() for m in vs}}
    stack: List[str] = []

    def dfs(node: str) -> Optional[List[str]]:
        color[node] = GRAY
        stack.append(node)
        for nxt in sorted(edges.get(node, ())):
            if color[nxt] == GRAY:
                return stack[stack.index(nxt):] + [nxt]
            if color[nxt] == WHITE:
                found = dfs(nxt)
                if found:
                    return found
        stack.pop()
        color[node] = BLACK
        return None

    for node in sorted(color):
        if color[node] == WHITE:
            found = dfs(node)
            if found:
                return found
    return None


@rule("X1")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    # 1. bare Lock()/RLock() constructions
    for src in project.python_files():
        if src.relpath == LOCKDEP_PATH:
            continue
        tree = src.tree()
        if tree is None:
            continue
        enclosing = astutil.enclosing_function_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node) or ""
            if name in ("threading.Lock", "threading.RLock"):
                fn = enclosing.get(node.lineno, "<module>")
                out.append(Violation(
                    "X1", src.relpath, node.lineno,
                    f"bare {name}() in {fn} — construct project locks via "
                    "lockdep.make_lock()/make_rlock() so runtime lockdep "
                    "and the static graph see them",
                    detail=f"bare-lock:{fn}",
                ))

    # 2. static acquisition-order graph
    per_module, attr_labels = _collect_lock_maps(project)
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        table = per_module.get(src.relpath, {})
        _walk_withs(tree.body, (), table, attr_labels, edges, sites,
                    src.relpath)
    cycle = _find_cycle(edges)
    if cycle:
        first_edge = (cycle[0], cycle[1]) if len(cycle) > 1 else None
        relpath, line = sites.get(first_edge, (LOCKDEP_PATH, 1)) \
            if first_edge else (LOCKDEP_PATH, 1)
        out.append(Violation(
            "X1", relpath, line,
            "lock-order cycle: " + " -> ".join(cycle),
            detail="cycle:" + "->".join(sorted(set(cycle))),
        ))
    return out


def lock_graph(project: Project) -> Dict[str, Set[str]]:
    """The extracted static acquisition-order graph (CLI --graph dump)."""
    per_module, attr_labels = _collect_lock_maps(project)
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        _walk_withs(tree.body, (), per_module.get(src.relpath, {}),
                    attr_labels, edges, sites, src.relpath)
    return edges
