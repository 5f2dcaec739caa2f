"""Shared analysis context for the port's R-rules (the twin of
nice_tpu/analysis/racerules/context.py).

Builds, once per racelint run:

* the spawn-site scan (every ``Thread(`` / ``ThreadPoolExecutor(`` /
  ``ThreadingHTTPServer(`` construction in ``nice_tpu_torch/`` and
  ``chip_smoke.py``, with its enclosing scope) that the R1 coverage gate
  matches against the ThreadRegistry;
* a cross-module call graph rooted at each registered thread entry, with
  scope-correct resolution of ``self.method``, same-module names,
  ``from``-imports and class constructors, plus dispatch-aware edges
  (``pool.submit(fn)`` runs ``fn`` on the pool whose spawn scope encloses
  the submit). The reference's writer-actor and event-loop routes have no
  counterpart here: the port has no server;
* per-function attribute/global write sites with the set of lock labels
  lexically held at each site (resolved through X1's lock maps);
* the static X1 acquisition graph and the runtime lockdep order graph
  loaded from ``nice_tpu_torch/analysis/lockorder.json`` (R2's
  cross-check input).

Everything is plain AST work: no module of the port is imported, so
racelint runs on a machine with no card and no torch.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from nice_tpu_torch.analysis import astutil, core, threadspec
from nice_tpu_torch.analysis.rules import x1_lock_order as x1

# The analyzer's own machinery (schedex spawns scheduler threads) is not
# part of the threads the registry audits.
GATE_EXEMPT_PREFIXES = ("nice_tpu_torch/analysis/", "tests/")
# The port's tree: the package and the smoke beside it.
TREE_PREFIXES = ("nice_tpu_torch/", "chip_smoke.py")
LOCKORDER_RELPATH = "nice_tpu_torch/analysis/lockorder.json"

MUTATOR_METHODS = {
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "clear", "remove", "discard", "extend", "insert", "setdefault",
}
# setdefault is a mutator for R1/R2 ownership purposes but is the SAFE
# re-validation idiom for R5 (atomic under the lock).

FuncKey = Tuple[str, str]  # (relpath, qualname)


@dataclasses.dataclass(frozen=True)
class SpawnSite:
    path: str
    line: int
    scope: str
    kind: str           # thread | pool | http-server
    call: str


@dataclasses.dataclass(frozen=True)
class WriteSite:
    path: str
    func: str           # qualname of the writing function
    line: int
    held: frozenset     # lock labels lexically held at the write
    via: str            # source text of the written expression


class RaceContext:
    def __init__(self, root: str):
        self.root = root
        self.spawn_sites: List[SpawnSite] = []
        self.functions: Dict[FuncKey, ast.AST] = {}
        self.edges: Dict[FuncKey, Set[FuncKey]] = {}
        self.root_reach: Dict[str, Set[FuncKey]] = {}
        # (path, scope, attr) -> write sites; scope is a class name or
        # "<module>"
        self.writes: Dict[Tuple[str, str, str], List[WriteSite]] = {}
        self.held_spans: Dict[FuncKey, List[Tuple[int, int, str]]] = {}
        self.lock_labels: Dict[str, Tuple[str, int]] = {}
        self.static_edges: Dict[str, Set[str]] = {}
        self.runtime_edges: Dict[str, Set[str]] = {}
        self.runtime_graph_path: Optional[str] = None
        self.report: Dict[str, object] = {}

    # -- queries -----------------------------------------------------------
    def roots_reaching(self, key: FuncKey) -> Set[str]:
        return {name for name, reach in self.root_reach.items()
                if key in reach}

    def held_at(self, key: FuncKey, line: int) -> Set[str]:
        return {label for (a, b, label) in self.held_spans.get(key, ())
                if a <= line <= b}


# --------------------------------------------------------------- construction


def _module_path(project: core.Project, dotted_mod: str) -> Optional[str]:
    """'nice_tpu_torch.ops.engine' -> 'nice_tpu_torch/ops/engine.py' when
    it exists."""
    rel = dotted_mod.replace(".", "/") + ".py"
    if project.get(rel) is not None:
        return rel
    rel_init = dotted_mod.replace(".", "/") + "/__init__.py"
    if project.get(rel_init) is not None:
        return rel_init
    return None


def _import_maps(project: core.Project, tree: ast.AST):
    """(module alias -> relpath, imported symbol -> relpath)."""
    mod_alias: Dict[str, str] = {}
    sym_from: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                path = _module_path(project, alias.name)
                if path:
                    mod_alias[alias.asname or alias.name.split(".")[-1]] = \
                        path
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            base = node.module
            for alias in node.names:
                sub = _module_path(project, f"{base}.{alias.name}")
                if sub:
                    mod_alias[alias.asname or alias.name] = sub
                else:
                    path = _module_path(project, base)
                    if path:
                        sym_from[alias.asname or alias.name] = path
    return mod_alias, sym_from


def _collect_functions(ctx: RaceContext, project: core.Project) -> None:
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        for qn, fn in astutil.iter_functions(tree):
            ctx.functions[(src.relpath, qn)] = fn


def _short_index(ctx: RaceContext) -> Dict[str, Dict[str, List[str]]]:
    """path -> short name -> qualnames in that file."""
    idx: Dict[str, Dict[str, List[str]]] = {}
    for (path, qn) in ctx.functions:
        idx.setdefault(path, {}).setdefault(
            qn.rsplit(".", 1)[-1], []).append(qn)
    return idx


def _resolve_callee(ctx, project, path, caller_qn, name,
                    mod_alias, sym_from, classes,
                    short_idx) -> Optional[FuncKey]:
    """Best-effort static resolution of a call target to a FuncKey."""
    if name.startswith("self."):
        method = name.split(".", 1)[1].split(".", 1)[0]
        cls = caller_qn.split(".", 1)[0]
        key = (path, f"{cls}.{method}")
        if key in ctx.functions:
            return key
        return None
    if "." not in name:
        if name in classes:
            key = (path, f"{name}.__init__")
            return key if key in ctx.functions else None
        if (path, name) in ctx.functions:
            return (path, name)
        if name in sym_from:
            tgt = (sym_from[name], name)
            if tgt in ctx.functions:
                return tgt
        # unique nested/short match inside the same file
        cands = short_idx.get(path, {}).get(name, [])
        if len(cands) == 1:
            return (path, cands[0])
        return None
    head, rest = name.split(".", 1)
    if head in mod_alias and "." not in rest:
        tgt = (mod_alias[head], rest)
        if tgt in ctx.functions:
            return tgt
    return None


def _callable_args(node: ast.Call) -> List[ast.AST]:
    """Arguments (incl. keyword values like ``target=``) that plausibly
    name a callable handed somewhere else to run."""
    out = list(node.args)
    out.extend(kw.value for kw in node.keywords if kw.arg)
    return out


def _build_call_graph(ctx: RaceContext, project: core.Project) -> None:
    short_idx = _short_index(ctx)
    dispatch: Dict[str, Set[FuncKey]] = {}   # root name -> extra entries
    pool_scopes = {
        (r.path, r.spawn_scope): r.name
        for r in threadspec.THREAD_ROOTS if r.kind == "pool"
    }

    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        mod_alias, sym_from = _import_maps(project, tree)
        classes = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)}
        for qn, fn in astutil.iter_functions(tree):
            caller = (src.relpath, qn)
            targets = ctx.edges.setdefault(caller, set())
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = astutil.call_name(node)
                if not name:
                    continue
                resolved = _resolve_callee(
                    ctx, project, src.relpath, qn, name,
                    mod_alias, sym_from, classes, short_idx)
                if resolved:
                    targets.add(resolved)
                # dispatch-aware edges: callables handed to another root
                # execute THERE, not here.
                route = None
                if name.endswith(".submit"):
                    route = pool_scopes.get((src.relpath, qn))
                if route is None:
                    continue
                for arg in _callable_args(node):
                    aname = astutil.dotted(arg)
                    cand = None
                    if aname:
                        cand = _resolve_callee(
                            ctx, project, src.relpath, qn, aname,
                            mod_alias, sym_from, classes, short_idx)
                    elif isinstance(arg, ast.Lambda):
                        for sub in ast.walk(arg):
                            if isinstance(sub, ast.Call):
                                sname = astutil.call_name(sub)
                                if sname:
                                    t = _resolve_callee(
                                        ctx, project, src.relpath, qn,
                                        sname, mod_alias, sym_from,
                                        classes, short_idx)
                                    if t:
                                        dispatch.setdefault(
                                            route, set()).add(t)
                        continue
                    if cand:
                        dispatch.setdefault(route, set()).add(cand)
    ctx.report["dispatch_entries"] = {
        k: sorted(f"{p}:{q}" for p, q in v) for k, v in dispatch.items()}
    _build_reach(ctx, project, dispatch)


def _build_reach(ctx: RaceContext, project: core.Project,
                 dispatch: Dict[str, Set[FuncKey]]) -> None:
    for root in threadspec.THREAD_ROOTS:
        entries: Set[FuncKey] = {
            (root.path, e) for e in root.entries
            if (root.path, e) in ctx.functions
        }
        entries |= dispatch.get(root.name, set())
        reach: Set[FuncKey] = set()
        frontier = list(entries)
        while frontier:
            key = frontier.pop()
            if key in reach:
                continue
            reach.add(key)
            for callee in ctx.edges.get(key, ()):
                if callee not in reach:
                    frontier.append(callee)
        ctx.root_reach[root.name] = reach
    ctx.report["root_reach_sizes"] = {
        name: len(reach) for name, reach in sorted(ctx.root_reach.items())}


# ------------------------------------------------------- writes and locks


def _held_spans_for(fn: ast.AST, table, attr_labels
                    ) -> List[Tuple[int, int, str]]:
    spans: List[Tuple[int, int, str]] = []

    def walk(body):
        for stmt in body:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    expr = astutil.dotted(item.context_expr)
                    label = x1._resolve(expr, table, attr_labels) \
                        if expr else None
                    if label:
                        spans.append(
                            (stmt.lineno,
                             getattr(stmt, "end_lineno", stmt.lineno),
                             label))
                walk(stmt.body)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue  # nested defs run later, not under these holds
            else:
                for block in x1._stmt_bodies(stmt):
                    walk(block)

    walk(getattr(fn, "body", []))
    return spans


def _module_globals(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
    return out


def _write_targets(node: ast.AST, globals_: Set[str]
                   ) -> List[Tuple[str, str, str]]:
    """(scope-kind, attr-or-name, via) writes performed by one statement
    or call node. scope-kind is 'self' or 'global'."""
    out: List[Tuple[str, str, str]] = []

    def attr_of(value: ast.AST) -> Optional[Tuple[str, str, str]]:
        d = astutil.dotted(value)
        if not d:
            return None
        if d.startswith("self.") and d.count(".") == 1:
            return ("self", d.split(".", 1)[1], d)
        if "." not in d and d in globals_:
            return ("global", d, d)
        return None

    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for tgt in targets:
            if isinstance(tgt, ast.Subscript):
                hit = attr_of(tgt.value)
                if hit:
                    out.append(hit)
            elif isinstance(tgt, (ast.Attribute, ast.Name)):
                hit = attr_of(tgt)
                if hit:
                    out.append(hit)
    elif isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
            hit = attr_of(fn.value)
            if hit:
                out.append(hit)
    return out


def _collect_writes(ctx: RaceContext, project: core.Project) -> None:
    per_module, attr_labels = x1._collect_lock_maps(project)
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        table = per_module.get(src.relpath, {})
        globals_ = _module_globals(tree)
        classes = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)}
        for qn, fn in astutil.iter_functions(tree):
            key = (src.relpath, qn)
            ctx.held_spans[key] = _held_spans_for(fn, table, attr_labels)
            short = qn.rsplit(".", 1)[-1]
            if short in ("__init__", "__new__"):
                continue  # construction happens-before publication
            head = qn.split(".")[0]
            cls = head if head in classes else None
            has_global = {
                n for g in ast.walk(fn) if isinstance(g, ast.Global)
                for n in g.names}
            for node in ast.walk(fn):
                for kind, name, via in _write_targets(node, globals_):
                    if kind == "self":
                        if cls is None:
                            continue
                        ident = (src.relpath, cls, name)
                    else:
                        # a bare NAME = ... without a global statement is
                        # a local shadowing the module global; container
                        # mutation (NAME[k] = / NAME.update()) always hits
                        # the shared object
                        plain_rebind = isinstance(
                            node, (ast.Assign, ast.AugAssign, ast.AnnAssign)
                        ) and not _is_subscript_store(node)
                        if plain_rebind and name not in has_global:
                            continue
                        ident = (src.relpath, "<module>", name)
                    line = getattr(node, "lineno", fn.lineno)
                    ctx.writes.setdefault(ident, []).append(WriteSite(
                        src.relpath, qn, line,
                        frozenset(ctx.held_at(key, line)), via))
    ctx.report["shared_write_identities"] = len(ctx.writes)


def _is_subscript_store(node: ast.AST) -> bool:
    if isinstance(node, ast.Assign):
        return any(isinstance(t, ast.Subscript) for t in node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return isinstance(node.target, ast.Subscript)
    return False


# ------------------------------------------------------------- spawn scan


def _collect_spawns(ctx: RaceContext, project: core.Project) -> None:
    for src in project.python_files():
        if src.relpath.startswith(GATE_EXEMPT_PREFIXES):
            continue
        if not src.relpath.startswith(TREE_PREFIXES):
            continue
        tree = src.tree()
        if tree is None:
            continue
        enclosing = astutil.enclosing_function_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node) or ""
            tail = name.rsplit(".", 1)[-1]
            kind = threadspec.SPAWN_KINDS.get(tail)
            if kind is None:
                continue
            scope = enclosing.get(node.lineno, "<module>")
            ctx.spawn_sites.append(SpawnSite(
                src.relpath, node.lineno, scope, kind, name))
    ctx.report["spawn_sites"] = len(ctx.spawn_sites)


def _collect_lock_labels(ctx: RaceContext, project: core.Project) -> None:
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                label = x1._lock_label(node)
                if label and label != "<unnamed>":
                    ctx.lock_labels.setdefault(
                        label, (src.relpath, node.lineno))
    ctx.report["lock_labels"] = len(ctx.lock_labels)


# ------------------------------------------------------------------ entry


def load_runtime_graph(path: str) -> Dict[str, Set[str]]:
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    edges = raw.get("edges", raw) if isinstance(raw, dict) else {}
    return {str(k): {str(x) for x in v} for k, v in edges.items()}


def build_context(root: str, project: core.Project,
                  lockorder_path: Optional[str] = None) -> RaceContext:
    ctx = RaceContext(root)
    _collect_spawns(ctx, project)
    _collect_functions(ctx, project)
    _build_call_graph(ctx, project)
    _collect_writes(ctx, project)
    _collect_lock_labels(ctx, project)
    ctx.static_edges = x1.lock_graph(project)
    if lockorder_path is None:
        lockorder_path = os.path.join(root, LOCKORDER_RELPATH)
    ctx.runtime_graph_path = lockorder_path
    if os.path.exists(lockorder_path):
        try:
            ctx.runtime_edges = load_runtime_graph(lockorder_path)
        except (OSError, ValueError):
            ctx.runtime_edges = {}
    ctx.report["runtime_edges"] = sum(
        len(v) for v in ctx.runtime_edges.values())
    ctx.report["static_edges"] = sum(
        len(v) for v in ctx.static_edges.values())
    return ctx
