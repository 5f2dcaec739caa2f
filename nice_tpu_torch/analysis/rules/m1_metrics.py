"""M1: metrics discipline (the port's copy of
nice_tpu/analysis/rules/m1_metrics.py).

(a) Process-global series must be declared in ``obs/series.py``: any
``metrics.counter/gauge/histogram(...)`` call (the obs.metrics module
functions register on the global registry) outside series.py is a
violation. Private ``Registry()`` instances declare through a method call
(``self.registry.counter``) and are exempt — but their names still join
the declared set.

(b) Every ``nice_*`` series-name token used anywhere (Python, web UI)
must resolve to a declared series — exactly, or as a derived-series suffix
(``_p50``/``_p95``/``_p99``/``_sum``/``_count``/``_bucket``, optionally
with a tier suffix) of one. Undeclared tokens are violations; so are
declared-but-unknown spellings in dashboards (catching dashboard drift
when a series is renamed).

(c) Label sets must be bounded: a declaration's ``labelnames`` must be a
literal tuple/list of string literals, never computed.

The port reads some series that only the reference's server emits (its SLO
specs are over the server's request and spot-check series); series.py names
them in ``SERVER_SERIES``, a literal tuple that joins the declared set. The
names of the port's C entry points (``nice_*`` functions of its CUDA and
host sources) are symbols, not series.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Set, Tuple

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, SourceFile, Violation, rule

PACKAGE = "nice_tpu_torch/"
SERIES_PATH = "nice_tpu_torch/obs/series.py"
METRICS_PATH = "nice_tpu_torch/obs/metrics.py"
DECL_FUNCS = ("counter", "gauge", "histogram")

_NAME_RE = re.compile(r"\bnice_[a-z0-9_]+\b")
_SERIES_TOKEN = re.compile(r"^nice_[a-z0-9_]+$")
# Derived-series machinery: history quantiles/aggregates and the renderer's
# histogram sub-series.
_DERIVED = re.compile(
    r"_(?:p50|p95|p99|sum|count|bucket|total)(?:_[a-z0-9]+)?$"
)

# Tokens that look like series names but are not (package names, file
# stems, native library symbols).
IGNORE_TOKENS = {
    "nice_tpu", "nice_tpu_torch", "nice_native", "nice_numbers",
    "nice_count", "nice_list", "nice_autotune", "nice_flight", "nice_sp_",
    # the main library's K3 entry of an older tree, which cuda_build binds
    # for scripts/kernel_ab.py's A/B against it
    "nice_strided_niceonly",
}

# The port's C and CUDA sources, whose nice_* functions are symbols.
NATIVE_DIRS = ("nice_tpu_torch/csrc", "nice_tpu_torch/native")
_NATIVE_FUNC = re.compile(r"^[\w \t\*]*?\b(nice_\w+)\s*\(", re.M)


def _decl_calls(src: SourceFile):
    tree = src.tree()
    if tree is None:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if not name:
            continue
        parts = name.split(".")
        if parts[-1] not in DECL_FUNCS or len(parts) < 2:
            continue
        first = None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            first = node.args[0].value
        yield node, name, first


def declared_series(project: Project) -> Set[str]:
    declared: Set[str] = set()
    for src in project.python_files(PACKAGE):
        for _node, _name, first in _decl_calls(src):
            if first and first.startswith("nice_"):
                declared.add(first)
    series = project.get(SERIES_PATH)
    if series is not None and series.tree() is not None:
        for node in series.tree().body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "SERVER_SERIES"
                    for t in node.targets) and \
                    isinstance(node.value, (ast.Tuple, ast.List)):
                declared.update(
                    el.value for el in node.value.elts
                    if isinstance(el, ast.Constant) and
                    isinstance(el.value, str))
    return declared


def native_symbols(project: Project) -> Set[str]:
    """The nice_* functions defined or declared in the port's C and CUDA
    sources."""
    out: Set[str] = set()
    for rel in NATIVE_DIRS:
        base = os.path.join(project.root, rel)
        if not os.path.isdir(base):
            continue
        for fn in sorted(os.listdir(base)):
            if fn.endswith((".cu", ".cuh", ".cpp", ".h")):
                out.update(_NATIVE_FUNC.findall(
                    project.read(f"{rel}/{fn}") or ""))
    return out


def _labelnames_literal(node: ast.Call) -> Tuple[bool, List[str]]:
    for kw in node.keywords:
        if kw.arg != "labelnames":
            continue
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            vals = []
            for el in kw.value.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    vals.append(el.value)
                else:
                    return False, []
            return True, vals
        return False, []
    return True, []  # no labels: trivially bounded


def _usable(used: str, declared: Set[str]) -> bool:
    if used in declared:
        return True
    stripped = _DERIVED.sub("", used)
    if stripped != used and stripped in declared:
        return True
    # Prefix fragments ("nice_mesh_" in a dashboard's startswith filter,
    # "nice_api_request" in a test assertion) are fine when at least one
    # declared series begins with them.
    return any(d.startswith(used) for d in declared)


@rule("M1")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    declared = declared_series(project)
    if not declared:
        return []
    symbols = native_symbols(project)

    for src in project.python_files(PACKAGE):
        if src.relpath == METRICS_PATH:
            continue
        for node, name, first in _decl_calls(src):
            # (a) global-registry declaration outside series.py: the call
            # target is the metrics MODULE itself ('metrics.counter' or
            # 'obs.metrics.counter'), not a registry instance.
            head = name.rsplit(".", 2)
            module_call = head[-2] == "metrics" if len(head) >= 2 else False
            if module_call and src.relpath != SERIES_PATH:
                out.append(Violation(
                    "M1", src.relpath, node.lineno,
                    f"global metric declared outside obs/series.py: "
                    f"{first or name}",
                    detail=f"global-decl:{first or name}",
                ))
            # (c) bounded labels
            literal, _vals = _labelnames_literal(node)
            if not literal:
                out.append(Violation(
                    "M1", src.relpath, node.lineno,
                    f"metric {first or name} declares computed labelnames "
                    "(label sets must be literal and bounded)",
                    detail=f"labels:{first or name}",
                ))

    # (b) usage scan across Python + web assets
    decl_lines: Dict[str, Set[int]] = {}
    for src in project.files():
        if src.is_python:
            tree = src.tree()
            if tree is None:
                continue
            tokens = []
            for value, line in astutil.string_literals(tree):
                if _SERIES_TOKEN.match(value):
                    tokens.append((value, line))
        else:
            tokens = [
                (m.group(0), src.text.count("\n", 0, m.start()) + 1)
                for m in _NAME_RE.finditer(src.text)
            ]
        for used, line in tokens:
            if used in IGNORE_TOKENS or used in symbols:
                continue
            if _usable(used, declared):
                continue
            key = f"{src.relpath}:{used}"
            if line in decl_lines.get(key, set()):
                continue
            decl_lines.setdefault(key, set()).add(line)
            out.append(Violation(
                "M1", src.relpath, line,
                f"series name {used!r} is not declared in obs/series.py",
                detail=f"undeclared:{used}",
            ))
    return out
