"""nicelint framework of the port: source model, inline escapes, ratchet
baseline and the dead-suppression audit (the port's copy of
nice_tpu/analysis/core.py, cut to what the port's rules use).

The design center is the RATCHET: a violation's identity must survive
unrelated edits, so baseline keys are ``rule|path|detail`` with no line
numbers; the line is carried separately for display only. A baselined
violation therefore stays baselined as the file grows around it, and fixing
it strands a stale key that ``--strict`` forces out of the baseline file.

The port's tree is ``nice_tpu_torch/`` and ``chip_smoke.py``; its baseline
is ``nice_tpu_torch/analysis/baseline.json``, shared by the nicelint rules
and the cudalint rules (``analysis/cudarules/``), each family ratcheting
its own slice (``filter_baseline``).
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from nice_tpu_torch.utils import fsio

# Escape grammar: a comment of the form "nicelint: allow <RULE>[,<RULE>...]"
# with an optional parenthesised reason, on the flagged line or the line above.
_ALLOW_RE = re.compile(
    r"#\s*nicelint:\s*allow\s+([A-Z]\d(?:\s*,\s*[A-Z]\d)*)\b"
)
_FENCE_RE = re.compile(r"#\s*nicelint:\s*fence\b")


class Violation:
    """One finding. ``key`` (rule|path|detail) is the ratchet identity and
    deliberately excludes the line number."""

    __slots__ = ("rule", "path", "line", "message", "detail")

    def __init__(self, rule: str, path: str, line: int, message: str,
                 detail: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message
        self.detail = detail

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.path}|{self.detail}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "key": self.key,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Violation {self.rule} {self.path}:{self.line} {self.detail}>"


class SourceFile:
    """One parsed file plus its inline nicelint escape markers."""

    def __init__(self, root: str, relpath: str):
        self.root = root
        self.relpath = relpath
        with open(os.path.join(root, relpath), encoding="utf-8",
                  errors="replace") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.AST] = None
        self._parse_error: Optional[SyntaxError] = None
        self._allows: Optional[Dict[int, Set[str]]] = None
        self._fences: Optional[Set[int]] = None

    @property
    def is_python(self) -> bool:
        return self.relpath.endswith(".py")

    def tree(self) -> Optional[ast.AST]:
        """The module AST, or None on syntax errors (the rules skip the
        file)."""
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as exc:
                self._parse_error = exc
        return self._tree

    def _scan_markers(self) -> None:
        self._allows = {}
        self._fences = set()
        for i, line in enumerate(self.lines, start=1):
            if "nicelint" not in line:
                continue
            m = _ALLOW_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                self._allows.setdefault(i, set()).update(rules)
            if _FENCE_RE.search(line):
                self._fences.add(i)

    def allow_site(self, rule: str, line: int) -> Optional[int]:
        """The marker line that allows ``rule`` at ``line`` (the line itself
        or the comment line above it), or None."""
        if self._allows is None:
            self._scan_markers()
        for ln in (line, line - 1):
            rules = self._allows.get(ln)
            if rules and rule in rules:
                return ln
        return None

    def allow_markers(self) -> Dict[int, Set[str]]:
        """marker line -> rule ids, for the dead-suppression audit."""
        if self._allows is None:
            self._scan_markers()
        return dict(self._allows)

    def string_spanned_lines(self) -> Set[int]:
        """Lines covered by string constants (docstrings, fixture sources).
        Escape markers on these lines are documentation, not suppressions:
        the dead-suppression audit must not count them."""
        tree = self.tree()
        if tree is None:
            return set()
        out: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                end = getattr(node, "end_lineno", node.lineno) or node.lineno
                out.update(range(node.lineno, end + 1))
        return out

    def is_fence(self, line: int) -> bool:
        if self._fences is None:
            self._scan_markers()
        return line in self._fences or (line - 1) in self._fences


class Project:
    """The files the port's linters run over: the Python files under the
    package, and the top-level files of the port beside it."""

    PY_DIRS = ("nice_tpu_torch",)
    PY_FILES = ("chip_smoke.py",)

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Optional[List[SourceFile]] = None

    def files(self) -> List[SourceFile]:
        if self._files is not None:
            return self._files
        out: List[SourceFile] = []
        for top in self.PY_DIRS:
            base = os.path.join(self.root, top)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__" and
                                     not d.startswith((".", "_build")))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), self.root
                        )
                        out.append(SourceFile(self.root, rel))
        for rel in self.PY_FILES:
            if os.path.isfile(os.path.join(self.root, rel)):
                out.append(SourceFile(self.root, rel))
        self._files = out
        return out

    def python_files(self, prefix: str = "") -> List[SourceFile]:
        return [f for f in self.files()
                if f.is_python and f.relpath.startswith(prefix)]

    def get(self, relpath: str) -> Optional[SourceFile]:
        for f in self.files():
            if f.relpath == relpath:
                return f
        return None

    def read(self, relpath: str) -> Optional[str]:
        """The text of any file of the tree (CUDA sources too), or None
        when the tree has no such file."""
        path = os.path.join(self.root, relpath)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()


# -- rule registry ---------------------------------------------------------

Rule = Callable[[Project], List[Violation]]
_RULES: Dict[str, Rule] = {}


def rule(rule_id: str):
    def deco(fn: Rule) -> Rule:
        _RULES[rule_id] = fn
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    # Import side-effect registers every rule module exactly once.
    from nice_tpu_torch.analysis import rules  # noqa: F401
    return dict(_RULES)


AllowSite = Tuple[str, int, str]  # (path, marker line, rule id)


def filter_allowed(
    project: Project, violations: Iterable[Violation]
) -> Tuple[List[Violation], List[Violation], Set[AllowSite]]:
    """(kept, allowed, used): the findings no marker allows, the ones an
    inline marker allows, and the marker sites that allowed something (the
    dead-suppression audit's ground truth)."""
    kept: List[Violation] = []
    allowed: List[Violation] = []
    used: Set[AllowSite] = set()
    for v in violations:
        src = project.get(v.path)
        site = src.allow_site(v.rule, v.line) if src is not None else None
        if site is not None:
            used.add((v.path, site, v.rule))
            allowed.append(v)
            continue
        kept.append(v)
    return kept, allowed, used


def sort_violations(violations: Iterable[Violation]) -> List[Violation]:
    return sorted(violations, key=lambda v: (v.path, v.line, v.rule, v.detail))


def run_rules_tracked(
    project: Project,
    only: Optional[Iterable[str]] = None,
    registry: Optional[Dict[str, Rule]] = None,
) -> Tuple[List[Violation], List[Violation], Set[AllowSite]]:
    """Runs a rule family (nicelint's by default; cudalint passes its own)
    and splits the findings as filter_allowed does."""
    rules = registry if registry is not None else all_rules()
    wanted = set(only) if only else None
    raw: List[Violation] = []
    for rule_id, fn in sorted(rules.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        raw.extend(fn(project))
    kept, allowed, used = filter_allowed(project, raw)
    return sort_violations(kept), sort_violations(allowed), used


# -- dead-suppression audit (rule S1) ---------------------------------------

DEAD_SUPPRESSION_RULE = "S1"


def dead_suppressions(project: Project, ran_rules: Iterable[str],
                      used: Set[AllowSite]) -> List[Violation]:
    """Allow markers whose rule no longer fires at that site. Only markers
    naming a rule in ``ran_rules`` are judged: a C2 allow is not dead just
    because the run was nicelint's. Identity is line-number-free: rule S1,
    detail ``dead:<rule>:<enclosing scope>``."""
    ran = set(ran_rules)
    out: List[Violation] = []
    for src in project.python_files():
        markers = src.allow_markers()
        if not markers:
            continue
        doc_lines = src.string_spanned_lines()
        scopes = _line_scope_map(src)
        for line in sorted(markers):
            if line in doc_lines:
                continue
            for rule_id in sorted(markers[line]):
                if rule_id not in ran:
                    continue
                if (src.relpath, line, rule_id) in used:
                    continue
                scope = scopes.get(line, "<module>")
                out.append(Violation(
                    DEAD_SUPPRESSION_RULE, src.relpath, line,
                    f"dead escape: '# nicelint: allow {rule_id}' but {rule_id} "
                    f"no longer fires here — delete the marker",
                    detail=f"dead:{rule_id}:{scope}",
                ))
    return out


def _line_scope_map(src: SourceFile) -> Dict[int, str]:
    """line -> innermost enclosing function name (S1's stable identity)."""
    tree = src.tree()
    if tree is None:
        return {}
    out: Dict[int, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno) or node.lineno
            for ln in range(node.lineno, end + 1):
                out[ln] = node.name  # walk order: inner defs overwrite outer
    return out


# -- ratchet baseline ------------------------------------------------------

BASELINE_RELPATH = os.path.join("nice_tpu_torch", "analysis", "baseline.json")


def load_baseline(root: str) -> Dict[str, str]:
    """key -> justification. Missing file means an empty baseline."""
    path = os.path.join(root, BASELINE_RELPATH)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return dict(data.get("entries", {}))


def save_baseline(root: str, entries: Dict[str, str]) -> None:
    path = os.path.join(root, BASELINE_RELPATH)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "comment": (
            "The port's ratchet baseline, shared by nicelint and cudalint. "
            "Every key is rule|path|detail for a KNOWN violation with a "
            "justification; new violations fail at once. Regenerate a "
            "family's slice with: python -m nice_tpu_torch.scripts.nicelint "
            "(or .cudalint) --update-baseline"
        ),
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    fsio.atomic_write_text(path, json.dumps(payload, indent=1) + "\n")


def filter_baseline(
    baseline: Dict[str, str], rule_ids: Iterable[str]
) -> Dict[str, str]:
    """The slice of the shared baseline one family owns. nicelint and
    cudalint ratchet against the same file; each must only see (and declare
    stale) keys for rules it actually ran. S1 keys are split by the rule
    embedded in their ``dead:<rule>:...`` detail, since both CLIs emit S1
    for their own family."""
    ids = set(rule_ids)
    out: Dict[str, str] = {}
    for key, why in baseline.items():
        parts = key.split("|", 2)
        rule_id = parts[0]
        detail = parts[2] if len(parts) == 3 else ""
        if rule_id == DEAD_SUPPRESSION_RULE:
            inner = detail.split(":", 2)[1] if detail.startswith("dead:") \
                else ""
            if DEAD_SUPPRESSION_RULE in ids and inner in ids:
                out[key] = why
        elif rule_id in ids:
            out[key] = why
    return out


def diff_against_baseline(
    violations: List[Violation], baseline: Dict[str, str]
) -> Tuple[List[Violation], List[str]]:
    """(new_violations, stale_baseline_keys)."""
    found = {v.key for v in violations}
    new = [v for v in violations if v.key not in baseline]
    stale = sorted(k for k in baseline if k not in found)
    return new, stale
