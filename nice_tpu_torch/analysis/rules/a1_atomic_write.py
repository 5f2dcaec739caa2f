"""A1: atomic-write discipline (the port's copy of
nice_tpu/analysis/rules/a1_atomic_write.py).

State files inside ``nice_tpu_torch/`` are written only through
``nice_tpu_torch.utils.fsio`` (same-dir temp + fsync + rename + dir fsync).
Any other write-mode ``open()`` / ``os.fdopen()`` in the package is a
violation: either migrate it to fsio, or, for streaming sinks (trace logs)
and files that are not state (build outputs, reports), carry an inline
``# nicelint: allow A1 (reason)``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, Violation, rule

PACKAGE = "nice_tpu_torch/"
FSIO_PATH = "nice_tpu_torch/utils/fsio.py"
WRITE_CHARS = set("wax+")


def _mode_of(node: ast.Call) -> Optional[str]:
    """The literal mode argument of an open()/os.fdopen() call, when the
    call is one and the mode is statically known."""
    name = astutil.call_name(node) or ""
    if name not in ("open", "os.fdopen", "fdopen", "io.open"):
        return None
    mode = None
    if len(node.args) >= 2:
        arg = node.args[1]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            mode = arg.value
        else:
            return "<dynamic>"
    for kw in node.keywords:
        if kw.arg == "mode":
            if isinstance(kw.value, ast.Constant) and \
                    isinstance(kw.value.value, str):
                mode = kw.value.value
            else:
                return "<dynamic>"
    return mode if mode is not None else "r"


@rule("A1")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.python_files(PACKAGE):
        if src.relpath == FSIO_PATH:
            continue
        tree = src.tree()
        if tree is None:
            continue
        enclosing = astutil.enclosing_function_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            mode = _mode_of(node)
            if mode is None:
                continue
            if mode != "<dynamic>" and not (set(mode) & WRITE_CHARS):
                continue
            fn = enclosing.get(node.lineno, "<module>")
            out.append(Violation(
                "A1", src.relpath, node.lineno,
                f"write-mode open({mode!r}) in {fn} — state files go "
                "through nice_tpu_torch.utils.fsio (tmp+fsync+rename)",
                detail=f"{fn}:{mode}",
            ))
    return out
