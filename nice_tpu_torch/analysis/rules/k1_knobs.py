"""K1: knob discipline, the port's form (part (a) of
nice_tpu/analysis/rules/k1_knobs.py).

The reference reads its knobs from ``NICE_TPU_*`` environment variables
through one registry, and K1 (a) keeps every read inside it. The port has
no such registry because it reads no environment variable at all: every
knob is a flag or an argument. So the port's K1 flags any environment read
anywhere in its tree: ``os.environ`` (a lookup, ``.get``, a copy or any
other use), ``os.environb``, ``os.getenv`` and ``from os import
environ/getenv``; the AST twin of the port's test that no module of it
reads the environment. A read of a literal name keeps the reference's
identity (``direct-read:<NAME>``); any other use is keyed by its function.
The reference's parts (b) and (c) check its knob registry and the docs
generated from it, which the port does not have.
"""

from __future__ import annotations

import ast
from typing import List, Set

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, Violation, rule

ENV_NAMES = ("environ", "environb", "getenv")


def _literal_read(node: ast.AST) -> str:
    """The literal variable name when ``node`` reads one: os.environ.get(
    "X"), os.getenv("X"), os.environ["X"]."""
    if isinstance(node, ast.Call):
        name = astutil.call_name(node) or ""
        if name in ("os.environ.get", "os.getenv") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            return node.args[0].value
    if isinstance(node, ast.Subscript) and \
            astutil.dotted(node.value) == "os.environ" and \
            isinstance(node.slice, ast.Constant) and \
            isinstance(node.slice.value, str):
        return node.slice.value
    return ""


@rule("K1")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for src in project.python_files():
        tree = src.tree()
        if tree is None:
            continue
        enclosing = astutil.enclosing_function_map(tree)
        seen: Set[str] = set()

        def flag(line: int, what: str, detail: str) -> None:
            if detail in seen:
                return
            seen.add(detail)
            out.append(Violation(
                "K1", src.relpath, line,
                f"environment read ({what}): the port's knobs are flags "
                "and arguments",
                detail=detail,
            ))

        consumed: Set[int] = set()
        for node in ast.walk(tree):
            name = _literal_read(node)
            if name:
                flag(node.lineno, name, f"direct-read:{name}")
                for sub in ast.walk(node):
                    consumed.add(id(sub))
        for node in ast.walk(tree):
            fn = enclosing.get(getattr(node, "lineno", 0), "<module>")
            if isinstance(node, ast.Attribute) and node.attr in ENV_NAMES \
                    and id(node) not in consumed:
                flag(node.lineno, node.attr, f"env-read:{fn}:{node.attr}")
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                for alias in node.names:
                    if alias.name in ENV_NAMES:
                        flag(node.lineno, alias.name,
                             f"env-read:{fn}:{alias.name}")
    return out
