"""Small shared AST helpers for the nicelint rules (the port's copy of
nice_tpu/analysis/astutil.py, cut to what its rules use)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted(node.func)


def iter_functions(tree: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(qualified_name, node) for every def/async def, including methods
    ('Class.method') and nested functions ('outer.<locals>.inner')."""

    def walk(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                yield qn, child
                yield from walk(child, f"{qn}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def enclosing_function_map(tree: ast.AST) -> Dict[int, str]:
    """line -> qualified name of the innermost enclosing function. Lines in
    module-level code are absent."""
    out: Dict[int, str] = {}
    for qn, fn in iter_functions(tree):
        start = fn.lineno
        end = getattr(fn, "end_lineno", start)
        for ln in range(start, end + 1):
            # innermost wins: later (nested) functions overwrite their span
            prev = out.get(ln)
            if prev is None or len(qn) >= len(prev):
                out[ln] = qn
    return out


def string_literals(tree: ast.AST) -> Iterator[Tuple[str, int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node.lineno
