"""D1: device-sync discipline in the engine and mesh hot paths (the port's
twin of nice_tpu/analysis/rules/d1_device_sync.py).

The engine's pipelined loop keeps the card fed only while the host waits
for it where it means to, and stepprof's fences promise to add no other
wait. So every point where the host waits on the card, or reads what the
card wrote, in ``ops/engine.py`` and ``parallel/mesh.py`` must sit on a
line marked ``# nicelint: fence`` (or directly below a fence comment line),
which keeps each of them grep-able and reviewed.

What counts, PyTorch's forms of JAX's ``block_until_ready`` /
``jax.device_get`` / ``np.asarray``: ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()`` (the host's read of a landing buffer an
asynchronous copy filled), ``.to("cpu")``, ``torch.cuda.synchronize()``
and an event's or stream's ``.synchronize()``. A receiver made by a numpy
call (``np.nonzero(x)[0].tolist()``) is host data and is skipped, as the
reference skips numpy-on-numpy.
"""

from __future__ import annotations

import ast
from typing import List

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project, Violation, rule

SCOPE = ("nice_tpu_torch/ops/engine.py", "nice_tpu_torch/parallel/mesh.py")

SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def _host_receiver(node: ast.AST) -> bool:
    """Whether the receiver chain starts at a numpy call (host data)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(node, ast.Call):
            name = astutil.call_name(node) or ""
            if name.startswith(("np.", "numpy.")):
                return True
            node = node.func
        else:
            node = node.value
    return False


def sync_kind(node: ast.Call) -> str:
    """The kind of device sync a call is, or "" for none."""
    if not isinstance(node.func, ast.Attribute):
        return ""
    attr = node.func.attr
    if attr == "to":
        target = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "device"), None)
        if isinstance(target, ast.Constant) and target.value == "cpu":
            return "to_cpu"
        return ""
    if attr not in SYNC_METHODS or node.args or node.keywords:
        return ""
    if astutil.call_name(node) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize"
    if _host_receiver(node.func.value):
        return ""
    return attr


@rule("D1")
def check(project: Project) -> List[Violation]:
    out: List[Violation] = []
    for relpath in SCOPE:
        src = project.get(relpath)
        if src is None or src.tree() is None:
            continue
        enclosing = astutil.enclosing_function_map(src.tree())
        for node in ast.walk(src.tree()):
            if not isinstance(node, ast.Call):
                continue
            kind = sync_kind(node)
            if not kind or src.is_fence(node.lineno):
                continue
            fn = enclosing.get(node.lineno, "<module>")
            out.append(Violation(
                "D1", relpath, node.lineno,
                f"device sync {kind} outside a '# nicelint: fence' site "
                f"in {fn}",
                detail=f"{fn}->{kind}",
            ))
    return out
