"""R3: blocking calls where blocking is forbidden.

Two obligations from the ThreadRegistry:

* a root declared ``may_block=False`` must not reach blocking operations
  through the cross-module call graph;
* a blocking call must not happen while lexically holding a lock whose
  LockSpec says ``may_block_under=False``: holding a cache or sampler lock
  across a file write or an HTTP wait stalls every reader. Locks that
  SERIALIZE a blocking resource (the nvcc build locks, the host library's
  build lock) are declared ``may_block_under=True`` and exempt.

The blocking tables are the reference nicelint L1's (a copy: L1, the
server's event-loop rule, is not ported) plus ``queue.get`` /
``Event.wait`` / ``Thread.join`` without a timeout and HTTP response
waits.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from nice_tpu_torch.analysis import astutil, threadspec
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.racerules import rrule
from nice_tpu_torch.analysis.racerules.context import TREE_PREFIXES

# The reference's nice_tpu/analysis/rules/l1_loop_purity.py tables, as they
# are there (their messages name the event loop, whose rule they come from).
BLOCKING_EXACT = {
    "time.sleep": "time.sleep blocks the loop thread",
    "open": "file I/O blocks the loop thread",
    "sqlite3.connect": "sqlite access on the loop thread",
    "socket.create_connection": "blocking socket connect",
    "subprocess.run": "subprocess wait on the loop thread",
    "subprocess.check_output": "subprocess wait on the loop thread",
    "subprocess.check_call": "subprocess wait on the loop thread",
}
BLOCKING_SUFFIXES = {
    ".result": "Future.result() waits on the loop thread",
    ".execute": "DB execute on the loop thread",
    ".executemany": "DB execute on the loop thread",
    ".fsync": "fsync on the loop thread",
}

EXTRA_SUFFIXES = {
    ".getresponse": "HTTP response wait",
    ".urlopen": "HTTP request wait",
}
# .get / .wait / .join block only without a timeout; receivers are
# filtered to queue/event/thread-ish names to avoid dict.get noise.
TIMEOUT_WAITS = {
    ".get": ("_q", "queue"),
    ".wait": ("event", "_stop", "_wake", "_refill", "cv", "cond"),
    ".join": ("thread", "_thread", "_t"),
}

ANALYSIS_PREFIX = "nice_tpu_torch/analysis/"


def _has_timeout(node: ast.Call) -> bool:
    if any(kw.arg == "timeout" for kw in node.keywords):
        return True
    return len(node.args) >= 2 or (
        len(node.args) == 1 and not isinstance(node.args[0], ast.Constant))


def _blocking_calls(fn: ast.AST) -> List[Tuple[int, str, str]]:
    found: List[Tuple[int, str, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if not name:
            continue
        if name in BLOCKING_EXACT:
            found.append((node.lineno, name, BLOCKING_EXACT[name]))
            continue
        matched = False
        for suffix, why in {**BLOCKING_SUFFIXES, **EXTRA_SUFFIXES}.items():
            if name.endswith(suffix) and name != "self" + suffix:
                found.append((node.lineno, name, why))
                matched = True
                break
        if matched:
            continue
        for suffix, recv_hints in TIMEOUT_WAITS.items():
            if not name.endswith(suffix) or "." not in name:
                continue
            recv = name.rsplit(".", 1)[0].lower()
            if any(h in recv for h in recv_hints) and not \
                    _has_timeout(node):
                found.append((node.lineno, name,
                              f"{suffix[1:]}() without timeout"))
            break
    return found


@rrule("R3")
def check(project: Project, ctx) -> List[Violation]:
    out: List[Violation] = []

    no_block_roots = [r for r in threadspec.THREAD_ROOTS
                      if not r.may_block]

    for (path, qn), fn in sorted(ctx.functions.items()):
        if not path.startswith(TREE_PREFIXES) or \
                path.startswith(ANALYSIS_PREFIX):
            continue
        calls = _blocking_calls(fn)
        if not calls:
            continue
        key = (path, qn)
        roots_here = ctx.roots_reaching(key)

        # (a) reachable from a may_block=False root
        for root in no_block_roots:
            if root.name not in roots_here:
                continue
            for line, callee, why in calls:
                out.append(Violation(
                    "R3", path, line,
                    f"{callee}() reachable from no-block root "
                    f"{root.name} via {qn}: {why}",
                    detail=f"noblock:{root.name}:{qn.rsplit('.', 1)[-1]}"
                           f"->{callee}",
                ))

        # (b) blocking while holding a may_block_under=False lock
        for line, callee, why in calls:
            for label in sorted(ctx.held_at(key, line)):
                spec = threadspec.lock_spec(label)
                if spec is None or spec.may_block_under:
                    continue
                out.append(Violation(
                    "R3", path, line,
                    f"{callee}() while holding {label} "
                    f"(may_block_under=False): {why} — release the lock "
                    "or declare the lock as serializing a blocking "
                    "resource",
                    detail=f"block-under:{label}:{callee}",
                ))
    return out
