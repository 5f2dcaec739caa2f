"""What cudalint reads of the tree, without building or importing it: the
CUDA sources' constants, constexpr functions, tier typedefs and C entry
points (regular expressions over the text), the ctypes binding of
ops/cuda_build.py and the C entries each wrapper of ops/cuda_engine.py
loads (its AST), and the Python mirrors' pure integer code (executed from
the AST of their modules, which import torch, in a namespace of their own).
"""

from __future__ import annotations

import __future__
import ast
import re
from typing import Dict, List, Optional, Tuple

from nice_tpu_torch.analysis import astutil
from nice_tpu_torch.analysis.core import Project


class SourceError(ValueError):
    """A source did not hold what the contracts read from it."""


# -- integer expressions (C constant expressions and constexpr bodies) -------

_BINOPS = {
    ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b, ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b, ast.BitAnd: lambda a, b: a & b,
    ast.BitOr: lambda a, b: a | b, ast.BitXor: lambda a, b: a ^ b,
    ast.LShift: lambda a, b: a << b, ast.RShift: lambda a, b: a >> b,
}
_UNOPS = {ast.USub: lambda a: -a, ast.UAdd: lambda a: a,
          ast.Invert: lambda a: ~a}
_CASTS = re.compile(r"\(\s*(?:const\s+)?(?:unsigned\s+)?(?:int|int32_t|"
                    r"uint32_t|int64_t|uint64_t|size_t|long long)\s*\)")


def c_to_py(expr: str) -> ast.expr:
    """A C integer expression as a Python AST: casts dropped, `/` as floor
    division (every operand here is non-negative), `p.x` as `x`."""
    text = _CASTS.sub("", " ".join(expr.split()))
    text = re.sub(r"\bp\.", "", text).replace("/", "//")
    try:
        return ast.parse(text.strip(), mode="eval").body
    except SyntaxError as exc:
        raise SourceError(f"not an integer expression: {expr!r}") from exc


def c_eval(node: ast.expr, env: Dict[str, int],
           funcs: Optional[Dict[str, Tuple[List[str], ast.expr]]] = None
           ) -> int:
    """Evaluates an integer expression: names from env, calls of the
    constexpr functions in funcs."""
    funcs = funcs or {}
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        if node.id not in env:
            raise SourceError(f"unknown name {node.id}")
        return env[node.id]
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](c_eval(node.left, env, funcs),
                                      c_eval(node.right, env, funcs))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNOPS:
        return _UNOPS[type(node.op)](c_eval(node.operand, env, funcs))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in funcs:
        params, body = funcs[node.func.id]
        args = [c_eval(a, env, funcs) for a in node.args]
        if len(args) != len(params):
            raise SourceError(f"{node.func.id} takes {len(params)} arguments")
        return c_eval(body, {**env, **dict(zip(params, args))}, funcs)
    raise SourceError(f"cannot evaluate {ast.dump(node)}")


# -- CUDA sources -------------------------------------------------------------

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CONSTEXPR = re.compile(r"\bconstexpr\s+int\s+(\w+)\s*=\s*([^;]+);")
_CONSTEXPR_FN = re.compile(
    r"\bconstexpr\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{\s*return\s+([^;]+);\s*\}",
    re.S)
_TYPEDEF_LANE = re.compile(
    r"\btypedef\s+Lane<\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,"
    r"\s*(true|false)\s*>\s+(\w+)\s*;")
_EXTERN_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_C_FUNC = re.compile(
    r"^(?:extern\s+\"C\"\s+)?(?:__global__\s+)?(?:const\s+)?"
    r"(?:int|void|char)\s*\*?\s*(\w+)\s*\(([^)]*)\)\s*\{", re.M)


def strip_comments(text: str) -> str:
    return _COMMENT.sub("", text)


def constexprs(text: str) -> Dict[str, int]:
    """name -> value of every `constexpr int NAME = EXPR;` whose value is a
    constant (in order, so a constant may use the ones before it; a
    template's, which depends on its parameters, is left out)."""
    out: Dict[str, int] = {}
    for name, expr in _CONSTEXPR.findall(strip_comments(text)):
        try:
            out[name] = c_eval(c_to_py(expr), out)
        except SourceError:
            continue
    return out


def constexpr_functions(text: str) -> Dict[str, Tuple[List[str], ast.expr]]:
    """name -> (parameter names, body) of every one-line constexpr
    function `constexpr int f(int a, ...) { return EXPR; }`."""
    out = {}
    for name, params, body in _CONSTEXPR_FN.findall(strip_comments(text)):
        names = [p.split()[-1] for p in params.split(",") if p.strip()]
        out[name] = (names, c_to_py(body))
    return out


def lane_typedefs(text: str) -> Dict[str, Tuple[int, int, int, int]]:
    """typedef name -> the Lane<...> capacities it names."""
    return {m[5]: tuple(int(x) for x in m[:4])
            for m in _TYPEDEF_LANE.findall(strip_comments(text))}


def call_argument(text: str, call: str, index: int) -> str:
    """The source text of argument `index` of the first call `call(...)`."""
    text = strip_comments(text)
    at = text.find(call + "(")
    if at < 0:
        raise SourceError(f"no call {call}(")
    depth, args, cur = 0, [], []
    for ch in text[at + len(call):]:
        if ch == "(":
            depth += 1
            if depth == 1:
                continue
        elif ch == ")":
            depth -= 1
            if depth == 0:
                args.append("".join(cur))
                break
        elif ch == "," and depth == 1:
            args.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if index >= len(args):
        raise SourceError(f"{call} has no argument {index}")
    return args[index].strip()


def _param_type(param: str) -> str:
    """The kind of a C parameter: "ptr", "int", "unsigned", "long long"."""
    p = " ".join(param.split())
    if "*" in p:
        return "ptr"
    words = p.split()[:-1]  # drop the parameter's name
    t = " ".join(w for w in words if w != "const")
    return {"unsigned int": "unsigned", "long long int": "long long"}.get(t, t)


def extern_c_functions(text: str) -> Dict[str, List[str]]:
    """name -> parameter kinds of every function defined with C linkage:
    inside `extern "C" { ... }` blocks, or declared `extern "C"` alone."""
    text = strip_comments(text)
    spans = []
    for m in _EXTERN_BLOCK.finditer(text):
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        spans.append(text[m.end():i])
    spans += [m.group(0) + "{" for m in re.finditer(
        r'^extern\s+"C"\s+[^{;]*\)\s*(?=\{)', text, re.M)]
    out: Dict[str, List[str]] = {}
    for body in spans:
        for name, params in _C_FUNC.findall(body):
            plist = [p for p in params.split(",") if p.strip()]
            out[name] = [_param_type(p) for p in plist]
    return out


# -- the Python side ----------------------------------------------------------

_SAFE_BUILTINS = {"max": max, "min": min, "int": int, "abs": abs,
                  "len": len, "range": range, "ValueError": ValueError}
_ANNOTATIONS = __future__.annotations.compiler_flag


def py_mirror(project: Project, relpath: str, names,
              env: Optional[Dict[str, object]] = None,
              overrides: Optional[Dict[str, object]] = None
              ) -> Dict[str, object]:
    """The named module-level constants and functions of a module of the
    tree, executed from its AST (in source order, decorators dropped) in a
    namespace of their own: the module is not imported, so torch is not.
    env seeds the namespace (what the code refers to beyond the names);
    overrides replace names after execution (a function reads them at
    call time). Raises SourceError when a name is missing."""
    src = project.get(relpath)
    if src is None or src.tree() is None:
        raise SourceError(f"{relpath}: missing or unparsable")
    wanted = set(names)
    body, found = [], set()
    for node in src.tree().body:
        if isinstance(node, ast.FunctionDef) and node.name in wanted:
            node = ast.FunctionDef(**{**node.__dict__, "decorator_list": []})
            body.append(node)
            found.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            hit = {t.id for t in targets if isinstance(t, ast.Name)} & wanted
            if hit:
                body.append(node)
                found |= hit
    missing = wanted - found
    if missing:
        raise SourceError(f"{relpath}: no module-level {sorted(missing)}")
    module = ast.fix_missing_locations(ast.Module(body=body, type_ignores=[]))
    code = compile(module, relpath, "exec", flags=_ANNOTATIONS,
                   dont_inherit=True)
    ns: Dict[str, object] = {"__builtins__": _SAFE_BUILTINS, **(env or {})}
    exec(code, ns)  # the tree's own pure integer code
    ns.update(overrides or {})
    return {k: ns[k] for k in wanted}


_CTYPES_KIND = {"c_void_p": "ptr", "c_char_p": "ptr", "c_int": "int",
                "c_uint": "unsigned", "c_longlong": "long long",
                "c_uint64": "unsigned long long"}


def _ctypes_kind(node: ast.AST, aliases: Dict[str, ast.AST]) -> str:
    if isinstance(node, ast.Name) and node.id in aliases:
        return _ctypes_kind(aliases[node.id], aliases)
    if isinstance(node, ast.Call) and \
            (astutil.call_name(node) or "").endswith("POINTER"):
        return "ptr"
    name = astutil.dotted(node) or ""
    return _CTYPES_KIND.get(name.rsplit(".", 1)[-1], f"?{name}")


def ctypes_signatures(project: Project, relpath: str,
                      func: str = "bind") -> Dict[str, Tuple[int, List[str]]]:
    """name -> (line, argument kinds) of each C function the binding
    function sets argtypes for: its `signatures` dict and any
    `lib.<name>.argtypes = [...]`."""
    src = project.get(relpath)
    tree = src.tree() if src is not None else None
    fn = next((n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
               and n.name == func), None) if tree is not None else None
    if fn is None:
        raise SourceError(f"{relpath}: no function {func}")
    aliases: Dict[str, ast.AST] = {}
    out: Dict[str, Tuple[int, List[str]]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        if isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple):
            for t, v in zip(target.elts, value.elts):
                if isinstance(t, ast.Name):
                    aliases[t.id] = v
        elif isinstance(target, ast.Name):
            aliases[target.id] = value
    sig = aliases.get("signatures")
    if isinstance(sig, ast.Dict):
        for k, v in zip(sig.keys, sig.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.List):
                out[k.value] = (k.lineno,
                                [_ctypes_kind(e, aliases) for e in v.elts])
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = astutil.dotted(node.targets[0]) or ""
            parts = name.split(".")
            if len(parts) == 3 and parts[2] == "argtypes" and \
                    isinstance(node.value, ast.List):
                out[parts[1]] = (node.lineno, [_ctypes_kind(e, aliases)
                                               for e in node.value.elts])
    return out


def wrapper_loads(project: Project, relpath: str) -> Dict[str, Tuple[int, set]]:
    """public function -> (line, the nice_* C entries it reaches as an
    attribute of a loaded library)."""
    src = project.get(relpath)
    if src is None or src.tree() is None:
        raise SourceError(f"{relpath}: missing or unparsable")
    out = {}
    for node in src.tree().body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            entries = {n.attr for n in ast.walk(node)
                       if isinstance(n, ast.Attribute)
                       and n.attr.startswith("nice_")}
            out[node.name] = (node.lineno, entries)
    return out
