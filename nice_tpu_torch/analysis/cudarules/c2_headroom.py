"""C2: int32 headroom (the twin of nice_tpu/analysis/jaxrules/j2_headroom.py,
whose number it keeps).

J2 proves by interval abstract interpretation over traced jaxprs that no
integer op wraps. A CUDA kernel cannot be traced, so C2 checks each bound
the registry declares by integer arithmetic over the spec's static domain,
with the tree's own integer code (the engine's clamp_segment and
_flush_every, the mxu mirror, the CUDA source's constants and constexpr
functions) read without importing it. Each obligation is a named function
returning its failures:

* ``k1_flush_budget`` (K1, and K5's detailed mode): after clamp_segment,
  one dispatch's lanes on every slice, batch * segment * n_dev, and the
  most a bin gathers before a flush, _flush_every(lanes * n_dev) * lanes *
  n_dev, stay at or below ACC_LIMIT // 2, itself at most HIST_ACC_BOUND:
  so every int32 bin, each slice's row, the mesh fold's row and the
  near-miss count stay below 2^31.
* ``k5_accum``: K5's s32 column sums, accum_bound(), fit; ``k5_lanes``:
  the wrapper refuses 2^31 lanes and takes one fewer; ``k5_smem``: the
  block's shared memory, by the CUDA source's formula, fits
  kMmaSmemMax for every plan mxu.supports_plan admits, in both modes.
* ``k3_counts``: a row counts at most periods * R <= STRIDED_OFFS_LANES_MAX
  candidates, and rows (at most STRIDED_DESC_MAX) fit the grid's y extent.
* ``k4_counts``: count and pruned are each at most the run's lanes, which
  fit u32 and int32.
* ``scalar_types``: every scalar argument of every entry fits its C type
  (and the type the C code narrows it to) over its domain.
* ``entry_domain``: an engine entry point that calls clamp_segment but
  bounds batch_size only from below admits batch_size * n_dev past
  ACC_LIMIT // 2, where clamp_segment returns 1 and the budget no longer
  holds. The reference has the same gap; each such site carries an inline
  allow naming ROADMAP queue 3, so the finding stays visible (cudalint
  prints it) without failing the run.
"""

from __future__ import annotations

import ast
import types
from typing import Callable, Dict, List, Tuple

from nice_tpu_torch.analysis import astutil, kernelspec as ks
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.cudarules import crule, line_of, sources

ENGINE = "nice_tpu_torch/ops/engine.py"
CE_PATH = "nice_tpu_torch/ops/cuda_engine.py"
MXU_PATH = "nice_tpu_torch/ops/mxu.py"

Failure = Tuple[str, str, str, int]  # (detail, message, path, line)
OBLIGATIONS: Dict[str, Callable[[Project], List[Failure]]] = {}


def obligation(name: str):
    def deco(fn):
        OBLIGATIONS[name] = fn
        return fn
    return deco


def grid(lo: int, hi: int) -> List[int]:
    """The probe points of [lo, hi]: its ends and every power of two in it
    with its neighbours."""
    pts = {lo, hi}
    k = 0
    while (1 << k) - 1 <= hi:
        pts.update(x for x in ((1 << k) - 1, 1 << k, (1 << k) + 1)
                   if lo <= x <= hi)
        k += 1
    return sorted(pts)


@obligation("k1_flush_budget")
def k1_flush_budget(project: Project) -> List[Failure]:
    eng = sources.py_mirror(project, ENGINE,
                            ("clamp_segment", "_flush_every", "ACC_LIMIT"),
                            overrides={"ACC_LIMIT": ks.ACC_LIMIT})
    clamp, flush = eng["clamp_segment"], eng["_flush_every"]
    half = ks.ACC_LIMIT // 2
    line = line_of(project.read(ENGINE), "def clamp_segment")
    if half > ks.HIST_ACC_BOUND[1] or half > ks.I32_MAX:
        return [("k1_flush_budget:acc-limit",
                 f"ACC_LIMIT // 2 = {half} passes HIST_ACC_BOUND "
                 f"{ks.HIST_ACC_BOUND[1]}: an int32 bin may pass 2^31",
                 ENGINE, line)]
    out: Dict[str, Failure] = {}
    dom = ks.DOMAIN
    for batch in grid(*dom["batch_size"]):
        for n_dev in grid(*dom["n_dev"]):
            for segment in grid(*dom["segment"]):
                seg = clamp(segment, batch, n_dev)
                lanes = batch * seg          # one slice's dispatch
                row = lanes * n_dev          # the fold's row
                fe = flush(row)
                at = f"batch {batch}, segment {segment}, n_dev {n_dev}"
                if not 1 <= seg <= segment:
                    out.setdefault("segment", (
                        "k1_flush_budget:segment",
                        f"clamp_segment gives {seg} at {at}", ENGINE, line))
                if row > half:
                    out.setdefault("lanes", (
                        "k1_flush_budget:lanes",
                        f"a dispatch's lanes {row} pass ACC_LIMIT // 2 = "
                        f"{half} at {at}", ENGINE, line))
                if fe * row > half:
                    out.setdefault("bins", (
                        "k1_flush_budget:bins",
                        f"a bin may gather {fe} x {row} = {fe * row} > "
                        f"ACC_LIMIT // 2 before a flush at {at}", ENGINE,
                        line))
    return list(out.values())


def _mxu(project: Project) -> Dict[str, object]:
    from nice_tpu_torch.analysis.cudarules.c6_kernelspec import MXU_NAMES
    return sources.py_mirror(project, MXU_PATH, MXU_NAMES)


@obligation("k5_accum")
def k5_accum(project: Project) -> List[Failure]:
    bound = _mxu(project)["accum_bound"]()
    if bound > ks.I32_MAX:
        return [("k5_accum:accum_bound",
                 f"K5's column sums reach {bound}, past the s32 accumulator",
                 MXU_PATH, line_of(project.read(MXU_PATH), "def accum_bound"))]
    return []


@obligation("k5_lanes")
def k5_lanes(project: Project) -> List[Failure]:
    mxu = types.SimpleNamespace(**_mxu(project))
    check = sources.py_mirror(project, CE_PATH, ("_check_mxu",),
                              env={"mxu": mxu})["_check_mxu"]
    line = line_of(project.read(CE_PATH), "def _check_mxu")
    shape = ks.plan_shape(40)
    try:
        check(shape, 1, (1 << 31) - 1)
    except ValueError:
        return [("k5_lanes:refuses-below", "_check_mxu refuses 2^31 - 1 "
                 "lanes, which K5's offsets take", CE_PATH, line)]
    try:
        check(shape, 1, 1 << 31)
    except ValueError:
        return []
    return [("k5_lanes:takes-2^31", "_check_mxu takes 2^31 lanes: K5's lane "
             "offsets are below 2^31", CE_PATH, line)]


@obligation("k5_smem")
def k5_smem(project: Project) -> List[Failure]:
    cuh = project.read(ks.CUH) or ""
    funcs = sources.constexpr_functions(cuh)
    consts = sources.constexprs(cuh)
    front = sources.c_to_py(sources.call_argument(
        project.read(ks.GRID) or "", "k5_smem_bytes", 2))
    call = sources.c_to_py("k5_smem_bytes(limbs_sq, limbs_cu, FRONT)")
    limit = consts.get("kMmaSmemMax", 0)
    supports = _mxu(project)["supports_plan"]
    for shape in ks.valid_shapes():
        if not supports(shape):
            continue
        env = {**consts, "base": shape.base, "limbs_sq": shape.limbs_sq,
               "limbs_cu": shape.limbs_cu}
        for mode, f in (("detailed", sources.c_eval(front, env, funcs)),
                        ("dense", 0)):
            got = sources.c_eval(call, {**env, "FRONT": f}, funcs)
            if got > limit:
                return [(f"k5_smem:{mode}",
                         f"mxu.supports_plan admits b{shape.base}, whose K5 "
                         f"block ({mode}) needs {got} bytes of shared memory "
                         f"> kMmaSmemMax {limit}", ks.CUH,
                         line_of(cuh, "kMmaSmemMax"))]
    return []


@obligation("k3_counts")
def k3_counts(project: Project) -> List[Failure]:
    out = []
    spec = ks.SPECS["nice_plan_strided_niceonly"]
    params = {p.name: p for p in spec.params}
    shape = ks.plan_shape(97)
    row_max = min(params["periods"].high(shape) * params["num_res"].high(shape),
                  ks.STRIDED_OFFS_LANES_MAX)
    if ks.STRIDED_OFFS_LANES_MAX > ks.I32_MAX or row_max > ks.I32_MAX:
        out.append(("k3_counts:row", f"a row may count {row_max} > 2^31 - 1",
                    ks.PLAN_CU, 1))
    rows = params["n_real"].high(shape)
    if rows > ks.STRIDED_DESC_MAX or ks.STRIDED_DESC_MAX > ks.GRID_Y_MAX:
        out.append(("k3_counts:rows", f"{rows} rows on a grid's y extent of "
                    f"{ks.GRID_Y_MAX} (STRIDED_DESC_MAX "
                    f"{ks.STRIDED_DESC_MAX})", ks.PLAN_CU, 1))
    blocks = -(-ks.STRIDED_OFFS_LANES_MAX // ks.THREADS)
    if blocks > ks.I32_MAX:
        out.append(("k3_counts:grid-x", f"{blocks} blocks a row",
                    ks.PLAN_CU, 1))
    return out


@obligation("k4_counts")
def k4_counts(project: Project) -> List[Failure]:
    spec = ks.SPECS["nice_niceonly_dense"]
    params = {p.name: p for p in spec.params}
    for base in ks.PROBE_BASES + ks.SWEEP_BASES:
        shape = ks.plan_shape(base)
        if spec.tier(shape, 0) is None:
            continue
        valid = params["valid_total"].high(shape)
        m = base - 1
        lanes = params["num_cls"].high(shape) * -(-valid // m)
        if lanes > ks.U32_MAX or valid > ks.I32_MAX:
            return [("k4_counts:lanes",
                     f"b{base}: a run of {valid} lanes walks {lanes} class "
                     "lanes: past u32, or its counts past int32", ks.MAIN_CU,
                     1)]
    return []


@obligation("scalar_types")
def scalar_types(project: Project) -> List[Failure]:
    out = []
    shapes = [ks.plan_shape(b) for b in ks.PROBE_BASES + ks.SWEEP_BASES]
    for spec in ks.all_specs().values():
        taken = [s for s in shapes if spec.kind == "shape" or any(
            spec.tier(s, mma) for mma in spec.modes)]
        for p in spec.params:
            if p.ctype == "ptr":
                continue
            for shape in taken:
                lo, hi = p.lo, p.high(shape)
                for ctype in filter(None, (p.ctype, p.cast)):
                    tlo, thi = ks.C_TYPE_RANGE[ctype]
                    if lo < tlo or hi > thi:
                        out.append((
                            f"scalar_types:{spec.name}:{p.name}:{ctype}",
                            f"{spec.name}'s {p.name} ranges over [{lo}, {hi}] "
                            f"at b{shape.base}, past {ctype}", spec.source, 1))
                        break
    return list({f[0]: f for f in out}.values())


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _guards_above(fn: ast.AST, name: str) -> bool:
    """Whether fn compares `name` against an upper bound anywhere (`name >
    x`, `x < name`; a comparison with 0 is a lower check)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            if _mentions(left, name) and isinstance(op, (ast.Gt, ast.GtE)):
                bound = right
            elif _mentions(right, name) and isinstance(op, (ast.Lt, ast.LtE)):
                bound = left
            else:
                bound = None
            if bound is not None and not (isinstance(bound, ast.Constant)
                                          and bound.value == 0):
                return True
            left = right
    return False


@obligation("entry_domain")
def entry_domain(project: Project) -> List[Failure]:
    src = project.get(ENGINE)
    if src is None or src.tree() is None:
        return [("entry_domain:unreadable", f"{ENGINE} missing", ENGINE, 1)]
    tree = src.tree()
    innermost = astutil.enclosing_function_map(tree)
    funcs = dict(astutil.iter_functions(tree))
    out = []
    for call in ast.walk(tree):
        if not (isinstance(call, ast.Call)
                and astutil.call_name(call) == "clamp_segment"):
            continue
        qn = innermost.get(call.lineno, "<module>")
        fn = funcs.get(qn)
        if fn is not None and _guards_above(fn, "batch_size"):
            continue
        out.append((
            f"entry_domain:{qn}",
            f"{qn} bounds batch_size only from below: it admits batch_size "
            f"* n_dev past ACC_LIMIT // 2 (the spec's domain: batch_size <= "
            f"{ks.DOMAIN['batch_size'][1]}, n_dev <= "
            f"{ks.DOMAIN['n_dev'][1]}), where clamp_segment returns 1 and "
            "the int32 budget no longer holds", ENGINE, call.lineno))
    return out


@crule("C2")
def check(project: Project, ctx) -> List[Violation]:
    out: Dict[str, Violation] = {}
    report = {}
    for name, fn in OBLIGATIONS.items():
        try:
            failures = fn(project)
        except sources.SourceError as exc:
            failures = [(f"{name}:unreadable", str(exc), ks.CUH, 1)]
        report[name] = len(failures)
        for detail, message, path, line in failures:
            v = Violation("C2", path, line, message, detail)
            out.setdefault(f"{v.key}|{line}", v)
    ctx.report["c2"] = {"obligations": report}
    return list(out.values())
