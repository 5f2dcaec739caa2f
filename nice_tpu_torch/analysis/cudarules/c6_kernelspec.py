"""C6: KernelSpec drift (the twin of nice_tpu/analysis/jaxrules/
j6_kernelspec.py, whose number it keeps).

(a) **Coverage.** Every C entry a public wrapper of ``ops/cuda_engine.py``
    loads has a spec naming that wrapper, every spec's wrappers load it and
    its source defines it, every ``extern "C"`` function of the kernel
    libraries (``nice_kernels.cu``, ``plan_kernels.cu``) is specced or a
    helper, every other CUDA source with C functions is exempt by name, the
    specs cover K1-K5, and each cited ``pallas_call`` line of the reference
    holds one (where the reference is in the tree).
(b) **Shape drift.** At the sweep bases, each spec's plain version on the
    CPU gives the declared outputs' shapes and dtypes, updates its in-place
    arguments in place, and the registry's plan shape is ops/limbs'.
(c) **Constant drift.** Every contract constant equals its Python mirror
    and its CUDA definition; the tier typedefs equal the declared
    capacities; K5's shared memory, C's formula and the Python mirror's,
    agree at every valid base; and the tier predicates (supports_base,
    plan_tier_takes, mxu.supports_plan, reference_takes, the tiers' fits)
    agree with the specs over a probe sweep bracketing each cap.
(d) **ABI drift.** Each ctypes ``argtypes`` list of ``cuda_build.bind`` has
    its C prototype's parameter count and kinds (pointer, ``int``,
    ``unsigned``, ``long long``), and so has each spec's parameter list.
(e) **Block-size drift.** The admissible block sizes are one rule in four
    places: nice_grid.cuh's ``block_threads_ok`` (with K5's least size),
    ``cuda_engine.block_threads_ok``, the registry's ``block_threads_ok``
    and each spec's ``block_threads`` domain. They must admit the same sizes
    over a sweep past both ends, every C entry must refuse the others with
    ``kBadThreads``, and (with the shape bases) each plain version must run
    at its least size and raise on a size outside the set.
"""

from __future__ import annotations

import os
from typing import Dict, List

from nice_tpu_torch.analysis import kernelspec as ks
from nice_tpu_torch.analysis.core import Project, Violation
from nice_tpu_torch.analysis.cudarules import crule, line_of, sources

KS_PATH = "nice_tpu_torch/analysis/kernelspec.py"
CE_PATH = "nice_tpu_torch/ops/cuda_engine.py"
MXU_PATH = "nice_tpu_torch/ops/mxu.py"
CSRC = "nice_tpu_torch/csrc"
KERNELS = ("K1", "K2", "K3", "K4", "K5")
# The plain runs of (b): lanes a batch, batches, and K3's rows.
BATCH, N_ITERS = 8, 2
CE_BLOCK_NAMES = ("block_threads_ok", "block_threads_min", "WARP",
                  "BLOCK_THREADS_MAX", "MMA_BLOCK_THREADS_MIN")
# The sizes the block-size rules are compared at: past both ends.
BLOCK_SWEEP = range(-32, 2 * ks.THREADS + 33)
MXU_NAMES = ("supports_plan", "smem_bytes", "accum_bound", "reference_takes",
             "tiles", "SMEM_LIMIT", "SOURCE_PAD", "TILE_LIMBS", "D_ROWS",
             "_DIGIT_MAX")


def _v(path: str, line: int, detail: str, message: str) -> Violation:
    return Violation("C6", path, line, message, detail)


def _c_entries(project: Project) -> Dict[str, Dict[str, List[str]]]:
    """source path -> its C functions, for every CUDA source of csrc/."""
    out = {}
    base = os.path.join(project.root, CSRC)
    for fn in sorted(os.listdir(base)) if os.path.isdir(base) else ():
        if fn.endswith(".cu"):
            rel = f"{CSRC}/{fn}"
            out[rel] = sources.extern_c_functions(project.read(rel))
    return out


def check_coverage(project: Project) -> List[Violation]:
    out = []
    specs = ks.all_specs()
    loads = sources.wrapper_loads(project, CE_PATH)
    for fn, (line, entries) in sorted(loads.items()):
        for entry in sorted(entries - set(ks.HELPERS)):
            if entry not in specs:
                out.append(_v(CE_PATH, line, f"unspecced-entry:{entry}",
                              f"{fn} loads {entry}, which has no KernelSpec "
                              "in analysis/kernelspec.py"))
            elif fn not in specs[entry].wrappers:
                out.append(_v(CE_PATH, line, f"wrapper-drift:{entry}:{fn}",
                              f"{fn} loads {entry}, whose spec does not "
                              "name it as a wrapper"))
    c_funcs = _c_entries(project)
    for spec in specs.values():
        for w in spec.wrappers:
            if w not in loads or spec.name not in loads[w][1]:
                out.append(_v(KS_PATH, 1, f"spec-wrapper-drift:{spec.name}:{w}",
                              f"the spec of {spec.name} names wrapper {w}, "
                              "which does not load it"))
        if spec.name not in c_funcs.get(spec.source, {}):
            out.append(_v(spec.source, 1, f"spec-source-drift:{spec.name}",
                          f"{spec.source} does not define {spec.name}"))
    for rel, funcs in c_funcs.items():
        if rel in (ks.MAIN_CU, ks.PLAN_CU):
            text = project.read(rel)
            for name in sorted(funcs):
                if name not in specs and name not in ks.HELPERS:
                    out.append(_v(rel, line_of(text, f" {name}("),
                                  f"unspecced-c-entry:{name}",
                                  f"{name} has no KernelSpec"))
        elif funcs and rel not in ks.EXEMPT_SOURCES:
            out.append(_v(rel, 1, f"unexempt-source:{rel}",
                          f"{rel} defines C functions {sorted(funcs)} but is "
                          "neither a kernel library nor exempt"))
    launches = set(sources.py_mirror(project, CE_PATH, ["LAUNCHES"])
                   ["LAUNCHES"])
    named = {k for spec in specs.values() for k in spec.launches}
    for key in sorted(launches ^ named):
        out.append(_v(KS_PATH, 1, f"launches-drift:{key}",
                      f"LAUNCHES key {key} is in one of cuda_engine.LAUNCHES "
                      "and the specs' launches, not both"))
    for spec in specs.values():
        for ref in spec.plain:
            path, func = ref.split(":")
            src = project.get(path)
            if src is not None and not any(
                    getattr(n, "name", None) == func
                    for n in (src.tree().body if src.tree() else ())):
                out.append(_v(KS_PATH, 1, f"plain-drift:{spec.name}:{func}",
                              f"{ref}, the plain version of {spec.name}, "
                              "is not defined"))
    covered = {k for spec in specs.values() for k in spec.kernels}
    for k in KERNELS:
        if k not in covered:
            out.append(_v(KS_PATH, 1, f"kernel-uncovered:{k}",
                          f"no spec launches {k}"))
    for k, cite in ks.JAX_CALLS.items():
        path, line = cite.rsplit(":", 1)
        text = project.read(path)
        if text is None:
            continue  # a tree without the reference beside it
        lines = text.splitlines()
        if int(line) > len(lines) or "pallas_call" not in lines[int(line) - 1]:
            out.append(_v(KS_PATH, 1, f"jax-cite-drift:{k}",
                          f"{cite} (the TPU kernel {k} replaces) holds no "
                          "pallas_call"))
    return out


def _run_plain(spec: ks.KernelSpec, plan, mma: int,
               block_threads: int = ks.THREADS):
    """(outputs, inputs) by name of the spec's plain version on the CPU,
    through its wrapper (a CPU tensor takes the plain version), at
    block_threads."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import int_to_limbs

    st = ve.start_limbs_tensor(plan.range_start, plan, "cpu")
    valid = BATCH * N_ITERS - 3
    if spec.name in ("nice_detailed_megaloop", "nice_plan_detailed_megaloop",
                     "nice_plan_detailed_megaloop_mma"):
        acc = torch.zeros(plan.base + 2, dtype=torch.int32)
        h, nm = ce.detailed_accum_megaloop(plan, BATCH, N_ITERS, acc, st,
                                           valid, use_mxu=mma,
                                           block_threads=block_threads)
        return [("hist_acc", h), ("nm", nm)], {"hist_acc": acc}
    if spec.name in ("nice_uniques", "nice_plan_uniques"):
        return [("uniques", ce.uniques_batch(plan, BATCH, st))], {}
    if spec.name == "nice_niceonly_dense":
        classes = ce.niceonly_classes(plan, True, "cpu")
        out = ce.niceonly_dense_megaloop(plan, BATCH, N_ITERS, classes, st,
                                         valid, use_mxu=mma,
                                         block_threads=block_threads)
        return [("count_pruned", out)], {}
    if spec.name == "nice_plan_strided_niceonly":
        desc = np.zeros((BATCH, ks.DESC_WIDTH), dtype=np.int64)
        lo = plan.range_start
        for row in range(BATCH):
            for k, x in enumerate((lo, lo, lo + 64)):
                desc[row, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
        counts = ce.strided_niceonly_batch(
            plan, 6, torch.tensor([1, 5], dtype=torch.int64), 4,
            torch.from_numpy(desc), BATCH - 1, block_threads=block_threads)
        return [("counts", counts)], {}
    raise KeyError(f"no plain run for {spec.name}")


def check_shapes(bases) -> List[Violation]:
    from nice_tpu_torch.ops.limbs import get_plan

    out = []
    for base in bases:
        plan, shape = get_plan(base), ks.plan_shape(base)
        got_shape = tuple(getattr(plan, f) for f in
                          ("limbs_n", "limbs_sq", "limbs_cu", "n_masks",
                           "range_start", "range_end"))
        if shape is None or got_shape != (
                shape.limbs_n, shape.limbs_sq, shape.limbs_cu, shape.n_masks,
                shape.range_start, shape.range_end):
            out.append(_v(KS_PATH, 1, f"plan-shape-drift:b{base}",
                          f"plan_shape({base}) differs from ops/limbs' plan"))
            continue
        for spec in ks.all_specs().values():
            if spec.kind != "launch":
                continue
            for mma in spec.modes:
                if spec.tier(shape, mma) is None:
                    continue
                outs, inputs = _run_plain(spec, plan, mma)
                got = tuple((name, tuple(t.shape),
                             str(t.dtype).replace("torch.", ""))
                            for name, t in outs)
                want = tuple((name, tuple(s), d) for name, s, d in
                             spec.outputs(shape, BATCH, N_ITERS))
                tag = f"{spec.name}:b{base}:mma{mma}"
                if got != want:
                    out.append(_v(KS_PATH, 1, f"shape-drift:{tag}",
                                  f"{tag}: the plain version gives {got}, "
                                  f"the spec declares {want}"))
                # The in-place arguments the plain version takes (the
                # others, such as the ring slots, are the kernel's alone).
                for name in set(spec.in_place) & set(inputs):
                    result = dict(outs)[name]
                    if result.data_ptr() != inputs[name].data_ptr():
                        out.append(_v(KS_PATH, 1, f"in-place-drift:{tag}",
                                      f"{tag}: an in-place argument came "
                                      "back as a new tensor"))
    return out


def check_plain_block_rule(bases) -> List[Violation]:
    """Each launch spec's plain version, at the first shape base it takes:
    it runs at its least block size and raises ValueError on a size the
    rule refuses (K2's entries take no block size)."""
    from nice_tpu_torch.ops.limbs import get_plan

    out = []
    for spec in ks.all_specs().values():
        params = {p.name: p for p in spec.params}
        if spec.kind != "launch" or "block_threads" not in params:
            continue
        for mma in spec.modes:
            base = next((b for b in bases
                         if spec.tier(ks.plan_shape(b), mma) is not None), None)
            if base is None:
                continue
            lo = ks.block_threads_min(mma)
            tag = f"{spec.name}:b{base}:mma{mma}"
            for threads in (lo, lo - ks.WARP, lo + ks.WARP // 2,
                            ks.THREADS + ks.WARP):
                try:
                    _run_plain(spec, get_plan(base), mma, threads)
                    ran = True
                except ValueError:
                    ran = False
                if ran != ks.block_threads_ok(threads, mma):
                    out.append(_v(KS_PATH, 1,
                                  f"plain-block-drift:{tag}:{threads}",
                                  f"{tag}: the plain version "
                                  f"{'ran' if ran else 'refused'} "
                                  f"block_threads {threads}"))
    return out


def check_block_rule(project: Project) -> List[Violation]:
    """(e) without the plain versions: the CUDA rule, the Python rule, the
    registry's and each spec's domain admit the same sizes, and every C
    entry that takes a block size refuses the others before launching."""
    try:
        grid = project.read(ks.GRID) or ""
        funcs = sources.constexpr_functions(grid)
        consts = sources.constexprs(grid)
        ce = sources.py_mirror(project, CE_PATH, CE_BLOCK_NAMES)
        rule = sources.c_to_py("block_threads_ok(threads, lo)")
    except sources.SourceError as exc:
        return [_v(ks.GRID, 1, "block-rule-unreadable", str(exc))]
    out: Dict[str, Violation] = {}
    for mma, lo_name in ((0, "kWarp"), (1, "kMmaMinThreads")):
        for threads in BLOCK_SWEEP:
            try:
                c_ok = bool(sources.c_eval(
                    rule, {**consts, "threads": threads,
                           "lo": consts.get(lo_name)}, funcs))
            except (sources.SourceError, TypeError) as exc:
                return [_v(ks.GRID, 1, "block-rule-unreadable", str(exc))]
            got = {"cuda": c_ok, "py": bool(ce["block_threads_ok"](threads,
                                                                    mma))}
            want = ks.block_threads_ok(threads, mma)
            for where, ok in got.items():
                detail = f"block-rule-drift:{where}:mma{mma}"
                if ok != want and detail not in out:
                    path = ks.GRID if where == "cuda" else CE_PATH
                    out[detail] = _v(
                        path, line_of(project.read(path) or "",
                                      "block_threads_ok"), detail,
                        f"{path} {'admits' if ok else 'refuses'} "
                        f"block_threads {threads} (mma {mma}); the spec "
                        f"{'admits' if want else 'refuses'} it")
    out = list(out.values())
    sources_text = {rel: project.read(rel) or ""
                    for rel in (ks.MAIN_CU, ks.PLAN_CU)}
    for spec in ks.all_specs().values():
        params = {p.name: p for p in spec.params}
        if "block_threads" not in params:
            continue
        p = params["block_threads"]
        lo = min(ks.block_threads_min(m) for m in spec.modes)
        if (p.lo, p.hi) != (lo, ks.THREADS):
            out.append(_v(KS_PATH, 1, f"block-domain-drift:{spec.name}",
                          f"{spec.name}'s block_threads domain is "
                          f"[{p.lo}, {p.hi}], the rule's [{lo}, {ks.THREADS}]"))
        body = sources.c_function_body(sources_text[spec.source], spec.name)
        if body is None or "block_threads_ok(block_threads" not in body \
                or "kBadThreads" not in body:
            out.append(_v(spec.source, line_of(sources_text[spec.source],
                                               f" {spec.name}("),
                          f"block-check-missing:{spec.name}",
                          f"{spec.name} does not refuse a block size outside "
                          "the rule (block_threads_ok, kBadThreads)"))
    return out


def check_constants(project: Project) -> List[Violation]:
    out = []
    cuda_consts: Dict[str, Dict[str, int]] = {}
    for m in ks.MIRRORS:
        if m.py is not None:
            path, sym = m.py
            try:
                got = sources.py_mirror(project, path, [sym])[sym]
            except sources.SourceError as exc:
                out.append(_v(path, 1, f"constant-missing:{m.name}:py",
                              str(exc)))
                continue
            if got != m.value:
                out.append(_v(path, line_of(project.read(path), sym),
                              f"constant-drift:{m.name}:py",
                              f"{path} {sym} = {got}, the spec's {m.name} = "
                              f"{m.value}"))
        if m.cuda is not None:
            path, sym = m.cuda
            if path not in cuda_consts:
                cuda_consts[path] = sources.constexprs(project.read(path) or "")
            got = cuda_consts[path].get(sym)
            if got != m.value:
                out.append(_v(path, line_of(project.read(path), sym),
                              f"constant-drift:{m.name}:cuda",
                              f"{path} {sym} = {got}, the spec's {m.name} = "
                              f"{m.value}"))
    cuh = project.read(ks.CUH) or ""
    typedefs = sources.lane_typedefs(cuh)
    for tier, tname in ks.TIER_TYPEDEFS.items():
        if typedefs.get(tname) != ks.TIERS[tier]:
            out.append(_v(ks.CUH, line_of(cuh, tname), f"tier-drift:{tname}",
                          f"{tname} is Lane<{typedefs.get(tname)}>, the "
                          f"spec's {tier} tier {ks.TIERS[tier]}"))
    out += _check_smem(project, cuh)
    out += _check_predicates(project, typedefs, cuda_consts.get(ks.CUH, {}))
    return out


def _check_smem(project: Project, cuh: str) -> List[Violation]:
    """K5's shared memory: the CUDA formula (with the detailed launch's
    front, from nice_grid.cuh's k5_shape), the Python mirror and the spec,
    at every valid base."""
    try:
        funcs = sources.constexpr_functions(cuh)
        consts = sources.constexprs(cuh)
        front = sources.c_to_py(sources.call_argument(
            project.read(ks.GRID) or "", "k5_smem_bytes", 2))
        mxu = sources.py_mirror(project, MXU_PATH, MXU_NAMES)
    except sources.SourceError as exc:
        return [_v(ks.CUH, 1, "smem-unreadable", str(exc))]
    for shape in ks.valid_shapes():
        env = {**consts, "base": shape.base, "limbs_sq": shape.limbs_sq,
               "limbs_cu": shape.limbs_cu}
        c_bytes = sources.c_eval(
            sources.c_to_py("k5_smem_bytes(limbs_sq, limbs_cu, FRONT)"),
            {**env, "FRONT": sources.c_eval(front, env, funcs)}, funcs)
        want = ks.k5_smem_bytes(shape, ks.k5_front(shape))
        if not c_bytes == mxu["smem_bytes"](shape) == want:
            return [_v(ks.CUH, line_of(cuh, "k5_smem_bytes"),
                       f"smem-drift:b{shape.base}",
                       f"K5's shared memory at b{shape.base}: CUDA {c_bytes}, "
                       f"ops/mxu.py {mxu['smem_bytes'](shape)}, spec {want}")]
    return []


def _check_predicates(project: Project, typedefs, cuh_consts
                      ) -> List[Violation]:
    out = []
    try:
        ce = sources.py_mirror(project, CE_PATH, (
            "supports_base", "plan_tier_takes", "MAX_HIST_BINS",
            "PLAN_TIER_LIMBS"))
        mxu = sources.py_mirror(project, MXU_PATH, MXU_NAMES)
    except sources.SourceError as exc:
        return [_v(CE_PATH, 1, "predicates-unreadable", str(exc))]
    if mxu["accum_bound"]() != ks.accum_bound():
        out.append(_v(MXU_PATH, line_of(project.read(MXU_PATH), "accum_bound"),
                      "predicate-drift:accum_bound",
                      f"mxu.accum_bound() = {mxu['accum_bound']()}, the "
                      f"spec's {ks.accum_bound()}"))
    c_plan_limbs = cuh_consts.get("kPlanTierLimbs")
    for base in sorted(set(ks.PROBE_BASES + ks.SWEEP_BASES)):
        shape = ks.plan_shape(base)
        pairs = {
            "supports_base": (ce["supports_base"](shape),
                              ks.supports_base(shape)),
            "plan_tier_takes": (ce["plan_tier_takes"](shape),
                                ks.plan_tier_takes(shape)),
            "plan_tier_takes_cuda": (c_plan_limbs is not None and
                                     shape.limbs_n <= c_plan_limbs,
                                     ks.plan_tier_takes(shape)),
            "supports_plan": (mxu["supports_plan"](shape),
                              ks.k5_takes(shape)),
            "reference_takes": (mxu["reference_takes"](shape),
                                ks.reference_takes(shape)),
        }
        for tier, tname in ks.TIER_TYPEDEFS.items():
            caps = typedefs.get(tname)
            c_fits = caps is not None and (
                shape.limbs_n <= caps[0] and shape.limbs_sq <= caps[1]
                and shape.limbs_cu <= caps[2] and shape.n_masks <= caps[3])
            pairs[f"fits_{tier}"] = (c_fits, ks.fits(shape, tier))
        for name, (got, want) in pairs.items():
            if got != want:
                out.append(_v(KS_PATH, 1, f"predicate-drift:{name}:b{base}",
                              f"{name} at b{base}: the tree says {got}, the "
                              f"spec {want}"))
    # The generic tier's claim: it holds every plan supports_base admits.
    for shape in ks.valid_shapes():
        if ks.supports_base(shape) and not ks.fits(shape, "generic"):
            out.append(_v(ks.CUH, 1, f"generic-tier-short:b{shape.base}",
                          f"b{shape.base} passes supports_base but no tier "
                          "holds it"))
            break
    return out


def check_abi(project: Project) -> List[Violation]:
    out = []
    try:
        sigs = sources.ctypes_signatures(project, ks.CUDA_BUILD)
    except sources.SourceError as exc:
        return [_v(ks.CUDA_BUILD, 1, "abi-unreadable", str(exc))]
    c_funcs: Dict[str, List[str]] = {}
    for rel in (ks.MAIN_CU, ks.PLAN_CU):
        c_funcs.update(sources.extern_c_functions(project.read(rel) or ""))
    for name, (line, kinds) in sorted(sigs.items()):
        if name in c_funcs:
            if kinds != c_funcs[name]:
                out.append(_v(ks.CUDA_BUILD, line, f"abi-drift:{name}",
                              f"ctypes binds {name} as {kinds}, its C "
                              f"prototype takes {c_funcs[name]}"))
        elif name not in ks.LEGACY_ENTRIES:
            out.append(_v(ks.CUDA_BUILD, line, f"abi-orphan:{name}",
                          f"ctypes binds {name}, which no kernel library "
                          "defines"))
    for name in sorted(set(ks.all_specs()) | set(ks.HELPERS)):
        if name not in sigs:
            out.append(_v(ks.CUDA_BUILD, 1, f"abi-unbound:{name}",
                          f"cuda_build.bind sets no argtypes for {name}"))
    for spec in ks.all_specs().values():
        kinds = [p.ctype for p in spec.params]
        if spec.name in c_funcs and kinds != c_funcs[spec.name]:
            out.append(_v(KS_PATH, 1, f"spec-abi-drift:{spec.name}",
                          f"the spec of {spec.name} declares {kinds}, its C "
                          f"prototype takes {c_funcs[spec.name]}"))
    return out


@crule("C6")
def check(project: Project, ctx) -> List[Violation]:
    out: Dict[str, Violation] = {}
    found = check_coverage(project)
    if ctx.bases:
        found += check_shapes(ctx.bases) + check_plain_block_rule(ctx.bases)
    found += (check_constants(project) + check_abi(project)
              + check_block_rule(project))
    for v in found:
        out.setdefault(v.key, v)
    ctx.report["c6"] = {"specs": sorted(ks.all_specs()),
                        "shape_bases": list(ctx.bases),
                        "probe_bases": list(ks.PROBE_BASES),
                        "findings": len(out)}
    return list(out.values())
