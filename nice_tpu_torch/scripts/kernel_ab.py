"""Device times of the kernels built from several source trees, in one
process on one card: a change against its parent, or design variants.

    python -m nice_tpu_torch.scripts.kernel_ab NAME=CSRC [NAME=CSRC ...] \
        [--rounds 2] [--k5-split] [--out FILE]

Each CSRC is a directory holding a tree's kernel sources (a tree's
nice_tpu_torch/csrc, or a copy of it with one edit). nvcc builds each
tree's main library (nice_kernels.cu) with cuda_build's flags and, where
the tree has the plan tier (plan_kernels.cu), its per-base libraries at b40
and b80, and a variant at b40: a copy of the tree whose plan_kernels.cu
gains K1 on the plan tier (K1_PLAN_ENTRY; the port's K1 stays
nice_kernels.cu's). For each build it reports nvcc's seconds, ptxas's
registers, stack and spills of K1-K5 and the local loads and stores (LDL,
STL) in their SASS. Then, in rounds that alternate the order of the builds,
each library is called directly with the plan words packed in the order of
its own PlanWord enum, on the main path's shapes: K1 over one 2^18 x 8
segment from b40's range start (and the variant's K1 there); K2 over one
2^18 sub-batch at b40, b80 and b510; K3 over the first descriptor group of
the smoke's mid-range b40 field and of its surviving b80 field (the MSD
filter over the field's chunks at the seed floor, as
engine._niceonly_strided forms them); K4 (fused classes) over a b98 run of
the median size of the smoke's b98 field (488,281 candidates, 10,068 kept)
and over a full 2^21-lane run; and K5, the tensor-core arm, at K1's b40
segment (from the per-base library where the tree builds K5 there), at
K4's two runs, and over one segment at b510 beside K1 there. Each output
is held against the plain version (exact; K3 also at chip_smoke's check
threshold; K5 at b510 against K1), and each kernel's time is its device
time in torch.profiler's records. One JSON line per build and round, and
with --out all of them in one file.

--k5-split adds, for the first tree, copies with one part of its K5 taken
out (K5_SPLIT: edits of the tree's nice_kernels.cuh and .cu), which time K5
alone: where a K5 launch spends its time. Their outputs may be wrong by
design, so they are reported, not held.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# The b98 run: a start inside the smoke's seeded b98 field (above 2^128)
# and the candidates of its median run.
B98_START = 413428759798923141071530212209627033363
B98_MEDIAN_RUN = 488_281
# The smoke's niceonly fields of 1e9 whose first group K3 is timed on: its
# seeded mid-range b40 field and its first seeded b80 field that the MSD
# filter does not prune whole (chip_smoke._mid_range_field, _surviving_field).
B40_FIELD_START = 3621284264916
B80_FIELD_START = 1976398009181507541370177909799
FIELD_SIZE = 10**9
BATCH, SEGMENT = 1 << 18, 8
U64 = (1 << 64) - 1


def plan_word_names(csrc: str) -> list:
    """The PlanWord enum of a tree's nice_kernels.cuh, in order."""
    with open(os.path.join(csrc, "nice_kernels.cuh")) as f:
        body = re.search(r"enum PlanWord \{(.*?)\};", f.read(), re.S).group(1)
    names = [re.sub(r"\s*=.*", "", n).strip() for n in body.split(",")]
    return [n for n in names if n and n != "PW_COUNT"]


def plan_words(names: list, plan):
    """A plan's words in the order `names` gives (every word any tree of
    the port has used)."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import digit_chunk, log2_fx

    e, chunk_div = digit_chunk(plan.base)
    magic, magic_full, shift = ce.digit_magics(plan.base)
    value = {
        "PW_BASE": plan.base, "PW_LIMBS_N": plan.limbs_n,
        "PW_LIMBS_SQ": plan.limbs_sq, "PW_LIMBS_CU": plan.limbs_cu,
        "PW_D_SQ": plan.d_sq, "PW_D_CU": plan.d_cu,
        "PW_N_MASKS": plan.n_masks, "PW_CUTOFF": plan.near_miss_cutoff,
        "PW_CHUNK_E": e, "PW_CHUNK_DIV": chunk_div,
        "PW_CHUNK_MAGIC": U64 // chunk_div, "PW_BASE_MAGIC": U64 // plan.base,
        "PW_LOG2_FX": log2_fx(plan.base), "PW_RES_MAGIC": U64 // (plan.base - 1),
        "PW_DIGIT_MAGIC": magic, "PW_DIGIT_MAGIC_FULL": magic_full,
        "PW_DIGIT_SHIFT": shift,
    }
    return (ctypes.c_uint64 * len(names))(*(value[n] for n in names))


KERNELS = ("detailed_megaloop_kernel", "uniques_kernel",
           "strided_niceonly_kernel", "niceonly_dense_kernel",
           "detailed_megaloop_mma_kernel", "niceonly_dense_mma_kernel")

# K5's time split (--k5-split): the tree's K5 with one part taken out or
# moved, as (file, old text, new text) edits of a copy of the tree, listed
# per layout of K5 (k5_layout: "staged", wmma with a per-warp staging area
# and each block's setup on one thread; "register", mma.sync in registers,
# the detailed mode on the plan tier to b97, the setup as warp products).
# A variant that names no edits for a layout has no such part there; an
# old text that is not in the tree exactly once makes split_tree raise, so
# a variant never drops out quietly when the kernel's source moves on.
#   constants_skipped: the setup's limb constants (S^2, S^3, and in the
#     staged layout 2S, 3S^2, 3S) are not formed; T's words still fill in;
#   products_only: the digit work becomes a fold of the product limbs, so
#     that only the products (and the launch around them) remain;
#   schoolbook: Lane::mul's products in place of the MMAs, i.e. K1's or
#     K4's lane inside K5's loop, setup and launch shape;
#   small_tier: the detailed mode at b40 in the main library's small tier
#     (a runtime plan), where the staged layout runs it already;
#   fill_skipped: T's words are not filled in (the register layout's fill
#     beside warp 0's products).
_MUL = ("    mul(n, p.limbs_n, n, p.limbs_n, sq, p.limbs_sq);\n"
        "    mul(sq, p.limbs_sq, n, p.limbs_n, cu, p.limbs_cu);")
_FOLD = [(
    "nice_kernels.cuh",
    "    if (!live) return 0;\n    return uniques_from(sq, cu, p);",
    "    if (!live) return 0;\n"
    "    uint32_t f = 0;\n"
    "    NICE_UNROLL\n"
    "    for (int k = 0; k < (UNROLL ? SQL : p.limbs_sq); ++k)\n"
    "      if (k < p.limbs_sq) f ^= sq[k];\n"
    "    NICE_UNROLL\n"
    "    for (int k = 0; k < (UNROLL ? CUL : p.limbs_cu); ++k)\n"
    "      if (k < p.limbs_cu) f += cu[k];\n"
    "    return (int)(f & 7u);")]
K5_SPLIT = {
    "constants_skipped": {
        "staged": [(
            "nice_kernels.cuh",
            "  if (threadIdx.x == 0) {\n    for (int i = 0; i < limbs_n; ++i)",
            "  if (threadIdx.x == 0 && start[0] < 0) {\n"
            "    for (int i = 0; i < limbs_n; ++i)")],
        "register": [(
            "nice_kernels.cuh",
            "    k5_warp_mul(sh.s, n, sh.s, n, sh.s_sq, lsq);",
            "    if (start[0] < 0) k5_warp_mul(sh.s, n, sh.s, n, sh.s_sq, lsq);"), (
            "nice_kernels.cuh",
            "    k5_warp_mul(sh.s_sq, lsq, sh.s, n, sh.s_cu, lcu);",
            "    if (start[0] < 0) "
            "k5_warp_mul(sh.s_sq, lsq, sh.s, n, sh.s_cu, lcu);")]},
    "products_only": {"staged": _FOLD, "register": _FOLD},
    "schoolbook": {
        "staged": [(
            "nice_kernels.cuh",
            "    products_mma(n, wrapped, i, p, sh, sq, cu);", _MUL)],
        "register": [(
            "nice_kernels.cuh",
            "    products_mma(n, wrapped, i, iq, p, b, sh, sq, cu);", _MUL)]},
    "small_tier": {"register": [(
        "nice_kernels.cu",
        "    if (plan_tier_takes(p)) return kPlanTierOnly;\n"
        "    const int rc = launch_k5<GenericTier>(p, st, valid_total, pad, h, n, mma,\n"
        "                                          block_threads, s);",
        "    const int rc = tier == 0\n"
        "        ? launch_k5<SmallTier>(p, st, valid_total, pad, h, n, mma,\n"
        "                               block_threads, s)\n"
        "        : launch_k5<GenericTier>(p, st, valid_total, pad, h, n, mma,\n"
        "                                 block_threads, s);")]},
    "fill_skipped": {"register": [(
        "nice_kernels.cuh",
        "    k5_fill(sh, nt_sq, nt, false);",
        "    if (start[0] < 0) k5_fill(sh, nt_sq, nt, false);"), (
        "nice_kernels.cuh",
        "    k5_fill(sh, nt_sq, nt, true);",
        "    if (start[0] < 0) k5_fill(sh, nt_sq, nt, true);")]},
}


def k5_layout(csrc: str) -> str:
    """The layout of a tree's K5: "staged" (wmma) or "register"."""
    with open(os.path.join(csrc, "nice_kernels.cuh")) as f:
        return "staged" if "wmma::" in f.read() else "register"


def split_tree(csrc: str, variant: str, out_dir: str) -> str | None:
    """A copy of the tree csrc in out_dir with K5_SPLIT[variant]'s edits for
    the tree's layout, or None where the variant has none for it. Raises
    ValueError when an edit's old text is not in the tree exactly once."""
    edits = K5_SPLIT[variant].get(k5_layout(csrc))
    if edits is None:
        return None
    edited = {}
    for name, old, new in edits:
        if name not in edited:
            with open(os.path.join(csrc, name)) as f:
                edited[name] = f.read()
        found = edited[name].count(old)
        if found != 1:
            raise ValueError(f"--k5-split {variant}: {name} holds the text "
                             f"to edit {found} times, not once")
        edited[name] = edited[name].replace(old, new)
    copy = os.path.join(out_dir, f"split-{variant}")
    shutil.copytree(csrc, copy)
    for name, text in edited.items():
        # nicelint: allow A1 (a scratch copy of the sources)
        with open(os.path.join(copy, name), "w") as f:
            f.write(text)
    return copy


def build_facts(lib_path: str, nvcc_log: str) -> dict:
    """ptxas's report and the SASS's local loads and stores of K1-K4's
    instantiations in one library."""
    from nice_tpu_torch.ops import cuda_build

    ptxas = [r for r in cuda_build.ptxas_resources(nvcc_log)
             if any(k in r["mangled"] for k in KERNELS)]
    sass = {f: {"LDL": sum(op == "LDL" for _, op, _ in ins),
                "STL": sum(op == "STL" for _, op, _ in ins),
                "static": len(ins)}
            for f, ins in cuda_build.sass_listing(lib_path).items()
            if any(k in f for k in KERNELS)}
    return {"ptxas": ptxas, "sass": sass}


# K1 on the plan tier, a recorded variant: appended to a copy of a tree's
# plan_kernels.cu, it launches K1 with the base's plan as constants, as
# nice_detailed_megaloop does with mma = 0 (at kThreads a block; THREADS_ARG
# is the argument a tree whose launches take a block size needs).
K1_PLAN_ENTRY = r"""
extern "C" int nice_plan_detailed_megaloop(const uint64_t* plan_words,
                                           const void* start,
                                           long long valid_total,
                                           long long pad, void* hist,
                                           void* nm, void* stream) {
  using namespace nice;
  if (!this_plan(plan_words)) return kOtherPlan;
  launch_k1<PlanTier>(plan_from_words(plan_words), (const int64_t*)start,
                      valid_total, pad, (int32_t*)hist, (int32_t*)nm,
                      THREADS_ARG (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
"""


def takes_block_threads(csrc: str) -> bool:
    """Whether a tree's launches take a block size (block_threads, an
    argument before the stream); a parent tree's may not."""
    with open(os.path.join(csrc, "nice_kernels.cu")) as f:
        return "int block_threads" in f.read()


# The entries whose ctypes binding a tree without block_threads lacks, and
# the argument's position from the end (before the stream, or before
# launch_shape's out).
_BLOCK_ARG = ("nice_detailed_megaloop", "nice_niceonly_dense",
              "nice_plan_strided_niceonly", "nice_plan_detailed_megaloop_mma",
              "nice_launch_shape", "nice_plan_launch_shape")


def bind_tree(lib, csrc: str) -> tuple:
    """cuda_build.bind for a tree's library, the block_threads argument
    dropped where the tree's entries lack it. Returns the arguments a call
    passes for it: (DEFAULT_BLOCK_THREADS,) or ()."""
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce

    cuda_build.bind(lib)
    if takes_block_threads(csrc):
        return (ce.DEFAULT_BLOCK_THREADS,)
    for name in _BLOCK_ARG:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
    return ()


def plan_build(csrc: str, base: int, out_dir: str, entry: str = ""):
    """nvcc of a tree's plan_kernels.cu with one base's generated header,
    in out_dir (with `entry` appended, in a copy of the tree there).
    Returns the loaded library and its build facts."""
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import get_plan

    os.makedirs(out_dir, exist_ok=True)
    if entry:
        copy = os.path.join(out_dir, "csrc")
        shutil.copytree(csrc, copy)
        # nicelint: allow A1 (a scratch copy of the sources)
        with open(os.path.join(copy, "plan_kernels.cu"), "a") as f:
            f.write(entry.replace("THREADS_ARG", "kThreads,"
                                  if takes_block_threads(csrc) else ""))
        csrc = copy
    # nicelint: allow A1 (a build input in a scratch directory)
    with open(os.path.join(out_dir, cuda_build.PLAN_HEADER), "w") as f:
        f.write(ce.plan_header(get_plan(base)))
    lib_path = os.path.join(out_dir, "libnice_plan.so")
    info = cuda_build.nvcc_library(lib_path, cuda_build.PLAN_SOURCES, csrc,
                                   (out_dir,))
    lib = ctypes.CDLL(lib_path)
    bind_tree(lib, csrc)
    return lib, dict(build_facts(lib_path, info["ptxas"]),
                     nvcc_secs=info["seconds"])


def build(name: str, csrc: str, out_dir: str, k5_only: bool = False) -> dict:
    """nvcc of one tree's main library and, where the tree has the plan
    tier, of its per-base libraries at b40 and b80 and of the K1 variant at
    b40, all at once. A k5_only tree (a --k5-split copy) builds its main
    library and its b40 library alone."""
    from concurrent.futures import ThreadPoolExecutor

    from nice_tpu_torch.ops import cuda_build

    names = plan_word_names(csrc)
    lib_path = os.path.join(out_dir, name, "libnice_kernels.so")
    plans = {}
    t0 = time.monotonic()
    with ThreadPoolExecutor(4) as pool:
        main_lib = pool.submit(cuda_build.nvcc_library, lib_path,
                               ("nice_kernels.cu",), csrc)
        if os.path.isfile(os.path.join(csrc, "plan_kernels.cu")):
            if names != plan_word_names(cuda_build.CSRC_DIR):
                raise RuntimeError(
                    f"{name}: a plan tier with another PlanWord enum")
            for key, base, entry in (("plan_b40", 40, ""), ("plan_b80", 80, ""),
                                     ("plan_b40_k1", 40, K1_PLAN_ENTRY)):
                if k5_only and key != "plan_b40":
                    continue
                plans[key] = pool.submit(plan_build, csrc, base,
                                         os.path.join(out_dir, name, key),
                                         entry)
        info = main_lib.result()
        plans = {k: f.result() for k, f in plans.items()}
    out = {"name": name, "csrc": csrc, "nvcc_secs": time.monotonic() - t0,
           "names": names, "lib": ctypes.CDLL(lib_path), "k5_only": k5_only,
           "plan_libs": {b: plans[f"plan_b{b}"][0]
                         for b in (40, 80) if f"plan_b{b}" in plans},
           "facts": {"main": build_facts(lib_path, info["ptxas"]),
                     **{k: facts for k, (_, facts) in plans.items()}}}
    out["bt"] = bind_tree(out["lib"], csrc)
    out["main_nvcc_secs"] = info["seconds"]
    out["plan_nvcc_secs"] = {k: facts["nvcc_secs"]
                             for k, (_, facts) in plans.items()}
    if "plan_b40_k1" in plans:
        k1 = plans["plan_b40_k1"][0].nice_plan_detailed_megaloop
        k1.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        k1.restype = ctypes.c_int
        out["k1_plan"] = k1
    return out


def first_group(base: int, start: int, size: int = FIELD_SIZE):
    """The first descriptor group the niceonly main path forms on the field
    [start, start + size) in a fresh process: the MSD filter over the
    field's chunks at the seed floor, coalesced runs, descriptors
    (engine._niceonly_strided's steps). Returns (setup, columns, int64
    descriptor table of STRIDED_DESC_MAX rows)."""
    import numpy as np

    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine, msd_filter

    s = engine.strided_setup(base, size)
    span = s.periods * s.table.modulus

    def ranges():
        for a, b in engine._filter_chunks(FieldSize(start, start + size),
                                          s.floor):
            for r in msd_filter.get_valid_ranges(
                    FieldSize(a, b), base, min_range_size=s.floor,
                    max_depth=engine._msd_depth_for(b - a, s.floor)):
                yield r.start(), r.end()

    runs = engine.coalesce_runs(ranges(), span * 64)
    cols = next(engine.grouped_columns(
        engine.desc_columns(runs, s.table.modulus, span), ce.STRIDED_DESC_MAX))
    desc = engine.pack_descriptors(cols, ce.STRIDED_DESC_MAX).astype(np.int64)
    return s, cols, desc


# nice_kernels.cuh kPlanTierOnly: the main library leaves the plan to the
# per-base one.
K_PLAN_TIER_ONLY = -3


def _launched(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed ({rc})")


def device_ms(fn, reps: int, kernel: str, attempts: int = 5) -> float:
    """Mean device milliseconds of one launch of `kernel` over reps calls.
    The profiler now and then returns fewer device records than launches
    (on the H100 it lost 1 of 3, 20 of 20, 1 of 20 three times running,
    and 12 of 20, most often in a process's first windows): such a window
    is measured again, up to `attempts` times; then a window that lost one
    record gives the mean of the records it has, and one that lost more
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if len(times) == reps:
            return sum(times) / reps / 1e3
        if len(times) > len(best):
            best = times
    if best and len(best) >= reps - 1:
        return sum(best) / len(best) / 1e3
    raise RuntimeError(f"the profiler saw {len(best)} of {reps} {kernel}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--k5-split", action="store_true",
                    help="also time the first tree's K5 with one part taken "
                         "out (K5_SPLIT)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    trees = [(*t.split("=", 1), False) for t in args.trees]
    with tempfile.TemporaryDirectory(prefix="nice-kernel-ab-") as tmp:
        from concurrent.futures import ThreadPoolExecutor

        if args.k5_split:
            name, csrc, _ = trees[0]
            copies = {v: split_tree(csrc, v, tmp) for v in K5_SPLIT}
            print(json.dumps({"k5_split": {"layout": k5_layout(csrc),
                                           "variants": [v for v, c in copies.items() if c]}}))
            trees += [(f"{name}-{v}", c, True) for v, c in copies.items() if c]
        with ThreadPoolExecutor(len(trees)) as pool:
            builds = list(pool.map(lambda t: build(t[0], t[1], tmp, t[2]),
                                   trees))
        p40, p80, p98, p510 = (get_plan(b) for b in (40, 80, 98, 510))
        st40 = ve.start_limbs_tensor(p40.range_start, p40, dev)
        st98 = ve.start_limbs_tensor(B98_START, p98, dev)
        k2_starts = {40: st40,
                     80: ve.start_limbs_tensor(B80_FIELD_START, p80, dev),
                     510: ve.start_limbs_tensor(p510.range_start, p510, dev)}
        groups = {40: first_group(40, B40_FIELD_START),
                  80: first_group(80, B80_FIELD_START)}
        k3_in = {}
        for base, (s, cols, desc) in groups.items():
            res = engine._device_residues(base, s.k, "cuda")
            d = torch.from_numpy(desc).to(dev)
            k3_in[base] = (s, len(cols[0]), res, d)
        cls = ce.niceonly_classes(p98, True, "cuda")
        lanes = BATCH * SEGMENT
        hist = torch.zeros(42, dtype=torch.int32, device=dev)
        want_hist, want_nm = ve.detailed_accum_megaloop(
            p40, BATCH, SEGMENT, hist.clone(), st40, lanes)
        want_u = {b: ve.uniques_batch(get_plan(b), BATCH, st)
                  for b, st in k2_starts.items()}
        want3 = {(b, mu): ve.niceonly_strided_counts(
                     s.plan, s.table.modulus, res, s.periods, d, n_real, mu)
                 for b, (s, n_real, res, d) in k3_in.items()
                 for mu in (b, (5 * b + 7) // 8)}
        want4 = {v: ve.niceonly_dense_megaloop(p98, BATCH, SEGMENT, cls, st98, v)
                 for v in (B98_MEDIAN_RUN, lanes)}
        # b510's segment: K5 is held against K1 of the first tree.
        st510 = k2_starts[510]
        h510 = torch.zeros(p510.base + 2, dtype=torch.int32, device=dev)
        nm510 = torch.zeros((), dtype=torch.int32, device=dev)
        _launched(builds[0]["lib"].nice_detailed_megaloop(
            plan_words(builds[0]["names"], p510), st510.data_ptr(), lanes, 0,
            h510.data_ptr(), nm510.data_ptr(), 0, *builds[0]["bt"], stream),
            "K1")
        want510 = (h510.clone(), int(nm510))
        lines = []
        for rnd in range(args.rounds):
            for b in (builds if rnd % 2 == 0 else builds[::-1]):
                lib, names, bt = b["lib"], b["names"], b["bt"]
                w40, w98 = plan_words(names, p40), plan_words(names, p98)
                h = hist.clone()
                nm = torch.zeros((), dtype=torch.int32, device=dev)
                u = torch.empty(BATCH, dtype=torch.int32, device=dev)
                counts = torch.zeros(ce.STRIDED_DESC_MAX, dtype=torch.int32,
                                     device=dev)
                out4 = torch.zeros(2, dtype=torch.int32, device=dev)
                w510 = plan_words(names, p510)
                h5 = torch.zeros(p510.base + 2, dtype=torch.int32, device=dev)

                def k1(fn=lib.nice_detailed_megaloop, mma=(0,), bt=bt):
                    _launched(fn(w40, st40.data_ptr(), lanes, 0, h.data_ptr(),
                                 nm.data_ptr(), *mma, *bt, stream), "K1")

                def k2(base):
                    plan = get_plan(base)
                    plib = b["plan_libs"].get(base)
                    fn = plib.nice_plan_uniques if plib else lib.nice_uniques
                    _launched(fn(plan_words(names, plan),
                                 k2_starts[base].data_ptr(), BATCH,
                                 u.data_ptr(), stream), "K2")

                def k3(base, min_u=None):
                    s, n_real, res, d = k3_in[base]
                    words = plan_words(names, s.plan)
                    min_u = base if min_u is None else min_u
                    r, m = s.table.num_residues, s.table.modulus
                    counts.zero_()
                    plib = b["plan_libs"].get(base)
                    if plib:
                        rc = plib.nice_plan_strided_niceonly(
                            words, d.data_ptr(), n_real, res.data_ptr(), r,
                            *ce.u32_divisor(r), m, s.periods, min_u,
                            counts.data_ptr(), *bt, stream)
                    else:
                        rc = lib.nice_strided_niceonly(
                            words, d.data_ptr(), n_real, res.data_ptr(), r, m,
                            s.periods, min_u, counts.data_ptr(), stream)
                    _launched(rc, "K3")

                def k4(valid, mma=0):
                    out4.zero_()
                    _launched(lib.nice_niceonly_dense(
                        w98, st98.data_ptr(), cls.data_ptr(), cls.shape[0],
                        valid, p98.base, mma, out4.data_ptr(), *bt, stream),
                        "K4")

                plib40 = b["plan_libs"].get(40)

                # K5's detailed mode at b40 runs where the tree runs it:
                # its main library, or (kPlanTierOnly there) its plan tier,
                # which also runs each block's setup alone (mma = 2).
                plan_k5 = lib.nice_detailed_megaloop(
                    w40, st40.data_ptr(), 0, 0, h.data_ptr(), nm.data_ptr(),
                    1, *bt, stream) == K_PLAN_TIER_ONLY

                def k5(mma=1):
                    if plan_k5:
                        k1(plib40.nice_plan_detailed_megaloop_mma, (mma,))
                    else:
                        k1(lib.nice_detailed_megaloop, (mma,))

                def b510(mma):
                    _launched(lib.nice_detailed_megaloop(
                        w510, st510.data_ptr(), lanes, 0, h5.data_ptr(),
                        nm.data_ptr(), mma, *bt, stream), "K1/K5 b510")

                # K5 first: a --k5-split tree times it alone.
                h.zero_()
                nm.zero_()
                k5()
                k5_exact = bool(torch.equal(h, want_hist)
                                and int(nm) == int(want_nm))
                k4(B98_MEDIAN_RUN, 1)
                k5_exact = k5_exact and bool(torch.equal(
                    out4, want4[B98_MEDIAN_RUN]))
                nm.zero_()
                b510(1)
                k5_exact = k5_exact and bool(torch.equal(h5, want510[0])
                                             and int(nm) == want510[1])
                line = {
                    "tree": b["name"], "round": rnd, "k5_exact": k5_exact,
                    "k5_b40_ms": device_ms(k5, 20,
                                           "detailed_megaloop_mma_kernel"),
                    "k5_b98_median_run_ms": device_ms(
                        lambda: k4(B98_MEDIAN_RUN, 1), 50,
                        "niceonly_dense_mma_kernel"),
                    "k5_b98_full_run_ms": device_ms(
                        lambda: k4(lanes, 1), 20, "niceonly_dense_mma_kernel"),
                    "k5_b510_ms": device_ms(lambda: b510(1), 3,
                                            "detailed_megaloop_mma_kernel"),
                }
                if plan_k5:
                    line.update({
                        "k5_setup_b40_ms": device_ms(
                            lambda: k5(2), 20, "detailed_megaloop_mma_kernel"),
                        "k5_setup_b98_median_run_ms": device_ms(
                            lambda: k4(B98_MEDIAN_RUN, 2), 50,
                            "niceonly_dense_mma_kernel"),
                        "k5_setup_b510_ms": device_ms(
                            lambda: b510(2), 5, "detailed_megaloop_mma_kernel"),
                    })
                if b["k5_only"]:
                    if rnd == 0:
                        line.update(nvcc_secs=b["nvcc_secs"], facts=b["facts"])
                    print(json.dumps(line), flush=True)
                    lines.append(line)
                    continue
                h.zero_()
                nm.zero_()
                k1()
                exact = bool(torch.equal(h, want_hist)
                             and int(nm) == int(want_nm))
                for base in k2_starts:
                    k2(base)
                    exact = exact and bool(torch.equal(u, want_u[base]))
                for (base, mu), want in want3.items():
                    k3(base, mu)
                    exact = exact and bool(torch.equal(counts, want))
                for v, want in want4.items():
                    k4(v)
                    exact = exact and bool(torch.equal(out4, want))
                line.update({
                    "k1_ms": device_ms(k1, 20, "detailed_megaloop_kernel"),
                    "k1_b510_ms": device_ms(lambda: b510(0), 3,
                                            "detailed_megaloop_kernel"),
                    "k2_b40_ms": device_ms(lambda: k2(40), 50, "uniques_kernel"),
                    "k2_b80_ms": device_ms(lambda: k2(80), 50, "uniques_kernel"),
                    "k2_b510_ms": device_ms(lambda: k2(510), 5,
                                            "uniques_kernel"),
                    "k3_b40_group_ms": device_ms(lambda: k3(40), 10,
                                                 "strided_niceonly_kernel"),
                    "k3_b80_group_ms": device_ms(lambda: k3(80), 10,
                                                 "strided_niceonly_kernel"),
                    "k4_median_run_ms": device_ms(lambda: k4(B98_MEDIAN_RUN),
                                                  50, "niceonly_dense_kernel"),
                    "k4_full_run_ms": device_ms(lambda: k4(lanes), 20,
                                                "niceonly_dense_kernel"),
                })
                if "k1_plan" in b:
                    # K1 on the plan tier at b40: a recorded variant.
                    def k1_plan():
                        k1(b["k1_plan"], (), ())

                    h.zero_()
                    nm.zero_()
                    k1_plan()
                    exact = exact and bool(torch.equal(h, want_hist)
                                           and int(nm) == int(want_nm))
                    line["k1_plan_tier_ms"] = device_ms(
                        k1_plan, 20, "detailed_megaloop_kernel")
                line["exact"] = exact and k5_exact
                if rnd == 0:
                    line.update(nvcc_secs=b["nvcc_secs"],
                                main_nvcc_secs=b["main_nvcc_secs"],
                                plan_nvcc_secs=b["plan_nvcc_secs"],
                                facts=b["facts"],
                                k3_groups={base: {"rows": n_real, "k": s.k,
                                                  "periods": s.periods}
                                           for base, (s, n_real, _, _)
                                           in k3_in.items()})
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        # nicelint: allow A1 (a report, not state)
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": lines},
                      f, indent=1)
    # A --k5-split copy's outputs may be wrong by design: not held.
    return 0 if all(line.get("exact", True) for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
