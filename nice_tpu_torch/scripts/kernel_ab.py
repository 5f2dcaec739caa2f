"""Device times of the kernels built from several source trees, in one
process on one card: a change against its parent, or design variants.

    python -m nice_tpu_torch.scripts.kernel_ab NAME=CSRC [NAME=CSRC ...] \
        [--rounds 2] [--out FILE]

Each CSRC is a directory holding a tree's kernel sources (a tree's
nice_tpu_torch/csrc, or a copy of it with one edit). nvcc builds each
tree's main library (nice_kernels.cu) with cuda_build's flags and, where
the tree has the plan tier (plan_kernels.cu), its per-base libraries at b40
and b80, and a variant at b40: a copy of the tree whose plan_kernels.cu
gains K1 on the plan tier (K1_PLAN_ENTRY; the port's K1 stays
nice_kernels.cu's). For each build it reports nvcc's seconds, ptxas's
registers, stack and spills of K1-K4 and the local loads and stores (LDL,
STL) in their SASS. Then, in rounds that alternate the order of the builds,
each library is called directly with the plan words packed in the order of
its own PlanWord enum, on the main path's shapes: K1 over one 2^18 x 8
segment from b40's range start (and the variant's K1 there); K2 over one 2^18 sub-batch at b40, b80 and b510; K3 over
the first descriptor group of the smoke's mid-range b40 field and of its
surviving b80 field (the MSD filter over the field's chunks at the seed
floor, as engine._niceonly_strided forms them); and K4 (fused classes) over
a b98 run of the median size of the smoke's b98 field (488,281 candidates,
10,068 kept) and over a full 2^21-lane run. Each output is held against the
plain version (exact; K3 also at chip_smoke's check threshold), and each
kernel's time is its device time in torch.profiler's records. One JSON line
per build and round, and with --out all of them in one file.
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
           "strided_niceonly_kernel", "niceonly_dense_kernel")


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
# nice_detailed_megaloop does with mma = 0.
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
                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
"""


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
        with open(os.path.join(copy, "plan_kernels.cu"), "a") as f:
            f.write(entry)
        csrc = copy
    with open(os.path.join(out_dir, cuda_build.PLAN_HEADER), "w") as f:
        f.write(ce.plan_header(get_plan(base)))
    lib_path = os.path.join(out_dir, "libnice_plan.so")
    info = cuda_build.nvcc_library(lib_path, cuda_build.PLAN_SOURCES, csrc,
                                   (out_dir,))
    lib = ctypes.CDLL(lib_path)
    cuda_build.bind(lib)
    return lib, dict(build_facts(lib_path, info["ptxas"]),
                     nvcc_secs=info["seconds"])


def build(name: str, csrc: str, out_dir: str) -> dict:
    """nvcc of one tree's main library and, where the tree has the plan
    tier, of its per-base libraries at b40 and b80 and of the K1 variant at
    b40, all at once."""
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
                plans[key] = pool.submit(plan_build, csrc, base,
                                         os.path.join(out_dir, name, key),
                                         entry)
        info = main_lib.result()
        plans = {k: f.result() for k, f in plans.items()}
    out = {"name": name, "csrc": csrc, "nvcc_secs": time.monotonic() - t0,
           "names": names, "lib": ctypes.CDLL(lib_path),
           "plan_libs": {b: plans[f"plan_b{b}"][0]
                         for b in (40, 80) if f"plan_b{b}" in plans},
           "facts": {"main": build_facts(lib_path, info["ptxas"]),
                     **{k: facts for k, (_, facts) in plans.items()}}}
    cuda_build.bind(out["lib"])
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


def _launched(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed ({rc})")


def device_ms(fn, reps: int, kernel: str, attempts: int = 3) -> float:
    """Mean device milliseconds of one launch of `kernel` over reps calls.
    The profiler now and then returns fewer device records than launches
    (it lost 1 of 3 and 20 of 20 in two runs on the H100): such a window
    is measured again, up to `attempts` times, and then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    raise RuntimeError(f"the profiler saw {len(times)} of {reps} {kernel}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
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
    trees = [t.split("=", 1) for t in args.trees]
    with tempfile.TemporaryDirectory(prefix="nice-kernel-ab-") as tmp:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(trees)) as pool:
            builds = list(pool.map(lambda t: build(t[0], t[1], tmp), trees))
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
        lines = []
        for rnd in range(args.rounds):
            for b in (builds if rnd % 2 == 0 else builds[::-1]):
                lib, names = b["lib"], b["names"]
                w40, w98 = plan_words(names, p40), plan_words(names, p98)
                h = hist.clone()
                nm = torch.zeros((), dtype=torch.int32, device=dev)
                u = torch.empty(BATCH, dtype=torch.int32, device=dev)
                counts = torch.zeros(ce.STRIDED_DESC_MAX, dtype=torch.int32,
                                     device=dev)
                out4 = torch.zeros(2, dtype=torch.int32, device=dev)

                def k1(fn=lib.nice_detailed_megaloop, mma=(0,)):
                    _launched(fn(w40, st40.data_ptr(), lanes, 0, h.data_ptr(),
                                 nm.data_ptr(), *mma, stream), "K1")

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
                            counts.data_ptr(), stream)
                    else:
                        rc = lib.nice_strided_niceonly(
                            words, d.data_ptr(), n_real, res.data_ptr(), r, m,
                            s.periods, min_u, counts.data_ptr(), stream)
                    _launched(rc, "K3")

                def k4(valid):
                    out4.zero_()
                    _launched(lib.nice_niceonly_dense(
                        w98, st98.data_ptr(), cls.data_ptr(), cls.shape[0],
                        valid, p98.base, 0, out4.data_ptr(), stream), "K4")

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
                line = {
                    "tree": b["name"], "round": rnd,
                    "k1_ms": device_ms(k1, 20, "detailed_megaloop_kernel"),
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
                }
                if "k1_plan" in b:
                    # K1 on the plan tier at b40: a recorded variant.
                    def k1_plan():
                        k1(b["k1_plan"], ())

                    h.zero_()
                    nm.zero_()
                    k1_plan()
                    exact = exact and bool(torch.equal(h, want_hist)
                                           and int(nm) == int(want_nm))
                    line["k1_plan_tier_ms"] = device_ms(
                        k1_plan, 20, "detailed_megaloop_kernel")
                line["exact"] = exact
                if rnd == 0:
                    line.update(nvcc_secs=b["nvcc_secs"], facts=b["facts"],
                                k3_groups={base: {"rows": n_real, "k": s.k,
                                                  "periods": s.periods}
                                           for base, (s, n_real, _, _)
                                           in k3_in.items()})
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": lines},
                      f, indent=1)
    return 0 if all(line["exact"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
