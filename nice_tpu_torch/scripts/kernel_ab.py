"""Device times of the kernels built from several source trees, in one
process on one card: a change against its parent, or design variants.

    python -m nice_tpu_torch.scripts.kernel_ab NAME=CSRC [NAME=CSRC ...] \
        [--rounds 2] [--out FILE]

Each CSRC is a directory holding nice_kernels.cu and nice_kernels.cuh (a
tree's nice_tpu_torch/csrc, or a copy of it with one edit). nvcc builds
each with cuda_build's flags; for each build it reports ptxas's registers,
stack and spills of the K1 and K4 instantiations and the local loads and
stores (LDL, STL) in their SASS. Then, in rounds that alternate the order
of the builds, each library is called directly with the plan words packed
in the order of its own PlanWord enum, on the main path's shapes: K1 over
one 2^18 x 8 segment from b40's range start, K2 over one 2^18 sub-batch
there, and K4 (fused classes) over a b98 run of the median size of the
smoke's b98 field (488,281 candidates, 10,068 kept) and over a full
2^21-lane run. Each output is held against the plain version (exact), and
each kernel's time is its device time in torch.profiler's records. One
JSON line per build and round, and with --out all of them in one file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# The b98 run: a start inside the smoke's seeded b98 field (above 2^128)
# and the candidates of its median run.
B98_START = 413428759798923141071530212209627033363
B98_MEDIAN_RUN = 488_281
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


def build(name: str, csrc: str, out_dir: str) -> dict:
    """nvcc of one tree's kernels; its ptxas and SASS facts for K1 and K4."""
    from nice_tpu_torch.ops import cuda_build

    lib_path = os.path.join(out_dir, f"lib_{name}.so")
    t0 = time.monotonic()
    proc = subprocess.run(
        [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib_path,
         os.path.join(csrc, "nice_kernels.cu")],
        capture_output=True, text=True)
    secs = time.monotonic() - t0
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}")
    wanted = ("detailed_megaloop_kernel", "niceonly_dense_kernel")
    ptxas = [r for r in cuda_build.ptxas_resources(proc.stdout + proc.stderr)
             if any(w in r["mangled"] for w in wanted)]
    local = {f: {"LDL": sum(op == "LDL" for _, op, _ in ins),
                 "STL": sum(op == "STL" for _, op, _ in ins),
                 "static": len(ins)}
             for f, ins in cuda_build.sass_listing(lib_path).items()
             if any(w in f for w in wanted)}
    lib = ctypes.CDLL(lib_path)
    cuda_build.bind(lib)
    return {"name": name, "csrc": csrc, "nvcc_secs": secs, "ptxas": ptxas,
            "sass": local, "lib": lib, "names": plan_word_names(csrc)}


def _launched(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed ({rc})")


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of one launch of `kernel` over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if len(times) != reps:
        raise RuntimeError(f"the profiler saw {len(times)} of {reps} {kernel}")
    return sum(times) / reps / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
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
        p40, p98 = get_plan(40), get_plan(98)
        st40 = ve.start_limbs_tensor(p40.range_start, p40, dev)
        st98 = ve.start_limbs_tensor(B98_START, p98, dev)
        cls = ce.niceonly_classes(p98, True, "cuda")
        lanes = BATCH * SEGMENT
        hist = torch.zeros(42, dtype=torch.int32, device=dev)
        want_hist, want_nm = ve.detailed_accum_megaloop(
            p40, BATCH, SEGMENT, hist.clone(), st40, lanes)
        want_u = ve.uniques_batch(p40, BATCH, st40)
        want4 = {v: ve.niceonly_dense_megaloop(p98, BATCH, SEGMENT, cls, st98, v)
                 for v in (B98_MEDIAN_RUN, lanes)}
        lines = []
        for rnd in range(args.rounds):
            for b in (builds if rnd % 2 == 0 else builds[::-1]):
                lib, w40, w98 = b["lib"], plan_words(b["names"], p40), \
                    plan_words(b["names"], p98)
                h = hist.clone()
                nm = torch.zeros((), dtype=torch.int32, device=dev)
                u = torch.empty(BATCH, dtype=torch.int32, device=dev)
                out4 = torch.zeros(2, dtype=torch.int32, device=dev)

                def k1():
                    _launched(lib.nice_detailed_megaloop(
                        w40, st40.data_ptr(), lanes, 0, h.data_ptr(),
                        nm.data_ptr(), 0, stream), "K1")

                def k2():
                    _launched(lib.nice_uniques(w40, st40.data_ptr(), BATCH,
                                               u.data_ptr(), stream), "K2")

                def k4(valid):
                    out4.zero_()
                    _launched(lib.nice_niceonly_dense(
                        w98, st98.data_ptr(), cls.data_ptr(), cls.shape[0],
                        valid, p98.base, 0, out4.data_ptr(), stream), "K4")

                k1()
                k2()
                exact = bool(torch.equal(h, want_hist)
                             and int(nm) == int(want_nm)
                             and torch.equal(u, want_u))
                for v, want in want4.items():
                    k4(v)
                    exact = exact and bool(torch.equal(out4, want))
                line = {
                    "tree": b["name"], "round": rnd, "exact": exact,
                    "k1_ms": device_ms(k1, 20, "detailed_megaloop_kernel"),
                    "k2_ms": device_ms(k2, 50, "uniques_kernel"),
                    "k4_median_run_ms": device_ms(lambda: k4(B98_MEDIAN_RUN),
                                                  50, "niceonly_dense_kernel"),
                    "k4_full_run_ms": device_ms(lambda: k4(lanes), 20,
                                                "niceonly_dense_kernel"),
                }
                if rnd == 0:
                    line.update(nvcc_secs=b["nvcc_secs"], ptxas=b["ptxas"],
                                sass=b["sass"])
                print(json.dumps(line), flush=True)
                lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": lines},
                      f, indent=1)
    return 0 if all(line["exact"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
