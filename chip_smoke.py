"""On-card smoke run of the PyTorch/CUDA port (nice_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Phases, each of which raises (exit code 1) on failure:
  1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build, all started together: nvcc builds the kernels from csrc/, g++ the
     host library of the niceonly path (native/), nvcc -cubin the op-count
     source whose SASS bounds the kernels (see 10), and nvcc the probe of
     the tensor cores' integer rate (csrc/imma_probe.cu);
  3. kernel vs plain: K1 (detailed megaloop) and K2 (per-lane uniques, plus
     survivor compaction) against their plain PyTorch versions on the card,
     exact integer equality, at b10, b17, b40, b50, b80, b97 and b510, from
     range_start and from a start straddling a 2^32 limb carry;
  4. strided vs plain: K3 (stride-descriptor niceonly counts) against its
     plain version, exact, at b10, b17, b40, b50 and b80 with each base's
     main-path stride shape: ragged runs, padded rows past n_real,
     candidates across multiples of 2^32, 2^64 and 2^96, and at b10 the
     descriptor holding 69, repeated, plus spans past the range's end. Each
     table runs at the nice test (min_uniques = base) and at a threshold
     about the median of num_uniques (check_min_uniques), where every row
     counts many lanes: no number but 69 is nice, so only the second makes
     a lost carry or a wrong range mask show;
  4b. dense vs plain: K4 (dense niceonly counts) against its plain version,
     exact, in both TPU modes (fused: the base's residue classes; unfused:
     all b-1) and at both thresholds, at b10 (from 47), b40, b98, b100, b510
     and b99 (no class: no launch, every lane pruned), from range_start and
     across the largest limb carry inside the range, ragged;
  4c. K5 vs plain and vs K1/K4: the tensor-core arm (use_mxu=1) of the
     detailed megaloop against its plain version and against K1 on the
     card, as phase 3 runs K1, and of the dense count against its plain
     version and K4, as phase 4b runs K4; exact, launch counts checked;
  5. golden and oracle fields: base-ten must give [(69, 10)] and the scalar
     oracle's histogram; default (1e6 @ b40) on the card must equal the same
     field through the plain path on the CPU; in niceonly mode base-ten must
     give [69] through K3 (its hit re-scanned on the host), and default on
     the card must equal the plain path on the CPU; base-ten through the
     dense loop must give [69] through K4 and K2;
  6. full width, detailed (the main path, launch counts read around it):
     the extra-large field (1e9 numbers @ b40) and a seeded mid-range b40
     field of 1e9, through the client's process_field; bins 1..40 must sum
     to 1e9, the scalar oracle must confirm every near miss, a seeded slice
     must agree with the oracle, and both K1 and K2 must have been launched;
  7. full width, niceonly (the niceonly main path, counts read around it):
     extra-large, the same mid-range b40 field, hi-base (1e9 @ b80) and a
     seeded b80 field of 1e9 that the MSD filter does not prune whole (it
     prunes hi-base whole), through process_field in niceonly mode with the
     default audit; K3 must launch once per descriptor group, a seeded 1e7
     slice of each field must equal the host library's scan, and each base
     must have launched K3;
  7b. full width, dense niceonly (b98's main path, counts read around it):
     the first 1e9 of b98 (pruned whole: no run) and the first seeded b98
     field of 1e9 that the MSD filter does not prune whole, through
     process_field; K4 must launch once per run, every reported number
     must be nice, and a seeded 2e5 slice must equal the scalar oracle's
     nice test, number by number;
  7c. the tuned path at full width: autotune.sweep on the card into a
     temporary winners table (extra-large detailed, a 1e8 slice, batches
     2^17-2^19 x segments 4/8/16 x K1/K5; the b98 field niceonly, batches
     2^17/2^18 x K4/K5), then a fresh process pointed at that table runs
     extra-large and the b98 field through process_field (autotune hits,
     results equal to phases 6 and 7b); then winners with use_mxu=1 at the
     default shape, and extra-large, mid-range and the b98 field through
     process_field with the launch counts set to 0 just before and read
     just after (K5's main path): K5 in K1's and K4's place, K2 re-scanning
     mid-range's near misses, results equal to the use_mxu=0 runs;
  8. claim -> process -> submit: the repository's coordination server in a
     separate process (python -m nice_tpu.server, seeded with b40 fields of
     1e9), one detailed and one niceonly single-shot client run on the card
     against it; both submits must be accepted and the server's spot check
     must pass;
  9. main-path shapes: K1 over one whole 2^18 x 8 segment and K2 (with the
     survivor compaction) over one 2^18 rare-scan sub-batch at b40, from
     extra-large's start and from the segment and sub-batch that hold the
     mid-range field's first near miss; K3 over the first descriptor group
     of the mid-range b40 field (1024 rows) and of the b80 field, as the
     main path launched them, at both thresholds; K4 over the b98 field's
     first run in both modes at both thresholds; K5 at K1's segments and
     K4's first run; each against its plain version (K5 also against
     K1/K4), exact;
 10. timing at those shapes: each kernel beside its plain version (K4 at
     the b98 field's median run, and over a full 2^21-lane run; K5 at K1's
     and K4's shapes beside K1/K4; K1 and K5 over one segment at b510), and
     a bound from the instructions one lane issues in the compiled code
     (csrc/op_count.cu built with the b40 plan and stride table, and the
     b98 plan and class table, as constants, counted with cuobjdump; K5's
     IMMAs at the rate the probe measures); then
     the kernels' estimated share of each main-path field's time (launches
     x kernel time / field time), each niceonly field's split into MSD
     filter, collector and dispatch time, and each b98 field's into MSD
     filter and loop;
 11. profile: the mid-range field once more in each mode, and the b98
     field in niceonly mode, under torch.profiler, for the device's busy
     and idle share of each wall time.
Then one {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Without CUDA (or outside the repository) it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

BASES = (10, 17, 40, 50, 80, 97, 510)
NICEONLY_BASES = (10, 17, 40, 50, 80)
# K4's checks: b99 keeps no residue class (no launch), the others span the
# small tier (b10, b40) and the generic one (b98 and up, 5+ limbs).
DENSE_BASES = (10, 40, 98, 100, 510, 99)
DENSE_BASE = 98  # the dense niceonly main path's base
SLICE_WIDTH = 10_000_000  # the niceonly fields' slice held to the host scan
DENSE_SLICE_WIDTH = 200_000  # the b98 fields' slice held to the oracle
SEED = 20261016
DEVICE = "cuda"
SERVER_BASE = 40
SERVER_FIELD_SIZE = 1_000_000_000  # the server's default --field-size

# The first descriptor group of each niceonly main-path field, as the
# pipeline launched it (engine.LAST_NICEONLY_STATS["first_group"]).
FIRST_GROUPS: dict = {}

# The main-path fields and their results at the default shape, by (mode,
# name): what the tuned runs (phase_tuned) must reproduce exactly.
FIELD_RESULTS: dict = {}

# Lanes one H100 SM can serve per clock: its four schedulers each issue one
# warp instruction (32 lanes) a clock, and per class of integer instruction
# the rates of the CUDA C++ Programming Guide's throughput table for compute
# capability 9.0. A class may have a pipe of its own, so the bound takes the
# busiest class or the issue slots, whichever is slower, never their sum.
ISSUE_LANES_PER_SM_CLK = 128
CLASS_LANES_PER_SM_CLK = {"add": 64, "multiply-add": 64, "shift": 64,
                          "compare": 64, "logic": 64, "popc": 16}
SASS_CLASS = {"IADD3": "add", "IADD": "add", "IADD32I": "add",
              "IMAD": "multiply-add", "IMUL": "multiply-add",
              "SHF": "shift", "SHL": "shift", "SHR": "shift",
              "ISETP": "compare", "IMNMX": "compare",
              "LOP3": "logic", "LOP": "logic", "LOP32I": "logic",
              "POPC": "popc", "IMMA": "tensor"}
# The tensor class (K5's integer MMAs, IMMA) has no row in the Programming
# Guide's table: its rate is measured in this run by csrc/imma_probe.cu
# (phase_timing sets it, in IMMA instructions x 32 lanes per SM clock).
CLASS_LANES_PER_SM_CLK["tensor"] = None
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------------------
# Bounds
# --------------------------------------------------------------------------

def sass_counts(plan, table, dense_plan) -> dict:
    """Instructions one lane of each kernel issues, read from the compiled
    code: K1-K3 at `plan`'s base (K3 with this stride table), K4 at
    dense_plan's (with its fused class table). nvcc builds csrc/op_count.cu
    with the plans as compile-time constants (every loop unrolls, so each
    function there is straight-line) and cuobjdump lists its SASS (see
    parse_sass)."""
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce

    nvcc = cuda_build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    dp = dense_plan
    with tempfile.TemporaryDirectory(prefix="nice-op-count-") as tmp:
        with open(os.path.join(tmp, "op_count_plan.h"), "w") as f:
            words = ", ".join(f"{w}ull" for w in ce.plan_words(plan))
            dense_words = ", ".join(f"{w}ull" for w in ce.plan_words(dp))
            n_cls = ce.niceonly_classes(dp, True, "cpu").shape[0]
            f.write(f"#define NICE_PLAN {words}\n"
                    f"#define NICE_K3_R {table.num_residues}u\n"
                    f"#define NICE_K3_M {table.modulus}u\n"
                    f"#define NICE_K4_PLAN {dense_words}\n"
                    f"#define NICE_K4_TIER {dp.limbs_n}, {dp.limbs_sq}, "
                    f"{dp.limbs_cu}, {dp.n_masks}\n"
                    f"#define NICE_K4_R {n_cls}u\n")
        cubin = os.path.join(tmp, "op_count.cubin")
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-cubin", "-I", tmp, "-o", cubin,
             os.path.join(cuda_build.CSRC_DIR, "op_count.cu")],
            check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    funcs = parse_sass(sass)
    check({"k1_lane", "k2_lane", "k3_lane", "k4_lane", "k5_detailed_lane",
           "k5_dense_lane"} <= set(funcs), f"op_count functions: {list(funcs)}")
    return funcs


def build_imma_probe(out_dir: str) -> str:
    """nvcc builds csrc/imma_probe.cu into a shared library in out_dir."""
    from nice_tpu_torch.ops import cuda_build

    lib = os.path.join(out_dir, "libimma_probe.so")
    subprocess.run(
        [cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
         os.path.join(cuda_build.CSRC_DIR, "imma_probe.cu")],
        check=True, capture_output=True, text=True)
    return lib


def imma_per_product(lib_path: str) -> float:
    """IMMA instructions one 16x16x16 u8 product compiles to: those of the
    probe kernel (its loop body, not unrolled, holds its 4 products)."""
    from nice_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    funcs = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            funcs[name] = 0
        elif name and re.search(r"\bIMMA\.", line):
            funcs[name] += 1
    counts = [n for f, n in funcs.items() if "imma_probe_kernel" in f]
    check(len(counts) == 1 and counts[0] > 0, f"probe SASS: {funcs}")
    return counts[0] / 4


def imma_rate(lib_path: str, sms: int, clk_mhz: float) -> dict:
    """16x16x16 u8 wmma products (mma_sync) one SM completes per clock, from
    one timed launch of the probe (4 blocks an SM, 8 warps each, 4 chains
    of `iters` products a warp), and IMMA instructions per SM clock."""
    import ctypes

    import torch

    lib = ctypes.CDLL(lib_path)
    lib.nice_imma_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.nice_imma_probe.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    blocks, iters = 4 * sms, 8192
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(lib.nice_imma_probe(blocks, iters, out.data_ptr(), stream) == 0,
              "the IMMA probe did not launch")

    ms = time_cuda(run, reps=3, warmup=1)
    products = blocks * 8 * 4 * iters
    rate = products / (ms * 1e-3 * clk_mhz * 1e6 * sms)
    per = imma_per_product(lib_path)
    return {"ms": ms, "products": products, "mma_per_sm_clk": rate,
            "imma_per_mma": per, "imma_per_sm_clk": rate * per}


def parse_sass(sass: str) -> dict:
    """Per function of a cuobjdump -sass listing of straight-line code: the
    instruction count (padding NOPs and the self-loop after EXIT left out),
    the count per integer class of SASS_CLASS and per opcode, and the
    forward branches (code a lane may skip, counted all the same). A
    backward branch, a loop that did not unroll, fails."""
    funcs: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"instructions": 0, "classes": {}, "opcodes": {},
                           "forward_branches": 0}
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if not (m and name):
            continue
        addr, toks = int(m.group(1), 16), m.group(2).split()
        if toks[0].startswith("@"):
            toks = toks[1:]
        op = toks[0].split(".")[0]
        if op == "NOP":
            continue
        f = funcs[name]
        if op == "BRA":
            target = int(re.findall(r"0x([0-9a-f]+)", m.group(2))[-1], 16)
            if target == addr:
                continue
            check(target > addr, f"{name}: a loop at {addr:#x} did not unroll")
            f["forward_branches"] += 1
        f["instructions"] += 1
        f["opcodes"][toks[0]] = f["opcodes"].get(toks[0], 0) + 1
        cls = SASS_CLASS.get(op)
        if cls:
            f["classes"][cls] = f["classes"].get(cls, 0) + 1
    return funcs


def lane_cycles(counts: dict) -> float:
    """Least SM clock cycles one lane's instructions need: the issue slots,
    or the busiest integer class at its own rate, whichever is more. (A
    lane of K5 counts its warp's instructions, as every lane does: the
    warp's MMAs serve its 32 lanes together.)"""
    t = counts["instructions"] / ISSUE_LANES_PER_SM_CLK
    for cls, k in counts["classes"].items():
        t = max(t, k / CLASS_LANES_PER_SM_CLK[cls])
    return t


def bound_ms(lanes: int, cycles_per_lane: float, nbytes: int, sms: int,
             clk_mhz: float) -> tuple[float, str]:
    t_ops = lanes * cycles_per_lane / (sms * clk_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_build(report: dict, tmp: str) -> tuple[dict, str]:
    """The builds, all started together: the kernels (nvcc), the niceonly
    path's host library (g++), the op-count source (nvcc -cubin, counted
    with cuobjdump) and the tensor-core rate probe (nvcc, into tmp).
    Returns the op counts per lane and the probe's library for
    phase_timing."""
    from concurrent.futures import ThreadPoolExecutor

    from nice_tpu_torch import native
    from nice_tpu_torch.ops import cuda_build, engine
    from nice_tpu_torch.ops.limbs import get_plan

    def timed(fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        return out, time.monotonic() - t0

    s = engine.strided_setup(SERVER_BASE, SERVER_FIELD_SIZE)
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=4) as pool:
        kernels = pool.submit(timed, cuda_build.load)
        host = pool.submit(timed, native.load)
        counted = pool.submit(timed, sass_counts, s.plan, s.table,
                              get_plan(DENSE_BASE))
        probe = pool.submit(timed, build_imma_probe, tmp)
        (_, t_kernels), (_, t_host) = kernels.result(), host.result()
        counts, t_counted = counted.result()
        probe_lib, t_probe = probe.result()
    wall = time.monotonic() - t0
    info = cuda_build.BUILD_INFO
    resources = []
    name = None
    for line in info.get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and "_kernel" in name:
            resources.append({"kernel": name, "stack": int(m.group(1)),
                              "spill_stores": int(m.group(2)),
                              "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and resources and resources[-1]["kernel"] == name:
            resources[-1]["registers"] = int(m.group(1))
    report["build"] = {"nvcc_secs": info["seconds"], "kernels_secs": t_kernels,
                       "gxx_secs": native.BUILD_INFO["seconds"],
                       "host_library_secs": t_host,
                       "op_count_secs": t_counted, "probe_secs": t_probe,
                       "wall_secs": wall, "ptxas": resources}
    emit({"phase": "build", **report["build"]})
    return counts, probe_lib


def _straddle_start(plan, lanes: int) -> int:
    boundary = ((plan.range_start >> 32) + 1) << 32
    return (boundary - lanes // 2) % (1 << (32 * plan.limbs_n))


def phase_kernel_vs_plain(report: dict) -> None:
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    diff = {"detailed_megaloop": 0, "uniques": 0}
    checked = {"detailed_megaloop": 0, "uniques": 0}
    t0 = time.monotonic()
    for base in BASES:
        plan = get_plan(base)
        batch = 128 if base == 510 else 256
        for start in (plan.range_start, _straddle_start(plan, batch)):
            st = ve.start_limbs_tensor(start, plan, dev)
            for n_iters in (1, 3):
                total = batch * n_iters
                valid = total - int(rng.integers(1, batch))
                acc0 = torch.from_numpy(
                    rng.integers(0, 1000, plan.base + 2, dtype=np.int32)
                ).to(dev)
                h_k, nm_k = ce.detailed_accum_megaloop(
                    plan, batch, n_iters, acc0.clone(), st, valid)
                h_p, nm_p = ve.detailed_accum_megaloop(
                    plan, batch, n_iters, acc0.clone(), st, valid)
                d = max(int((h_k - h_p).abs().max()), abs(int(nm_k) - int(nm_p)))
                diff["detailed_megaloop"] = max(diff["detailed_megaloop"], d)
                checked["detailed_megaloop"] += 1
            u_k = ce.uniques_batch(plan, batch, st)
            u_p = ve.uniques_batch(plan, batch, st)
            d = int((u_k - u_p).abs().max())
            # Survivors with a low threshold and a small cap: the ordered
            # prefix on overflow, through the kernel and the plain version.
            valid = batch - int(rng.integers(1, batch // 2))
            thresh = plan.near_miss_cutoff - 3
            s_k = ce.survivors_batch(plan, batch, thresh, 8, st, valid)
            s_p = ve.survivors_batch(plan, batch, thresh, 8, st, valid)
            for a, b in zip(s_k, s_p):
                d = max(d, int((a.long() - b.long()).abs().max()))
            diff["uniques"] = max(diff["uniques"], d)
            checked["uniques"] += 1
    torch.cuda.synchronize()
    report["kernel_vs_plain"] = {
        "bases": list(BASES), "max_abs_diff": diff, "cases": checked,
        "secs": time.monotonic() - t0,
    }
    emit({"phase": "kernel_vs_plain", **report["kernel_vs_plain"]})
    check(all(v == 0 for v in diff.values()), f"kernel != plain: {diff}")


def _desc_tensor(rows, n_pad: int, rng, dev):
    """int64 [len(rows) + n_pad, 12] descriptor table (n0, lo, hi as four
    u32 limbs each) on dev; the n_pad rows past the real ones hold junk the
    kernels must not count."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops.limbs import int_to_limbs

    desc = np.zeros((len(rows) + n_pad, 12), dtype=np.int64)
    for i, (n0, lo, hi) in enumerate(rows):
        desc[i, 0:4] = int_to_limbs(n0, 4)
        desc[i, 4:8] = int_to_limbs(lo, 4)
        desc[i, 8:12] = int_to_limbs(hi, 4)
    desc[len(rows):] = [[rng.randrange(1 << 32) for _ in range(12)]
                        for _ in range(n_pad)]
    return torch.from_numpy(desc).to(dev)


def check_min_uniques(base: int) -> int:
    """A K3 threshold about the median of num_uniques over stride
    candidates (5/8 of the base): a check at it counts many lanes of every
    descriptor, where the nice test (min_uniques = base) counts none."""
    return (5 * base + 7) // 8


def _k3_pair(s, desc, n_real: int, dev, min_uniques: int):
    """K3 and its plain version on one descriptor table at one threshold:
    (kernel counts, max abs difference)."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops import vector_engine as ve

    res = engine._device_residues(s.plan.base, s.k, str(dev))
    m = s.table.modulus
    got = ce.strided_niceonly_batch(s.plan, m, res, s.periods, desc, n_real,
                                    min_uniques)
    want = ve.niceonly_strided_counts(s.plan, m, res, s.periods, desc, n_real,
                                      min_uniques)
    return got, int((got - want).abs().max())


def _strided_rows(s, rng) -> tuple[list, int]:
    """(n0, lo, hi) rows of the kernel-vs-plain cases at one base, with the
    base's main-path stride shape, and how many of them (the last) cross a
    multiple of 2^32, 2^64 or 2^96."""
    plan, m = s.plan, s.table.modulus
    span = s.periods * m
    start, end = plan.range_start, plan.range_end
    if plan.base == 10:
        # 69 (the only nice number of a small range) in 64 rows, and spans
        # past the range's end, where the fixed-width digits can hit too.
        rows = [(0, 47, 100)] * 64
        for _ in range(16):
            lo = end + rng.randrange(10**6)
            rows.append((lo // m * m, lo, lo + span))
        return rows, 0
    rows = []
    room = end - start - 3 * span
    if room <= 0:  # a range narrower than three spans (b17)
        room = (end - start) // 2
    for _ in range(8):  # ragged runs, cut into spans
        lo = start + rng.randrange(room)
        hi = min(end, lo + rng.randrange(1, 3 * span))
        n0 = lo // m * m
        while n0 < hi:
            rows.append((n0, lo, hi))
            n0 += span
    n_carry = 0
    for width in (32, 64, 96):  # candidates across a multiple of 2^width
        boundary = ((start >> width) + 1) << width
        if start < boundary < end - span:
            n0 = (boundary - span // 2) // m * m
            rows.append((n0, max(n0, start), n0 + span))
            n_carry += 1
    return rows, n_carry


def phase_strided_vs_plain(report: dict) -> None:
    import torch

    from nice_tpu_torch.ops import engine

    dev = torch.device(DEVICE)
    rng = random.Random(SEED)
    cases, diff, hits = [], 0, 0
    t0 = time.monotonic()
    for base in NICEONLY_BASES:
        s = engine.strided_setup(base, SERVER_FIELD_SIZE)
        rows, n_carry = _strided_rows(s, rng)
        desc = _desc_tensor(rows, 2, rng, dev)
        case = {"base": base, "k": s.k, "periods": s.periods,
                "rows": len(rows), "carry_rows": n_carry}
        for key, min_u in (("nice", base), ("median", check_min_uniques(base))):
            got, d = _k3_pair(s, desc, len(rows), dev, min_u)
            diff = max(diff, d)
            case[key] = {"min_uniques": min_u, "counted": int(got.sum()),
                         "max_abs_diff": d,
                         "zero_rows": int((got[:len(rows)] == 0).sum()),
                         "carry_counts": got[len(rows) - n_carry:len(rows)].tolist(),
                         "padding": got[len(rows):].tolist()}
        hits += case["nice"]["counted"]
        cases.append(case)
    torch.cuda.synchronize()
    report["strided_vs_plain"] = {"cases": cases, "max_abs_diff": diff,
                                  "hits": hits, "secs": time.monotonic() - t0}
    emit({"phase": "strided_vs_plain", **report["strided_vs_plain"]})
    check(diff == 0, f"K3 != plain: {cases}")
    check(cases[0]["nice"]["counted"] >= 64, f"b10 rows lost 69: {cases[0]}")
    for c in cases:
        # The median threshold must make the comparison see real counts: in
        # every table, and in every row that crosses a limb boundary.
        check(c["median"]["counted"] > 0
              and all(x > 0 for x in c["median"]["carry_counts"])
              and c["median"]["padding"] == [0, 0],
              f"b{c['base']}: the median threshold counted too little: {c}")


def _carry_start(plan, lanes: int) -> int:
    """A start whose lanes cross the largest limb carry inside the base's
    range: the first multiple of 2^w above range_start for the largest w (a
    multiple of 32) with one inside the range (2^128 at b98, 7 * 2^128 at
    b100, a multiple of 2^896 at b510)."""
    for w in range(32 * (plan.limbs_n - 1), 0, -32):
        b = ((plan.range_start >> w) + 1) << w
        if plan.range_start + lanes < b < plan.range_end - lanes:
            return b - lanes // 2
    raise SmokeFailure(f"b{plan.base}: no limb carry inside the range")


def _k4_pair(plan, fused: bool, start: int, batch: int, n_iters: int,
             valid: int, min_uniques: int, dev):
    """K4 and its plain version on one run: (kernel [count, pruned], max abs
    difference)."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve

    classes = ce.niceonly_classes(plan, fused, str(dev))
    st = ve.start_limbs_tensor(start, plan, dev)
    got = ce.niceonly_dense_megaloop(plan, batch, n_iters, classes, st, valid,
                                     min_uniques)
    want = ve.niceonly_dense_megaloop(plan, batch, n_iters, classes, st, valid,
                                      min_uniques)
    return got.tolist(), int((got - want).abs().max())


def phase_dense_vs_plain(report: dict) -> None:
    """K4 against its plain version, exact, in both TPU modes (fused: the
    base's residue classes; unfused: all b-1) and at both thresholds, at
    DENSE_BASES, from range_start (b10: 47) and from a start across a limb
    carry, with a ragged valid_total over three iterations."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import get_plan

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    cases, diff = [], 0
    launches0 = ce.LAUNCHES["niceonly_dense"]
    calls = 0
    t0 = time.monotonic()
    for base in DENSE_BASES:
        plan = get_plan(base)
        batch = 256 if base == 510 else 1024
        valid = 3 * batch - int(rng.integers(1, batch))
        starts = [("range_start", 47 if base == 10 else plan.range_start)]
        if base != 10:  # b10's one limb holds its whole range
            starts.append(("carry", _carry_start(plan, 3 * batch)))
        for where, start in starts:
            for fused in (True, False):
                case = {"base": base, "start": where, "fused": fused,
                        "valid": valid}
                for key, min_u in (("nice", base),
                                   ("median", check_min_uniques(base))):
                    got, d = _k4_pair(plan, fused, start, batch, 3, valid,
                                      min_u, dev)
                    diff = max(diff, d)
                    calls += 1
                    case[key] = {"min_uniques": min_u, "count": got[0],
                                 "pruned": got[1], "max_abs_diff": d}
                cases.append(case)
    torch.cuda.synchronize()
    launched = ce.LAUNCHES["niceonly_dense"] - launches0
    report["dense_vs_plain"] = {"cases": cases, "max_abs_diff": diff,
                                "launches": launched,
                                "secs": time.monotonic() - t0}
    emit({"phase": "dense_vs_plain", **report["dense_vs_plain"]})
    check(diff == 0, f"K4 != plain: {cases}")
    empty = [c for c in cases if c["base"] == 99 and c["fused"]]
    check(launched == calls - 2 * len(empty),
          f"{launched} K4 launches for {calls} calls ({len(empty)} empty "
          "tables)")
    for c in cases:
        if c in empty:  # no class: every lane pruned, nothing launched
            check(c["median"]["count"] == 0
                  and c["median"]["pruned"] == c["valid"], f"b99: {c}")
        elif c["fused"]:
            check(c["median"]["pruned"] < c["valid"], f"nothing kept: {c}")
        elif c["start"] == "carry" or c["base"] == 10:
            # Unfused, every lane is kept; across a carry (and at b10) the
            # median threshold must count many. At a range's start the
            # squares lead with zeros and num_uniques sits lower.
            check(c["median"]["count"] > 0 and c["median"]["pruned"] == 0,
                  f"the median threshold counted nothing: {c}")
    check(all(c["nice"]["count"] >= 1 for c in cases if c["base"] == 10),
          f"b10 from 47 lost 69: {cases[:2]}")


def _k5_detailed(plan, batch: int, n_iters: int, acc0, st, valid: int):
    """K5 in the detailed mode, its plain version and K1 on one segment:
    (K5's near-miss count, max abs difference from the plain version, from
    K1), over the histogram and the count."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve

    h5, nm5 = ce.detailed_accum_megaloop(plan, batch, n_iters, acc0.clone(),
                                         st, valid, 1)
    hp, nmp = ve.detailed_accum_megaloop(plan, batch, n_iters, acc0.clone(),
                                         st, valid, 1)
    h1, nm1 = ce.detailed_accum_megaloop(plan, batch, n_iters, acc0.clone(),
                                         st, valid)
    return (int(nm5),
            max(int((h5 - hp).abs().max()), abs(int(nm5) - int(nmp))),
            max(int((h5 - h1).abs().max()), abs(int(nm5) - int(nm1))))


def _k5_dense(plan, fused: bool, start: int, batch: int, n_iters: int,
              valid: int, min_uniques: int, dev):
    """K5 in the dense mode, its plain version and K4 on one run: (K5's
    [count, pruned], max abs difference from the plain version, from K4)."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve

    classes = ce.niceonly_classes(plan, fused, str(dev))
    st = ve.start_limbs_tensor(start, plan, dev)
    args = (plan, batch, n_iters, classes, st, valid, min_uniques)
    got = ce.niceonly_dense_megaloop(*args, use_mxu=1)
    want = ve.niceonly_dense_megaloop(*args, use_mxu=1)
    k4 = ce.niceonly_dense_megaloop(*args)
    return (got.tolist(), int((got - want).abs().max()),
            int((got - k4).abs().max()))


def phase_mxu_vs_plain(report: dict) -> None:
    """K5 against its plain version and against K1/K4 on the card, exact:
    the detailed mode at BASES as phase 3 runs K1 (from range_start and
    across a 2^32 carry, which at b10 and b17 wraps past the top limb), the
    dense mode at DENSE_BASES as phase 4b runs K4 (both TPU modes, both
    thresholds, from range_start or 47 and across the largest carry)."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    diff = {"detailed_megaloop_mma": 0, "niceonly_dense_mma": 0}
    vs_k1_k4 = dict(diff)
    launches0 = dict(ce.LAUNCHES)
    calls = {"detailed_megaloop_mma": 0, "niceonly_dense_mma": 0}
    detailed, dense = [], []
    t0 = time.monotonic()
    for base in BASES:
        plan = get_plan(base)
        batch = 128 if base == 510 else 256
        for start in (plan.range_start, _straddle_start(plan, batch)):
            st = ve.start_limbs_tensor(start, plan, dev)
            for n_iters in (1, 3):
                valid = batch * n_iters - int(rng.integers(1, batch))
                acc0 = torch.from_numpy(
                    rng.integers(0, 1000, plan.base + 2, dtype=np.int32)).to(dev)
                nm, d, dk = _k5_detailed(plan, batch, n_iters, acc0, st, valid)
                diff["detailed_megaloop_mma"] = max(diff["detailed_megaloop_mma"], d)
                vs_k1_k4["detailed_megaloop_mma"] = max(
                    vs_k1_k4["detailed_megaloop_mma"], dk)
                calls["detailed_megaloop_mma"] += 1
                detailed.append({"base": base, "start": start,
                                 "n_iters": n_iters, "near_misses": nm})
    empty = 0
    for base in DENSE_BASES:
        plan = get_plan(base)
        batch = 256 if base == 510 else 1024
        valid = 3 * batch - int(rng.integers(1, batch))
        starts = [("range_start", 47 if base == 10 else plan.range_start)]
        if base != 10:
            starts.append(("carry", _carry_start(plan, 3 * batch)))
        for where, start in starts:
            for fused in (True, False):
                case = {"base": base, "start": where, "fused": fused,
                        "valid": valid}
                for key, min_u in (("nice", base),
                                   ("median", check_min_uniques(base))):
                    got, d, dk = _k5_dense(plan, fused, start, batch, 3, valid,
                                           min_u, dev)
                    diff["niceonly_dense_mma"] = max(diff["niceonly_dense_mma"], d)
                    vs_k1_k4["niceonly_dense_mma"] = max(
                        vs_k1_k4["niceonly_dense_mma"], dk)
                    calls["niceonly_dense_mma"] += 1
                    empty += base == 99 and fused
                    case[key] = {"min_uniques": min_u, "count": got[0],
                                 "pruned": got[1]}
                dense.append(case)
    torch.cuda.synchronize()
    launched = {k: ce.LAUNCHES[k] - launches0[k] for k in calls}
    report["mxu_vs_plain"] = {"max_abs_diff": diff, "max_abs_diff_vs_k1_k4": vs_k1_k4,
                              "calls": calls, "launches": launched,
                              "detailed": detailed, "dense": dense,
                              "secs": time.monotonic() - t0}
    emit({"phase": "mxu_vs_plain", **report["mxu_vs_plain"]})
    check(all(v == 0 for v in diff.values()), f"K5 != plain: {diff}")
    check(all(v == 0 for v in vs_k1_k4.values()), f"K5 != K1/K4: {vs_k1_k4}")
    check(launched["detailed_megaloop_mma"] == calls["detailed_megaloop_mma"]
          and launched["niceonly_dense_mma"] == calls["niceonly_dense_mma"] - empty,
          f"{launched} K5 launches for {calls} calls ({empty} on empty tables)")
    check(any(c["near_misses"] > 0 for c in detailed),
          "no K5 detailed case counted a near miss")
    for c in dense:
        if c["fused"] and c["base"] != 99:
            check(c["median"]["pruned"] < c["valid"], f"nothing kept: {c}")
        elif not c["fused"] and (c["start"] == "carry" or c["base"] == 10):
            check(c["median"]["count"] > 0,
                  f"the median threshold counted nothing: {c}")
    check(all(c["nice"]["count"] >= 1 for c in dense if c["base"] == 10),
          f"b10 from 47 lost 69 through K5: {dense[:2]}")


def phase_golden(report: dict) -> None:
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine, scalar

    ten = get_benchmark_field(BenchmarkMode.BASE_TEN)
    r = engine.process_range_detailed(ten.to_field_size(), ten.base,
                                      device=DEVICE)
    nice = [(n.number, n.num_uniques) for n in r.nice_numbers]
    check(nice == [(69, 10)], f"base-ten nice numbers {nice}")
    check(r == scalar.process_range_detailed(ten.to_field_size(), ten.base),
          "base-ten differs from the scalar oracle")
    default = get_benchmark_field(BenchmarkMode.DEFAULT)
    t0 = time.monotonic()
    card = engine.process_range_detailed(default.to_field_size(), default.base,
                                         device=DEVICE)
    t_card = time.monotonic() - t0
    t0 = time.monotonic()
    cpu = engine.process_range_detailed(default.to_field_size(), default.base,
                                        device="cpu")
    t_cpu = time.monotonic() - t0
    check(card == cpu, "default field: card differs from the CPU plain path")
    report["golden"] = {"base_ten": nice, "default_near_misses": len(card.nice_numbers),
                        "default_card_secs": t_card,
                        "default_cpu_plain_secs": t_cpu}
    emit({"phase": "golden", **report["golden"]})

    # Niceonly: base-ten through K3, its one hit re-scanned on the host by
    # the collector; default on the card against the plain path on the CPU.
    ce.reset_launches()
    r = engine.process_range_niceonly(ten.to_field_size(), ten.base,
                                      device=DEVICE)
    stats = dict(engine.LAST_NICEONLY_STATS)
    nice = [n.number for n in r.nice_numbers]
    check(nice == [69], f"base-ten niceonly gives {nice}")
    check(ce.LAUNCHES["strided_niceonly"] >= 1 and stats.get("nice") == 1,
          f"base-ten niceonly did not find 69 through K3: {ce.LAUNCHES}, {stats}")
    card = engine.process_range_niceonly(default.to_field_size(),
                                         default.base, device=DEVICE)
    cpu = engine.process_range_niceonly(default.to_field_size(),
                                        default.base, device="cpu")
    check(card == cpu, "default niceonly: card differs from the CPU plain path")
    report["golden_niceonly"] = {
        "base_ten": nice, "base_ten_k3_launches": ce.LAUNCHES["strided_niceonly"],
        "base_ten_descriptors": stats["descriptors"],
        "default_nice": len(card.nice_numbers)}
    emit({"phase": "golden_niceonly", **report["golden_niceonly"]})

    # The dense loop (b98's path) on base-ten: 69 through K4, then K2.
    import torch

    ce.reset_launches()
    found = []
    engine._niceonly_dense(ten.to_field_size(), ten.base, torch.device(DEVICE),
                           found)
    dense = [n.number for n in found]
    check(dense == [69] and ce.LAUNCHES["niceonly_dense"] >= 1
          and ce.LAUNCHES["uniques"] >= 1,
          f"base-ten through the dense loop gives {dense}: {ce.LAUNCHES}")
    report["golden_dense"] = {"base_ten": dense,
                              "k4_launches": ce.LAUNCHES["niceonly_dense"],
                              "k2_launches": ce.LAUNCHES["uniques"]}
    emit({"phase": "golden_dense", **report["golden_dense"]})


def _check_field(data, results) -> int:
    """Sum, oracle and seeded-slice checks of one detailed field; returns
    the near-miss count."""
    from nice_tpu_torch.core import number_stats
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import scalar

    check(len(results.distribution) == data.base, "distribution length")
    total = sum(d.count for d in results.distribution)
    check(total == data.range_size, f"bins sum to {total}, not {data.range_size}")
    cutoff = number_stats.get_near_miss_cutoff(data.base)
    for n in results.nice_numbers:
        check(data.range_start <= n.number < data.range_end, f"{n} outside field")
        check(n.num_uniques > cutoff, f"{n} is not a near miss")
        u = scalar.get_num_unique_digits(n.number, data.base)
        check(u == n.num_uniques, f"oracle gives {u} for {n}")
    # A seeded slice through the oracle: its near misses must be reported
    # and no bin may hold more than the field's.
    rng = random.Random(SEED + data.range_start)
    width = min(20_000, data.range_size)
    s = rng.randrange(data.range_start, data.range_end - width + 1)
    sl = scalar.process_range_detailed(FieldSize(s, s + width), data.base)
    reported = {(n.number, n.num_uniques) for n in results.nice_numbers}
    for n in sl.nice_numbers:
        check((n.number, n.num_uniques) in reported, f"slice near miss {n} missing")
    field = {d.num_uniques: d.count for d in results.distribution}
    for d in sl.distribution:
        check(d.count <= field[d.num_uniques], f"slice bin {d} exceeds the field's")
    return len(results.nice_numbers)


def _mid_range_field(base: int):
    """A seeded full-width field of the server's 1e9 grid over the base's
    range, away from its start: the extra-large field (the range's first
    1e9) holds no near miss at b40, and a field that does drives the rare
    path (K2) too."""
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops.limbs import get_plan

    plan = get_plan(base)
    n_fields = (plan.range_end - plan.range_start) // SERVER_FIELD_SIZE
    k = random.Random(SEED).randrange(n_fields // 4, 3 * n_fields // 4)
    start = plan.range_start + k * SERVER_FIELD_SIZE
    return DataToClient(claim_id=0, base=base, range_start=start,
                        range_end=start + SERVER_FIELD_SIZE,
                        range_size=SERVER_FIELD_SIZE)


def phase_full_width(report: dict) -> None:
    """The main path: a client processing two full-width b40 fields, the
    extra-large benchmark field and a mid-range one, with the launch
    counters set to 0 just before and read just after."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.ops import cuda_engine as ce

    fields = [("extra-large", get_benchmark_field(BenchmarkMode.EXTRA_LARGE)),
              ("mid-range", _mid_range_field(SERVER_BASE))]
    args = client.build_parser().parse_args(["--device", DEVICE])
    runs = []
    ce.reset_launches()
    for name, data in fields:
        before = dict(ce.LAUNCHES)
        results, elapsed = client.process_field(data, args)
        launches = {k: v - before[k] for k, v in ce.LAUNCHES.items()}
        FIELD_RESULTS[("detailed", name)] = (data, results)
        runs.append({
            "field": name, "base": data.base, "range_start": data.range_start,
            "numbers": data.range_size, "elapsed_secs": elapsed,
            "numbers_per_sec": data.range_size / elapsed,
            "launches": launches, "near_misses": _check_field(data, results),
            "near_miss_numbers": [n.number for n in results.nice_numbers],
        })
    total = dict(ce.LAUNCHES)
    report["full_width"] = {"fields": runs, "launches": total}
    report["main_path_launches"] = total
    for run in runs:
        emit({"phase": "full_width", **run})
    check(all(r["launches"]["detailed_megaloop"] > 0 for r in runs),
          "K1 was not launched on a field")
    check(all(r["near_misses"] == 0 or r["launches"]["uniques"] > 0
              for r in runs), "near misses without a K2 launch")
    check(total["uniques"] > 0, "the main path never reached K2")


def _surviving_field(base: int):
    """The first field of a seeded draw from the server's 1e9 grid over the
    base's range that the MSD filter does not prune whole, as the niceonly
    pipeline itself finds (a pruned field forms no descriptor group, or at
    b98 and up no dense run). At b80 it prunes about 19 fields in 20
    (hi-base, the range's first, among them), at b98 about 99 in 100, so
    this is the field that takes the niceonly main path through K3 (b80) or
    K4 (b98) there."""
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan

    plan = get_plan(base)
    n_fields = (plan.range_end - plan.range_start) // SERVER_FIELD_SIZE
    rng = random.Random(SEED)
    for _ in range(200):
        start = plan.range_start + rng.randrange(n_fields) * SERVER_FIELD_SIZE
        data = DataToClient(claim_id=0, base=base, range_start=start,
                            range_end=start + SERVER_FIELD_SIZE,
                            range_size=SERVER_FIELD_SIZE)
        engine.process_range_niceonly(data.to_field_size(), base,
                                      device=DEVICE)
        stats = engine.LAST_NICEONLY_STATS
        if stats.get("groups") or stats.get("runs"):
            return data
    raise SmokeFailure(f"no b{base} field of 200 survives the MSD filter")


def _check_niceonly(data, results) -> dict:
    """Every reported number is nice and in the field, and a seeded
    SLICE_WIDTH slice of the field holds exactly the numbers the host
    library's scan finds there."""
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import engine, scalar

    check(results.distribution == (), "niceonly results carry a distribution")
    for n in results.nice_numbers:
        check(data.range_start <= n.number < data.range_end, f"{n} outside field")
        check(n.num_uniques == data.base
              and scalar.get_num_unique_digits(n.number, data.base) == data.base,
              f"{n} is not nice")
    rng = random.Random(SEED + data.range_start)
    width = min(SLICE_WIDTH, data.range_size)
    lo = rng.randrange(data.range_start, data.range_end - width + 1)
    want = engine.host_niceonly(FieldSize(lo, lo + width), data.base)
    got = [n.number for n in results.nice_numbers if lo <= n.number < lo + width]
    check(got == want, f"slice [{lo}, {lo + width}): device {got}, host {want}")
    return {"slice_start": lo, "slice_width": width, "slice_nice": len(want)}


def phase_full_width_niceonly(report: dict) -> None:
    """The niceonly main path: a client processing four full-width fields in
    niceonly mode (extra-large, the mid-range b40 field, hi-base, and the
    surviving b80 field), with the launch counts set to 0 just before and
    read just after."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine

    fields = [("extra-large", get_benchmark_field(BenchmarkMode.EXTRA_LARGE)),
              ("mid-range", _mid_range_field(SERVER_BASE)),
              ("hi-base", get_benchmark_field(BenchmarkMode.HI_BASE)),
              ("b80-surviving", _surviving_field(80))]
    args = client.build_parser().parse_args(["niceonly", "--device", DEVICE])
    runs = []
    ce.reset_launches()
    for name, data in fields:
        before = ce.LAUNCHES["strided_niceonly"]
        results, elapsed = client.process_field(data, args)
        launches = ce.LAUNCHES["strided_niceonly"] - before
        stats = dict(engine.LAST_NICEONLY_STATS)
        FIRST_GROUPS[name] = stats.pop("first_group")
        check(launches == stats["groups"],
              f"{name}: {launches} K3 launches for {stats['groups']} groups")
        runs.append({"field": name, "base": data.base,
                     "range_start": data.range_start, "numbers": data.range_size,
                     "elapsed_secs": elapsed,
                     "numbers_per_sec": data.range_size / elapsed,
                     "k3_launches": launches, "nice": len(results.nice_numbers),
                     **_check_niceonly(data, results), "stats": stats})
    total = dict(ce.LAUNCHES)
    report["full_width_niceonly"] = {"fields": runs, "launches": total}
    report["main_path_launches"]["strided_niceonly"] = total["strided_niceonly"]
    for run in runs:
        emit({"phase": "full_width_niceonly", **run})
    for base in (SERVER_BASE, 80):
        check(sum(r["k3_launches"] for r in runs if r["base"] == base) > 0,
              f"the niceonly main path never reached K3 at b{base}")


def _check_dense(data, results) -> dict:
    """Every reported number is nice and in the field, and a seeded
    DENSE_SLICE_WIDTH slice of the field holds exactly the numbers the
    scalar oracle's nice test finds there, number by number (the host
    library takes no value above 2^128)."""
    from nice_tpu_torch.ops import scalar

    check(results.distribution == (), "niceonly results carry a distribution")
    for n in results.nice_numbers:
        check(data.range_start <= n.number < data.range_end, f"{n} outside field")
        check(n.num_uniques == data.base
              and scalar.get_num_unique_digits(n.number, data.base) == data.base,
              f"{n} is not nice")
    rng = random.Random(SEED + data.range_start)
    width = min(DENSE_SLICE_WIDTH, data.range_size)
    lo = rng.randrange(data.range_start, data.range_end - width + 1)
    t0 = time.monotonic()
    want = [n for n in range(lo, lo + width) if scalar.get_is_nice(n, data.base)]
    got = [n.number for n in results.nice_numbers if lo <= n.number < lo + width]
    check(got == want, f"slice [{lo}, {lo + width}): device {got}, oracle {want}")
    return {"slice_start": lo, "slice_width": width, "slice_nice": len(want),
            "slice_oracle_secs": time.monotonic() - t0}


def phase_full_width_dense(report: dict) -> None:
    """The dense niceonly main path: a client processing two full-width b98
    fields in niceonly mode (the range's first 1e9, which the MSD filter
    prunes whole, and the first seeded field it does not), with the launch
    counts set to 0 just before and read just after."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan

    lo = get_plan(DENSE_BASE).range_start
    fields = [("b98-first", DataToClient(
                  claim_id=0, base=DENSE_BASE, range_start=lo,
                  range_end=lo + SERVER_FIELD_SIZE,
                  range_size=SERVER_FIELD_SIZE)),
              ("b98-surviving", _surviving_field(DENSE_BASE))]
    args = client.build_parser().parse_args(["niceonly", "--device", DEVICE])
    runs = []
    ce.reset_launches()
    for name, data in fields:
        before = dict(ce.LAUNCHES)
        results, elapsed = client.process_field(data, args)
        launches = {k: v - before[k] for k, v in ce.LAUNCHES.items()}
        FIELD_RESULTS[("niceonly", name)] = (data, results)
        stats = dict(engine.LAST_NICEONLY_STATS)
        check(stats["base"] == DENSE_BASE and stats["start"] == data.range_start,
              f"{name}: the dense loop did not run the field: {stats}")
        check(launches["niceonly_dense"] == stats["runs"] == stats["launches"],
              f"{name}: {launches} launches for {stats['runs']} runs")
        runs.append({"field": name, "base": data.base,
                     "range_start": data.range_start,
                     "numbers": data.range_size, "elapsed_secs": elapsed,
                     "numbers_per_sec": data.range_size / elapsed,
                     "launches": launches, "nice": len(results.nice_numbers),
                     **_check_dense(data, results), "stats": stats})
    total = dict(ce.LAUNCHES)
    report["full_width_dense"] = {"fields": runs, "launches": total}
    report["main_path_launches"]["niceonly_dense"] = total["niceonly_dense"]
    for run in runs:
        emit({"phase": "full_width_dense", **run})
    check(runs[0]["stats"]["runs"] == 0, f"b98-first was not pruned whole: {runs[0]}")
    check(runs[1]["launches"]["niceonly_dense"] > 0,
          "the dense niceonly main path never reached K4")


# A fresh process of the tuned path: points the port's winners table at
# argv[1], runs the fields of argv[2] on device argv[3] through the client's
# process_field and prints what the tuned run resolved, launched and found.
_FRESH_TUNED = """
import json, sys
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import DataToClient
from nice_tpu_torch.ops import autotune, engine
from nice_tpu_torch.ops import cuda_engine as ce
autotune.WINNERS_PATH = sys.argv[1]
out = []
for mode, base, start, size in json.loads(sys.argv[2]):
    data = DataToClient(claim_id=0, base=base, range_start=start,
                        range_end=start + size, range_size=size)
    args = client.build_parser().parse_args([mode, "--device", sys.argv[3]])
    ce.reset_launches()
    results, secs = client.process_field(data, args)
    out.append({"mode": mode, "base": base, "secs": secs,
                "resolved": engine.resolve_tuning(mode, base, sys.argv[3]),
                "launches": {k: v for k, v in ce.LAUNCHES.items() if v},
                "distribution": [[d.num_uniques, d.count]
                                 for d in results.distribution],
                "nice": [[n.number, n.num_uniques] for n in results.nice_numbers]})
print(json.dumps({"fields": out, "events": autotune.EVENTS}))
"""


def _pairs(results) -> tuple[list, list]:
    return ([[d.num_uniques, d.count] for d in results.distribution],
            [[n.number, n.num_uniques] for n in results.nice_numbers])


def phase_tuned(report: dict, tmp: str) -> None:
    """The tuned path at full width:
      1. sweeps on the card (autotune.sweep, the harness in a subprocess)
         into a temporary winners table: extra-large, detailed, a 1e8
         slice, batches 2^17-2^19 x segments 4/8/16 x K1/K5; then the
         b98-surviving field, niceonly, whole, batches 2^17/2^18 x segment
         8 x K4/K5;
      2. a fresh Python process pointed at that table runs extra-large
         (detailed) and b98-surviving (niceonly) through process_field:
         autotune hits, and results equal to the default-shape runs;
      3. winners with use_mxu=1 at the default shape (detailed b40,
         niceonly b98) in a second table, and extra-large, mid-range and
         b98-surviving through process_field here, the launch counts set to
         0 just before and read just after: K5 launched in K1's and K4's
         place (and K2 re-scanning mid-range's near misses), results equal
         to the use_mxu=0 runs. These are K5's main-path launches."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.ops import autotune, engine
    from nice_tpu_torch.ops import cuda_engine as ce

    xl, _ = FIELD_RESULTS[("detailed", "extra-large")]
    mid, _ = FIELD_RESULTS[("detailed", "mid-range")]
    b98, _ = FIELD_RESULTS[("niceonly", "b98-surviving")]
    saved = autotune.WINNERS_PATH
    try:
        autotune.WINNERS_PATH = os.path.join(tmp, "swept.json")
        t0 = time.monotonic()
        won_d = autotune.sweep("detailed", DEVICE, bench_mode="extra-large",
                               batch_shifts=[17, 18, 19], segments=[4, 8, 16],
                               mxu="auto", slice_size=100_000_000, timeout=400)
        t1 = time.monotonic()
        won_n = autotune.sweep("niceonly", DEVICE,
                               field=(DENSE_BASE, b98.range_start, b98.range_size),
                               batch_shifts=[17, 18], segments=[8], mxu="auto",
                               slice_size=b98.range_size, timeout=400)
        t2 = time.monotonic()
        with open(autotune.WINNERS_PATH) as f:
            table = json.load(f)
        swept = {k: v["swept"] for k, v in table.items()}
        fields = [["detailed", xl.base, xl.range_start, xl.range_size],
                  ["niceonly", b98.base, b98.range_start, b98.range_size]]
        proc = subprocess.run(
            [sys.executable, "-c", _FRESH_TUNED, autotune.WINNERS_PATH,
             json.dumps(fields), DEVICE], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, "the fresh tuned process failed:\n"
              + proc.stderr[-3000:])
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        for run, name, mode, won in zip(fresh["fields"],
                                        ("extra-large", "b98-surviving"),
                                        ("detailed", "niceonly"), (won_d, won_n)):
            _, want = FIELD_RESULTS[(mode, name)]
            check([run["distribution"], run["nice"]] == list(_pairs(want)),
                  f"{name}: the tuned run differs from the default-shape run")
            check(run["resolved"] == [won["batch_size"], won["megaloop"],
                                      won["use_mxu"]],
                  f"{name}: resolved {run['resolved']}, the winner is {won}")
        check(fresh["events"]["hit"] > 0 and fresh["events"]["invalidated"] == 0,
              f"the fresh process did not hit the table: {fresh['events']}")

        # K5's main path: use_mxu=1 winners at the default shape.
        autotune.WINNERS_PATH = os.path.join(tmp, "k5.json")
        shape = {"batch_size": engine.DEFAULT_BATCH_SIZE,
                 "megaloop": engine.MEGALOOP_SEGMENT_DEFAULT, "use_mxu": 1}
        autotune.record("detailed", SERVER_BASE, DEVICE, shape)
        autotune.record("niceonly", DENSE_BASE, DEVICE, shape)
        runs = []
        ce.reset_launches()
        for mode, name in (("detailed", "extra-large"), ("detailed", "mid-range"),
                           ("niceonly", "b98-surviving")):
            data, want = FIELD_RESULTS[(mode, name)]
            args = client.build_parser().parse_args([mode, "--device", DEVICE])
            before = dict(ce.LAUNCHES)
            results, elapsed = client.process_field(data, args)
            launches = {k: v - before[k] for k, v in ce.LAUNCHES.items()}
            check(_pairs(results) == _pairs(want),
                  f"{name}: K5's results differ from K1's/K4's")
            runs.append({"field": name, "mode": mode, "elapsed_secs": elapsed,
                         "launches": launches})
            if mode == "niceonly":
                runs[-1]["stats"] = {k: engine.LAST_NICEONLY_STATS[k] for k in
                                     ("runs", "use_mxu", "msd_secs", "loop_secs")}
        k5_launches = dict(ce.LAUNCHES)
    finally:
        autotune.WINNERS_PATH = saved
        autotune.reset_for_tests()
    report["tuned"] = {"sweep_detailed_secs": t1 - t0,
                       "sweep_niceonly_secs": t2 - t1, "winners": {
                           "detailed": won_d, "niceonly": won_n},
                       "swept": swept, "fresh": fresh, "k5_runs": runs,
                       "launches": k5_launches}
    report["main_path_launches"].update(
        detailed_megaloop_mma=k5_launches["detailed_megaloop_mma"],
        niceonly_dense_mma=k5_launches["niceonly_dense_mma"])
    emit({"phase": "tuned", **{k: v for k, v in report["tuned"].items()
                               if k != "fresh"},
          "fresh": [{k: v for k, v in r.items() if k in
                     ("mode", "base", "secs", "resolved", "launches")}
                    for r in fresh["fields"]] + [fresh["events"]]})
    xl_run, mid_run, b98_run = runs
    for run in (xl_run, mid_run):
        check(run["launches"]["detailed_megaloop"] == 0
              and run["launches"]["detailed_megaloop_mma"] > 0,
              f"{run['field']}: K5 did not take K1's place: {run['launches']}")
    check(mid_run["launches"]["uniques"] > 0, "K2 did not re-scan mid-range")
    check(b98_run["launches"]["niceonly_dense"] == 0
          and b98_run["launches"]["niceonly_dense_mma"]
          == b98_run["stats"]["runs"] > 0,
          f"b98-surviving: K5 did not take K4's place: {b98_run['launches']}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def phase_server(report: dict) -> None:
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import FieldResults
    from nice_tpu_torch.ops import cuda_engine as ce

    port = _free_port()
    api = f"http://127.0.0.1:{port}"
    with tempfile.TemporaryDirectory(prefix="nice-chip-smoke-") as tmp:
        log_path = os.path.join(tmp, "server.log")
        with open(log_path, "wb") as log_f:
            server = subprocess.Popen(
                [sys.executable, "-m", "nice_tpu.server", "--db",
                 os.path.join(tmp, "nice.db"), "--init-base", str(SERVER_BASE),
                 "--field-size", str(SERVER_FIELD_SIZE),
                 "--host", "127.0.0.1", "--port", str(port)],
                cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT,
            )
        try:
            deadline = time.monotonic() + 120
            while True:
                check(server.poll() is None, "server exited: " + _tail(log_path))
                try:
                    _get_json(api + "/status")
                    break
                except OSError:
                    check(time.monotonic() < deadline, "server did not come up")
                    time.sleep(0.5)
            args = client.build_parser().parse_args(
                ["detailed", "--api-base", api, "--username", "chip-smoke",
                 "--device", DEVICE])
            ce.reset_launches()
            t0 = time.monotonic()
            data, sub, resp = client.run_single_iteration(args)
            elapsed = time.monotonic() - t0
            launches = dict(ce.LAUNCHES)
            check(resp.get("status") == "OK" and not resp.get("duplicate"),
                  f"submit not accepted: {resp}")
            # The server's fields are 1e9 wide except the base's last one.
            check(data.base == SERVER_BASE
                  and 0 < data.range_size <= SERVER_FIELD_SIZE,
                  f"claimed {data}, not a b{SERVER_BASE} field")
            _check_field(data, FieldResults(tuple(sub.unique_distribution),
                                            tuple(sub.nice_numbers)))
            spot = {}
            deadline = time.monotonic() + 60
            while not spot.get("pass"):
                check(time.monotonic() < deadline, f"no spot check: {spot}")
                time.sleep(1.0)
                spot = _get_json(api + "/status")["fleet"]["trust"]["spot_checks"]
            check(spot.get("fail", 0) == 0, f"spot check failed: {spot}")
            # A niceonly round against the same server.
            args = client.build_parser().parse_args(
                ["niceonly", "--api-base", api, "--username", "chip-smoke",
                 "--device", DEVICE])
            ce.reset_launches()
            t0 = time.monotonic()
            n_data, n_sub, n_resp = client.run_single_iteration(args)
            n_elapsed = time.monotonic() - t0
            check(n_resp.get("status") == "OK" and not n_resp.get("duplicate"),
                  f"niceonly submit not accepted: {n_resp}")
            check(n_data.base == SERVER_BASE and n_sub.unique_distribution is None,
                  f"niceonly round: claimed {n_data}, sent {n_sub}")
            _check_niceonly(n_data, FieldResults((), tuple(n_sub.nice_numbers)))
            n_launches = dict(ce.LAUNCHES)
        finally:
            server.terminate()
            try:
                server.wait(timeout=15)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait(timeout=15)
    report["server"] = {"claim_id": data.claim_id, "numbers": data.range_size,
                        "client_secs": elapsed, "launches": launches,
                        "near_misses": len(sub.nice_numbers), "reply": resp,
                        "spot_checks": spot,
                        "niceonly": {"claim_id": n_data.claim_id,
                                     "range_start": n_data.range_start,
                                     "numbers": n_data.range_size,
                                     "client_secs": n_elapsed,
                                     "launches": n_launches,
                                     "nice": len(n_sub.nice_numbers),
                                     "reply": n_resp}}
    emit({"phase": "server", **report["server"]})


def _tail(path: str) -> str:
    with open(path, "rb") as f:
        return f.read()[-2000:].decode(errors="replace")


def _main_shape_starts(report: dict) -> dict:
    """Starts of the main path's launches to hold the kernels to: the
    extra-large field's first segment, and the mid-range field's segment and
    rare-scan sub-batch that hold its first near miss (so K1's near-miss
    count and K2's survivors are not all zero)."""
    from nice_tpu_torch.ops import engine

    lanes = engine.DEFAULT_BATCH_SIZE * engine.MEGALOOP_SEGMENT_DEFAULT
    sub = min(engine.RARE_SCAN_BATCH, engine.DEFAULT_BATCH_SIZE)
    xl, mid = report["full_width"]["fields"]
    hit = mid["near_miss_numbers"][0]
    seg = mid["range_start"] + (hit - mid["range_start"]) // lanes * lanes
    return {"range_start": xl["range_start"], "near_miss_segment": seg,
            "near_miss_sub_batch": seg + (hit - seg) // sub * sub}


def _main_path_group(name: str, report: dict, dev):
    """The first descriptor group the niceonly main path launched on a
    field: (its stride shape, columns, int64 desc table on dev)."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine, stride_filter
    from nice_tpu_torch.ops.limbs import get_plan

    stats = next(r for r in report["full_width_niceonly"]["fields"]
                 if r["field"] == name)["stats"]
    cols = FIRST_GROUPS[name]
    check(cols is not None, f"{name}: the main path launched no group")
    s = engine.StridedSetup(
        get_plan(stats["base"]), None, stats["floor"], stats["k"],
        stats["periods"], stride_filter.get_stride_table(stats["base"], stats["k"]))
    desc = torch.from_numpy(engine.pack_descriptors(
        cols, ce.STRIDED_DESC_MAX).astype(np.int64)).to(dev)
    return s, cols, desc


def _dense_stats(name: str, report: dict) -> dict:
    """The dense loop's stats of one b98 main-path field."""
    return next(r for r in report["full_width_dense"]["fields"]
                if r["field"] == name)["stats"]


def phase_main_shapes(report: dict) -> None:
    """Each kernel against its plain version at the shapes the main path
    gives it, exact: K1 over a whole 2^18 x 8 segment with every lane valid,
    K2 (and the survivor compaction after it) over one rare-scan sub-batch,
    K3 over the first descriptor groups of two fields, K4 over the b98
    field's first run."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan

    dev = torch.device(DEVICE)
    plan = get_plan(SERVER_BASE)
    batch, seg = engine.DEFAULT_BATCH_SIZE, engine.MEGALOOP_SEGMENT_DEFAULT
    sub = min(engine.RARE_SCAN_BATCH, batch)
    cap = min(engine.SURVIVOR_CAP, sub)
    rng = np.random.default_rng(SEED)
    starts = _main_shape_starts(report)
    diff = {"detailed_megaloop": 0, "uniques": 0, "strided_niceonly": 0}
    cases = []
    for name in ("range_start", "near_miss_segment"):
        st = ve.start_limbs_tensor(starts[name], plan, dev)
        acc0 = torch.from_numpy(
            rng.integers(0, 1000, plan.base + 2, dtype=np.int32)).to(dev)
        h_k, nm_k = ce.detailed_accum_megaloop(plan, batch, seg, acc0.clone(),
                                               st, batch * seg)
        h_p, nm_p = ve.detailed_accum_megaloop(plan, batch, seg, acc0.clone(),
                                               st, batch * seg)
        d = max(int((h_k - h_p).abs().max()), abs(int(nm_k) - int(nm_p)))
        diff["detailed_megaloop"] = max(diff["detailed_megaloop"], d)
        cases.append({"kernel": "detailed_megaloop", "start": starts[name],
                      "lanes": batch * seg, "near_misses": int(nm_k)})
    for name in ("range_start", "near_miss_sub_batch"):
        st = ve.start_limbs_tensor(starts[name], plan, dev)
        u_k = ce.uniques_batch(plan, sub, st)
        d = int((u_k - ve.uniques_batch(plan, sub, st)).abs().max())
        s_k = ce.survivors_batch(plan, sub, plan.near_miss_cutoff, cap, st, sub)
        s_p = ve.survivors_batch(plan, sub, plan.near_miss_cutoff, cap, st, sub)
        for a, b in zip(s_k, s_p):
            d = max(d, int((a.long() - b.long()).abs().max()))
        diff["uniques"] = max(diff["uniques"], d)
        cases.append({"kernel": "uniques", "start": starts[name], "lanes": sub,
                      "survivors": int(s_k[0])})
    for name in ("mid-range", "b80-surviving"):
        st, cols, desc = _main_path_group(name, report, dev)
        case = {"kernel": "strided_niceonly", "field": name,
                "base": st.plan.base, "rows": len(cols[0]),
                "k": st.k, "periods": st.periods,
                "lanes": len(cols[0]) * st.periods * st.table.num_residues}
        for key, min_u in (("nice", st.plan.base),
                           ("median", check_min_uniques(st.plan.base))):
            got, d = _k3_pair(st, desc, len(cols[0]), dev, min_u)
            diff["strided_niceonly"] = max(diff["strided_niceonly"], d)
            case[key] = {"min_uniques": min_u, "counted": int(got.sum()),
                         "zero_rows": int((got[:len(cols[0])] == 0).sum())}
        cases.append(case)
    # K4 over the b98 field's first run, as the main path launched it, in
    # both modes (the main path runs the fused one).
    dplan = get_plan(DENSE_BASE)
    start, valid = _dense_stats("b98-surviving", report)["first_run"]
    dense_cases = []
    diff["niceonly_dense"] = 0
    for fused in (True, False):
        case = {"kernel": "niceonly_dense", "field": "b98-surviving",
                "start": start, "valid": valid, "fused": fused}
        for key, min_u in (("nice", DENSE_BASE),
                           ("median", check_min_uniques(DENSE_BASE))):
            got, d = _k4_pair(dplan, fused, start, batch, seg, valid, min_u,
                              dev)
            diff["niceonly_dense"] = max(diff["niceonly_dense"], d)
            case[key] = {"min_uniques": min_u, "count": got[0],
                         "pruned": got[1]}
        dense_cases.append(case)
    # K5 at the same shapes: the b40 segments against its plain version and
    # K1, the b98 first run against its plain version and K4.
    k5_cases = []
    vs_k1_k4 = {"detailed_megaloop_mma": 0, "niceonly_dense_mma": 0}
    diff.update(vs_k1_k4)
    for name in ("range_start", "near_miss_segment"):
        st = ve.start_limbs_tensor(starts[name], plan, dev)
        acc0 = torch.from_numpy(
            rng.integers(0, 1000, plan.base + 2, dtype=np.int32)).to(dev)
        nm, d, dk = _k5_detailed(plan, batch, seg, acc0, st, batch * seg)
        diff["detailed_megaloop_mma"] = max(diff["detailed_megaloop_mma"], d)
        vs_k1_k4["detailed_megaloop_mma"] = max(vs_k1_k4["detailed_megaloop_mma"], dk)
        k5_cases.append({"kernel": "detailed_megaloop_mma", "start": starts[name],
                         "lanes": batch * seg, "near_misses": nm})
    for fused in (True, False):
        case = {"kernel": "niceonly_dense_mma", "field": "b98-surviving",
                "start": start, "valid": valid, "fused": fused}
        for key, min_u in (("nice", DENSE_BASE),
                           ("median", check_min_uniques(DENSE_BASE))):
            got, d, dk = _k5_dense(dplan, fused, start, batch, seg, valid,
                                   min_u, dev)
            diff["niceonly_dense_mma"] = max(diff["niceonly_dense_mma"], d)
            vs_k1_k4["niceonly_dense_mma"] = max(vs_k1_k4["niceonly_dense_mma"], dk)
            case[key] = {"min_uniques": min_u, "count": got[0], "pruned": got[1]}
        k5_cases.append(case)
    torch.cuda.synchronize()
    report["main_shapes"] = {"base": plan.base, "max_abs_diff": diff,
                             "max_abs_diff_vs_k1_k4": vs_k1_k4,
                             "cases": cases + dense_cases + k5_cases}
    emit({"phase": "main_shapes", **report["main_shapes"]})
    check(all(v == 0 for v in vs_k1_k4.values()), f"K5 != K1/K4: {vs_k1_k4}")
    check(k5_cases[1]["near_misses"] > 0, f"K5's near-miss segment: {k5_cases}")
    check(all(c["median"]["count"] > 0 for c in k5_cases[2:]),
          f"K5's first run counted nothing at the median: {k5_cases}")
    check(all(v == 0 for v in diff.values()), f"kernel != plain: {diff}")
    check(cases[1]["near_misses"] > 0 and cases[3]["survivors"] > 0,
          f"the near-miss segment found none: {cases}")
    check(all(c["median"]["counted"] > 0 for c in cases[4:]),
          f"the median threshold counted nothing in a main-path group: {cases}")
    check(all(c["median"]["count"] > 0 for c in dense_cases),
          f"the median threshold counted nothing in the first run: {dense_cases}")


def phase_timing(report: dict, counts: dict, probe_lib: str, sms: int,
                 clk_mhz: float) -> list:
    import torch

    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine, mxu
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan

    dev = torch.device(DEVICE)
    plan = get_plan(SERVER_BASE)
    batch, seg = engine.DEFAULT_BATCH_SIZE, engine.MEGALOOP_SEGMENT_DEFAULT
    lanes_k1 = batch * seg
    lanes_k2 = min(engine.RARE_SCAN_BATCH, batch)
    st = ve.start_limbs_tensor(_main_shape_starts(report)["range_start"],
                               plan, dev)
    acc = torch.zeros(plan.base + 2, dtype=torch.int32, device=dev)
    # K3: the mid-range b40 field's first group (1024 descriptors); the b80
    # field's first group (generic tier) is timed beside it.
    s3, cols, desc = _main_path_group("mid-range", report, dev)
    n_real = len(cols[0])
    res = engine._device_residues(s3.plan.base, s3.k, str(dev))
    m3 = s3.table.modulus
    s8, cols8, desc8 = _main_path_group("b80-surviving", report, dev)
    res8 = engine._device_residues(s8.plan.base, s8.k, str(dev))

    def k1():
        ce.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1)

    def p1():
        ve.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1)

    def k2():
        ce.uniques_batch(plan, lanes_k2, st)

    def p2():
        ve.uniques_batch(plan, lanes_k2, st)

    def k3():
        ce.strided_niceonly_batch(s3.plan, m3, res, s3.periods, desc, n_real)

    def p3():
        ve.niceonly_strided_counts(s3.plan, m3, res, s3.periods, desc, n_real)

    def k3_b80():
        ce.strided_niceonly_batch(s8.plan, s8.table.modulus, res8, s8.periods,
                                  desc8, len(cols8[0]))

    # K4: the b98 field's median run (its typical one), in the fused mode
    # the main path runs, and a full run of batch * seg lanes from its start.
    dplan = get_plan(DENSE_BASE)
    d_start, d_valid = _dense_stats("b98-surviving", report)["median_run"]
    classes = ce.niceonly_classes(dplan, True, str(dev))
    st4 = ve.start_limbs_tensor(d_start, dplan, dev)

    def k4(valid=d_valid):
        return ce.niceonly_dense_megaloop(dplan, batch, seg, classes, st4, valid)

    def p4():
        ve.niceonly_dense_megaloop(dplan, batch, seg, classes, st4, d_valid)

    # K5 at K1's and K4's shapes, and K1 and K5 over one segment at b510.
    def k5():
        ce.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1, 1)

    def p5():
        ve.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1, 1)

    def k5d(valid=d_valid):
        return ce.niceonly_dense_megaloop(dplan, batch, seg, classes, st4,
                                          valid, use_mxu=1)

    def p5d():
        ve.niceonly_dense_megaloop(dplan, batch, seg, classes, st4, d_valid,
                                   use_mxu=1)

    wide = get_plan(510)
    st_wide = ve.start_limbs_tensor(wide.range_start, wide, dev)
    acc_wide = torch.zeros(wide.base + 2, dtype=torch.int32, device=dev)

    def k1_b510(mma=0):
        ce.detailed_accum_megaloop(wide, batch, seg, acc_wide, st_wide,
                                   lanes_k1, mma)

    # Plain, kernel, kernel, plain: both versions see the same card state.
    p1_a = time_cuda(p1, reps=2, warmup=1)
    k1_a = time_cuda(k1, reps=20)
    k1_b = time_cuda(k1, reps=20)
    p1_b = time_cuda(p1, reps=2, warmup=0)
    p5_a = time_cuda(p5, reps=2, warmup=1)
    k5_a = time_cuda(k5, reps=20)
    k1_c = time_cuda(k1, reps=20)
    k5_b = time_cuda(k5, reps=20)
    p5_b = time_cuda(p5, reps=2, warmup=0)
    k1_b510_a = time_cuda(k1_b510, reps=3, warmup=1)
    k5_b510_a = time_cuda(lambda: k1_b510(1), reps=3, warmup=1)
    k5_b510_b = time_cuda(lambda: k1_b510(1), reps=3, warmup=0)
    k1_b510_b = time_cuda(k1_b510, reps=3, warmup=0)
    p2_a = time_cuda(p2, reps=3, warmup=1)
    k2_a = time_cuda(k2, reps=50)
    k2_b = time_cuda(k2, reps=50)
    p2_b = time_cuda(p2, reps=3, warmup=0)
    p3_a = time_cuda(p3, reps=2, warmup=1)
    k3_a = time_cuda(k3, reps=20)
    k3_b = time_cuda(k3, reps=20)
    p3_b = time_cuda(p3, reps=2, warmup=0)
    k3_b80_ms = time_cuda(k3_b80, reps=10)
    p4_a = time_cuda(p4, reps=2, warmup=1)
    k4_a = time_cuda(k4, reps=50)
    k4_b = time_cuda(k4, reps=50)
    p4_b = time_cuda(p4, reps=2, warmup=0)
    k4_full_ms = time_cuda(lambda: k4(lanes_k1), reps=20)
    p5d_a = time_cuda(p5d, reps=2, warmup=1)
    k5d_a = time_cuda(k5d, reps=50)
    k4_c = time_cuda(k4, reps=50)
    k5d_b = time_cuda(k5d, reps=50)
    p5d_b = time_cuda(p5d, reps=2, warmup=0)
    k5d_full_ms = time_cuda(lambda: k5d(lanes_k1), reps=20)
    # The tensor class's rate: the IMMA instructions an SM completes a
    # clock (the probe), 32 lanes each, as the other classes count lanes.
    check(counts["k5_detailed_lane"]["classes"].get("tensor", 0) > 0,
          "K5's lane issues no IMMA")
    probe = imma_rate(probe_lib, sms, clk_mhz)
    CLASS_LANES_PER_SM_CLK["tensor"] = 32 * probe["imma_per_sm_clk"]
    c5 = lane_cycles(counts["k5_detailed_lane"])
    c5d = lane_cycles(counts["k5_dense_lane"])
    # K1 reads the start limbs and the accumulator, writes the accumulator
    # and the count; K2 reads the start limbs and writes 4 bytes a lane; K3
    # reads the descriptors and the residues and writes a count a row; K4
    # reads the start limbs and the class table and writes two counts.
    c1, c2 = lane_cycles(counts["k1_lane"]), lane_cycles(counts["k2_lane"])
    c3 = lane_cycles(counts["k3_lane"])
    c4 = lane_cycles(counts["k4_lane"])
    # K4's work depends on the data: only the kept lanes reach the digit
    # work, so the bound counts those (valid - pruned) at a full lane each.
    bytes4 = 8 * dplan.limbs_n + 8 * classes.shape[0] + 8
    kept4 = d_valid - k4()[1].item()
    kept4_full = lanes_k1 - k4(lanes_k1)[1].item()
    b4 = bound_ms(kept4, c4, bytes4, sms, clk_mhz)
    b4_full = bound_ms(kept4_full, c4, bytes4, sms, clk_mhz)
    b1 = bound_ms(lanes_k1, c1, 8 * plan.limbs_n + 2 * 4 * (plan.base + 2) + 4,
                  sms, clk_mhz)
    b2 = bound_ms(lanes_k2, c2, 8 * plan.limbs_n + 4 * lanes_k2, sms, clk_mhz)
    # K3's work depends on the data: only candidates inside [lo, hi) reach
    # the digit work, so the bound counts those (the stride table's count
    # over each row's clipped span) at the full lane's instructions.
    span = s3.periods * m3
    in_range = 0
    for g in range(n_real):
        n0, lo, hi = (engine.desc_value(cols, j, g) for j in range(3))
        a, b = max(lo, n0), min(hi, n0 + span)
        if a < b:
            in_range += s3.table.count_candidates(FieldSize(a, b))
    b3 = bound_ms(in_range, c3, 8 * 12 * n_real + 8 * s3.table.num_residues
                  + 4 * desc.shape[0], sms, clk_mhz)
    # K5 moves K1's and K4's bytes; its work is K1's lanes (K4's kept ones).
    b5 = bound_ms(lanes_k1, c5, 8 * plan.limbs_n + 2 * 4 * (plan.base + 2) + 4,
                  sms, clk_mhz)
    b5d = bound_ms(kept4, c5d, bytes4, sms, clk_mhz)
    b5d_full = bound_ms(kept4_full, c5d, bytes4, sms, clk_mhz)
    report["timing"] = {
        "base": plan.base, "sms": sms, "clk_max_mhz": clk_mhz,
        "k1": {"lanes": lanes_k1, "ms": [k1_a, k1_b], "plain_ms": [p1_a, p1_b],
               "sass": counts["k1_lane"], "lane_cycles": c1,
               "bound_ms": b1[0], "bound_by": b1[1]},
        "k2": {"lanes": lanes_k2, "ms": [k2_a, k2_b], "plain_ms": [p2_a, p2_b],
               "sass": counts["k2_lane"], "lane_cycles": c2,
               "bound_ms": b2[0], "bound_by": b2[1]},
        "k3": {"rows": n_real, "k": s3.k, "periods": s3.periods,
               "lanes": n_real * s3.periods * s3.table.num_residues,
               "lanes_in_range": in_range, "ms": [k3_a, k3_b],
               "plain_ms": [p3_a, p3_b], "sass": counts["k3_lane"],
               "lane_cycles": c3, "bound_ms": b3[0], "bound_by": b3[1]},
        "k3_b80": {"rows": len(cols8[0]), "k": s8.k, "periods": s8.periods,
                   "lanes": len(cols8[0]) * s8.periods * s8.table.num_residues,
                   "ms": k3_b80_ms},
        "k4": {"base": DENSE_BASE, "start": d_start, "valid": d_valid,
               "kept": kept4, "classes": int(classes.shape[0]),
               "ms": [k4_a, k4_b], "plain_ms": [p4_a, p4_b],
               "sass": counts["k4_lane"], "lane_cycles": c4,
               "bound_ms": b4[0], "bound_by": b4[1]},
        "k4_full_run": {"valid": lanes_k1, "kept": kept4_full,
                        "ms": k4_full_ms, "bound_ms": b4_full[0],
                        "bound_by": b4_full[1]},
        "imma_probe": {**probe,
                       "tensor_lanes_per_sm_clk": CLASS_LANES_PER_SM_CLK["tensor"]},
        "k5_detailed": {"lanes": lanes_k1, "ms": [k5_a, k5_b],
                        "plain_ms": [p5_a, p5_b], "k1_ms_between": k1_c,
                        "sass": counts["k5_detailed_lane"], "lane_cycles": c5,
                        "bound_ms": b5[0], "bound_by": b5[1]},
        "k5_dense": {"base": DENSE_BASE, "valid": d_valid, "kept": kept4,
                     "ms": [k5d_a, k5d_b], "plain_ms": [p5d_a, p5d_b],
                     "k4_ms_between": k4_c, "sass": counts["k5_dense_lane"],
                     "lane_cycles": c5d, "bound_ms": b5d[0],
                     "bound_by": b5d[1]},
        "k5_dense_full_run": {"valid": lanes_k1, "kept": kept4_full,
                              "ms": k5d_full_ms, "bound_ms": b5d_full[0],
                              "bound_by": b5d_full[1]},
        "b510_segment": {"lanes": lanes_k1, "start": wide.range_start,
                         "k1_ms": [k1_b510_a, k1_b510_b],
                         "k5_ms": [k5_b510_a, k5_b510_b]},
    }
    emit({"phase": "timing", **report["timing"]})
    return [
        ("detailed_megaloop", "nice_tpu/ops/pallas_engine.py:181",
         min(k1_a, k1_b), min(p1_a, p1_b), b1),
        ("uniques", "nice_tpu/ops/pallas_engine.py:466",
         min(k2_a, k2_b), min(p2_a, p2_b), b2),
        ("strided_niceonly", "nice_tpu/ops/pallas_engine.py:410",
         min(k3_a, k3_b), min(p3_a, p3_b), b3),
        ("niceonly_dense", "nice_tpu/ops/pallas_engine.py:181",
         min(k4_a, k4_b), min(p4_a, p4_b), b4),
        ("detailed_megaloop_mma", "nice_tpu/ops/pallas_engine.py:181",
         min(k5_a, k5_b), min(p5_a, p5_b), b5),
        ("niceonly_dense_mma", "nice_tpu/ops/pallas_engine.py:181",
         min(k5d_a, k5d_b), min(p5d_a, p5d_b), b5d),
    ]


def _profiled(run_field) -> dict:
    """run_field() under torch.profiler: wall time, device time and the
    device's idle share of the wall, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_field()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name[:60]
            ms = evt.time_range.elapsed_us() / 1e3
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
    busy_ms = sum(by_kernel.values())
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_kernel": dict(top)}


def phase_profile(report: dict) -> None:
    """The mid-range field once more in each mode, and the surviving b98
    field in niceonly mode (the dense loop), under torch.profiler: the
    device's busy and idle share of each field's wall time."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import DataToClient

    data = _mid_range_field(SERVER_BASE)
    b98 = next(r for r in report["full_width_dense"]["fields"]
               if r["field"] == "b98-surviving")
    dense = DataToClient(claim_id=0, base=DENSE_BASE,
                         range_start=b98["range_start"],
                         range_end=b98["range_start"] + b98["numbers"],
                         range_size=b98["numbers"])
    for key, mode, name, field in (
            ("profile", "detailed", "mid-range", data),
            ("profile_niceonly", "niceonly", "mid-range", data),
            ("profile_dense", "niceonly", "b98-surviving", dense)):
        args = client.build_parser().parse_args([mode, "--device", DEVICE])
        report[key] = {"field": name, "mode": mode,
                       **_profiled(lambda: client.process_field(field, args))}
        emit({"phase": "profile", **report[key]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import nice_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="nice-chip-smoke-")
    try:
        return _run(args, t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, t_start: float, tmp: str) -> int:
    import torch

    card = nvidia_smi("name,power.limit")
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "sms": sms,
                    "clk_max_mhz": clk_mhz}
    emit(f"card: {card} | torch {torch.__version__} | cuda {torch.version.cuda}")

    counts, probe_lib = phase_build(report, tmp)
    phase_kernel_vs_plain(report)
    phase_strided_vs_plain(report)
    phase_dense_vs_plain(report)
    phase_mxu_vs_plain(report)
    phase_golden(report)
    phase_full_width(report)
    phase_full_width_niceonly(report)
    phase_full_width_dense(report)
    phase_tuned(report, tmp)
    phase_server(report)
    phase_main_shapes(report)
    timed = phase_timing(report, counts, probe_lib, sms, clk_mhz)
    phase_profile(report)
    kernel_ms = {name: ms for name, _, ms, _, _ in timed}
    for run in report["full_width"]["fields"]:
        est = sum(n * kernel_ms[k] for k, n in run["launches"].items())
        run["kernel_ms_est"] = est
        run["kernel_share_est"] = est / (run["elapsed_secs"] * 1e3)
        emit({"phase": "where_time_goes", "field": run["field"],
              "elapsed_ms": run["elapsed_secs"] * 1e3, "kernel_ms_est": est,
              "kernel_share_est": run["kernel_share_est"]})
    k3_group_ms = {SERVER_BASE: kernel_ms["strided_niceonly"],
                   80: report["timing"]["k3_b80"]["ms"]}
    for run in report["full_width_niceonly"]["fields"]:
        # The pipeline's stages overlap: wall ~ the slowest of the MSD pool
        # (msd_busy over its threads), the dispatcher (gen + disp + put) and
        # the collector. K3's share is at most launches x a full group's time.
        st = run["stats"]
        emit({"phase": "where_time_goes", "field": run["field"],
              "mode": "niceonly", "base": run["base"],
              "elapsed_ms": run["elapsed_secs"] * 1e3,
              "pipeline_wall_ms": st["wall"] * 1e3,
              "msd_busy_ms": st["msd_busy"] * 1e3,
              "filter_threads": st["filter_threads"],
              "collect_busy_ms": st["collect_busy"] * 1e3,
              "dispatch_gen_ms": st["gen"] * 1e3,
              "dispatch_disp_ms": st["disp"] * 1e3,
              "dispatch_put_ms": st["put"] * 1e3,
              "descriptors": st["descriptors"], "k3_launches": run["k3_launches"],
              "k3_ms_at_most": run["k3_launches"] * k3_group_ms[run["base"]]})
    for run in report["full_width_dense"]["fields"]:
        # One run in flight: wall = MSD filter + the loop (upload, K4,
        # readback per run); K4's share is about launches x a typical run.
        st = run["stats"]
        k4_est = run["launches"]["niceonly_dense"] * kernel_ms["niceonly_dense"]
        emit({"phase": "where_time_goes", "field": run["field"],
              "mode": "niceonly", "base": run["base"],
              "elapsed_ms": run["elapsed_secs"] * 1e3,
              "msd_ms": st["msd_secs"] * 1e3, "loop_ms": st["loop_secs"] * 1e3,
              "runs": st["runs"], "k4_launches": run["launches"]["niceonly_dense"],
              "k4_ms_est": k4_est,
              "host_loop_ms_est": st["loop_secs"] * 1e3 - k4_est})

    for run in report["tuned"]["k5_runs"]:
        # K5 in K1's and K4's place on the same fields, the same process.
        default = next(
            r for key in ("full_width", "full_width_dense")
            for r in report[key]["fields"] if r["field"] == run["field"])
        est = sum(n * kernel_ms[k] for k, n in run["launches"].items())
        emit({"phase": "where_time_goes", "field": run["field"],
              "mode": run["mode"], "use_mxu": 1,
              "elapsed_ms": run["elapsed_secs"] * 1e3,
              "use_mxu_0_elapsed_ms": default["elapsed_secs"] * 1e3,
              "kernel_ms_est": est})

    kernel_bases = {"detailed_megaloop": BASES, "uniques": BASES,
                    "strided_niceonly": NICEONLY_BASES,
                    "niceonly_dense": DENSE_BASES,
                    "detailed_megaloop_mma": BASES,
                    "niceonly_dense_mma": DENSE_BASES}
    k5_diff = {k: max(report["mxu_vs_plain"]["max_abs_diff"][k],
                      report["mxu_vs_plain"]["max_abs_diff_vs_k1_k4"][k],
                      report["main_shapes"]["max_abs_diff_vs_k1_k4"][k])
               for k in ("detailed_megaloop_mma", "niceonly_dense_mma")}
    vs_plain = dict(report["kernel_vs_plain"]["max_abs_diff"],
                    strided_niceonly=report["strided_vs_plain"]["max_abs_diff"],
                    niceonly_dense=report["dense_vs_plain"]["max_abs_diff"],
                    **k5_diff)
    kernels = []
    for name, replaces, ms, plain_ms, (b_ms, b_by) in timed:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nice_tpu_torch/csrc/nice_kernels.cu",
            "replaces": replaces,
            "launches": report["main_path_launches"][name],
            "max_abs_err": max(vs_plain[name],
                               report["main_shapes"]["max_abs_diff"][name]),
            "bases": list(kernel_bases[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    report["kernels"] = kernels
    report["total_secs"] = time.monotonic() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    emit({"kernels": kernels})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
