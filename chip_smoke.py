"""On-card smoke run of the PyTorch/CUDA port (nice_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Phases, each of which raises (exit code 1) on failure:
  1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build, all started together: nvcc builds the main library of kernels
     from csrc/ and the per-base library (csrc/plan_kernels.cu: K2, K3 and
     K5's detailed mode on the plan tier) of each base of PLAN_BASES but
     PREFETCH_BASE (b97: phase 2b builds it), g++ the host library of
     the niceonly path (native/), nvcc -cubin the op-count source whose
     SASS bounds the kernels (see 10) at b40 and at b80, and nvcc the
     probe of the tensor cores' integer rate (csrc/imma_probe.cu); ptxas's
     registers, stack and spills of every kernel instantiation of the main
     library, by kernel and tier (K4's and K5's dense register tier must
     have neither stack, spills, LDL nor STL), the static SASS count of
     each (cuobjdump),
     and each per-base build's nvcc seconds, registers, stack, spills and
     the local loads and stores (LDL, STL) in its SASS (there must be
     none);
  2b. fleet, the prefetch run: the extra-large field through the client's
     process_field three times, the second while the client's prefetch
     hook warms a claimed b97 field on its nice-prefetch thread (b97's
     per-base nvcc build, in a subprocess): its seconds beside the runs
     without, the warm's seconds and build facts; equal results;
  3. kernel vs plain: K1 (detailed megaloop) and K2 (per-lane uniques, plus
     survivor compaction) against their plain PyTorch versions on the card,
     exact integer equality, at b10, b17, b40, b50, b80, b97 and b510, from
     range_start and from a start straddling a 2^32 limb carry; K1 and K2
     run on the plan tier at every base to b97 and in the generic tier at
     b510;
  4. strided vs plain: K3 (stride-descriptor niceonly counts, on the plan
     tier) against its plain version, exact, at b10, b17, b40, b50, b80 and
     b97 with each base's main-path stride shape: ragged runs, padded rows
     past n_real, candidates across multiples of 2^32, 2^64 and 2^96 above
     the range's middle, and at b10 the descriptor holding 69, repeated,
     plus spans past the range's end. Each table runs at the nice test
     (min_uniques = base) and at a threshold about the median of
     num_uniques (check_min_uniques), where every row counts many lanes: no
     number but 69 is nice, so only the second makes a lost carry or a
     wrong range mask show;
  4b. dense vs plain: K4 (dense niceonly counts) against its plain version,
     exact, in both TPU modes (fused: the base's residue classes; unfused:
     all b-1) and at both thresholds, at b10 (from 47), b40, b98, b100, b510
     and b99 (no class: no launch, every lane pruned), from range_start and
     across the largest limb carry inside the range, ragged; b98 and b100
     must run in K4's dense register tier;
  4c. K5 vs plain and vs K1/K4: the tensor-core arm (use_mxu=1) of the
     detailed megaloop against its plain version and against K1 on the
     card, as phase 3 runs K1 (the plan tier to b97, the generic tier at
     b510) and at b1024, the top of K5's admitted range, and of the dense
     count against its plain version and K4, as
     phase 4b runs K4, and at b104 (the small, dense and generic tiers);
     exact, every valid_total ragged, launch counts and tiers checked;
  4d. kernelspec: the kernel-spec registry's claims
     (nice_tpu_torch/analysis/kernelspec.py, through
     nice_tpu_torch/scripts/spec_witness.py): every spec's witnesses (lanes
     whose low limbs are all ones, windows straddling m * 2^(32j), the
     range's ends; K3's descriptors across the same edges) through the
     kernel and its plain version at b40, b80, b98, b100 and b510, every
     difference 0; one K1 launch at b40 of 2^18 x clamp_segment's largest
     segment (about 2^30 lanes), whose bins must sum to its lanes and equal
     the same lanes in default segments; the error paths (K5 past 2^31
     lanes, the main library's K5 on a plan-tier plan, a per-base library
     asked for another plan, K5's shared memory, a base past 2048 bins)
     must raise; launch_shape's tier of each kernel at the probe bases must
     be the spec's. One {"kernelspec": {...}} line;
  5. golden and oracle fields: base-ten must give [(69, 10)] and the scalar
     oracle's histogram; default (1e6 @ b40) on the card must equal the same
     field through the plain path on the CPU; in niceonly mode base-ten must
     give [69] through K3 (its hit re-scanned on the host), and default on
     the card must equal the plain path on the CPU (both with
     host_niceonly_max=0, which holds them on K3 whatever the default
     limit of the host route); base-ten
     through the dense loop must give [69] through K4 and K2;
  5b. host engines: the native backend through the client (--backend
     native --threads 0) on the default and large (1e8 @ b40) fields in
     both modes, equal to the card's runs, with its thread count and
     numbers/s; the large field again beside the client's prefetch warm of
     a native niceonly b64 claim, and after it; the route sweep
     (scripts/host_route_sweep.py: b50 fields of 2^20-2^27 numbers and the
     msd-ineffective cell through the host route and through K3, the
     median of 5 after a warm pass, equal results, K3 launches 0 on the
     route and at least 1 on K3) and the HOST_NICEONLY_MAX it chooses; a
     scalar field checkpointed into a snapshot file every chunk, stopped
     after its second snapshot and resumed from it, equal to the
     uninterrupted run;
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
     2^18/2^19 x segments 8/16 x K1/K5; the b98 field niceonly, batch 2^18
     x K4/K5; a b510 segment detailed, K1/K5, which K5 must win), then a fresh process pointed at that table runs extra-large,
     the b98 field and the b510 segment through process_field (autotune
     hits, results equal to phases 6 and 7b and to K1's at b510, K5
     launched at b510); then winners with use_mxu=1 at the
     default shape, and extra-large, mid-range and the b98 field through
     process_field with the launch counts set to 0 just before and read
     just after (K5's main path): K5 in K1's and K4's place, K2 re-scanning
     mid-range's near misses, results equal to the use_mxu=0 runs. The
     extra-large sweep also sweeps the block size (128 and 256 threads),
     and a third table pins block_threads=128 at the default shape:
     extra-large, mid-range and the b98 field in a fresh process, results
     equal to phases 6 and 7b, 128 threads in the feed stats, launch_shape
     reporting 128 for K1, K4 and K5;
  7e. blocks: the tuning harness's blocks and stride-blocks kinds
     (nice_tpu_torch/scripts/tune_kernels.py): K1 at b40 and b80 (the
     plan tier), K5 at b40, K3 on a b40 group of 1024 descriptors
     and K4 over the b98 field's median run, at block sizes 32, 64, 128
     and 256 (K5 from 64), each output equal to its 256-thread output and
     to the plain version's; one {"blocks": ...} line of device ms by
     kernel and size;
  7d. pipeline: extra-large (b40 detailed) and b98-surviving (dense
     niceonly) at the default shape through the engine with feed_depth=0
     (the synchronous A/B) and the default feed depth, timed in turns (0,
     default, default, 0): field seconds and the feed stats (dispatches,
     the host's gaps between them); every run must give the same results
     and launches (their profiled runs come after phase 11);
  8. claim -> process -> submit: the repository's coordination server in a
     separate process (python -m nice_tpu.server, seeded with b40 fields of
     1e9), one detailed and one niceonly single-shot client run on the card
     against it; both submits must be accepted and the server's spot check
     must pass. The detailed run has the observability layer's telemetry
     beat (--telemetry-secs 1), --stepprof and a local --metrics-port: the
     server's /status fleet must list the client with the field's numbers,
     /critpath must see its phase breakdown, the field's timeline must hold
     its phases event, every submit must carry the claim's traceparent, and
     the client's /metrics must count K1's launches as detailed dispatches;
  8a. fleet, on the same server: the client's main with --claim-block 3 and
     --api-base naming a dead port before the live server (the launch
     counts set to 0 just before and read just after): it must rotate past
     the dead endpoint, claim 3 b40 fields of 1e9 under one block lease,
     have each accepted and passing the phase 6 checks, and stamp every
     request with the server's epoch; the JAX jobs runner then makes the
     submissions canonical, --validate --base 40 must return 0, and against
     a second server over a copy of the ledger with its canonical
     distributions tampered with it must return 1;
  8d. tenants, on the same server: `python -m nice_tpu_torch.client
     --tenants "canon:detailed:40:prio=3;nice:niceonly:40:prio=1;
     mining:near-miss:40"` in a subprocess on the card: exit code 0, one
     claim row stamped with each tenant's name (claims.tenant), and each
     claim's submission in the server's ledger, passing the phase 6 / 7
     checks;
  8b. crash and resume: against a second such server, `python -m
     nice_tpu_torch.client detailed --checkpoint-dir D` (CRASH_BATCH lanes a
     batch, so that the 1e9 field takes seconds) is SIGKILLed once its first
     snapshot lands; the same command again must resume that claim from the
     snapshot's cursor, be accepted, pass the spot check and retire the
     snapshot, and its histogram and near misses must equal an
     uninterrupted run of the field here; it prints the kill and resume
     cursors and both runs' seconds;
  8c. bench: `python -m nice_tpu_torch.scripts.bench --only extra-large
     --reps 3` in a subprocess: the headline first and last with the suite,
     median, min and max pass seconds and the card's nvidia-smi name on
     every line, the detailed bins summing to 1e9;
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
     and K4's shapes beside K1/K4, and its blocks' setup alone; K1 and K5
     over one segment at b510), by CUDA events over back-to-back calls and
     by each kernel's own device time (torch.profiler), which the kernels
     line gives; each launch's shape (grid, threads, resident blocks an SM:
     K1's segment must be one full wave, b98's K4 and K5 must run in the
     dense tier and K5's median run cover as many SMs as K4's, K1, K2, K3
     and K5's b40 segment to b97 on the plan tier); K3 over the b80 field's
     first group and K2 over a 2^18
     sub-batch at b80 (plan tier) and b510 (generic tier), by device time;
     K1's runtime-plan SASS (the generic tier's) beside the constant-plan
     count; and
     a bound from the instructions one lane issues in the compiled code
     (csrc/op_count.cu built with the b40 plan and stride table, and again
     with b80's, and the b98 plan and class table, as constants, counted
     with cuobjdump; K5's IMMAs at the rate the probe measures, and K5's
     bound the lesser of its lane's and K5_EARLIER_LANES'), at b510
     from the multiplies the plan's shapes need (scripts/generic_bound.py,
     held against the op-count lanes at b40 and b80); then
     the kernels' estimated share of each main-path field's time (launches
     x kernel time / field time), each niceonly field's split into MSD
     filter, collector and dispatch time, and each b98 field's into MSD
     filter and loop;
 11. profile: the mid-range field once more in each mode, and the b98
     field in niceonly mode, under torch.profiler, for the device's busy
     and idle share of each wall time (the pipelined loop's); then the
     pipeline phase's fields at feed depth 0 and the default, for the
     idle share and K1's/K4's device ms at each;
 11b. sched: the multi-tenant scheduler at full width (the main path of
     sched/, launch counts set to 0 just before each run and read just
     after): canon (detailed extra-large, prio 3), mining (near-miss, the
     mid-range b40 field, prio 0), nice (niceonly extra-large, prio 1) and
     dense (niceonly b98-surviving, prio 1), 1e9 numbers each, built and
     run solo first; then under deficit at the default page size (4
     segments) and quantum (5 s), and under rr with a preemption at every
     page boundary together with a hi-base sweep tenant (b520, the first
     2^24 numbers of its range, 2 pages). Every assembled field must equal
     its solo run exactly, and the tenants must have launched K1 (canon,
     mining, sweep), K2 (mining), K3 (nice) and K4 (dense); printed: pages,
     preemptions, starved counts, occupancy shares, launches and seconds a
     page by tenant, busy seconds against solo seconds, and vs_sequential
     (the solo seconds' sum over the interleaved seconds); the closing
     where_time_goes lines split each tenant's busy time into its kernels'
     estimate and a fixed cost a page;
 12. obs: the extra-large field through process_field three times in each
     of three settings of the observability layer, in this order: off (no
     sampler, no heartbeat), the client's defaults (the pyprof, memwatch
     and history samplers running), and the defaults with --stepprof; the
     medians, the stepprof buckets and fences (none off the profiler, one
     a K1 launch on it; K1's launches equal in every setting); a memwatch
     sample of the card; a --profile-dir run whose Chrome trace holds one
     K1 device record per K1 launch. The samplers stay off until here;
 13. mesh: fields on a mesh of slices through
     nice_tpu_torch/scripts/multichip_scaling.py (phase_mesh): extra-large
     detailed on 1, 2 and 4 logical slices of the card (cuda:0 repeated,
     one stream a slice) with a downshift drill on 4, mid-range on 4 (K2
     on the slices), extra-large niceonly and b98-surviving on 1 and 2 (a
     drill at b98), each equal to the one-device field; a checkpointed
     field on 4 slices failing with elastic off, resumed on 2 slices and on
     1; a --devices cuda:0,cuda:0 client against a fresh server; and the
     same on distinct cards where the machine has more than one;
 14. threads (phase_threads): the off path in this process (no factory hook,
     the port's locks plain threading.Locks); a lockdep run of the main
     paths in a fresh process (python -m nice_tpu_torch.utils.lockdep
     --device cuda: extra-large detailed beside a prefetch build of b95
     (lockdep.PREFETCH_BASE), mid-range, extra-large niceonly,
     b98-surviving, the mesh drill on 4 slices and a two-tenant scheduler
     run, with the obs samplers and a checkpoint ticker on), each field
     equal to its lockdep-off result, no order cycle and no disagreement
     with X1's static graph, its
     nodes, edges and long holds printed; and racelint, nicelint, cudalint
     --strict and racecheck on this machine, each exiting 0. One
     {"threads": {...}} line;
 15. chaos (phase_chaos): the port's chaos drill on the card (python -m
     nice_tpu_torch.scripts.chaos_smoke --device cuda): a seeded b22
     server, three block-lease client runs under dropped submit replies,
     a server SIGKILL and restart mid run 2, a dispatch fault in run 3's
     second member and reruns that resume its snapshots; every field
     accepted exactly once and equal to the scalar oracle, the clients'
     K1 segments on the card counted from their logs. One {"chaos": ...}
     line;
 16. gate (phase_gate): the regression gate's client legs
     (nice_tpu_torch/scripts/perf_gate.py) against the committed
     TORCH_BENCH_r01.json: the bench diff printed (throughput is not
     held here: the host's speed varies between calls), the stepprof and
     feed-idle legs' checks held; then the record copied with every
     compared case's value doubled, and the bench leg against the copy
     with --strict must flag every compared case and exit 1. One
     {"gate": ...} line.
Then one {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Without CUDA (or outside the repository) it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import glob
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
# K3's checks: the niceonly bases and b97, the plan tier's 4-limb edge.
STRIDED_BASES = NICEONLY_BASES + (97,)
# The bases with a per-base library (K2, K3 on the plan tier): every base
# of BASES to b97. The build phase builds each but PREFETCH_BASE, which the
# prefetch run's warm builds on the client's prefetch thread, before the
# base's first use (phase 3's K2).
PLAN_BASES = tuple(b for b in BASES if b <= 97)
PREFETCH_BASE = 97
# K4's checks: b99 keeps no residue class (no launch), the others span the
# small tier (b10, b40) and the generic one (b98 and up, 5+ limbs).
DENSE_BASES = (10, 40, 98, 100, 510, 99)
DENSE_BASE = 98  # the dense niceonly main path's base
# K5's detailed checks: phase 3's bases and b1024, the widest plan that
# mxu.supports_plan admits (generic tier), where the plain version's many
# small launches take about a second a call: one call there.
K5_TOP_BASE = 1024
K5_DETAILED_BASES = BASES + (K5_TOP_BASE,)
SLICE_WIDTH = 10_000_000  # the niceonly fields' slice held to the host scan
DENSE_SLICE_WIDTH = 200_000  # the b98 fields' slice held to the oracle
SEED = 20261016
DEVICE = "cuda"
SERVER_BASE = 40
SERVER_FIELD_SIZE = 1_000_000_000  # the server's default --field-size
FLEET_BLOCK = 3  # fields the fleet phase claims under one block lease
# The bench phase's command line and its headline field's numbers.
BENCH_ARGV = ("--only", "extra-large", "--reps", "3")
# The client flags that start no sampler thread (phase_obs's "off").
SAMPLERS_OFF = ("--pyprof-hz", "0", "--memwatch-secs", "0",
                "--history-secs", "0")
BENCH_NUMBERS = 1_000_000_000

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
# K5's lanes as op_count.cu counted them on the H100 for the wmma-staged
# design of commit ae93e0b (b40 in the small tier, b98 in the generic
# tier): K5's bound is the lesser of these and this tree's lanes.
K5_EARLIER_LANES = {
    "k5_detailed_lane": {"instructions": 668, "classes": {
        "multiply-add": 300, "logic": 45, "shift": 114, "tensor": 8,
        "add": 64, "compare": 42, "popc": 2}},
    "k5_dense_lane": {"instructions": 3869, "classes": {
        "multiply-add": 1766, "logic": 401, "add": 372, "shift": 273,
        "compare": 407, "tensor": 28, "popc": 4}},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# When the run started (main sets it): each phase line carries its seconds
# since then, so that the smoke's own time can be split by phase.
T_START = time.monotonic()


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_secs": time.monotonic() - T_START}
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
    code: K1-K3 and K5's detailed mode at `plan`'s base (their plan tier's
    lane; K3 with this stride table), K4 and K5's dense mode at
    dense_plan's (with its fused class table). nvcc builds csrc/op_count.cu
    with the plans as compile-time constants (every loop unrolls, so each
    function there is straight-line) and cuobjdump lists its SASS (see
    parse_sass)."""
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce

    nvcc = cuda_build.find_nvcc()
    dp = dense_plan
    with tempfile.TemporaryDirectory(prefix="nice-op-count-") as tmp:
        with open(os.path.join(tmp, cuda_build.PLAN_HEADER), "w") as f:
            r = table.num_residues
            f.write(ce.plan_header(
                plan, NICE_K3_R=f"{r}u",
                NICE_K3_DIV="{}u, {}, {}".format(*ce.u32_divisor(r)),
                NICE_K3_M=f"{table.modulus}u",
                NICE_K4_PLAN=", ".join(f"{w}ull" for w in ce.plan_words(dp)),
                NICE_K4_TIER=f"{dp.limbs_n}, {dp.limbs_sq}, {dp.limbs_cu}, "
                             f"{dp.n_masks}",
                NICE_K4_R=f"{ce.niceonly_classes(dp, True, 'cpu').shape[0]}u"))
        cubin = os.path.join(tmp, "op_count.cubin")
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-cubin", "-I", tmp, "-o", cubin,
             os.path.join(cuda_build.CSRC_DIR, "op_count.cu")],
            check=True, capture_output=True, text=True)
        funcs = parse_sass(cuda_build.sass_listing(cubin))
    check({"k1_lane", "k2_lane", "k3_lane", "k4_lane", "k5_detailed_lane",
           "k5_dense_lane"} <= set(funcs), f"op_count functions: {list(funcs)}")
    return funcs


# Lane<NL, SQL, CUL, NM, UNROLL> of nice_kernels.cuh by its template
# arguments, as they appear in a mangled kernel name.
TIERS = {"LaneILi2ELi4ELi6ELi2ELb1E": "small", "LaneILi5ELi9ELi13ELi4ELb1E": "dense",
         "LaneILi144ELi288ELi424ELi64ELb0E": "generic", "8PlanTier": "plan"}


def kernel_label(mangled: str) -> tuple[str, str]:
    """(kernel, tier) of a mangled kernel instantiation's name."""
    kernel = re.search(r"nice\d+(\w+?_kernel)", mangled)
    tier = next((t for k, t in TIERS.items() if k in mangled), "?")
    return (kernel.group(1) if kernel else mangled), tier


def runtime_sass(lib_path: str) -> dict:
    """Per kernel instantiation of the built library, from cuobjdump -sass:
    its static instruction count (padding NOPs left out), the static count
    of its outermost loop (the grid-stride loop: the backward branch that
    spans the most code) and its local loads and stores (LDL, STL). Its
    inner loops (the digit chunks) run their plan's trip counts at run
    time, so a lane issues more than the loop's static count; op_count.cu's
    constant-plan lane unrolls them all."""
    from nice_tpu_torch.ops import cuda_build

    out = {}
    for name, ins in cuda_build.sass_listing(lib_path).items():
        if "_kernel" not in name:
            continue
        loops = [(_branch_target(text), addr) for addr, op, text in ins
                 if op == "BRA" and _branch_target(text) < addr]
        lo, hi = max(loops, key=lambda b: b[1] - b[0]) if loops else (0, -1)
        kernel, tier = kernel_label(name)
        out[name] = {"kernel": kernel, "tier": tier, "static": len(ins),
                     "loop_static": sum(1 for a, _, _ in ins if lo <= a <= hi),
                     "loops": len(loops),
                     "LDL": sum(op == "LDL" for _, op, _ in ins),
                     "STL": sum(op == "STL" for _, op, _ in ins)}
    return out


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

    funcs = {name: sum(op == "IMMA" for _, op, _ in ins)
             for name, ins in cuda_build.sass_listing(lib_path).items()}
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


def _branch_target(text: str) -> int:
    return int(re.findall(r"0x([0-9a-f]+)", text)[-1], 16)


def parse_sass(listing: dict) -> dict:
    """Per function of a SASS listing of straight-line code
    (cuda_build.sass_listing): the instruction count (the self-loop after
    EXIT left out), the count per integer class of SASS_CLASS and per
    opcode, and the forward branches (code a lane may skip, counted all the
    same). A backward branch, a loop that did not unroll, fails."""
    funcs: dict = {}
    for name, ins in listing.items():
        f = funcs[name] = {"instructions": 0, "classes": {}, "opcodes": {},
                           "forward_branches": 0}
        for addr, op, text in ins:
            if op == "BRA":
                target = _branch_target(text)
                if target == addr:
                    continue
                check(target > addr, f"{name}: a loop at {addr:#x} did not unroll")
                f["forward_branches"] += 1
            opcode = text.split()[1] if text.startswith("@") else text.split()[0]
            f["instructions"] += 1
            f["opcodes"][opcode] = f["opcodes"].get(opcode, 0) + 1
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

def plan_build_facts(base: int, info: dict) -> dict:
    """One per-base build's facts: nvcc seconds, and per kernel ptxas's
    registers, stack and spills and the LDL/STL in its SASS."""
    from nice_tpu_torch.ops import cuda_build

    sass = cuda_build.sass_listing(info["path"])
    kernels = []
    for r in cuda_build.ptxas_resources(info["ptxas"]):
        ins = sass.get(r["mangled"], [])
        kernels.append({
            "kernel": kernel_label(r["mangled"])[0],
            "registers": r.get("registers"), "stack": r["stack"],
            "spill_stores": r["spill_stores"], "spill_loads": r["spill_loads"],
            "LDL": sum(op == "LDL" for _, op, _ in ins),
            "STL": sum(op == "STL" for _, op, _ in ins), "static": len(ins)})
    return {"base": base, "nvcc_secs": info["seconds"], "kernels": kernels}


def _check_plan_build(pb: dict) -> None:
    """A per-base build holds K1, K2, K3 and K5's detailed mode, none with a
    stack, spills or local loads and stores."""
    check(sorted(k["kernel"] for k in pb["kernels"])
          == ["detailed_megaloop_kernel", "detailed_megaloop_mma_kernel",
              "strided_niceonly_kernel", "uniques_kernel"]
          and all(k["stack"] == k["spill_stores"] == k["LDL"] == k["STL"]
                  == 0 for k in pb["kernels"]),
          f"b{pb['base']}'s per-base build: {pb}")


def _timed(fn, *args):
    t0 = time.monotonic()
    out = fn(*args)
    return out, time.monotonic() - t0


def phase_build(report: dict, tmp: str) -> dict:
    """The builds, all started together: the main library of kernels
    (nvcc), the niceonly path's host library (g++), the per-base library of
    each base of PLAN_BASES but PREFETCH_BASE (nvcc; each with its facts,
    plan_build_facts),
    the op-count source at b40 and at b80 (nvcc -cubin, counted with
    cuobjdump) and the tensor-core rate probe (nvcc, into tmp). Returns
    the op counts (with K1's runtime-plan SASS counts) and the probe's
    library for phase_timing."""
    from concurrent.futures import ThreadPoolExecutor

    from nice_tpu_torch import native
    from nice_tpu_torch.ops import cuda_build, engine
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import get_plan

    def plan_build(base: int) -> dict:
        info, secs = _timed(cuda_build.build_plan,
                            ce.plan_header(get_plan(base)))
        return dict(plan_build_facts(base, info), secs=secs)

    s = engine.strided_setup(SERVER_BASE, SERVER_FIELD_SIZE)
    s80 = engine.strided_setup(80, SERVER_FIELD_SIZE)
    dp = get_plan(DENSE_BASE)
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=5 + len(PLAN_BASES)) as pool:
        kernels = pool.submit(_timed, cuda_build.load)
        host = pool.submit(_timed, native.load)
        plans = [pool.submit(plan_build, b) for b in PLAN_BASES
                 if b != PREFETCH_BASE]
        counted = pool.submit(_timed, sass_counts, s.plan, s.table, dp)
        counted80 = pool.submit(sass_counts, s80.plan, s80.table, dp)
        probe = pool.submit(_timed, build_imma_probe, tmp)
        (_, t_kernels), (_, t_host) = kernels.result(), host.result()
        builds = [f.result() for f in plans]
        counts, t_counted = counted.result()
        counts80 = counted80.result()
        probe_lib, t_probe = probe.result()
    wall = time.monotonic() - t0
    info = cuda_build.BUILD_INFO
    resources = [dict(zip(("kernel", "tier"), kernel_label(r["mangled"])), **r)
                 for r in cuda_build.ptxas_resources(info.get("ptxas", ""))]
    sass = runtime_sass(info["path"])
    report["build"] = {"nvcc_secs": info["seconds"], "kernels_secs": t_kernels,
                       "gxx_secs": native.BUILD_INFO["seconds"],
                       "host_library_secs": t_host, "plan_builds": builds,
                       "op_count_secs": t_counted, "probe_secs": t_probe,
                       "wall_secs": wall, "ptxas": resources,
                       "runtime_sass": list(sass.values())}
    emit({"phase": "build", **report["build"]})
    # K4's and K5's dense register tier exists to keep b98's limbs out of
    # local memory, and the plan tier every base's to b97 (K1, K2, K3 and
    # K5's detailed mode).
    by_name = {v["kernel"] + "/" + v["tier"]: v for v in sass.values()}
    dense = [dict(r, LDL=by_name[r["kernel"] + "/dense"]["LDL"],
                  STL=by_name[r["kernel"] + "/dense"]["STL"])
             for r in resources if r["tier"] == "dense"]
    check(sorted(r["kernel"] for r in dense)
          == ["niceonly_dense_kernel", "niceonly_dense_mma_kernel"]
          and all(r["stack"] == r["spill_stores"] == r["LDL"] == r["STL"] == 0
                  for r in dense), f"K4's and K5's dense tier: {dense}")
    for pb in builds:
        _check_plan_build(pb)
    # K1's runtime-plan lane: the main library's generic tier, which runs K1
    # above the plan tier (b98 and up).
    counts["k1_runtime"] = next(
        v for v in sass.values()
        if v["kernel"] == "detailed_megaloop_kernel" and v["tier"] == "generic")
    return {"counts": counts, "counts80": counts80, "probe_lib": probe_lib}


def phase_prefetch(report: dict) -> None:
    """Fleet, the prefetch run: the extra-large field (b40, detailed)
    through the client's process_field on the card three times: once
    first (the process's first 1e9 field), once while the client's prefetch
    hook (--prefetch, _prefetch_on_claim), handed a claim of a
    PREFETCH_BASE field, warms that base on its nice-prefetch thread (the
    base's nvcc build, which the build phase left out, in a subprocess),
    and once after that warm has finished. The field's seconds with the
    warm running beside those without, the warm's own seconds, and the
    facts of the build it made; the results must be equal, and the build
    must have come from the warm."""
    import threading
    from concurrent.futures import Future

    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.core.types import DataToClient, SearchMode
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import get_plan

    xl = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    plan = get_plan(PREFETCH_BASE)
    header = ce.plan_header(plan)
    check(header not in cuda_build.PLAN_BUILDS,
          f"b{PREFETCH_BASE}'s library was loaded before its warm")
    args = client.build_parser().parse_args(["detailed", "--device", DEVICE])
    first, first_secs = client.process_field(xl, args)
    _check_field(xl, first)
    claim = Future()
    client._prefetch_on_claim(claim, args, SearchMode.DETAILED)
    t0 = time.monotonic()
    claim.set_result(DataToClient(
        claim_id=0, base=PREFETCH_BASE, range_start=plan.range_start,
        range_end=plan.range_start + SERVER_FIELD_SIZE,
        range_size=SERVER_FIELD_SIZE))
    during, during_secs = client.process_field(xl, args)
    warms = [t for t in threading.enumerate() if t.name == "nice-prefetch"]
    overlapped = any(t.is_alive() for t in warms)
    for t in warms:
        t.join()
    warm_secs = time.monotonic() - t0
    check(header in cuda_build.PLAN_BUILDS,
          f"the prefetch warm did not load b{PREFETCH_BASE}'s library")
    build = plan_build_facts(PREFETCH_BASE, cuda_build.PLAN_BUILDS[header])
    _check_plan_build(build)
    # A build (not a library left by an earlier run of this checkout) runs
    # for seconds: past the 1e9 field it overlaps.
    check(build["nvcc_secs"] == 0 or overlapped,
          "the warm's build did not overlap the field")
    after, after_secs = client.process_field(xl, args)
    check(_pairs(first) == _pairs(during) == _pairs(after),
          "extra-large differs between the prefetch runs")
    report["fleet_prefetch"] = {
        "field": "extra-large", "warm_base": PREFETCH_BASE,
        "first_field_secs": first_secs, "field_secs_with_warm": during_secs,
        "field_secs_after_warm": after_secs, "warm_secs": warm_secs,
        "warm_overlapped_field": overlapped, "warm_build": build}
    emit({"phase": "fleet", "run": "prefetch", **report["fleet_prefetch"]})


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
    k1_tiers, k2_tiers = {}, {}
    t0 = time.monotonic()
    for base in BASES:
        plan = get_plan(base)
        batch = 128 if base == 510 else 256
        k1_tiers[base] = ce.launch_shape("detailed_megaloop", plan,
                                         batch)["tier"]
        k2_tiers[base] = ce.launch_shape("uniques", plan, batch)["tier"]
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
        "k1_tiers": k1_tiers, "k2_tiers": k2_tiers,
        "secs": time.monotonic() - t0,
    }
    emit({"phase": "kernel_vs_plain", **report["kernel_vs_plain"]})
    check(all(v == 0 for v in diff.values()), f"kernel != plain: {diff}")
    check(all(t == ("plan" if b in PLAN_BASES else "generic")
              for tiers in (k1_tiers, k2_tiers) for b, t in tiers.items()),
          f"K1's and K2's tiers: {k1_tiers}, {k2_tiers}")


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
    multiple of 2^32, 2^64 or 2^96: the first above the range's middle (near
    a range's start the squares lead with zeros, and at b97 num_uniques
    stays below check_min_uniques for the first 2^29 numbers)."""
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
    mid = (start + end) // 2
    for width in (32, 64, 96):  # candidates across a multiple of 2^width
        boundary = ((mid >> width) + 1) << width
        if start < boundary < end - span:
            n0 = (boundary - span // 2) // m * m
            rows.append((n0, max(n0, start), n0 + span))
            n_carry += 1
    return rows, n_carry


def phase_strided_vs_plain(report: dict) -> None:
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine

    dev = torch.device(DEVICE)
    rng = random.Random(SEED)
    cases, diff, hits = [], 0, 0
    t0 = time.monotonic()
    for base in STRIDED_BASES:
        s = engine.strided_setup(base, SERVER_FIELD_SIZE)
        rows, n_carry = _strided_rows(s, rng)
        desc = _desc_tensor(rows, 2, rng, dev)
        case = {"base": base, "k": s.k, "periods": s.periods,
                "rows": len(rows), "carry_rows": n_carry,
                "tier": ce.launch_shape(
                    "strided_niceonly", s.plan,
                    s.periods * s.table.num_residues, len(rows))["tier"]}
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
    check(all(c["tier"] == "plan" for c in cases), f"K3 off the plan tier: {cases}")
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
                n_cls = ce.niceonly_classes(plan, fused, str(dev)).shape[0]
                case = {"base": base, "start": where, "fused": fused,
                        "valid": valid, "tier": ce.launch_shape(
                            "niceonly_dense", plan, n_cls, valid)["tier"]
                        if n_cls else None}
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
    check(all(c["tier"] == "dense" for c in cases if c["base"] in (98, 100)),
          f"b98/b100 outside K4's dense tier: {cases}")
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


# K5's dense-mode checks: K4's bases, and b104, the dense register tier's
# last base.
K5_DENSE_BASES = DENSE_BASES + (104,)


def _ragged(rng, total: int, batch: int) -> int:
    """A valid_total below total whose last warp is ragged (not a multiple
    of 32)."""
    valid = total - int(rng.integers(1, batch))
    return valid - 1 if valid % 32 == 0 else valid


def phase_mxu_vs_plain(report: dict) -> None:
    """K5 against its plain version and against K1/K4 on the card, exact,
    in every tier it runs in: the detailed mode at K5_DETAILED_BASES as
    phase 3 runs K1 (from range_start and across a 2^32 carry, which at b10
    and b17 wraps past the top limb: the schoolbook branch), on the plan
    tier to b97 and the generic tier at b510 and b1024 (one call there:
    three iterations across the carry); the dense mode at K5_DENSE_BASES
    as phase 4b runs K4 (both TPU modes, both thresholds, from range_start
    or 47 and across the largest carry), in the small, dense (b98, b100,
    b104) and generic (b510) tiers; every valid_total ragged."""
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
    tiers = {"detailed_megaloop_mma": {}, "niceonly_dense_mma": {}}
    t0 = time.monotonic()
    for base in K5_DETAILED_BASES:
        plan = get_plan(base)
        batch = 128 if base >= 510 else 256
        tiers["detailed_megaloop_mma"][base] = ce.launch_shape(
            "detailed_megaloop_mma", plan, 3 * batch)["tier"]
        top = base == K5_TOP_BASE
        starts = (plan.range_start, _straddle_start(plan, batch))
        for start in starts[top:]:
            st = ve.start_limbs_tensor(start, plan, dev)
            for n_iters in (1, 3)[top:]:
                valid = _ragged(rng, batch * n_iters, batch)
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
    for base in K5_DENSE_BASES:
        plan = get_plan(base)
        batch = 256 if base == 510 else 1024
        valid = _ragged(rng, 3 * batch, batch)
        tiers["niceonly_dense_mma"][base] = ce.launch_shape(
            "niceonly_dense_mma", plan, base - 1, valid)["tier"]
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
                              "tiers": tiers, "detailed": detailed,
                              "dense": dense, "secs": time.monotonic() - t0}
    emit({"phase": "mxu_vs_plain", **report["mxu_vs_plain"]})
    check(all(t == ("plan" if b in PLAN_BASES else "generic")
              for b, t in tiers["detailed_megaloop_mma"].items())
          and all(t == ("small" if b <= 55 else "dense" if b <= 104
                        else "generic")
                  for b, t in tiers["niceonly_dense_mma"].items()),
          f"K5's tiers: {tiers}")
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


def phase_kernelspec(report: dict) -> None:
    """The kernel-spec registry's claims on the card
    (nice_tpu_torch/scripts/spec_witness.py): each spec's witnesses at the
    limb boundaries through the kernel and its plain version, one K1 launch
    at clamp_segment's edge against the same lanes in default segments, the
    error paths, and launch_shape's tiers against the spec's. Its launches
    count toward no main path (the counts are set to 0 after)."""
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.scripts import spec_witness

    t0 = time.monotonic()
    try:
        ks_report = spec_witness.run(torch.device(DEVICE), PLAN_BASES)
    finally:
        ce.reset_launches()
    edge = ks_report["clamp_edge"]
    line = {
        "specs": ks_report["specs"],
        "witnesses": {name: {k: [c["max_abs_diff"], c["cases"], c["tier"]]
                             for k, c in by.items()}
                      for name, by in ks_report["witnesses"].items()},
        "witness_cases": ks_report["witness_cases"],
        "max_abs_diff": ks_report["max_abs_diff"],
        "clamp_edge_lanes": edge["lanes"], "clamp_edge_ms": edge["ms"],
        "clamp_edge_budget": edge["budget"],
        "clamp_edge_equal_to_segments": edge["equal_to_segments"],
        "errors_raised": {k: v.split(":")[0] for k, v in
                          ks_report["errors"].items()},
        "tiers": ks_report["tiers"],
        "secs": time.monotonic() - t0,
    }
    report["kernelspec"] = {**ks_report, "secs": line["secs"]}
    emit({"kernelspec": line})
    check(not ks_report["failures"], f"kernelspec: {ks_report['failures']}")


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
    # host_niceonly_max=0 holds these small fields on K3 whatever the host
    # route's default limit (phase host_engines holds the route).
    ce.reset_launches()
    r = engine.process_range_niceonly(ten.to_field_size(), ten.base,
                                      device=DEVICE, host_niceonly_max=0)
    stats = dict(engine.LAST_NICEONLY_STATS)
    nice = [n.number for n in r.nice_numbers]
    check(nice == [69], f"base-ten niceonly gives {nice}")
    check(ce.LAUNCHES["strided_niceonly"] >= 1 and stats.get("nice") == 1,
          f"base-ten niceonly did not find 69 through K3: {ce.LAUNCHES}, {stats}")
    card = engine.process_range_niceonly(default.to_field_size(),
                                         default.base, device=DEVICE,
                                         host_niceonly_max=0)
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


# The host_engines phase: the native backend's fields (benchmark modes) and
# the route sweep's repetitions (a warm pass, then this many timed).
NATIVE_FIELDS = ("default", "large")
HOST_SWEEP_SIZES = tuple(1 << k for k in range(20, 28))
HOST_SWEEP_REPS = 5
# The next claim the prefetch warm builds for beside the native field: a
# niceonly b64 field, whose host stride table (k = 3, 1.6M residues) is the
# largest a host-route base builds.
NATIVE_WARM_BASE = 64
# The scalar drill's field (b40, its range's start) and chunk.
SCALAR_DRILL = (40, 1 << 16, 1 << 13)


def phase_host_engines(report: dict) -> None:
    """The host engines on the card's machine, after the golden fields:
      * the native backend through the client (--backend native --threads
        0) on the default (1e6 @ b40) and large (1e8 @ b40) fields in both
        modes, each equal to the card's run of the field through the client
        (niceonly with --host-niceonly-max 0, so that K3 runs it); the
        thread count and the numbers/s;
      * the large field natively once more while the client's prefetch
        warms a claimed niceonly b64 field for the native backend (its host
        stride table) on the nice-prefetch thread, and once after: the
        seconds with the warm beside the seconds after it;
      * the route sweep (scripts/host_route_sweep.py): b50 fields of 2^20 to
        2^27 numbers from the msd-ineffective cell's start, and that cell,
        each through the host route and through K3 (a warm pass, then the
        median of HOST_SWEEP_REPS), equal results, no K3 launch on the
        route and at least one on K3; the limit the sweep chooses beside
        engine.HOST_NICEONLY_MAX;
      * a scalar field checkpointed into a snapshot file every chunk and
        stopped by an exception from its callback after the second
        snapshot, resumed from that file: equal to the uninterrupted run."""
    import threading
    from concurrent.futures import Future

    from nice_tpu_torch import ckpt
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.core.types import DataToClient, SearchMode
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan
    from nice_tpu_torch.scripts import host_route_sweep

    out: dict = {"cores": os.cpu_count(),
                 "threads": engine.resolve_threads(None)}
    runs = []
    large = None
    for mode in ("detailed", "niceonly"):
        native_args = client.build_parser().parse_args(
            [mode, "--backend", "native", "--threads", "0"])
        card_args = client.build_parser().parse_args(
            [mode, "--device", DEVICE, "--host-niceonly-max", "0"])
        for name in NATIVE_FIELDS:
            data = get_benchmark_field(BenchmarkMode(name))
            before = sum(ce.LAUNCHES.values())
            got, secs = client.process_field(data, native_args)
            check(sum(ce.LAUNCHES.values()) == before,
                  f"native {mode} {name} launched a kernel")
            want, card_secs = client.process_field(data, card_args)
            check(_pairs(got) == _pairs(want),
                  f"native {mode} {name} differs from the card's run")
            if mode == "detailed":
                _check_field(data, got)
                if name == NATIVE_FIELDS[-1]:
                    large = (data, got, secs)
            runs.append({"mode": mode, "field": name, "base": data.base,
                         "numbers": data.range_size, "native_secs": secs,
                         "native_numbers_per_sec": data.range_size / secs,
                         "card_secs": card_secs,
                         "hits": len(got.nice_numbers)})
            emit({"phase": "host_engines", "run": "native", **runs[-1],
                  "threads": out["threads"]})
    out["native"] = runs

    # The native large field (the last of NATIVE_FIELDS) beside the
    # prefetch warm of a native niceonly claim (the host stride table of
    # NATIVE_WARM_BASE), then after it.
    data, want, alone_secs = large
    args = client.build_parser().parse_args(
        ["detailed", "--backend", "native", "--threads", "0"])
    warm_args = client.build_parser().parse_args(
        ["niceonly", "--backend", "native", "--threads", "0"])
    plan = get_plan(NATIVE_WARM_BASE)
    claim = Future()
    client._prefetch_on_claim(claim, warm_args, SearchMode.NICEONLY)
    t0 = time.monotonic()
    claim.set_result(DataToClient(
        claim_id=0, base=NATIVE_WARM_BASE, range_start=plan.range_start,
        range_end=plan.range_start + SERVER_FIELD_SIZE,
        range_size=SERVER_FIELD_SIZE))
    during, during_secs = client.process_field(data, args)
    warms = [t for t in threading.enumerate() if t.name == "nice-prefetch"]
    for t in warms:
        t.join()
    warm_secs = time.monotonic() - t0
    after, after_secs = client.process_field(data, args)
    check(_pairs(during) == _pairs(after) == _pairs(want),
          "the native large field differs beside the warm")
    out["native_prefetch"] = {
        "field": NATIVE_FIELDS[-1], "warm_base": NATIVE_WARM_BASE,
        "field_secs_alone": alone_secs, "field_secs_with_warm": during_secs,
        "field_secs_after_warm": after_secs, "warm_secs": warm_secs,
        "with_over_after": during_secs / after_secs}
    emit({"phase": "host_engines", "run": "native_prefetch",
          **out["native_prefetch"]})

    # The route sweep: the measurement behind engine.HOST_NICEONLY_MAX.
    sweep = host_route_sweep.sweep(
        list(HOST_SWEEP_SIZES), HOST_SWEEP_REPS, device=DEVICE,
        emit=lambda line: emit({"phase": "host_engines", "run": "route_sweep",
                                **json.loads(line)}))
    out["route_sweep"] = sweep
    emit({"phase": "host_engines", "run": "route_sweep_table", "rows": [
        {"field": r["field"], "numbers": r["numbers"],
         "host_median_secs": r["host"]["median_secs"],
         "k3_median_secs": r["k3"]["median_secs"],
         "host_over_k3": r["host_over_k3"]} for r in sweep["rows"]],
        "chosen_host_niceonly_max": sweep["chosen_host_niceonly_max"],
        "engine_host_niceonly_max": engine.HOST_NICEONLY_MAX})

    # The scalar drill: checkpoint every chunk into a snapshot file, stop
    # after the second, resume from the file.
    base, size, chunk = SCALAR_DRILL
    lo = get_plan(base).range_start
    field = DataToClient(claim_id=0, base=base, range_start=lo,
                         range_end=lo + size, range_size=size)
    t0 = time.monotonic()
    full = engine.process_range_detailed(field.to_field_size(), base,
                                         backend="scalar")
    full_secs = time.monotonic() - t0
    with tempfile.TemporaryDirectory() as d:
        ckptr = ckpt.FieldCheckpointer(d, field, SearchMode.DETAILED,
                                       "scalar", chunk, DEVICE)
        saved = []

        def save(state):
            ckptr.save(state)
            saved.append(state["cursor"])
            if len(saved) == 2:
                raise InterruptedError("stopped after the second snapshot")

        try:
            engine.process_range_detailed(
                field.to_field_size(), base, backend="scalar",
                batch_size=chunk, checkpoint_cb=save, checkpoint_batches=1)
            check(False, "the scalar drill was not stopped")
        except InterruptedError:
            pass
        state = ckptr.load()
        check(state is not None and state["cursor"] == lo + 2 * chunk,
              f"the scalar drill's snapshot: {state and state['cursor']}")
        resumed = engine.process_range_detailed(
            field.to_field_size(), base, backend="scalar", batch_size=chunk,
            resume=state)
    check(resumed == full, "the resumed scalar field differs")
    _check_field(field, full)
    out["scalar_drill"] = {"base": base, "numbers": size, "chunk": chunk,
                           "snapshots": saved, "resume_cursor":
                           state["cursor"], "full_secs": full_secs}
    emit({"phase": "host_engines", "run": "scalar_drill",
          **out["scalar_drill"]})
    report["host_engines"] = out


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
    check(all(r["launches"]["detailed_megaloop_plan"]
              == r["launches"]["detailed_megaloop"] for r in runs),
          "K1 ran off the plan tier on a b40 field")
    check(all(r["near_misses"] == 0 or r["launches"]["uniques"] > 0
              for r in runs), "near misses without a K2 launch")
    check(total["uniques"] > 0, "the main path never reached K2")


def _surviving_field(base: int):
    """The niceonly main path's field at `base`: the port's
    engine.surviving_field over the server's 1e9 grid, drawn with SEED (a
    field the MSD filter does not prune whole, so that it reaches K3 at b80
    or K4 at b98)."""
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops import engine

    field = engine.surviving_field(base, SERVER_FIELD_SIZE, SEED,
                                   device=DEVICE)
    return DataToClient(claim_id=0, base=base, range_start=field.range_start,
                        range_end=field.range_end,
                        range_size=SERVER_FIELD_SIZE)


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
        FIELD_RESULTS[("niceonly", name)] = (data, results)
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
                "block_threads": engine.LAST_FEED_STATS.get("block_threads"),
                "median_run": engine.LAST_NICEONLY_STATS.get("median_run")
                if mode == "niceonly" else None,
                "launches": {k: v for k, v in ce.LAUNCHES.items() if v},
                "distribution": [[d.num_uniques, d.count]
                                 for d in results.distribution],
                "nice": [[n.number, n.num_uniques] for n in results.nice_numbers]})
print(json.dumps({"fields": out, "events": autotune.EVENTS}))
"""


def _kernel_ms_est(launches: dict, kernel_ms: dict) -> float:
    """The launches' device milliseconds at each kernel's timed ms; the
    "detailed_megaloop_plan" count is K1's launches again, so it adds
    nothing."""
    return sum(n * kernel_ms[k] for k, n in launches.items()
               if k != "detailed_megaloop_plan")


def _pairs(results) -> tuple[list, list]:
    return ([[d.num_uniques, d.count] for d in results.distribution],
            [[n.number, n.num_uniques] for n in results.nice_numbers])


# The wide base of the tuned path: one segment of b510 from its range start
# (2^18 x 8 lanes), where K5 outruns K1.
WIDE_BASE = 510
WIDE_SLICE = 1 << 21


# The block size of the tuned path's second winners table (phase_tuned 4):
# half the default, so every K1, K4 and K5 launch of its fields changes
# shape.
TUNED_BLOCK_THREADS = 128


def _spread(records) -> list:
    """Each swept config's shape with its mean, min and max pass seconds."""
    return [{k: r.get(k) for k in ("batch_size", "megaloop", "use_mxu",
                                   "block_threads", "launch_threads",
                                   "elapsed_secs", "min_secs", "max_secs",
                                   "reps")} for r in records]


def _fresh_tuned(path: str, fields: list) -> dict:
    """_FRESH_TUNED's report for the fields [mode, base, start, size] under
    the winners table at path."""
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH_TUNED, path, json.dumps(fields),
         DEVICE], cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, "the fresh tuned process failed:\n"
          + proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_tuned(report: dict, tmp: str) -> None:
    """The tuned path at full width:
      1. sweeps on the card (autotune.sweep, the harness in a subprocess)
         into a temporary winners table: extra-large, detailed, a 1e8
         slice, batches 2^18/2^19 x segments 8/16 x K1/K5 x blocks of
         128/256 threads; then the
         b98-surviving field, niceonly, whole, batch 2^18 x segment 8 x
         K4/K5 (small grids keep the smoke near two minutes); then one
         wide base, a b510 segment, detailed, batch
         2^18 x segment 8 x K1/K5, whose winner must be K5;
      2. a fresh Python process pointed at that table runs extra-large
         (detailed), b98-surviving (niceonly) and the b510 segment through
         process_field: autotune hits, results equal to the default-shape
         runs (at b510 to K1's, run here), and at b510 K5 launched;
      3. winners with use_mxu=1 at the default shape (detailed b40,
         niceonly b98) in a second table, and extra-large, mid-range and
         b98-surviving through process_field here, the launch counts set to
         0 just before and read just after: K5 launched in K1's and K4's
         place (and K2 re-scanning mid-range's near misses), results equal
         to the use_mxu=0 runs. These are K5's main-path launches;
      4. winners with block_threads=128 at the default shape (detailed b40,
         niceonly b98) in a third table, and extra-large, mid-range and
         b98-surviving through process_field in a fresh process: results
         equal to the default runs, 128 threads in the engine's feed stats,
         and launch_shape at 128 reporting 128 for K1 and K5 over a
         segment and for K4 over a full run (and, over the b98 field's
         median run, the size K4's small-run rule gives)."""
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import autotune, engine
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops.limbs import get_plan

    xl, _ = FIELD_RESULTS[("detailed", "extra-large")]
    mid, _ = FIELD_RESULTS[("detailed", "mid-range")]
    b98, _ = FIELD_RESULTS[("niceonly", "b98-surviving")]
    saved = autotune.WINNERS_PATH
    try:
        autotune.WINNERS_PATH = os.path.join(tmp, "swept.json")
        t0 = time.monotonic()
        won_d = autotune.sweep("detailed", DEVICE, bench_mode="extra-large",
                               batch_shifts=[18, 19], segments=[8, 16],
                               mxu="auto", threads=[TUNED_BLOCK_THREADS, 256],
                               slice_size=100_000_000, timeout=400)
        t1 = time.monotonic()
        spread = {"detailed": _spread(autotune.LAST_SWEEP)}
        won_n = autotune.sweep("niceonly", DEVICE,
                               field=(DENSE_BASE, b98.range_start, b98.range_size),
                               batch_shifts=[18], segments=[8], mxu="auto",
                               slice_size=b98.range_size, timeout=400)
        t2 = time.monotonic()
        spread["niceonly"] = _spread(autotune.LAST_SWEEP)
        wide_start = get_plan(WIDE_BASE).range_start
        won_w = autotune.sweep("detailed", DEVICE,
                               field=(WIDE_BASE, wide_start, WIDE_SLICE),
                               batch_shifts=[18], segments=[8], mxu="auto",
                               slice_size=WIDE_SLICE, timeout=300)
        t3 = time.monotonic()
        spread["detailed_b510"] = _spread(autotune.LAST_SWEEP)
        wide_k1 = _pairs(engine.process_range_detailed(
            FieldSize(wide_start, wide_start + WIDE_SLICE), WIDE_BASE,
            device=DEVICE, use_mxu=0))
        with open(autotune.WINNERS_PATH) as f:
            table = json.load(f)
        swept = {k: v["swept"] for k, v in table.items()}
        fields = [["detailed", xl.base, xl.range_start, xl.range_size],
                  ["niceonly", b98.base, b98.range_start, b98.range_size],
                  ["detailed", WIDE_BASE, wide_start, WIDE_SLICE]]
        fresh = _fresh_tuned(autotune.WINNERS_PATH, fields)
        wants = [_pairs(FIELD_RESULTS[("detailed", "extra-large")][1]),
                 _pairs(FIELD_RESULTS[("niceonly", "b98-surviving")][1]),
                 wide_k1]
        for run, name, want, won in zip(
                fresh["fields"], ("extra-large", "b98-surviving", "b510"),
                wants, (won_d, won_n, won_w)):
            check([run["distribution"], run["nice"]] == list(want),
                  f"{name}: the tuned run differs from the default-shape run")
            check(run["resolved"] == [won["batch_size"], won["megaloop"],
                                      won["use_mxu"],
                                      won.get("block_threads", 256)],
                  f"{name}: resolved {run['resolved']}, the winner is {won}")
        check(fresh["events"]["hit"] > 0 and fresh["events"]["invalidated"] == 0,
              f"the fresh process did not hit the table: {fresh['events']}")
        # K5 wins the b510 segment and a fresh process runs it there: the
        # main path by which K5 reaches a user.
        wide_run = fresh["fields"][2]
        check(won_w["use_mxu"] == 1
              and wide_run["launches"].get("detailed_megaloop_mma", 0) > 0
              and "detailed_megaloop" not in wide_run["launches"],
              f"b510: K5 did not win or run: {won_w}, {wide_run['launches']}")

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

        # A block size of 128 at the default shape, in a fresh process.
        autotune.WINNERS_PATH = os.path.join(tmp, "threads.json")
        shape = dict(shape, use_mxu=0, block_threads=TUNED_BLOCK_THREADS)
        autotune.record("detailed", SERVER_BASE, DEVICE, shape)
        autotune.record("niceonly", DENSE_BASE, DEVICE, shape)
        names = (("detailed", "extra-large"), ("detailed", "mid-range"),
                 ("niceonly", "b98-surviving"))
        threaded = _fresh_tuned(autotune.WINNERS_PATH, [
            [mode, data.base, data.range_start, data.range_size]
            for mode, data in ((m, FIELD_RESULTS[(m, n)][0])
                               for m, n in names)])
    finally:
        autotune.WINNERS_PATH = saved
        autotune.reset_for_tests()
    report["tuned"] = {"sweep_detailed_secs": t1 - t0,
                       "sweep_niceonly_secs": t2 - t1,
                       "sweep_wide_secs": t3 - t2, "winners": {
                           "detailed": won_d, "niceonly": won_n,
                           "detailed_b510": won_w},
                       "swept": swept, "sweep_spread": spread,
                       "fresh": fresh, "k5_runs": runs,
                       "launches": k5_launches}
    report["main_path_launches"].update(
        detailed_megaloop_mma=k5_launches["detailed_megaloop_mma"]
        + wide_run["launches"]["detailed_megaloop_mma"],
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
    report["tuned"]["block_threads"] = _check_threaded(threaded, names)


def _check_threaded(threaded: dict, names) -> dict:
    """phase_tuned 4: the fields of the block_threads=128 table equal the
    default runs, ran at 128 threads, and launch_shape reports 128 for K1,
    K4 and K5 (K4 over the b98 field's median run: what the small-run rule
    gives)."""
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan

    bt = TUNED_BLOCK_THREADS
    lanes = engine.DEFAULT_BATCH_SIZE * engine.MEGALOOP_SEGMENT_DEFAULT
    p40, p98 = get_plan(SERVER_BASE), get_plan(DENSE_BASE)
    n_cls = ce.niceonly_classes(p98, True, "cpu").shape[0]
    runs = []
    for (mode, name), run in zip(names, threaded["fields"]):
        want = _pairs(FIELD_RESULTS[(mode, name)][1])
        check([run["distribution"], run["nice"]] == list(want),
              f"{name}: the block_threads={bt} run differs from the default")
        check(run["resolved"][3] == bt and run["block_threads"] == bt,
              f"{name}: ran at {run['block_threads']} threads, not {bt}")
        runs.append({k: run[k] for k in ("mode", "base", "secs", "resolved",
                                          "block_threads", "launches")})
    median = threaded["fields"][2]["median_run"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    med_lanes = n_cls * -(-median[1] // (DENSE_BASE - 1))
    shapes = {
        "k1_segment": ce.launch_shape("detailed_megaloop", p40, lanes,
                                      block_threads=bt),
        "k5_segment": ce.launch_shape("detailed_megaloop_mma", p40, lanes,
                                      block_threads=bt),
        "k4_full_run": ce.launch_shape("niceonly_dense", p98, n_cls, lanes,
                                       block_threads=bt),
        "k5_dense_full_run": ce.launch_shape("niceonly_dense_mma", p98, n_cls,
                                             lanes, block_threads=bt),
        "k4_median_run": ce.launch_shape("niceonly_dense", p98, n_cls,
                                         median[1], block_threads=bt),
    }
    small = 64 if med_lanes < sms * bt else bt
    for key, shape in shapes.items():
        want = small if key == "k4_median_run" else bt
        check(shape["threads"] == want,
              f"launch_shape {key} at {bt}: {shape['threads']} threads, "
              f"not {want}")
    out = {"block_threads": bt, "runs": runs, "shapes": shapes,
           "k4_median_run_lanes": med_lanes, "events": threaded["events"]}
    emit({"phase": "tuned_block_threads", **out})
    return out


# The blocks phase's process: runs the tuning harness
# (nice_tpu_torch.scripts.tune_kernels) with --json on each argument list
# of the JSON object argv[1] and prints {name: [exit code, records]}. A
# process of its own: its many torch.profiler windows (device_ms) left the
# smoke's later profiling short of records when they ran in the smoke's.
_BLOCKS_RUN = """
import contextlib, io, json, sys
from nice_tpu_torch.scripts import tune_kernels
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tune_kernels.main(argv + ["--json"])
    out[name] = [rc, [json.loads(line) for line in buf.getvalue().splitlines()
                      if line.startswith("{")]]
print(json.dumps(out))
"""


# The block sizes the blocks phase times (of the admissible set: every
# power of two; K5 starts at two warps).
BLOCK_SIZES = (32, 64, 128, 256)


def phase_blocks(report: dict) -> None:
    """The tuning harness's blocks and stride-blocks kinds on the card
    (nice_tpu_torch.scripts.tune_kernels, in one fresh process):
    K1 over one 2^18 x 8 segment at b40 (extra-large's start) and at b80
    (hi-base's start), both on the plan tier, K5 at the same
    b40 segment, K3 on a 1024-descriptor group of the mid-range b40 field's
    stride shape, and K4 over the b98-surviving field's median run, the
    last two at check_min_uniques (where their counts are not all 0); each
    at every admissible size of BLOCK_SIZES, its device time, and its
    output equal to the 256-thread output and to the plain version's on
    the CPU (--plain). One {"blocks": ...} line of device ms by kernel and
    size. Its launches are another process's: none counts toward a main
    path."""
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field

    xl = get_benchmark_field(BenchmarkMode("extra-large"))
    hi = get_benchmark_field(BenchmarkMode("hi-base"))
    mid, _ = FIELD_RESULTS[("detailed", "mid-range")]
    b98, _ = FIELD_RESULTS[("niceonly", "b98-surviving")]
    median = report["full_width_dense"]["fields"][1]["stats"]["median_run"]
    sizes = ",".join(str(t) for t in BLOCK_SIZES)

    def field(data, start=None):
        start = data.range_start if start is None else start
        return f"{data.base}:{start}:{data.range_size}"

    cases = {
        "K1_K5_b40": ["blocks", "--field", field(xl), "--mxu", "auto"],
        "K1_b80": ["blocks", "--field", field(hi), "--mxu", "off"],
        "K3_b40": ["stride-blocks", "--field", field(mid),
                   "--min-uniques", str(check_min_uniques(mid.base))],
        "K4_b98_median_run": ["blocks", "--field", field(b98, median[0]),
                              "--block-lanes", str(median[1]), "--mxu", "off",
                              "--min-uniques", str(check_min_uniques(b98.base))],
    }
    t0 = time.monotonic()
    argv = {name: a + ["--device", DEVICE, "--plain", "--threads", sizes]
            for name, a in cases.items()}
    proc = subprocess.run([sys.executable, "-c", _BLOCKS_RUN,
                           json.dumps(argv)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, "the blocks process failed:\n"
          + proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rcs = {name: rc for name, (rc, _) in out.items()}
    records = [r for _, recs in out.values() for r in recs]
    ms: dict = {}
    for r in records:
        key = {"detailed_megaloop": "K1", "detailed_megaloop_mma": "K5",
               "strided_niceonly": "K3",
               "niceonly_dense": "K4"}[r["kernel"]] + f"_b{r['base']}"
        ms.setdefault(key, {})[r["requested"]] = r["ms"]
    line = {"card": report["card"], "ms": ms,
            "threads": {f"{r['kernel']}_b{r['base']}@{r['requested']}":
                        r["block_threads"] for r in records},
            "lanes": {f"{r['kernel']}_b{r['base']}": r["lanes"]
                      for r in records},
            "k3_group": next(({k: r[k] for k in ("k", "periods", "modulus",
                                                  "residues")}
                              for r in records if "periods" in r), None),
            "all_equal_to_256": all(r["equal_to_default"] for r in records),
            "all_equal_to_plain": all(r["equal_to_plain"] for r in records),
            "rcs": rcs, "secs": time.monotonic() - t0}
    report["blocks"] = {**line, "records": records}
    emit({"blocks": line})
    check(all(rc == 0 for rc in rcs.values()), f"blocks: exit codes {rcs}")
    check(line["all_equal_to_256"] and line["all_equal_to_plain"],
          "blocks: a block size's output differs from the 256-thread or the "
          "plain version's")
    for key, want in (("K1_b40", BLOCK_SIZES), ("K1_b80", BLOCK_SIZES),
                      ("K5_b40", BLOCK_SIZES[1:]), ("K3_b40", BLOCK_SIZES),
                      ("K4_b98", BLOCK_SIZES)):
        check(sorted(ms.get(key, {})) == list(want),
              f"blocks: {key} timed at {sorted(ms.get(key, {}))}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def _start_server(tmp: str, port: int, seed: bool = True):
    """The repository's coordination server in a separate process over
    tmp/nice.db, seeded with SERVER_BASE fields of SERVER_FIELD_SIZE unless
    seed is False; (process, url, log)."""
    log_path = os.path.join(tmp, "server.log")
    init = (["--init-base", str(SERVER_BASE), "--field-size",
             str(SERVER_FIELD_SIZE)] if seed else [])
    with open(log_path, "wb") as log_f:
        server = subprocess.Popen(
            [sys.executable, "-m", "nice_tpu.server", "--db",
             os.path.join(tmp, "nice.db"), *init,
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT,
        )
    api = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while True:
        check(server.poll() is None, "server exited: " + _tail(log_path))
        try:
            _get_json(api + "/status")
            return server, api, log_path
        except OSError:
            check(time.monotonic() < deadline, "server did not come up")
            time.sleep(0.5)


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def _await_spot_check(api: str) -> dict:
    spot = {}
    deadline = time.monotonic() + 60
    while not spot.get("pass"):
        check(time.monotonic() < deadline, f"no spot check: {spot}")
        time.sleep(1.0)
        spot = _get_json(api + "/status")["fleet"]["trust"]["spot_checks"]
    check(spot.get("fail", 0) == 0, f"spot check failed: {spot}")
    return spot


def _field_of_claim(db_path: str, claim_id: int) -> int:
    import sqlite3

    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute("SELECT field_id FROM claims WHERE id = ?",
                            (claim_id,)).fetchall()
    finally:
        conn.close()
    check(len(rows) == 1, f"no claim {claim_id} in the server's ledger")
    return int(rows[0][0])


def _poll(fn, what: str, secs: float = 20.0):
    """fn() until it returns something true, for at most secs."""
    deadline = time.monotonic() + secs
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.25)


def phase_server(report: dict, api: str, db_path: str) -> None:
    """Claim -> process -> submit against the server at `api`: one detailed
    and one niceonly single-shot client run on the card. The detailed one
    runs with the observability layer's telemetry beat (--telemetry-secs 1),
    --stepprof and a local metrics port (the registry set to 0 just before):
    the server's /status fleet must list the client with the field's
    numbers, its /critpath must see the phase breakdown the snapshot
    carried, the field's timeline must hold the phases event, every submit
    must carry the claim's traceparent, and the client's /metrics must
    count as many detailed dispatches as K1 launched."""
    from nice_tpu_torch import obs
    from nice_tpu_torch.client import api_client
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.types import FieldResults
    from nice_tpu_torch.obs import stepprof, telemetry
    from nice_tpu_torch.ops import cuda_engine as ce

    args = client.build_parser().parse_args(
        ["detailed", "--api-base", api, "--username", "chip-smoke",
         "--device", DEVICE, "--telemetry-secs", "1", "--stepprof",
         "--metrics-port", "0", *SAMPLERS_OFF])
    obs.reset()
    client.configure_obs(args)
    sent = []
    real_request = api_client._request_json

    def request(url, body=None, timeout=None):
        sent.append((url.split("?")[0].rsplit("/", 1)[-1],
                     obs.current_traceparent()))
        return real_request(url, body) if timeout is None else \
            real_request(url, body, timeout)

    api_client._request_json = request
    ce.reset_launches()
    t0 = time.monotonic()
    try:
        with client.telemetry_beat(args):
            data, sub, resp = client.run_single_iteration(args)
            elapsed = time.monotonic() - t0
            # One more beat after the submit carries its journal events.
            time.sleep(1.5)
    finally:
        api_client._request_json = real_request
        stepprof.configure(False)
    launches = dict(ce.LAUNCHES)
    check(resp.get("status") == "OK" and not resp.get("duplicate"),
          f"submit not accepted: {resp}")
    obs_checks = _server_obs_checks(api, db_path, data, sub, launches, sent,
                                    telemetry.client_id("chip-smoke"))
    # The server's fields are 1e9 wide except the base's last one.
    check(data.base == SERVER_BASE
          and 0 < data.range_size <= SERVER_FIELD_SIZE,
          f"claimed {data}, not a b{SERVER_BASE} field")
    _check_field(data, FieldResults(tuple(sub.unique_distribution),
                                    tuple(sub.nice_numbers)))
    spot = _await_spot_check(api)
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
    report["server"] = {"claim_id": data.claim_id, "numbers": data.range_size,
                        "client_secs": elapsed, "launches": launches,
                        "near_misses": len(sub.nice_numbers), "reply": resp,
                        "spot_checks": spot, "obs": obs_checks,
                        "niceonly": {"claim_id": n_data.claim_id,
                                     "range_start": n_data.range_start,
                                     "numbers": n_data.range_size,
                                     "client_secs": n_elapsed,
                                     "launches": n_launches,
                                     "nice": len(n_sub.nice_numbers),
                                     "reply": n_resp}}
    emit({"phase": "server", **report["server"]})


def _server_obs_checks(api: str, db_path: str, data, sub, launches: dict,
                       sent: list, client_id: str) -> dict:
    """The server phase's observability checks (see phase_server)."""
    from nice_tpu_torch import obs
    from nice_tpu_torch.obs import series

    def fleet_row():
        for c in _get_json(api + "/status")["fleet"]["clients"]:
            if c["client_id"] == client_id:
                return c
        return None

    row = _poll(fleet_row, "the client in /status fleet")
    check(int(row["numbers_total"]) == data.range_size,
          f"fleet numbers {row['numbers_total']} != {data.range_size}")
    check(sub.telemetry is not None
          and sub.telemetry.get("phase_breakdown"),
          "the submission carried no phase breakdown")
    util = _poll(lambda: _get_json(api + "/critpath")["utilization"].get(
        "device_busy"), "a device_busy share in /critpath", 30.0)
    field_id = _field_of_claim(db_path, data.claim_id)

    def phases_event():
        tl = _get_json(f"{api}/fields/{field_id}/timeline")["events"]
        return next((e for e in tl if e["kind"] == "client_phases"), None)

    phases = _poll(phases_event, "the phases event on the field's timeline")
    submits = [tp for kind, tp in sent if kind == "submit"]
    check(submits and all(obs.parse_traceparent(tp)
                          == obs.claim_trace_id(data.claim_id)
                          for tp in submits),
          f"a submit without the claim's traceparent: {submits}")
    port = int(series.METRICS_BOUND_PORT.value())
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=5) as r:
        text = r.read().decode()
    m = re.search(r'^nice_engine_dispatches_total\{mode="detailed"\} (\d+)$',
                  text, re.M)
    check(m is not None and int(m.group(1)) == launches["detailed_megaloop"],
          f"/metrics dispatches {m and m.group(1)} != K1's "
          f"{launches['detailed_megaloop']} launches")
    return {"fleet_numbers_total": row["numbers_total"],
            "critpath_device_busy": util, "phases_event": phases["detail"],
            "submit_traceparents": len(submits),
            "metrics_port": port, "metrics_dispatches": int(m.group(1)),
            "requests": sorted({kind for kind, _ in sent})}


def _blocks(db_path: str) -> dict:
    """The server's block claims: block_id -> [(claim_id, the field as a
    DataToClient)], from its sqlite file (ranges are zero-padded decimal
    text)."""
    import sqlite3

    from nice_tpu_torch.core.types import DataToClient

    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT c.block_id, c.id, f.base_id, f.range_start, f.range_end "
            "FROM claims c JOIN fields f ON f.id = c.field_id "
            "WHERE c.block_id IS NOT NULL ORDER BY c.id").fetchall()
    finally:
        conn.close()
    out: dict = {}
    for block, claim_id, base, lo, hi in rows:
        lo, hi = int(lo), int(hi)
        out.setdefault(block, []).append(DataToClient(
            claim_id=claim_id, base=base, range_start=lo, range_end=hi,
            range_size=hi - lo))
    return out


def _tamper_canon(src_path: str, dst_path: str) -> int:
    """A copy of the server's ledger (sqlite's backup, consistent under a
    live writer) with one count moved between two bins of every canonical
    SERVER_BASE distribution (the bins still sum to the field, so the server
    serves it); returns how many it changed."""
    import sqlite3

    src, dst = sqlite3.connect(src_path), sqlite3.connect(dst_path)
    try:
        src.backup(dst)
        rows = dst.execute(
            "SELECT s.id, s.distribution FROM submissions s JOIN fields f ON "
            "f.canon_submission_id = s.id WHERE f.base_id = ?",
            (SERVER_BASE,)).fetchall()
        for sid, dist in rows:
            dist = json.loads(dist)
            full = [d for d in dist if int(d["count"]) > 0]
            full[0]["count"] = int(full[0]["count"]) - 1
            full[1]["count"] = int(full[1]["count"]) + 1
            dst.execute("UPDATE submissions SET distribution = ? WHERE id = ?",
                        (json.dumps(dist), sid))
        dst.commit()
    finally:
        src.close()
        dst.close()
    return len(rows)


def phase_fleet(report: dict, api: str, server_dir: str) -> None:
    """Fleet, on the server phase's server (its ledger in server_dir):
      1. `python -m nice_tpu_torch.client detailed --claim-block 3` (its
         main, in this process) with --api-base naming a dead 127.0.0.1 port
         before the live server, on the card, the launch counts set to 0
         just before and read just after: the client must rotate past the
         dead endpoint (marked dead, the failover cursor on the live one),
         claim FLEET_BLOCK b40 fields of 1e9 under one block lease (a
         partial block, which the server hands out when its random pivot
         lands near a chunk's end, is processed and submitted like any and
         the run repeated, at most twice more), and every member must be
         accepted and pass _check_field; every request must carry the
         server's epoch (X-Nice-Epoch);
      2. the JAX jobs runner (`python -m nice_tpu.jobs`, which imports no
         jax) makes every submitted field canonical; `--validate --base 40`
         on the card must return 0;
      3. a second server over a copy of the ledger whose canonical
         distributions were tampered with: `--validate --base 40` must
         return 1."""
    from urllib.parse import urlsplit

    from nice_tpu_torch.client import api_client
    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.ops import cuda_engine as ce

    db_path = os.path.join(server_dir, "nice.db")
    dead = f"http://127.0.0.1:{_free_port()}"
    servers = f"{dead},{api}"
    stamps: list = []
    real_headers = api_client._headers

    def headers(body):
        out = real_headers(body)
        stamps.append(out.get("X-Nice-Epoch"))
        return out

    # The samplers stay off until phase_obs, which times the field with
    # and without them (a sampler thread lives as long as the process).
    argv = ["detailed", "--api-base", servers, "--username",
            "chip-smoke-fleet", "--claim-block", str(FLEET_BLOCK),
            "--device", DEVICE, "--renew-secs", "5", *SAMPLERS_OFF]
    api_client._headers = headers
    runs = []
    try:
        ce.reset_launches()
        for _ in range(3):
            t0 = time.monotonic()
            check(client.main(argv) == 0, "the block client failed")
            runs.append(time.monotonic() - t0)
            blocks = _blocks(db_path)
            full = [b for b in blocks.values() if len(b) == FLEET_BLOCK]
            if full:
                break
        launches = dict(ce.LAUNCHES)
    finally:
        api_client._headers = real_headers
    check(bool(full), f"no block of {FLEET_BLOCK} in {len(runs)} runs: "
          f"{[len(b) for b in blocks.values()]}")
    epoch = _get_json(api + "/status")["epoch"]
    check(stamps and all(st == str(epoch) for st in stamps)
          and api_client.last_seen_epoch() == epoch,
          f"requests without the server's epoch {epoch}: {stamps}")
    key = ",".join(api_client.split_servers(servers))
    check(("http", urlsplit(dead).netloc) in api_client._dead_hosts
          and api_client._failover_idx.get(key) == 1,
          "the client did not rotate past the dead endpoint")
    members = []
    for data in (d for b in blocks.values() for d in b):
        got = _read_submission(db_path, data.claim_id)
        check(data.base == SERVER_BASE
              and 0 < data.range_size <= SERVER_FIELD_SIZE,
              f"block member {data}")
        members.append({"claim_id": data.claim_id,
                        "range_start": data.range_start,
                        "near_misses": _check_field(data, got)})
    check(launches["detailed_megaloop"] > 0, f"K1 not launched: {launches}")

    jobs = subprocess.run([sys.executable, "-m", "nice_tpu.jobs", "--db",
                           db_path], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    check(jobs.returncode == 0, "the jobs runner failed:\n" + jobs.stderr[-3000:])
    validate = ["--validate", "--base", str(SERVER_BASE), "--username",
                "chip-smoke-validate", "--device", DEVICE, *SAMPLERS_OFF]
    t0 = time.monotonic()
    canon_rc = client.main(validate + ["--api-base", api])
    canon_secs = time.monotonic() - t0
    check(canon_rc == 0, f"--validate on the canon returned {canon_rc}")
    tampered_dir = os.path.join(server_dir, "tampered")
    os.makedirs(tampered_dir)
    n_tampered = _tamper_canon(db_path, os.path.join(tampered_dir, "nice.db"))
    check(n_tampered >= FLEET_BLOCK, f"{n_tampered} canonical submissions")
    server2, api2, _ = _start_server(tampered_dir, _free_port(), seed=False)
    try:
        tampered_rc = client.main(validate + ["--api-base", api2])
    finally:
        _stop(server2)
    check(tampered_rc == 1,
          f"--validate on the tampered canon returned {tampered_rc}")
    report["fleet"] = {"block_runs_secs": runs, "blocks": len(blocks),
                       "members": members, "launches": launches,
                       "requests": len(stamps), "epoch": epoch,
                       "validate_canon_rc": canon_rc,
                       "validate_canon_secs": canon_secs,
                       "canonical_tampered": n_tampered,
                       "validate_tampered_rc": tampered_rc}
    emit({"phase": "fleet", **report["fleet"]})


def phase_bench(report: dict) -> None:
    """`python -m nice_tpu_torch.scripts.bench --only extra-large --reps 3`
    in a subprocess: the headline (detailed extra-large) first and last,
    the suite embedded in the last; every line with its median, min and max
    pass seconds and the card as nvidia-smi names it; the detailed bins
    summing to the 1e9 field."""
    card = nvidia_smi("name,power.limit")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "nice_tpu_torch.scripts.bench", *BENCH_ARGV,
         "--device", DEVICE], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    secs = time.monotonic() - t0
    check(proc.returncode == 0, "the bench failed:\n" + proc.stderr[-3000:])
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    first, last = lines[0], lines[-1]
    check(first["metric"] == "numbers/sec/chip detailed (extra-large, base 40)"
          and {k: v for k, v in last.items() if k not in
               ("suite", "budget_secs", "budget_used_secs")} == first
          and len(last["suite"]) == len(lines) - 1,
          "the headline is not first and last")
    check(first["range_size"] == sum(first["distribution"]) == BENCH_NUMBERS,
          "the headline's bins do not sum to its field")
    for line in lines[:-1]:
        check(line["min_secs"] <= line["elapsed_secs"] <= line["max_secs"]
              and len(line["pass_secs"]) == line["reps"]
              and line["device"] == card, f"bench line {line['metric']}")
    keys = ("metric", "value", "elapsed_secs", "min_secs", "max_secs",
            "first_field_secs", "warm_secs", "build_secs", "launches")
    report["bench"] = {"secs": secs, "device": first["device"],
                       "lines": [{k: line.get(k) for k in keys}
                                 for line in lines[:-1]],
                       "feed_ab": {d: {k: v for k, v in ab.items()
                                       if k != "feed_stats"}
                                   for d, ab in first["feed_ab"].items()}}
    emit({"phase": "bench", **report["bench"]})


# The pipeline phase's kernels, by the profiler's kernel names.
PIPELINE_KERNELS = {"detailed": "detailed_megaloop", "niceonly": "niceonly_dense"}


def _field_run(mode: str, data, depth: int):
    """One field through the engine at the default shape and feed depth
    `depth`: (results, seconds, the feed stats, the launches)."""
    import torch
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine

    process = (engine.process_range_detailed if mode == "detailed"
               else engine.process_range_niceonly)
    before = dict(ce.LAUNCHES)
    t0 = time.monotonic()
    results = process(data.to_field_size(), data.base, device=DEVICE,
                      feed_depth=depth)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return (results, secs, dict(engine.LAST_FEED_STATS),
            {k: v - before[k] for k, v in ce.LAUNCHES.items() if v - before[k]})


def _pinned_dense_floor():
    """Context: the dense floor controller pinned at its current floor (it
    adapts after every field, which changes the runs), so that every run of
    an A/B does the same work; the controller is put back after."""
    import contextlib

    from nice_tpu_torch.ops import adaptive_floor

    @contextlib.contextmanager
    def pinned():
        ctrl = adaptive_floor.get_floor_controller("dense")
        adaptive_floor._CONTROLLERS["dense"] = adaptive_floor.AdaptiveFloor(
            pinned=ctrl.current())
        try:
            yield
        finally:
            adaptive_floor._CONTROLLERS["dense"] = ctrl

    return pinned()


PIPELINE_FIELDS = (("detailed", "extra-large"), ("niceonly", "b98-surviving"))


def phase_pipeline(report: dict) -> None:
    """The pipelined host loop against the synchronous one: extra-large
    (b40 detailed) and b98-surviving (dense niceonly) at the default shape,
    with feed_depth=0 (each block of starts made inline) and the default
    depth, timed in turns (0, default, default, 0): field seconds, the feed
    stats and the launches, which with the results must not differ. (Their
    runs under torch.profiler come last, phase_pipeline_profile: profiling
    whole fields before the timing phase left its profiler windows short
    of records.)"""
    from nice_tpu_torch.ops import engine

    depths = (0, engine.FEED_DEPTH_DEFAULT)
    out = []
    with _pinned_dense_floor():
        for mode, name in PIPELINE_FIELDS:
            data, want = FIELD_RESULTS[(mode, name)]
            runs = []
            for depth in (depths[0], depths[1], depths[1], depths[0]):
                results, secs, feed, launches = _field_run(mode, data, depth)
                check(_pairs(results) == _pairs(want),
                      f"{name}: feed depth {depth} changed the results")
                runs.append({"feed_depth": depth, "field_secs": secs,
                             "feed_stats": feed, "launches": launches})
            check(all(r["launches"] == runs[0]["launches"] for r in runs),
                  f"{name}: the launches differ between feed depths: {runs}")
            row = {"field": name, "mode": mode, "base": data.base,
                   "numbers": data.range_size, "runs": runs}
            out.append(row)
            emit({"phase": "pipeline", **row})
    report["pipeline"] = out


def phase_pipeline_profile(report: dict) -> None:
    """The pipeline phase's fields once at each feed depth under
    torch.profiler, recording the device alone: the device's idle share and
    K1's/K4's device ms."""
    from nice_tpu_torch.ops import engine

    out = []
    with _pinned_dense_floor():
        for mode, name in PIPELINE_FIELDS:
            data, _ = FIELD_RESULTS[(mode, name)]
            kernel = PIPELINE_KERNELS[mode]
            for depth in (0, engine.FEED_DEPTH_DEFAULT):
                prof = _profiled(lambda: _field_run(mode, data, depth),
                                 cpu=False)
                row = {"field": name, "mode": mode, "feed_depth": depth,
                       "wall_ms": prof["wall_ms"],
                       "device_idle_share": prof["device_idle_share"],
                       "kernel_device_ms": sum(
                           ms for k, ms in
                           prof["device_ms_by_kernel_all"].items()
                           if kernel in k)}
                out.append(row)
                emit({"phase": "pipeline_profile", **row})
    report["pipeline_profile"] = out


# The crash-resume phase's field width: the server's own (it hands out no
# detailed field above 1e9), and a client batch small enough that one such
# field takes seconds on the card, so that a SIGKILL lands mid-field.
CRASH_BATCH = 8192
CRASH_CKPT_BATCHES = 256


def phase_crash_resume(report: dict) -> None:
    """A port client SIGKILLed mid-field resumes its claim: the JAX
    package's server (as phase 8 starts it) hands out a b40 field; `python
    -m nice_tpu_torch.client detailed --checkpoint-dir D` runs it on the
    card at CRASH_BATCH lanes a batch, a snapshot every CRASH_CKPT_BATCHES
    segments, and is SIGKILLed once the first claim-*.ckpt lands; the same
    command again must log that it resumes that claim from a cursor above
    the field's start, submit, be accepted, pass the spot check and leave
    no snapshot; and its histogram and near misses must equal an
    uninterrupted run of the same field in this process."""
    from nice_tpu_torch.ckpt import read_snapshot
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops import engine

    with tempfile.TemporaryDirectory(prefix="nice-chip-crash-") as tmp:
        server, api, _ = _start_server(tmp, _free_port())
        ckpt_dir = os.path.join(tmp, "ckpt")
        cmd = [sys.executable, "-m", "nice_tpu_torch.client", "detailed",
               "--api-base", api, "--username", "chip-smoke-crash",
               "--device", DEVICE, "--checkpoint-dir", ckpt_dir,
               "--batch-size", str(CRASH_BATCH),
               "--checkpoint-batches", str(CRASH_CKPT_BATCHES),
               "--renew-secs", "2"]
        client = None
        try:
            t0 = time.monotonic()
            with open(os.path.join(tmp, "run1.log"), "wb") as log1:
                client = subprocess.Popen(cmd, cwd=REPO, stdout=log1,
                                          stderr=subprocess.STDOUT)
                snaps = []
                deadline = time.monotonic() + 300
                while not snaps and client.poll() is None:
                    check(time.monotonic() < deadline, "no snapshot in 300 s")
                    snaps = glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt"))
                    time.sleep(0.005)
                alive = client.poll() is None
                client.kill()  # SIGKILL: no cleanup, a real crash
                client.wait(timeout=30)
            run1_secs = time.monotonic() - t0
            run1 = _tail(os.path.join(tmp, "run1.log"))
            check(bool(snaps) and alive,
                  "the client did not die mid-field:\n" + run1)
            manifest, _ = read_snapshot(snaps[0])
            data = DataToClient.from_json(manifest["field"])
            kill_cursor = int(manifest["cursor"])
            check(data.range_start < kill_cursor < data.range_end,
                  f"kill cursor {kill_cursor} outside {data}")

            t0 = time.monotonic()
            run2 = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=600)
            run2_secs = time.monotonic() - t0
            check(run2.returncode == 0,
                  "the resumed client failed:\n" + run2.stderr[-3000:])
            m = re.search(r"resuming claim (\d+) from checkpoint: .* cursor "
                          r"(\d+)", run2.stderr)
            check(m is not None and int(m.group(1)) == data.claim_id,
                  "the restart did not resume the claim:\n"
                  + run2.stderr[-3000:])
            resume_cursor = int(m.group(2))
            check(data.range_start < resume_cursor == kill_cursor,
                  f"resumed from {resume_cursor}, killed at {kill_cursor}")
            check(f"submitted claim {data.claim_id}" in run2.stderr,
                  "the resumed submission was not accepted:\n"
                  + run2.stderr[-3000:])
            check(not glob.glob(os.path.join(ckpt_dir, "claim-*.ckpt")),
                  "the snapshot outlived its accepted submit")
            field_secs = re.search(r"processed [\d,]+ numbers in ([\d.]+)s",
                                   run2.stderr)
            spot = _await_spot_check(api)
        finally:
            if client is not None and client.poll() is None:
                client.kill()
                client.wait(timeout=30)
            _stop(server)
        # The submission the server took, against an uninterrupted run.
        got = _read_submission(os.path.join(tmp, "nice.db"), data.claim_id)
    want = engine.process_range_detailed(data.to_field_size(), data.base,
                                         device=DEVICE)
    check(_pairs(got) == _pairs(want),
          "the resumed submission differs from an uninterrupted run")
    _check_field(data, got)
    report["crash_resume"] = {
        "claim_id": data.claim_id, "range_start": data.range_start,
        "numbers": data.range_size, "kill_cursor": kill_cursor,
        "resume_cursor": resume_cursor,
        "resumed_numbers": data.range_end - resume_cursor,
        "run1_secs": run1_secs, "run2_secs": run2_secs,
        "run2_field_secs": float(field_secs.group(1)) if field_secs else None,
        "batch_size": CRASH_BATCH, "checkpoint_batches": CRASH_CKPT_BATCHES,
        "near_misses": len(want.nice_numbers), "spot_checks": spot}
    emit({"phase": "crash_resume", **report["crash_resume"]})


def _read_submission(db_path: str, claim_id: int):
    """The server's record of the submission for a claim, read from its
    sqlite file (JSON rows of num_uniques/count and number/num_uniques; a
    niceonly submission has no distribution), as FieldResults."""
    import sqlite3

    from nice_tpu_torch.core.types import (FieldResults, NiceNumberSimple,
                                           UniquesDistributionSimple)

    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute("SELECT distribution, numbers FROM submissions "
                            "WHERE claim_id = ?", (claim_id,)).fetchall()
    finally:
        conn.close()
    check(len(rows) == 1, f"{len(rows)} submissions for claim {claim_id}")
    dist, nums = (json.loads(col or "[]") for col in rows[0])  # niceonly: NULL
    return FieldResults(
        distribution=tuple(sorted(
            (UniquesDistributionSimple(num_uniques=int(d["num_uniques"]),
                                       count=int(d["count"])) for d in dist),
            key=lambda d: d.num_uniques)),
        nice_numbers=tuple(sorted(
            (NiceNumberSimple(number=int(n["number"]),
                              num_uniques=int(n["num_uniques"])) for n in nums),
            key=lambda n: n.number)))


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
        n_cls = ce.niceonly_classes(dplan, fused, str(dev)).shape[0]
        case = {"kernel": "niceonly_dense", "field": "b98-surviving",
                "start": start, "valid": valid, "fused": fused,
                "shape": ce.launch_shape("niceonly_dense", dplan, n_cls, valid)}
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
    check(all(c["shape"]["tier"] == "dense" for c in dense_cases),
          f"the first run outside K4's dense tier: {dense_cases}")


def _in_range_lanes(s, cols, n_real: int) -> int:
    """The candidates of a descriptor group inside their rows' [lo, hi):
    the stride table's count over each row's clipped span (the lanes that
    reach the digit work)."""
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import engine

    span = s.periods * s.table.modulus
    total = 0
    for g in range(n_real):
        n0, lo, hi = (engine.desc_value(cols, j, g) for j in range(3))
        a, b = max(lo, n0), min(hi, n0 + span)
        if a < b:
            total += s.table.count_candidates(FieldSize(a, b))
    return total


def phase_timing(report: dict, built: dict, sms: int, clk_mhz: float) -> list:
    """Device times, plain times and bounds at the main path's shapes (the
    module note's phase 10); `built` holds phase_build's op counts and
    probe library."""
    import torch

    from nice_tpu_torch.ops import cuda_build, engine
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import vector_engine as ve
    from nice_tpu_torch.ops.limbs import get_plan
    from nice_tpu_torch.scripts.kernel_ab import device_ms

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

    # K2 over a 2^18 sub-batch at b80 (plan tier, from the b80 field's
    # start) and at b510 (generic tier, from its range start).
    p80, p510 = get_plan(80), get_plan(510)
    b80_start = next(r["range_start"] for r in
                     report["full_width_niceonly"]["fields"]
                     if r["field"] == "b80-surviving")
    st80 = ve.start_limbs_tensor(b80_start, p80, dev)
    st510 = ve.start_limbs_tensor(p510.range_start, p510, dev)
    acc80 = torch.zeros(p80.base + 2, dtype=torch.int32, device=dev)

    def k1_b80():  # one 2^18 x 8 segment on the plan tier (hi-base's)
        ce.detailed_accum_megaloop(p80, batch, seg, acc80, st80, lanes_k1)

    def k2_b80():
        ce.uniques_batch(p80, lanes_k2, st80)

    def p2_b80():
        ve.uniques_batch(p80, lanes_k2, st80)

    def k2_b510():
        ce.uniques_batch(p510, lanes_k2, st510)

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

    # K5's setup alone (mma = 2: each block's setup over the launch's grid,
    # no lane), at the b40 segment (the per-base library), the b98 median
    # run and the b510 segment; called through the C entries, as the
    # wrappers launch only whole kernels.
    stream = torch.cuda.current_stream().cuda_stream
    lib, plib = cuda_build.load(), ce.plan_library(plan)
    nm0 = torch.zeros((), dtype=torch.int32, device=dev)
    out0 = torch.zeros(2, dtype=torch.int32, device=dev)

    def setup_b40():
        check(plib.nice_plan_detailed_megaloop_mma(
            ce.plan_words(plan), st.data_ptr(), lanes_k1, 0, acc.data_ptr(),
            nm0.data_ptr(), 2, ce.DEFAULT_BLOCK_THREADS, stream) == 0,
            "K5's setup at b40")

    def setup_b98():
        check(lib.nice_niceonly_dense(
            ce.plan_words(dplan), st4.data_ptr(), classes.data_ptr(),
            classes.shape[0], d_valid, dplan.base, 2, out0.data_ptr(),
            ce.DEFAULT_BLOCK_THREADS, stream) == 0, "K5's setup at b98")

    def setup_b510():
        check(lib.nice_detailed_megaloop(
            ce.plan_words(wide), st_wide.data_ptr(), lanes_k1, 0,
            acc_wide.data_ptr(), nm0.data_ptr(), 2, ce.DEFAULT_BLOCK_THREADS,
            stream) == 0, "K5's setup at b510")

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
    p2_b80_a = time_cuda(p2_b80, reps=2, warmup=1)
    k2_b80_ms = time_cuda(k2_b80, reps=50)
    p2_b80_b = time_cuda(p2_b80, reps=2, warmup=0)
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
    # Device time of each kernel alone (torch.profiler's records): the
    # events above time back-to-back calls, which for the short launches
    # (K2, K4) is the host's rate of calls more than the kernel's time.
    dev = {"k1": device_ms(k1, 20, "detailed_megaloop_kernel"),
           "k2": device_ms(k2, 50, "uniques_kernel"),
           "k3": device_ms(k3, 10, "strided_niceonly_kernel"),
           "k3_b80": device_ms(k3_b80, 10, "strided_niceonly_kernel"),
           "k2_b80": device_ms(k2_b80, 50, "uniques_kernel"),
           "k1_b80": device_ms(k1_b80, 10, "detailed_megaloop_kernel"),
           "k2_b510": device_ms(k2_b510, 5, "uniques_kernel"),
           "k4": device_ms(k4, 50, "niceonly_dense_kernel"),
           "k4_full": device_ms(lambda: k4(lanes_k1), 20,
                                "niceonly_dense_kernel"),
           "k5": device_ms(k5, 20, "detailed_megaloop_mma_kernel"),
           "k5d": device_ms(k5d, 50, "niceonly_dense_mma_kernel"),
           "k5d_full": device_ms(lambda: k5d(lanes_k1), 20,
                                 "niceonly_dense_mma_kernel"),
           "k1_b510": device_ms(k1_b510, 3, "detailed_megaloop_kernel"),
           "k5_b510": device_ms(lambda: k1_b510(1), 3,
                                "detailed_megaloop_mma_kernel"),
           "k5_setup": device_ms(setup_b40, 20, "detailed_megaloop_mma_kernel"),
           "k5d_setup": device_ms(setup_b98, 50, "niceonly_dense_mma_kernel"),
           "k5_b510_setup": device_ms(setup_b510, 5,
                                      "detailed_megaloop_mma_kernel")}
    check(int(out0.abs().sum()) == 0 and int(nm0) == 0,
          "K5's setup alone counted something")
    # Each timed launch's shape: its grid against one full resident wave.
    n_cls = int(classes.shape[0])
    shapes = {
        "k1": ce.launch_shape("detailed_megaloop", plan, lanes_k1),
        "k2": ce.launch_shape("uniques", plan, lanes_k2),
        "k3": ce.launch_shape("strided_niceonly", s3.plan,
                              s3.periods * s3.table.num_residues, n_real),
        "k3_b80": ce.launch_shape("strided_niceonly", s8.plan,
                                  s8.periods * s8.table.num_residues,
                                  len(cols8[0])),
        "k2_b80": ce.launch_shape("uniques", p80, lanes_k2),
        "k1_b80": ce.launch_shape("detailed_megaloop", p80, lanes_k1),
        "k2_b510": ce.launch_shape("uniques", p510, lanes_k2),
        "k4": ce.launch_shape("niceonly_dense", dplan, n_cls, d_valid),
        "k4_full": ce.launch_shape("niceonly_dense", dplan, n_cls, lanes_k1),
        "k5": ce.launch_shape("detailed_megaloop_mma", plan, lanes_k1),
        "k5d": ce.launch_shape("niceonly_dense_mma", dplan, n_cls, d_valid),
        "k5d_full": ce.launch_shape("niceonly_dense_mma", dplan, n_cls,
                                    lanes_k1),
        "k5_b510": ce.launch_shape("detailed_megaloop_mma", wide, lanes_k1),
    }
    emit({"phase": "launch_shapes", **shapes})
    check(shapes["k1"]["grid"] == shapes["k1"]["blocks_per_sm"] * shapes["k1"]["sms"],
          f"K1's segment is not one resident wave: {shapes['k1']}")
    check(shapes["k4"]["tier"] == "dense" and shapes["k4_full"]["tier"] == "dense",
          f"b98's K4 runs outside the dense tier: {shapes['k4']}")
    check(all(shapes[k]["tier"] == "plan"
              for k in ("k1", "k1_b80", "k2", "k3", "k3_b80", "k2_b80"))
          and shapes["k2_b510"]["tier"] == "generic",
          f"K1/K2/K3 tiers: {shapes}")
    # K5 runs K1's and K4's tiers (the plan tier at b40), and its b98 median
    # run spreads over at least as many SMs as K4's.
    check(shapes["k5"]["tier"] == "plan" and shapes["k5d"]["tier"] == "dense"
          and shapes["k5d_full"]["tier"] == "dense"
          and shapes["k5_b510"]["tier"] == "generic"
          and min(shapes["k5d"]["grid"], sms) >= min(shapes["k4"]["grid"], sms),
          f"K5's tiers and shapes: {shapes}")
    # The tensor class's rate: the IMMA instructions an SM completes a
    # clock (the probe), 32 lanes each, as the other classes count lanes.
    counts, counts80 = built["counts"], built["counts80"]
    check(counts["k5_detailed_lane"]["classes"].get("tensor", 0) > 0,
          "K5's lane issues no IMMA")
    probe = imma_rate(built["probe_lib"], sms, clk_mhz)
    CLASS_LANES_PER_SM_CLK["tensor"] = 32 * probe["imma_per_sm_clk"]
    # K5's bound takes the lane that needs fewer cycles: this tree's, or
    # the earlier wmma-staged one (K5_EARLIER_LANES), so that a redesign
    # cannot raise the yardstick it is judged against.
    c5_lanes = {k: (lane_cycles(counts[k]), lane_cycles(K5_EARLIER_LANES[k]))
                for k in K5_EARLIER_LANES}
    c5, c5d = (min(c5_lanes[k]) for k in ("k5_detailed_lane", "k5_dense_lane"))
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
    in_range = _in_range_lanes(s3, cols, n_real)
    b3 = bound_ms(in_range, c3, 8 * 12 * n_real + 8 * s3.table.num_residues
                  + 4 * desc.shape[0], sms, clk_mhz)
    # K3 and K2 at b80: the lanes of op_count.cu built with b80's plan.
    c3_80, c2_80 = (lane_cycles(counts80[k]) for k in ("k3_lane", "k2_lane"))
    in_range8 = _in_range_lanes(s8, cols8, len(cols8[0]))
    b3_80 = bound_ms(in_range8, c3_80, 8 * 12 * len(cols8[0])
                     + 8 * s8.table.num_residues + 4 * desc8.shape[0], sms,
                     clk_mhz)
    b2_80 = bound_ms(lanes_k2, c2_80, 8 * p80.limbs_n + 4 * lanes_k2, sms,
                     clk_mhz)
    # K1 at b80 runs the plan tier; its bound is the constant-plan lane of
    # op_count.cu built with b80's plan, as K2's and K3's there.
    c1_80 = lane_cycles(counts80["k1_lane"])
    b1_80 = bound_ms(lanes_k1, c1_80, 8 * p80.limbs_n
                     + 2 * 4 * (p80.base + 2) + 4, sms, clk_mhz)
    # b510, in the generic tier: the multiplies a lane needs at b510's
    # shapes (scripts/generic_bound.py). The same count at b40 and b80 walks
    # exactly the constant-plan lanes' limb steps (IMAD.WIDE.U32.X) and
    # digit divisions (IMAD.HI.U32) and stays under their multiply-adds.
    from nice_tpu_torch.scripts import generic_bound as gb

    held = {}
    for name, p, lane, kernel in (
            ("k1_b40", plan, counts["k1_lane"], "detailed_megaloop_kernel"),
            ("k2_b40", plan, counts["k2_lane"], "uniques_kernel"),
            ("k2_b80", p80, counts80["k2_lane"], "uniques_kernel"),
            ("k5_b40", plan, counts["k5_detailed_lane"],
             "detailed_megaloop_mma_kernel")):
        need = gb.lane_ops(p, kernel)
        ops = lane["opcodes"]
        held[name] = {"need": need, "lane_multiply_add":
                      lane["classes"]["multiply-add"],
                      "need_cycles": lane_cycles(need),
                      "lane_cycles": lane_cycles(lane)}
        check(need["steps"]["limb_steps"] == ops.get("IMAD.WIDE.U32.X", 0)
              and need["steps"]["digit_steps"] == ops.get("IMAD.HI.U32", 0)
              and need["classes"]["multiply-add"]
              <= lane["classes"]["multiply-add"]
              and need["classes"].get("tensor", 0)
              == lane["classes"].get("tensor", 0),
              f"generic_bound's count against the {name} lane: {held[name]}")
    wide_need = {k: gb.lane_ops(wide, k) for k in gb.KERNELS}
    c_wide = {k: lane_cycles(v) for k, v in wide_need.items()}
    hist_bytes = 8 * wide.limbs_n + 2 * 4 * (wide.base + 2) + 4
    b2_510 = bound_ms(lanes_k2, c_wide["uniques_kernel"],
                      8 * wide.limbs_n + 4 * lanes_k2, sms, clk_mhz)
    b1_510 = bound_ms(lanes_k1, c_wide["detailed_megaloop_kernel"], hist_bytes,
                      sms, clk_mhz)
    b5_510 = bound_ms(lanes_k1, c_wide["detailed_megaloop_mma_kernel"],
                      hist_bytes, sms, clk_mhz)
    # K5 moves K1's and K4's bytes; its work is K1's lanes (K4's kept ones).
    b5 = bound_ms(lanes_k1, c5, 8 * plan.limbs_n + 2 * 4 * (plan.base + 2) + 4,
                  sms, clk_mhz)
    b5d = bound_ms(kept4, c5d, bytes4, sms, clk_mhz)
    b5d_full = bound_ms(kept4_full, c5d, bytes4, sms, clk_mhz)
    report["timing"] = {
        "base": plan.base, "sms": sms, "clk_max_mhz": clk_mhz,
        "k1": {"lanes": lanes_k1, "ms": [k1_a, k1_b], "device_ms": dev["k1"],
               "plain_ms": [p1_a, p1_b], "shape": shapes["k1"],
               "sass": counts["k1_lane"], "sass_runtime": counts["k1_runtime"],
               "lane_cycles": c1, "bound_ms": b1[0], "bound_by": b1[1]},
        "k2": {"lanes": lanes_k2, "ms": [k2_a, k2_b], "device_ms": dev["k2"],
               "plain_ms": [p2_a, p2_b], "shape": shapes["k2"],
               "sass": counts["k2_lane"], "lane_cycles": c2,
               "bound_ms": b2[0], "bound_by": b2[1]},
        "k3": {"rows": n_real, "k": s3.k, "periods": s3.periods,
               "lanes": n_real * s3.periods * s3.table.num_residues,
               "lanes_in_range": in_range, "ms": [k3_a, k3_b],
               "device_ms": dev["k3"], "shape": shapes["k3"],
               "plain_ms": [p3_a, p3_b], "sass": counts["k3_lane"],
               "lane_cycles": c3, "bound_ms": b3[0], "bound_by": b3[1]},
        "k3_b80": {"rows": len(cols8[0]), "k": s8.k, "periods": s8.periods,
                   "lanes": len(cols8[0]) * s8.periods * s8.table.num_residues,
                   "lanes_in_range": in_range8, "ms": k3_b80_ms,
                   "device_ms": dev["k3_b80"], "shape": shapes["k3_b80"],
                   "sass": counts80["k3_lane"], "lane_cycles": c3_80,
                   "bound_ms": b3_80[0], "bound_by": b3_80[1]},
        "k1_b80": {"lanes": lanes_k1, "start": b80_start,
                   "device_ms": dev["k1_b80"], "sass": counts80["k1_lane"],
                   "lane_cycles": c1_80, "bound_ms": b1_80[0],
                   "bound_by": b1_80[1], "shape": shapes["k1_b80"]},
        "k2_b80": {"lanes": lanes_k2, "start": b80_start, "ms": k2_b80_ms,
                   "device_ms": dev["k2_b80"], "plain_ms": [p2_b80_a, p2_b80_b],
                   "shape": shapes["k2_b80"], "sass": counts80["k2_lane"],
                   "lane_cycles": c2_80, "bound_ms": b2_80[0],
                   "bound_by": b2_80[1]},
        # b510's bound: the multiplies the plan's shapes need.
        "k2_b510": {"lanes": lanes_k2, "start": p510.range_start,
                    "device_ms": dev["k2_b510"], "shape": shapes["k2_b510"],
                    "lane_need": wide_need["uniques_kernel"],
                    "lane_cycles": c_wide["uniques_kernel"],
                    "bound_ms": b2_510[0], "bound_by": b2_510[1]},
        "k4": {"base": DENSE_BASE, "start": d_start, "valid": d_valid,
               "kept": kept4, "classes": n_cls,
               "ms": [k4_a, k4_b], "device_ms": dev["k4"],
               "plain_ms": [p4_a, p4_b], "shape": shapes["k4"],
               "sass": counts["k4_lane"], "lane_cycles": c4,
               "bound_ms": b4[0], "bound_by": b4[1]},
        "k4_full_run": {"valid": lanes_k1, "kept": kept4_full,
                        "ms": k4_full_ms, "device_ms": dev["k4_full"],
                        "shape": shapes["k4_full"], "bound_ms": b4_full[0],
                        "bound_by": b4_full[1]},
        "imma_probe": {**probe,
                       "tensor_lanes_per_sm_clk": CLASS_LANES_PER_SM_CLK["tensor"]},
        "k5_detailed": {"lanes": lanes_k1, "ms": [k5_a, k5_b],
                        "device_ms": dev["k5"], "shape": shapes["k5"],
                        "setup_device_ms": dev["k5_setup"],
                        "plain_ms": [p5_a, p5_b], "k1_ms_between": k1_c,
                        "sass": counts["k5_detailed_lane"], "lane_cycles": c5,
                        "lane_cycles_this_and_earlier":
                            c5_lanes["k5_detailed_lane"],
                        "bound_ms": b5[0], "bound_by": b5[1]},
        "k5_dense": {"base": DENSE_BASE, "valid": d_valid, "kept": kept4,
                     "ms": [k5d_a, k5d_b], "device_ms": dev["k5d"],
                     "setup_device_ms": dev["k5d_setup"],
                     "shape": shapes["k5d"], "plain_ms": [p5d_a, p5d_b],
                     "k4_ms_between": k4_c, "sass": counts["k5_dense_lane"],
                     "lane_cycles": c5d, "lane_cycles_this_and_earlier":
                         c5_lanes["k5_dense_lane"], "bound_ms": b5d[0],
                     "bound_by": b5d[1]},
        "k5_dense_full_run": {"valid": lanes_k1, "kept": kept4_full,
                              "ms": k5d_full_ms, "device_ms": dev["k5d_full"],
                              "shape": shapes["k5d_full"],
                              "bound_ms": b5d_full[0],
                              "bound_by": b5d_full[1]},
        "b510_segment": {
            "lanes": lanes_k1, "start": wide.range_start,
            "k1_ms": [k1_b510_a, k1_b510_b], "k1_device_ms": dev["k1_b510"],
            "k5_device_ms": dev["k5_b510"],
            "k5_setup_device_ms": dev["k5_b510_setup"],
            "k5_shape": shapes["k5_b510"],
            "k1_lane_need": wide_need["detailed_megaloop_kernel"],
            "k1_lane_cycles": c_wide["detailed_megaloop_kernel"],
            "k1_bound_ms": b1_510[0], "k1_bound_by": b1_510[1],
            "k5_ms": [k5_b510_a, k5_b510_b],
            "k5_lane_need": wide_need["detailed_megaloop_mma_kernel"],
            "k5_lane_cycles": c_wide["detailed_megaloop_mma_kernel"],
            "k5_bound_ms": b5_510[0], "k5_bound_by": b5_510[1]},
        "need_vs_lanes": held,
    }
    emit({"phase": "timing", **report["timing"]})
    # The kernels line gives each kernel's device time and tier.
    return [
        ("detailed_megaloop", "nice_tpu/ops/pallas_engine.py:181",
         dev["k1"], min(p1_a, p1_b), b1, shapes["k1"]["tier"]),
        ("uniques", "nice_tpu/ops/pallas_engine.py:466",
         dev["k2"], min(p2_a, p2_b), b2, shapes["k2"]["tier"]),
        ("strided_niceonly", "nice_tpu/ops/pallas_engine.py:410",
         dev["k3"], min(p3_a, p3_b), b3, shapes["k3"]["tier"]),
        ("niceonly_dense", "nice_tpu/ops/pallas_engine.py:181",
         dev["k4"], min(p4_a, p4_b), b4, shapes["k4"]["tier"]),
        ("detailed_megaloop_mma", "nice_tpu/ops/pallas_engine.py:181",
         dev["k5"], min(p5_a, p5_b), b5, shapes["k5"]["tier"]),
        ("niceonly_dense_mma", "nice_tpu/ops/pallas_engine.py:181",
         dev["k5d"], min(p5d_a, p5d_b), b5d, shapes["k5d"]["tier"]),
    ]


def _profiled(run_field, cpu: bool = True) -> dict:
    """run_field() under torch.profiler: wall time, device time and the
    device's idle share of the wall, and device time by kernel. cpu=False
    records the device alone, which spares the host loop the profiler's
    per-call tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if cpu else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
            "device_ms_by_kernel": dict(top),
            "device_ms_by_kernel_all": by_kernel}


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
        prof = _profiled(lambda: client.process_field(field, args))
        prof.pop("device_ms_by_kernel_all")
        report[key] = {"field": name, "mode": mode, **prof}
        emit({"phase": "profile", **report[key]})


# Phase obs: the extra-large field through process_field in three settings
# of the observability layer, each OBS_REPS times, in this order (a sampler
# thread, once started, lives as long as the process): no sampler and no
# heartbeat, the client's defaults, and the defaults with --stepprof.
OBS_REPS = 3
OBS_SETTINGS = (("off", (*SAMPLERS_OFF, "--telemetry-secs", "0")),
                ("defaults", ()),
                ("stepprof", ("--stepprof",)))
K1_SYMBOL = "detailed_megaloop_kernel"


def _k1_records(trace_path: str) -> int:
    """K1's device records in a torch.profiler Chrome trace (K5's
    detailed_megaloop_mma_kernel is not K1)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and K1_SYMBOL in e.get("name", ""))


def phase_obs(report: dict, tmp: str) -> None:
    """12. obs: the extra-large field through process_field OBS_REPS times
    in each of OBS_SETTINGS: each setting's median, min and max seconds,
    its stepprof fences and K1 launches a run (equal in every setting; no
    fence off the profiler, one a dispatch on it), the stepprof buckets
    (device_compute > 0, host_other >= 0); a memwatch sample after the
    field (in_use > 0, peak >= in_use, limit = mem_get_info's total); and
    a --profile-dir run whose Chrome trace holds one K1 device record per
    K1 launch."""
    import statistics

    import torch

    from nice_tpu_torch.client import main as client
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.obs import memwatch, stepprof, trace
    from nice_tpu_torch.ops import cuda_engine as ce

    xl = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    want = None
    settings = {}
    stepprof.reset()  # the server phase's fences are not this phase's
    for name, extra in OBS_SETTINGS:
        args = client.build_parser().parse_args(
            ["detailed", "--device", DEVICE, *extra])
        client.configure_obs(args)
        secs, k1, fences = [], [], []
        for _ in range(OBS_REPS):
            k1_0 = ce.LAUNCHES["detailed_megaloop"]
            f0 = stepprof.fence_count()
            results, elapsed = client.process_field(xl, args)
            secs.append(elapsed)
            k1.append(ce.LAUNCHES["detailed_megaloop"] - k1_0)
            fences.append(stepprof.fence_count() - f0)
            want = _pairs(results) if want is None else want
            check(_pairs(results) == want,
                  f"extra-large differs in the obs setting {name}")
        entry = {"median_secs": statistics.median(secs),
                 "min_secs": min(secs), "max_secs": max(secs), "secs": secs,
                 "k1_launches": k1, "fences": fences,
                 "fence_count": stepprof.fence_count()}
        if stepprof.enabled():
            b = dict(stepprof.LAST_BREAKDOWN)
            entry["buckets"] = {k: b[k] for k in (*stepprof.PHASES, "wall")}
            check(b["device_compute"] > 0 and b["host_other"] >= 0,
                  f"stepprof buckets {entry['buckets']}")
            check(fences == k1, f"fences {fences} != K1 launches {k1}")
        else:
            check(not any(fences), f"fences with the profiler off: {fences}")
        settings[name] = entry
    stepprof.configure(False)
    check(len({tuple(e["k1_launches"]) for e in settings.values()}) == 1
          and settings["off"]["k1_launches"][0] > 0,
          f"K1 launches differ between the settings: "
          f"{ {k: e['k1_launches'] for k, e in settings.items()} }")
    mem = memwatch.sample()
    dev = mem["devices"]["0"]
    limit = torch.cuda.mem_get_info(0)[1]
    check(dev["in_use"] > 0 and dev["peak"] >= dev["in_use"]
          and dev["limit"] == limit, f"memwatch {dev}, mem_get_info {limit}")
    prof_dir = os.path.join(tmp, "profile")
    attempts = []
    trace.configure(profile_dir=prof_dir)
    try:
        # torch.profiler loses records now and then (see kernel_ab's
        # device_ms): a run whose trace lost some is made again, three at
        # most.
        for _ in range(3):
            k1_0 = ce.LAUNCHES["detailed_megaloop"]
            client.process_field(xl, args)
            launched = ce.LAUNCHES["detailed_megaloop"] - k1_0
            newest = max(glob.glob(os.path.join(prof_dir, "*.json")),
                         key=os.path.getmtime)
            attempts.append({"launches": launched,
                             "k1_records": _k1_records(newest)})
            if attempts[-1]["k1_records"] == launched:
                break
    finally:
        trace.configure(None)
    check(attempts[-1]["k1_records"] == attempts[-1]["launches"] > 0,
          f"the profile-dir traces' K1 records against launches: {attempts}")
    report["obs"] = {"field": "extra-large", "card": report["card"],
                     "settings": settings,
                     "defaults_over_off": settings["defaults"]["median_secs"]
                     / settings["off"]["median_secs"],
                     "stepprof_over_off": settings["stepprof"]["median_secs"]
                     / settings["off"]["median_secs"],
                     "memwatch": dev, "mem_get_info_total": limit,
                     "profile_dir_runs": attempts}
    emit({"phase": "obs", **report["obs"]})


# The mesh phase: the slice counts of the logical-slice scaling run, its
# drills (mesh.dispatch specs; the item index puts the loss mid-field) and
# the item at which the checkpointed field fails with elastic off.
MESH_COUNTS = (1, 2, 4)
MESH_DRILL = "mesh.dispatch:dead:1@100"
MESH_DENSE_DRILL = "mesh.dispatch:dead@100"
MESH_CKPT_FAULT = "mesh.dispatch:dead@60"


def phase_mesh(report: dict, tmp: str) -> None:
    """13. mesh: fields on a mesh of slices (parallel/mesh.py and the
    engine's mesh path) through scripts/multichip_scaling.py, the launch
    counts set to 0 just before and read just after:
      * extra-large detailed on ["cuda:0"] * k for k in MESH_COUNTS (logical
        slices of the one card, each on its own stream; k = 1 is the
        one-device path): every pass equal to phase 6's one-device field;
        each k's median of 3 passes after a warm pass, a pass at feed depth
        0, its K1 launches and LAST_FEED_STATS; the drill MESH_DRILL on 4
        slices: equal, one reshard, 3 slices at the end;
      * the mid-range b40 field on 4 slices once, equal to phase 6's, with
        K2 on the slices that hold its near misses;
      * extra-large niceonly (K3) and b98-surviving (K4) on 1 and 2 slices,
        equal to phases 7 and 7b; b98 also runs MESH_DENSE_DRILL;
      * checkpoints across layouts: extra-large detailed on 4 slices,
        checkpointed every 16 items, with elastic off and MESH_CKPT_FAULT:
        it must raise DispatchError with a state of several remaining
        segments, which resumes on 2 slices and on 1, equal to phase 6;
      * the client: a single-shot detailed client with --devices
        cuda:0,cuda:0 against a fresh server: its log shows the field on 2
        slices, its submission is in the server's ledger and passes phase
        6's checks;
      * distinct cards: with more than one card, extra-large detailed on
        cuda:0..n-1 as above; with one, a line that says so and no pass."""
    import sqlite3

    import torch

    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.faults import injector as faults
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.parallel import mesh as pmesh
    from nice_tpu_torch.scripts import multichip_scaling as ms

    t0 = time.monotonic()
    card = report["card"]
    out: dict = {"card": card}

    def scale(key, mode, name, devices, counts, drill, want_drill_end=None,
              profile=False):
        data, want = FIELD_RESULTS[(mode, name)]
        ce.reset_launches()
        rep = ms.scaling(data.to_field_size(), data.base, devices, counts,
                         mode=mode, reps=3, want=ms.result_pairs(want),
                         drill=drill, profile=profile)
        rep["launches"] = dict(ce.LAUNCHES)
        out[key] = rep
        emit({"phase": "mesh", "run": key, "card": card, **{
            k: v for k, v in rep.items() if k != "counts"},
            "counts": [{k: r[k] for k in ("slices", "median_secs", "min_secs",
                                          "max_secs", "secs_vs_first",
                                          "depth0_secs", "idle_p50_us",
                                          "idle_p95_us", "launches", "equal",
                                          "profile")
                        if k in r}
                       | {"n_dev": (r["feed"]["n_dev_start"],
                                    r["feed"]["n_dev_end"]),
                          "dispatches": r["feed"].get("dispatches")}
                       for r in rep["counts"]]})
        check(all(r["equal"] for r in rep["counts"]),
              f"mesh {key}: a pass differs from the one-device field")
        for r in rep["counts"]:
            check(r["feed"]["n_dev_start"] == r["feed"]["n_dev_end"]
                  == r["slices"], f"mesh {key}: {r['feed']}")
        if drill is not None:
            d = rep["drill"]
            check(d["equal"] and d["reshards"] == 1
                  and d["n_dev_end"] == want_drill_end,
                  f"mesh {key}: the drill {d}")
        return rep

    slice0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    logical = [slice0] * max(MESH_COUNTS)
    xl = scale("extra_large", "detailed", "extra-large", logical, MESH_COUNTS,
               MESH_DRILL, 3, profile=DEVICE == "cuda")
    check(all(r["launches"].get("detailed_megaloop", 0) > 0
              for r in xl["counts"]), "mesh: K1 was not launched")

    # The rare path on the slices: mid-range's near misses.
    data, want = FIELD_RESULTS[("detailed", "mid-range")]
    ce.reset_launches()
    got = engine.process_range_detailed(data.to_field_size(), data.base,
                                        device=DEVICE, devices=logical)
    mid_launches = dict(ce.LAUNCHES)
    check(_pairs(got) == _pairs(want), "mesh: mid-range differs")
    check(mid_launches["uniques"] > 0, "mesh: mid-range never reached K2")
    out["mid_range"] = {"launches": mid_launches,
                        "feed": dict(engine.LAST_FEED_STATS)}
    emit({"phase": "mesh", "run": "mid_range", **out["mid_range"]})

    xn = scale("extra_large_niceonly", "niceonly", "extra-large", logical,
               (1, 2), None)
    check(xn["launches"]["strided_niceonly"] > 0, "mesh: K3 never launched")
    dn = scale("b98_surviving", "niceonly", "b98-surviving", logical, (1, 2),
               MESH_DENSE_DRILL, 1)
    check(dn["launches"]["niceonly_dense"] > 0, "mesh: K4 never launched")

    # Checkpoints across layouts.
    data, want = FIELD_RESULTS[("detailed", "extra-large")]
    states = []
    faults.configure(MESH_CKPT_FAULT)
    try:
        engine.process_range_detailed(
            data.to_field_size(), data.base, device=DEVICE, devices=logical,
            elastic=False, checkpoint_cb=states.append, checkpoint_batches=16,
            checkpoint_secs=0)
        raise SmokeFailure("mesh: the elastic-off field did not raise")
    except engine.DispatchError as e:
        state = e.state
    finally:
        faults.reset()
        pmesh.heal_devices()
    check(state is not None and len(state["remaining"]) > 1,
          f"mesh: the failed field's state: {state and state['remaining']}")
    resumed = {}
    for name, devices in (("2 slices", logical[:2]), ("1", None)):
        got = engine.process_range_detailed(data.to_field_size(), data.base,
                                            device=DEVICE, devices=devices,
                                            resume=state)
        check(_pairs(got) == _pairs(want), f"mesh: resumed on {name} differs")
        resumed[name] = dict(engine.LAST_FEED_STATS)
    out["ckpt"] = {"states": len(states), "remaining": len(state["remaining"]),
                   "cursor": state["cursor"],
                   "resumed_n_dev": {k: v["n_dev_start"]
                                     for k, v in resumed.items()}}
    emit({"phase": "mesh", "run": "ckpt", **out["ckpt"]})

    # The client against a fresh server.
    server_dir = os.path.join(tmp, "mesh-server")
    os.makedirs(server_dir)
    server, api, _ = _start_server(server_dir, _free_port())
    try:
        t1 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "nice_tpu_torch.client", "detailed",
             "--api-base", api, "--username", "chip-smoke-mesh",
             "--device", DEVICE, "--devices", ",".join(logical[:2]),
             "--telemetry-secs", "0", *SAMPLERS_OFF],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        secs = time.monotonic() - t1
    finally:
        _stop(server)
    check(proc.returncode == 0, f"the --devices client failed "
          f"({proc.returncode}):\n" + proc.stderr[-3000:])
    check("on 2 slices" in proc.stderr,
          "the --devices client's field did not run on 2 slices")
    db_path = os.path.join(server_dir, "nice.db")
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT c.id, f.base_id, f.range_start, f.range_end FROM claims c "
            "JOIN fields f ON f.id = c.field_id").fetchall()
    finally:
        conn.close()
    check(len(rows) == 1, f"the --devices client's claims: {rows}")
    claim_id, base, start, end = rows[0]
    start, end = int(start), int(end)
    claim = DataToClient(claim_id=claim_id, base=int(base), range_start=start,
                         range_end=end, range_size=end - start)
    near = _check_field(claim, _read_submission(db_path, claim_id))
    out["client"] = {"secs": secs, "claim_id": claim_id, "base": int(base),
                     "range_start": start, "near_misses": near}
    emit({"phase": "mesh", "run": "client", **out["client"]})

    n_cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if n_cards > 1:
        cards = [f"cuda:{i}" for i in range(n_cards)]
        scale("distinct_cards", "detailed", "extra-large", cards,
              (1, n_cards), "mesh.dispatch:dead@40", n_cards - 1)
    else:
        out["distinct_cards"] = "not run: this machine has one card"
        emit({"phase": "mesh", "run": "distinct_cards",
              "not_run": f"{n_cards} card"})
    out["secs"] = time.monotonic() - t0
    report["mesh"] = out
    emit({"phase": "mesh", "secs": out["secs"]})


# The threads phase: the arguments of the lockdep run beyond the fields
# (none on the card: full width), the linters run on this machine beside it
# (racelint runs after it, on its graph), and the lockdep run's results,
# keyed by the lockdep-off field each must equal.
THREADS_ARGV: tuple = ()
THREADS_LINTERS = (("nicelint", ("--strict",)), ("cudalint", ("--strict",)),
                   ("racecheck", ()))
THREADS_WANT = {"extra-large": ("detailed", "extra-large"),
                "mid-range": ("detailed", "mid-range"),
                "extra-large-niceonly": ("niceonly", "extra-large"),
                "b98-surviving": ("niceonly", "b98-surviving"),
                "mesh-drill": ("detailed", "extra-large"),
                "sched-canon": ("detailed", "extra-large"),
                "sched-nice": ("niceonly", "extra-large")}


def phase_threads(report: dict, tmp: str) -> None:
    """14. threads: the thread twin on the card.
      * the off path in this process (lockdep off): no factory hook, the
        port's locks plain threading.Locks (make_lock's and the module
        locks' type), make_lock's lock as fast as a raw one;
      * a lockdep run of the main paths in a fresh process (python -m
        nice_tpu_torch.utils.lockdep --device cuda, every lock built
        instrumented): extra-large detailed (K1) while nice-prefetch warms
        b95, lockdep.PREFETCH_BASE (its nvcc build: a library an earlier run
        left is removed first), mid-range (K2), extra-large niceonly (K3),
        b98-surviving (K4), extra-large on 4 logical slices under
        MESH_DRILL, and a
        two-tenant scheduler run with sched-slo, with the obs samplers, the
        metrics server, stepprof and a checkpoint ticker on. The run fails
        itself where a step launched none of its kernels (K1-K4); every
        field must equal its lockdep-off result from the phases before, and
        no order-cycle may be recorded. Printed: the graph's nodes and
        edges, the long holds by thread and lock (reported, not failed);
      * racelint --strict on the run's graph (R2's static/runtime
        cross-check against X1's graph), and the other linters
        (THREADS_LINTERS: nicelint, cudalint --strict and racecheck) on
        this machine, beside the lockdep run: each must exit 0.
    One {"threads": {...}} line."""
    import _thread
    import collections

    from nice_tpu_torch.analysis import schedex
    from nice_tpu_torch.faults import injector as faults
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan
    from nice_tpu_torch.parallel import mesh as pmesh
    from nice_tpu_torch.utils import lockdep

    t0 = time.monotonic()
    out: dict = {"card": report["card"]}

    # The off path.
    plain = _thread.LockType  # the type of a plain threading.Lock()
    zero = schedex.zero_cost_report()
    module_locks = {"ops.engine._mesh_cache_lock": engine._mesh_cache_lock,
                    "ops.cuda_build._lock": cuda_build._lock,
                    "parallel.mesh._dead_lock": pmesh._dead_lock,
                    "faults.injector._plan_lock": faults._plan_lock}
    out["off"] = {"lockdep": lockdep.enabled(),
                  "factory_hook": lockdep.factory_hook() is not None,
                  "minted_type": zero["minted_type"],
                  "module_locks_plain": all(type(v) is plain
                                            for v in module_locks.values()),
                  "raw_ns_per_op": zero["raw_ns_per_op"],
                  "minted_ns_per_op": zero["minted_ns_per_op"],
                  "ratio": zero["ratio"]}
    check(not out["off"]["lockdep"] and not out["off"]["factory_hook"]
          and zero["minted_is_plain"] and out["off"]["module_locks_plain"],
          f"threads: the off path is not plain: {out['off']}")

    # No phase before builds the prefetch base; a library an earlier run of
    # this checkout left is removed, so that the warm builds it.
    header = ce.plan_header(get_plan(lockdep.PREFETCH_BASE))
    key_dir = os.path.join(cuda_build.BUILD_DIR, "plan-" + cuda_build.plan_build_key(
        cuda_build.find_nvcc(), header))
    check(header not in cuda_build.PLAN_BUILDS,
          f"threads: b{lockdep.PREFETCH_BASE}'s library was loaded before")
    out["prefetch_lib_left_by_earlier_run"] = os.path.isdir(key_dir)
    shutil.rmtree(key_dir, ignore_errors=True)
    lib = os.path.join(key_dir, cuda_build.LIB_NAME)

    graph = os.path.join(tmp, "lockorder.json")
    results = os.path.join(tmp, "lockdep.json")
    mid, _ = FIELD_RESULTS[("detailed", "mid-range")]
    b98, _ = FIELD_RESULTS[("niceonly", "b98-surviving")]
    cmd = [sys.executable, "-m", "nice_tpu_torch.utils.lockdep",
           "--device", DEVICE, "--dump-graph", graph, "--no-merge",
           "--results", results, "--mid-range-start", str(mid.range_start),
           "--dense-start", str(b98.range_start),
           "--drill", MESH_DRILL, *THREADS_ARGV]
    racecheck_json = os.path.join(tmp, "racecheck.json")

    def linter(name, *extra):
        argv = [sys.executable, "-m", f"nice_tpu_torch.scripts.{name}", *extra]
        return time.monotonic(), subprocess.Popen(
            argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    linters = {name: linter(name, *extra,
                            *(("--json", racecheck_json)
                              if name == "racecheck" else ()))
               for name, extra in THREADS_LINTERS}
    t1 = time.monotonic()
    lint = {}
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        out["lockdep_secs"] = time.monotonic() - t1
        check(proc.returncode == 0, f"threads: the lockdep run failed "
              f"({proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        linters["racelint"] = linter("racelint", "--strict", "--lockorder",
                                     graph)
    finally:
        for name, (started, p) in linters.items():
            try:
                text, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            lint[name] = {"rc": p.returncode,
                          "done_within_secs": time.monotonic() - started,
                          "last": text.strip().splitlines()[-1:] if text else [],
                          "text": text}
    with open(results) as f:
        run = json.load(f)

    # Each field against its lockdep-off result.
    equal = {}
    for key, want_key in THREADS_WANT.items():
        check(key in run["results"], f"threads: the lockdep run has no {key}")
        equal[key] = run["results"][key] == list(_pairs(FIELD_RESULTS[want_key][1]))
    check(all(equal.values()), f"threads: lockdep-on fields differ: {equal}")
    check(os.path.isfile(lib) and run.get("prefetch_nvcc_secs", 0) > 0,
          f"threads: the prefetch warm did not build "
          f"b{lockdep.PREFETCH_BASE}'s library")

    # The graph: no cycle of its own (racelint's R2 holds it against X1's).
    edges = {k: set(v) for k, v in run["observed_edges"].items()}
    cycles = [v for v in run["violations"] if v["kind"] == "order-cycle"]
    check(not cycles, f"threads: order cycles recorded: {cycles}")
    holds: dict = collections.defaultdict(lambda: {"count": 0, "max_secs": 0.0})
    for v in run["violations"]:
        if v["kind"] == "long-hold":
            h = holds[f"{v['thread']}|{v['lock']}"]
            h["count"] += 1
            h["max_secs"] = max(h["max_secs"], v["held_secs"])

    for name, r in lint.items():
        check(r["rc"] == 0, f"threads: {name} failed ({r['rc']}):\n"
              + r["text"][-3000:])
    with open(racecheck_json) as f:
        rc = json.load(f)
    nodes = sorted(set(edges) | {b for bs in edges.values() for b in bs})
    out.update({
        "ran": run["ran"], "field_secs": run.get("secs"),
        "fields_equal": equal, "launches": run["launches"],
        "prefetch_base": lockdep.PREFETCH_BASE,
        "prefetch_nvcc_secs": run.get("prefetch_nvcc_secs"),
        "checkpoints": run.get("checkpoints"), "mesh": run.get("mesh"),
        "sched_pages": run.get("sched_pages"),
        "nodes": nodes, "edges": {k: sorted(v) for k, v in sorted(edges.items())},
        "n_edges": sum(len(v) for v in edges.values()),
        "order_cycles": len(cycles), "long_holds": dict(holds),
        "linters": {k: {"rc": v["rc"], "done_within_secs": v["done_within_secs"],
                        "last": v["last"]}
                    for k, v in lint.items()},
        "racecheck": {k: v["verdict"] for k, v in rc["scenarios"].items()},
        "racecheck_zero_cost": rc["bench_schedex_off"]["minted_type"]})
    out["secs"] = time.monotonic() - t0
    report["threads"] = out
    emit({"threads": out})


CHAOS_TIMEOUT = 900


def phase_chaos(report: dict) -> None:
    """15. chaos: the drill in a subprocess on the card (module doc); any
    failure it reports fails the smoke, and its clients must have run K1
    on the card."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "nice_tpu_torch.scripts.chaos_smoke",
         "--device", DEVICE], cwd=REPO, capture_output=True, text=True,
        timeout=CHAOS_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    check(bool(lines), "chaos: no output:\n" + proc.stderr[-3000:])
    out = json.loads(lines[-1])
    out["secs"] = time.monotonic() - t0
    check(proc.returncode == 0 and out["ok"],
          f"chaos: the drill failed ({proc.returncode}): {out['failures']}")
    check(out["fields"] == 6 and out["submissions"] == 6,
          f"chaos: {out['submissions']} submissions over {out['fields']} "
          "fields")
    check(out["server_killed"] and out["dropped_responses"] >= 1
          and out["duplicate_replays"] >= 1 and out["dispatch_faults"] >= 1,
          f"chaos: a fault did not fire: {out}")
    check(out["resumed_claims"].get(str(out["faulted_claim"]))
          == out["faulted_cursor"], f"chaos: the faulted claim was not "
          f"resumed from its snapshot: {out}")
    check(out["k1_segments"].get(DEVICE, 0) > 0,
          f"chaos: no K1 segment ran on {DEVICE}: {out['k1_segments']}")
    report["chaos"] = out
    emit({"chaos": out})


GATE_RECORD = "TORCH_BENCH_r01.json"


def phase_gate(report: dict, tmp: str) -> None:
    """16. gate: perf_gate's legs against the committed record (module
    doc), then its bench leg against a copy with every compared case's
    value doubled, which must flag each of them and exit 1 under
    --strict. A record of another card name is stamped with this card's for
    the copy (the flags check the diff, not the card). The first run is a
    fresh process, as a user runs the gate: this one has run the obs
    samplers since phase 12, whose wake-ups land in the feed thread's
    hand-offs (a smoke that ran it in process: feed idle 0.89 at the
    default depth against 0.78 at depth 0)."""
    from nice_tpu_torch.scripts import perf_gate

    t0 = time.monotonic()
    out1 = os.path.join(tmp, "gate.json")
    proc = subprocess.run(
        [sys.executable, "-m", "nice_tpu_torch.scripts.perf_gate",
         "--device", DEVICE, "--out", out1], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    rc1 = proc.returncode
    check(os.path.isfile(out1), f"gate: no report ({rc1}):\n"
          + proc.stdout[-2000:] + proc.stderr[-2000:])
    with open(out1) as f:
        gate = json.load(f)
    errors = {leg: v["error"] for leg, v in gate["legs"].items()
              if "error" in v}
    check(rc1 == 0 and not errors and "error" not in gate["regression"]["bench"],
          f"gate: a leg failed: {errors or gate['regression']['bench']}")
    for leg in ("stepprof", "feed-idle"):
        check(not gate["legs"][leg]["problems"],
              f"gate: the {leg} leg: {gate['legs'][leg]['problems']}")
    bench = gate["regression"]["bench"]
    sp = gate["stepprof"]

    with open(os.path.join(REPO, GATE_RECORD)) as f:
        record = json.load(f)
    compared = sorted(bench.get("cases") or
                      [c for c, v in record["parsed"]["suite"].items()
                       if not v.get("skipped") and "error" not in v])
    for case in compared:
        record["parsed"]["suite"][case]["value"] *= 2
    restamped = bench["baseline"] != GATE_RECORD
    if restamped:
        record["card"] = gate["card"]
    doubled = os.path.join(tmp, "doubled")
    os.makedirs(doubled)
    with open(os.path.join(doubled, GATE_RECORD), "w") as f:
        json.dump(record, f)
    out2 = os.path.join(tmp, "gate_doubled.json")
    rc2 = perf_gate.main(["--device", DEVICE, "--records-dir", doubled,
                          "--legs", "bench", "--strict", "--out", out2])
    with open(out2) as f:
        cases2 = json.load(f)["regression"]["bench"].get("cases", {})
    flagged = sorted(c for c, v in cases2.items() if v["regressed"])
    check(rc2 == 1 and compared and flagged == compared,
          f"gate: the doubled record flagged {flagged} of {compared} "
          f"(exit {rc2})")
    out = {
        "card": gate["card"], "baseline": bench["baseline"],
        "note": bench.get("note"), "cases": bench.get("cases"),
        "critpath": bench.get("critpath"), "peak_mem": bench.get("peak_mem"),
        "problems": gate["problems"],
        "stepprof": {"fences_off": sp["profiler_off"]["fences"],
                     "fences_on": sp["profiler_on"]["fences"],
                     "reconciliation": sp["reconciliation"],
                     "overhead_frac_on_vs_off": sp["overhead_frac_on_vs_off"]},
        "feed_idle": sp["feed_idle"],
        "doubled": {"rc": rc2, "compared": compared, "flagged": flagged,
                    "restamped": restamped},
        "leg_secs": {leg: v["secs"] for leg, v in gate["legs"].items()},
        "secs": time.monotonic() - t0}
    report["gate"] = out
    emit({"gate": out})


# The sched phase's tenants (name, kind, field, priority); the hi-base sweep
# tenant's base and numbers (the first of its range: two pages at the
# default shape).
SCHED_SWEEP_BASE = 520
SCHED_SWEEP_NUMBERS = 1 << 24
SCHED_TENANTS_SPEC = ("canon:detailed:40:prio=3;nice:niceonly:40:prio=1;"
                      "mining:near-miss:40")
# Kernels each local tenant must launch (cuda_engine.LAUNCHES keys).
SCHED_KERNELS = {"canon": ("detailed_megaloop",),
                 "mining": ("detailed_megaloop", "uniques"),
                 "nice": ("strided_niceonly",),
                 "dense": ("niceonly_dense",),
                 "sweep": ("detailed_megaloop",)}


def _sched_class():
    """MultiTenantScheduler that keeps, by tenant, each page's seconds, the
    kernels its pages launched (cuda_engine.LAUNCHES deltas) and the
    engine's split of each page (the niceonly pipelines' stats)."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.sched import MultiTenantScheduler

    class Counting(MultiTenantScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.page_secs = {s.name: [] for s in self.registry}
            self.launches = {s.name: {} for s in self.registry}
            self.split = {s.name: {} for s in self.registry}

        def _execute_page(self, spec, page):
            before = dict(ce.LAUNCHES)
            t0 = time.monotonic()
            out = super()._execute_page(spec, page)
            self.page_secs[spec.name].append(time.monotonic() - t0)
            mine = self.launches[spec.name]
            for k, v in ce.LAUNCHES.items():
                if v != before[k]:
                    mine[k] = mine.get(k, 0) + v - before[k]
            if spec.mode == "niceonly":
                st = engine.LAST_NICEONLY_STATS
                split = self.split[spec.name]
                for k in ("wall", "msd_busy", "collect_busy", "gen", "disp",
                          "msd_secs", "loop_secs"):
                    if k in st:
                        split[k] = split.get(k, 0.0) + float(st[k])
            return out

    return Counting


def _sched_run(fields: dict, specs: list, solo: dict, policy: str,
               quantum_secs: float) -> dict:
    """One scheduler run of `fields` ({tenant: DataToClient}) on the card,
    the launch counts set to 0 just before it and read just after; every
    assembled field must equal its solo run. Returns the run's record."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.sched import StaticSource, TenantRegistry

    source = StaticSource({name: [(name, d.base, d.range_start, d.range_end)]
                           for name, d in fields.items()})
    scheduler = _sched_class()(TenantRegistry(specs), source, policy=policy,
                               quantum_secs=quantum_secs, device=DEVICE)
    ce.reset_launches()
    t0 = time.monotonic()
    stats = scheduler.run()
    secs = time.monotonic() - t0
    launches = dict(ce.LAUNCHES)
    check(scheduler.table.check_invariants() == [], "page table invariants")
    for name in fields:
        got = source.results[name].get(name)
        check(got is not None and _pairs(got) == _pairs(solo[name][0]),
              f"{policy}: tenant {name}'s field differs from its solo run")
        for k in SCHED_KERNELS[name]:
            check(scheduler.launches[name].get(k, 0) > 0,
                  f"{policy}: tenant {name} never launched {k}: "
                  f"{scheduler.launches[name]}")
    check(sum(v for k, v in launches.items()) ==
          sum(sum(t.values()) for t in scheduler.launches.values()),
          "launches outside the tenants' pages")
    solo_secs = sum(solo[name][1] for name in fields)
    tenants = {}
    for name, t in stats["tenants"].items():
        ps = scheduler.page_secs[name]
        tenants[name] = {
            "numbers": fields[name].range_size,
            "pages": t["pages"], "preemptions": t["preemptions"],
            "starved": t["starved"], "busy_secs": t["busy_secs"],
            "solo_secs": solo[name][1],
            "busy_vs_solo": t["busy_secs"] / solo[name][1],
            "page_secs_mean": sum(ps) / len(ps), "page_secs_max": max(ps),
            "page_secs_min": min(ps),
            "share": scheduler.meter.shares().get(name, 0.0),
            "launches": scheduler.launches[name],
            "split": scheduler.split[name]}
    return {"policy": policy, "quantum_secs": quantum_secs,
            "page_batches": scheduler.table.page_batches,
            "rounds": stats["rounds"], "interleaved_secs": secs,
            "solo_secs_sum": solo_secs, "vs_sequential": solo_secs / secs,
            "occupancy": stats["occupancy"], "launches": launches,
            "tenants": tenants}


def phase_sched(report: dict) -> None:
    """The multi-tenant scheduler on the card, at full width: the tenants
    canon (detailed, extra-large, prio 3), mining (near-miss, the mid-range
    b40 field, prio 0), nice (niceonly, extra-large, prio 1) and dense
    (niceonly, b98-surviving, prio 1), each field 1e9 numbers, built
    (scheduler.warm) and then run solo through process_range_* (timed);
    then a run under deficit at the default page size and quantum, and one
    under rr with quantum_secs=1e-9 (a preemption at every page boundary)
    that also holds the hi-base sweep tenant (b520, the first 2^24 numbers
    of its range). Each run sets the launch counts to 0 just before and
    reads them just after; every assembled field must equal its solo run
    exactly, and each tenant must have launched its kernels (canon K1,
    mining K1 and K2, nice K3, dense K4, sweep K1). Printed: pages,
    preemptions, starved counts, occupancy shares and launches by tenant,
    seconds a page, each tenant's busy seconds against its solo seconds,
    and the interleaved seconds against the sum of the solo seconds
    (vs_sequential)."""
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
    from nice_tpu_torch.core.types import DataToClient
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan
    from nice_tpu_torch.sched import (MultiTenantScheduler, StaticSource,
                                      TenantRegistry, TenantSpec,
                                      hi_base_sweep_tenant, near_miss_tenant)

    xl = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    lo = get_plan(SCHED_SWEEP_BASE).range_start
    fields = {"canon": xl, "mining": _mid_range_field(SERVER_BASE), "nice": xl,
              "dense": FIELD_RESULTS[("niceonly", "b98-surviving")][0],
              "sweep": DataToClient(claim_id=0, base=SCHED_SWEEP_BASE,
                                    range_start=lo,
                                    range_end=lo + SCHED_SWEEP_NUMBERS,
                                    range_size=SCHED_SWEEP_NUMBERS)}
    specs = {"canon": TenantSpec(name="canon", mode="detailed", base=40,
                                 priority=3),
             "mining": near_miss_tenant(40, name="mining"),
             "nice": TenantSpec(name="nice", mode="niceonly", base=40,
                                priority=1),
             "dense": TenantSpec(name="dense", mode="niceonly",
                                 base=DENSE_BASE, priority=1),
             "sweep": hi_base_sweep_tenant(SCHED_SWEEP_BASE, name="sweep")}
    t0 = time.monotonic()
    MultiTenantScheduler(TenantRegistry(specs.values()), StaticSource({}),
                         device=DEVICE).warm()
    warm_secs = time.monotonic() - t0
    solo = {}
    for name, data in fields.items():
        process = (engine.process_range_detailed
                   if specs[name].mode == "detailed"
                   else engine.process_range_niceonly)
        t0 = time.monotonic()
        results = process(data.to_field_size(), data.base, device=DEVICE)
        solo[name] = (results, time.monotonic() - t0)
    for name in ("canon", "mining", "dense"):
        mode = "detailed" if specs[name].mode == "detailed" else "niceonly"
        key = {"canon": "extra-large", "mining": "mid-range",
               "dense": "b98-surviving"}[name]
        check(_pairs(solo[name][0]) == _pairs(FIELD_RESULTS[(mode, key)][1]),
              f"the solo run of {name} differs from phase 6/7b's")
    check(solo["mining"][0].nice_numbers != (), "mid-range holds no near miss")
    four = ("canon", "mining", "nice", "dense")
    runs = [
        _sched_run({n: fields[n] for n in four}, [specs[n] for n in four],
                   solo, "deficit", 5.0),
        _sched_run(fields, list(specs.values()), solo, "rr", 1e-9),
    ]
    check(runs[1]["tenants"]["sweep"]["pages"] == 2,
          f"the sweep tenant ran {runs[1]['tenants']['sweep']['pages']} pages")
    check(all(t["preemptions"] > 0 for name, t in runs[1]["tenants"].items()
              if t["pages"] > 1), "rr: a tenant was never preempted")
    report["sched"] = {"warm_secs": warm_secs,
                       "solo_secs": {n: s for n, (_, s) in solo.items()},
                       "runs": runs}
    for run in runs:
        emit({"phase": "sched", **run})


def phase_sched_server(report: dict, api: str, db_path: str) -> None:
    """`python -m nice_tpu_torch.client --tenants "canon:detailed:40:prio=3;
    nice:niceonly:40:prio=1;mining:near-miss:40"` in a subprocess against
    the server at `api`, on the card: exit code 0, one claim row stamped
    with each tenant's name (the server's claims.tenant), and each claim's
    submission accepted (its row in the server's ledger) and passing the
    phase 6 / 7 checks."""
    import sqlite3

    from nice_tpu_torch.core.types import DataToClient, FieldResults

    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "nice_tpu_torch.client", "--api-base", api,
         "--username", "chip-smoke-tenants", "--tenants", SCHED_TENANTS_SPEC,
         "--device", DEVICE, *SAMPLERS_OFF],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.monotonic() - t0
    check(proc.returncode == 0,
          f"the --tenants client failed ({proc.returncode}):\n"
          + proc.stderr[-3000:])
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.execute(
            "SELECT c.id, c.tenant, c.search_mode, f.base_id, f.range_start, "
            "f.range_end FROM claims c JOIN fields f ON f.id = c.field_id "
            "WHERE c.tenant IS NOT NULL ORDER BY c.id").fetchall()
    finally:
        conn.close()
    check(sorted(r[1] for r in rows) == ["canon", "mining", "nice"],
          f"tenant claim rows: {rows}")
    claims = []
    for claim_id, tenant, mode, base, start, end in rows:
        start, end = int(start), int(end)
        data = DataToClient(claim_id=claim_id, base=int(base),
                            range_start=start, range_end=end,
                            range_size=end - start)
        got = _read_submission(db_path, claim_id)  # exactly one row
        if tenant == "nice":
            check(mode == "niceonly", f"nice claimed {mode}")
            checked = _check_niceonly(data, FieldResults((), got.nice_numbers))
        else:
            check(mode == "detailed", f"{tenant} claimed {mode}")
            checked = {"near_misses": _check_field(data, got)}
        claims.append({"tenant": tenant, "claim_id": claim_id, "mode": mode,
                       "base": data.base, "range_start": start,
                       "numbers": data.range_size, **checked})
    done = [line for line in proc.stderr.splitlines()
            if "scheduler done" in line]
    report["sched_server"] = {"secs": secs, "claims": claims,
                              "log": done[-1][-300:] if done else None}
    emit({"phase": "sched_server", **report["sched_server"]})


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

    global T_START
    t_start = T_START = time.monotonic()
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

    built = phase_build(report, tmp)
    phase_prefetch(report)
    phase_kernel_vs_plain(report)
    phase_strided_vs_plain(report)
    phase_dense_vs_plain(report)
    phase_mxu_vs_plain(report)
    phase_kernelspec(report)
    phase_golden(report)
    phase_host_engines(report)
    phase_full_width(report)
    phase_full_width_niceonly(report)
    phase_full_width_dense(report)
    phase_pipeline(report)
    phase_tuned(report, tmp)
    phase_blocks(report)
    server_dir = os.path.join(tmp, "server")
    os.makedirs(server_dir)
    server, api, _ = _start_server(server_dir, _free_port())
    try:
        phase_server(report, api, os.path.join(server_dir, "nice.db"))
        phase_fleet(report, api, server_dir)
        phase_sched_server(report, api, os.path.join(server_dir, "nice.db"))
    finally:
        _stop(server)
    phase_crash_resume(report)
    phase_bench(report)
    phase_main_shapes(report)
    timed = phase_timing(report, built, sms, clk_mhz)
    phase_profile(report)
    phase_pipeline_profile(report)
    phase_sched(report)
    phase_obs(report, tmp)
    phase_mesh(report, tmp)
    phase_threads(report, tmp)
    phase_chaos(report)
    phase_gate(report, tmp)
    kernel_ms = {name: ms for name, _, ms, _, _, _ in timed}
    for run in report["full_width"]["fields"]:
        est = _kernel_ms_est(run["launches"], kernel_ms)
        run["kernel_ms_est"] = est
        run["kernel_share_est"] = est / (run["elapsed_secs"] * 1e3)
        emit({"phase": "where_time_goes", "field": run["field"],
              "elapsed_ms": run["elapsed_secs"] * 1e3, "kernel_ms_est": est,
              "kernel_share_est": run["kernel_share_est"]})
    k3_group_ms = {SERVER_BASE: kernel_ms["strided_niceonly"],
                   80: report["timing"]["k3_b80"]["device_ms"]}
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
        # wall = MSD filter (up front) + the pipelined loop of runs; K4's
        # share of the loop is about launches x a typical run.
        st = run["stats"]
        k4_est = run["launches"]["niceonly_dense"] * kernel_ms["niceonly_dense"]
        emit({"phase": "where_time_goes", "field": run["field"],
              "mode": "niceonly", "base": run["base"],
              "elapsed_ms": run["elapsed_secs"] * 1e3,
              "msd_ms": st["msd_secs"] * 1e3, "loop_ms": st["loop_secs"] * 1e3,
              "runs": st["runs"], "k4_launches": run["launches"]["niceonly_dense"],
              "k4_ms_est": k4_est,
              "host_loop_ms_est": st["loop_secs"] * 1e3 - k4_est})

    for run in report["sched"]["runs"]:
        # A tenant's busy seconds less its kernels' estimated time, over its
        # pages: the fixed cost a page pays for being its own engine call.
        for name, t in run["tenants"].items():
            if name == "sweep":  # b520: no kernel timed at that base
                continue
            est = _kernel_ms_est(t["launches"], kernel_ms)
            emit({"phase": "where_time_goes", "sched": run["policy"],
                  "tenant": name, "pages": t["pages"],
                  "busy_ms": t["busy_secs"] * 1e3,
                  "solo_ms": t["solo_secs"] * 1e3, "kernel_ms_est": est,
                  "fixed_ms_per_page_est":
                      (t["busy_secs"] * 1e3 - est) / t["pages"],
                  "split_ms": {k: v * 1e3 for k, v in t["split"].items()}})

    for run in report["tuned"]["k5_runs"]:
        # K5 in K1's and K4's place on the same fields, the same process.
        default = next(
            r for key in ("full_width", "full_width_dense")
            for r in report[key]["fields"] if r["field"] == run["field"])
        est = _kernel_ms_est(run["launches"], kernel_ms)
        emit({"phase": "where_time_goes", "field": run["field"],
              "mode": run["mode"], "use_mxu": 1,
              "elapsed_ms": run["elapsed_secs"] * 1e3,
              "use_mxu_0_elapsed_ms": default["elapsed_secs"] * 1e3,
              "kernel_ms_est": est})

    kernel_bases = {"detailed_megaloop": BASES, "uniques": BASES,
                    "strided_niceonly": STRIDED_BASES,
                    "niceonly_dense": DENSE_BASES,
                    "detailed_megaloop_mma": K5_DETAILED_BASES,
                    "niceonly_dense_mma": K5_DENSE_BASES}
    k5_diff = {k: max(report["mxu_vs_plain"]["max_abs_diff"][k],
                      report["mxu_vs_plain"]["max_abs_diff_vs_k1_k4"][k],
                      report["main_shapes"]["max_abs_diff_vs_k1_k4"][k])
               for k in ("detailed_megaloop_mma", "niceonly_dense_mma")}
    vs_plain = dict(report["kernel_vs_plain"]["max_abs_diff"],
                    strided_niceonly=report["strided_vs_plain"]["max_abs_diff"],
                    niceonly_dense=report["dense_vs_plain"]["max_abs_diff"],
                    **k5_diff)
    kernels = []
    for name, replaces, ms, plain_ms, (b_ms, b_by), tier in timed:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nice_tpu_torch/csrc/" + (
                "plan_kernels.cu" if tier == "plan" else "nice_kernels.cu"),
            "tier": tier, "replaces": replaces,
            "launches": report["main_path_launches"][name],
            "max_abs_err": max(vs_plain[name],
                               report["main_shapes"]["max_abs_diff"][name]),
            "bases": list(kernel_bases[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        if name == "detailed_megaloop":
            kernels[-1]["plan_tier_launches"] = (
                report["main_path_launches"]["detailed_megaloop_plan"])
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
