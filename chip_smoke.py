"""On-card smoke run of the PyTorch/CUDA port (nice_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out REPORT.json]

Phases, each of which raises (exit code 1) on failure:
  1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc builds the kernels from csrc/ at first use, timed;
  3. kernel vs plain: K1 (detailed megaloop) and K2 (per-lane uniques, plus
     survivor compaction) against their plain PyTorch versions on the card,
     exact integer equality, at b10, b17, b40, b50, b80, b97 and b510, from
     range_start and from a start straddling a 2^32 limb carry;
  4. golden and oracle fields: base-ten must give [(69, 10)] and the scalar
     oracle's histogram; default (1e6 @ b40) on the card must equal the same
     field through the plain path on the CPU;
  5. full width (the main path, launch counts read around it): the
     extra-large field (1e9 numbers @ b40) and a seeded mid-range b40 field
     of 1e9, through the client's process_field; bins 1..40 must sum to 1e9,
     the scalar oracle must confirm every near miss, a seeded slice must
     agree with the oracle, and both K1 and K2 must have been launched;
  6. claim -> process -> submit: the repository's coordination server in a
     separate process (python -m nice_tpu.server, seeded with b40 fields of
     1e9), one single-shot client run on the card against it; the submit
     must be accepted and the server's spot check must pass;
  7. main-path shapes: K1 over one whole 2^18 x 8 segment and K2 (with the
     survivor compaction) over one 2^18 rare-scan sub-batch at b40, against
     their plain versions, exact, from extra-large's start and from the
     segment and sub-batch that hold the mid-range field's first near miss;
  8. timing at those shapes: each kernel beside its plain version, and a
     bound from the instructions one lane issues in the compiled code
     (csrc/op_count.cu built with the b40 plan as a constant, counted with
     cuobjdump); then the kernels' estimated share of each main-path
     field's time (launches x kernel time / field time);
  9. profile: the mid-range field once more under torch.profiler, for the
     device's busy and idle share of its wall time.
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
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))

BASES = (10, 17, 40, 50, 80, 97, 510)
SEED = 20261016
DEVICE = "cuda"
SERVER_BASE = 40
SERVER_FIELD_SIZE = 1_000_000_000  # the server's default --field-size

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
              "POPC": "popc"}
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

def sass_counts(plan) -> dict:
    """Instructions one lane of each kernel issues at this base, read from
    the compiled code: nvcc builds csrc/op_count.cu with the plan as a
    compile-time constant (every loop unrolls, so each function there is
    straight-line) and cuobjdump lists its SASS (see parse_sass)."""
    from nice_tpu_torch.ops import cuda_build
    from nice_tpu_torch.ops import cuda_engine as ce

    nvcc = cuda_build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory(prefix="nice-op-count-") as tmp:
        with open(os.path.join(tmp, "op_count_plan.h"), "w") as f:
            words = ", ".join(f"{w}ull" for w in ce.plan_words(plan))
            f.write(f"#define NICE_PLAN {words}\n")
        cubin = os.path.join(tmp, "op_count.cubin")
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-cubin", "-I", tmp, "-o", cubin,
             os.path.join(cuda_build.CSRC_DIR, "op_count.cu")],
            check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    funcs = parse_sass(sass)
    check({"k1_lane", "k2_lane"} <= set(funcs), f"op_count functions: {list(funcs)}")
    return funcs


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
    or the busiest integer class at its own rate, whichever is more."""
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

def phase_build(report: dict) -> None:
    from nice_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    cuda_build.load()
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
    report["build"] = {"nvcc_secs": info["seconds"],
                       "load_secs": time.monotonic() - t0,
                       "ptxas": resources}
    emit({"phase": "build", **report["build"]})


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


def phase_golden(report: dict) -> None:
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
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
                        "spot_checks": spot}
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


def phase_main_shapes(report: dict) -> None:
    """K1 and K2 against their plain versions at the shapes the main path
    gives them: K1 over a whole 2^18 x 8 segment with every lane valid, K2
    (and the survivor compaction after it) over one rare-scan sub-batch;
    exact equality."""
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
    diff = {"detailed_megaloop": 0, "uniques": 0}
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
    torch.cuda.synchronize()
    report["main_shapes"] = {"base": plan.base, "max_abs_diff": diff,
                             "cases": cases}
    emit({"phase": "main_shapes", **report["main_shapes"]})
    check(all(v == 0 for v in diff.values()), f"kernel != plain: {diff}")
    check(cases[1]["near_misses"] > 0 and cases[3]["survivors"] > 0,
          f"the near-miss segment found none: {cases}")


def phase_timing(report: dict, sms: int, clk_mhz: float) -> list:
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
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
    counts = sass_counts(plan)

    def k1():
        ce.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1)

    def p1():
        ve.detailed_accum_megaloop(plan, batch, seg, acc, st, lanes_k1)

    def k2():
        ce.uniques_batch(plan, lanes_k2, st)

    def p2():
        ve.uniques_batch(plan, lanes_k2, st)

    # Plain, kernel, kernel, plain: both versions see the same card state.
    p1_a = time_cuda(p1, reps=2, warmup=1)
    k1_a = time_cuda(k1, reps=20)
    k1_b = time_cuda(k1, reps=20)
    p1_b = time_cuda(p1, reps=2, warmup=0)
    p2_a = time_cuda(p2, reps=3, warmup=1)
    k2_a = time_cuda(k2, reps=50)
    k2_b = time_cuda(k2, reps=50)
    p2_b = time_cuda(p2, reps=3, warmup=0)
    # K1 reads the start limbs and the accumulator, writes the accumulator
    # and the count; K2 reads the start limbs and writes 4 bytes a lane.
    c1, c2 = lane_cycles(counts["k1_lane"]), lane_cycles(counts["k2_lane"])
    b1 = bound_ms(lanes_k1, c1, 8 * plan.limbs_n + 2 * 4 * (plan.base + 2) + 4,
                  sms, clk_mhz)
    b2 = bound_ms(lanes_k2, c2, 8 * plan.limbs_n + 4 * lanes_k2, sms, clk_mhz)
    report["timing"] = {
        "base": plan.base, "sms": sms, "clk_max_mhz": clk_mhz,
        "k1": {"lanes": lanes_k1, "ms": [k1_a, k1_b], "plain_ms": [p1_a, p1_b],
               "sass": counts["k1_lane"], "lane_cycles": c1,
               "bound_ms": b1[0], "bound_by": b1[1]},
        "k2": {"lanes": lanes_k2, "ms": [k2_a, k2_b], "plain_ms": [p2_a, p2_b],
               "sass": counts["k2_lane"], "lane_cycles": c2,
               "bound_ms": b2[0], "bound_by": b2[1]},
    }
    emit({"phase": "timing", **report["timing"]})
    return [
        ("detailed_megaloop", "nice_tpu/ops/pallas_engine.py:181",
         min(k1_a, k1_b), min(p1_a, p1_b), b1),
        ("uniques", "nice_tpu/ops/pallas_engine.py:466",
         min(k2_a, k2_b), min(p2_a, p2_b), b2),
    ]


def phase_profile(report: dict) -> None:
    """One mid-range field again under torch.profiler: the device's busy
    and idle share of the field's wall time, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_tpu_torch.client import main as client

    data = _mid_range_field(SERVER_BASE)
    args = client.build_parser().parse_args(["--device", DEVICE])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        client.process_field(data, args)
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
    report["profile"] = {"field": "mid-range", "wall_ms": wall_ms,
                         "device_busy_ms": busy_ms,
                         "device_idle_share": 1.0 - busy_ms / wall_ms,
                         "device_ms_by_kernel": dict(top)}
    emit({"phase": "profile", **report["profile"]})


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
    card = nvidia_smi("name,power.limit")
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "sms": sms,
                    "clk_max_mhz": clk_mhz}
    emit(f"card: {card} | torch {torch.__version__} | cuda {torch.version.cuda}")

    phase_build(report)
    phase_kernel_vs_plain(report)
    phase_golden(report)
    phase_full_width(report)
    phase_server(report)
    phase_main_shapes(report)
    timed = phase_timing(report, sms, clk_mhz)
    phase_profile(report)
    kernel_ms = {name: ms for name, _, ms, _, _ in timed}
    for run in report["full_width"]["fields"]:
        est = sum(n * kernel_ms[k] for k, n in run["launches"].items())
        run["kernel_ms_est"] = est
        run["kernel_share_est"] = est / (run["elapsed_secs"] * 1e3)
        emit({"phase": "where_time_goes", "field": run["field"],
              "elapsed_ms": run["elapsed_secs"] * 1e3, "kernel_ms_est": est,
              "kernel_share_est": run["kernel_share_est"]})

    kernels = []
    for name, replaces, ms, plain_ms, (b_ms, b_by) in timed:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nice_tpu_torch/csrc/nice_kernels.cu",
            "replaces": replaces,
            "launches": report["main_path_launches"][name],
            "max_abs_err": max(report["kernel_vs_plain"]["max_abs_diff"][name],
                               report["main_shapes"]["max_abs_diff"][name]),
            "bases": list(BASES),
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
