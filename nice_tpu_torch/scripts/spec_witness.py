"""The registry's claims held against the kernels on the card
(nice_tpu_torch/analysis/kernelspec.py): what chip_smoke.py's kernelspec
phase and the cuda tests run.

    python -m nice_tpu_torch.scripts.spec_witness [--device cuda]

prints one {"kernelspec": {...}} line and exits 0 when every check holds:

1. witnesses: for every spec that launches a kernel, at its witness bases,
   windows of lanes at the limb boundaries inside the base's range (a lane
   whose low limbs are all ones, m * 2^(32j) - 1, and windows straddling
   m * 2^(32j); the range's first and last windows; K3's descriptors
   across the same edges, at the nice test and about the median of
   num_uniques) go through the kernel and through its plain version on the
   same device: every difference must be 0, at the default block size and
   again at the kernel's least one (K1, K3 and K4 one warp, K5 two);
2. the clamp's edge: one K1 launch at b40 with batch * n_iters at
   clamp_segment's largest value for the default batch (about 2^30 lanes),
   whose bins must sum to its lanes and equal the same lanes run in
   default segments;
3. the error paths must raise: K5 past 2^31 lanes, the main library's K5
   on a plan-tier plan (kPlanTierOnly), a per-base library asked for
   another plan (kOtherPlan), K5's shared memory past kMmaSmemMax
   (kNoSmem), a base with base + 2 > 2048, and a block size outside the
   rule at each C entry that takes one (kBadThreads) and at its wrapper;
4. tiers: launch_shape's tier for each kernel at the probe bases must be
   the one the spec predicts (a kernel the per-base library runs, at the
   bases given a library).

The plain versions run on the card too (they are PyTorch), so a difference
is the kernel's. No launch here counts toward a main path: callers that
count launches set the counts to 0 after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from nice_tpu_torch.analysis import kernelspec as ks
from nice_tpu_torch.ops import cuda_build
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine, stride_filter
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

SEED = 20261017
# Lanes of a detailed and a uniques window (n_iters x batch), of a dense run,
# and the windows a base at most.
BATCH, N_ITERS = 256, 2
DENSE_BATCH = 1 << 12
WINDOWS = 12
# K3's witness shape: stride periods a descriptor (of the base's depth-1
# table).
K3_PERIODS = 16


def check_min_uniques(base: int) -> int:
    """About the median of num_uniques (5/8 of the base): where a count is
    not all zeros, as it is at the nice test away from b10."""
    return (5 * base + 7) // 8


def _diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _shape(plan) -> tuple[int, int]:
    """(lanes a batch, windows) of a base's detailed and uniques witnesses:
    half of each on a wide plan, whose plain version runs many more ops a
    lane."""
    return (BATCH, WINDOWS) if plan.limbs_n <= 8 else (BATCH // 2, WINDOWS // 2)


def _detailed(plan, shape, dev, mma: int, rng,
              threads: int) -> tuple[int, int]:
    batch, windows = _shape(plan)
    lanes = batch * N_ITERS
    diff = cases = 0
    for start in ks.witness_starts(shape, lanes, windows):
        st = ve.start_limbs_tensor(start, plan, dev)
        valid = lanes - int(rng.integers(1, batch))
        acc0 = torch.from_numpy(
            rng.integers(0, 1000, plan.base + 2, dtype=np.int32)).to(dev)
        h_k, nm_k = ce.detailed_accum_megaloop(plan, batch, N_ITERS,
                                               acc0.clone(), st, valid,
                                               use_mxu=mma,
                                               block_threads=threads)
        h_p, nm_p = ve.detailed_accum_megaloop(plan, batch, N_ITERS,
                                               acc0.clone(), st, valid,
                                               use_mxu=mma)
        diff = max(diff, _diff(h_k, h_p), abs(int(nm_k) - int(nm_p)))
        cases += 1
    return diff, cases


def _uniques(plan, shape, dev) -> tuple[int, int]:
    batch, windows = _shape(plan)
    lanes = batch * N_ITERS
    diff = cases = 0
    for start in ks.witness_starts(shape, lanes, windows):
        st = ve.start_limbs_tensor(start, plan, dev)
        diff = max(diff, _diff(ce.uniques_batch(plan, lanes, st),
                               ve.uniques_batch(plan, lanes, st)))
        cases += 1
    return diff, cases


def _dense(plan, shape, dev, mma: int, rng,
           threads: int) -> tuple[int, int]:
    classes = ce.niceonly_classes(plan, True, str(dev))
    diff = cases = 0
    for start in ks.witness_starts(shape, DENSE_BATCH * N_ITERS, WINDOWS):
        st = ve.start_limbs_tensor(start, plan, dev)
        valid = DENSE_BATCH * N_ITERS - int(rng.integers(1, DENSE_BATCH))
        for min_u in (plan.base, check_min_uniques(plan.base)):
            got = ce.niceonly_dense_megaloop(plan, DENSE_BATCH, N_ITERS,
                                             classes, st, valid, min_u,
                                             use_mxu=mma,
                                             block_threads=threads)
            want = ve.niceonly_dense_megaloop(plan, DENSE_BATCH, N_ITERS,
                                              classes, st, valid, min_u,
                                              use_mxu=mma)
            diff = max(diff, _diff(got, want))
            cases += 1
    return diff, cases


def strided_rows(shape, modulus: int, periods: int) -> list:
    """(n0, lo, hi) descriptor rows across each limb edge of the range (a
    span centred on m * 2^(32j), its ends ragged) and at the range's
    start."""
    span = periods * modulus
    rows = []
    for edge in [shape.range_start + span // 2] + ks.limb_edges(shape):
        n0 = (edge - span // 2) // modulus * modulus
        lo = max(shape.range_start, n0 + modulus // 3)
        hi = min(shape.range_end, n0 + span - modulus // 5)
        rows.append((n0, lo, hi))
    return rows


def _strided(plan, shape, dev, threads: int) -> tuple[int, int, int]:
    table = stride_filter.get_stride_table(plan.base, 1)
    res = torch.from_numpy(table.residues_u32.astype(np.int64)).to(dev)
    rows = strided_rows(shape, table.modulus, K3_PERIODS)
    desc = np.zeros((len(rows) + 2, ks.DESC_WIDTH), dtype=np.int64)
    for i, (n0, lo, hi) in enumerate(rows):
        for k, x in enumerate((n0, lo, hi)):
            desc[i, 4 * k:4 * k + 4] = int_to_limbs(x, 4)
    desc = torch.from_numpy(desc).to(dev)
    diff = counted = 0
    for min_u in (plan.base, check_min_uniques(plan.base)):
        got = ce.strided_niceonly_batch(plan, table.modulus, res, K3_PERIODS,
                                        desc, len(rows), min_u,
                                        block_threads=threads)
        want = ve.niceonly_strided_counts(plan, table.modulus, res,
                                          K3_PERIODS, desc, len(rows), min_u)
        diff = max(diff, _diff(got, want))
        counted += int(got.sum())
    return diff, 2, counted


def witnesses(dev, names=None) -> dict:
    """The witnesses of every launch spec (or of those named) through the
    kernel and its plain version, at the default block size and at the
    kernel's least: {spec: {"b<base>[/mma][@threads]": {max_abs_diff,
    cases, tier}}} (no @threads: the default; K2 takes none)."""
    rng = np.random.default_rng(SEED)
    out: dict = {}
    for spec in ks.all_specs().values():
        if names is not None and spec.name not in names:
            continue
        for base, mma in spec.witness_bases:
            plan, shape = get_plan(base), ks.plan_shape(base)
            tier = spec.tier(shape, mma)
            if tier is None:
                raise AssertionError(f"{spec.name}: witness base {base} "
                                     f"(mma {mma}) is not one it takes")
            sizes = (ce.DEFAULT_BLOCK_THREADS, ce.block_threads_min(mma))
            if spec.name in ("nice_uniques", "nice_plan_uniques"):
                sizes = sizes[:1]
            for threads in sizes:
                if spec.name in ("nice_detailed_megaloop",
                                 "nice_plan_detailed_megaloop_mma"):
                    diff, cases = _detailed(plan, shape, dev, mma, rng,
                                            threads)
                    extra = {}
                elif spec.name in ("nice_uniques", "nice_plan_uniques"):
                    diff, cases = _uniques(plan, shape, dev)
                    extra = {}
                elif spec.name == "nice_niceonly_dense":
                    diff, cases = _dense(plan, shape, dev, mma, rng, threads)
                    extra = {}
                else:
                    diff, cases, counted = _strided(plan, shape, dev,
                                                    threads)
                    extra = {"counted": counted}
                key = f"b{base}" + ("/mma" if mma else "")
                if threads != ce.DEFAULT_BLOCK_THREADS:
                    key += f"@{threads}"
                out.setdefault(spec.name, {})[key] = {
                    "max_abs_diff": diff, "cases": cases, "tier": tier,
                    **extra}
    return out


def clamp_edge(dev) -> dict:
    """One K1 launch at b40 of batch x clamp_segment's largest segment for
    the default batch, held to the same lanes in default segments."""
    plan = get_plan(40)
    batch = engine.DEFAULT_BATCH_SIZE
    n_iters = engine.clamp_segment(1 << 30, batch)
    lanes = batch * n_iters
    st = ve.start_limbs_tensor(plan.range_start, plan, dev)
    hist = torch.zeros(plan.base + 2, dtype=torch.int32, device=dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    _, nm = ce.detailed_accum_megaloop(plan, batch, n_iters, hist, st, lanes)
    t1.record()
    torch.cuda.synchronize(dev)
    ms = t0.elapsed_time(t1)
    seg = engine.MEGALOOP_SEGMENT_DEFAULT
    ref = torch.zeros_like(hist)
    nm_ref = 0
    pos = 0
    while pos < lanes:
        n = min(seg, (lanes - pos) // batch)
        s = ve.start_limbs_tensor(plan.range_start + pos, plan, dev)
        _, m = ce.detailed_accum_megaloop(plan, batch, n, ref, s, batch * n)
        nm_ref += int(m)
        pos += batch * n
    h, r = hist.cpu(), ref.cpu()
    return {"base": 40, "batch": batch, "n_iters": n_iters, "lanes": lanes,
            "budget": ks.ACC_LIMIT // 2, "ms": ms,
            "bins_sum": int(h.long().sum()), "near_misses": int(nm),
            "segments": -(-lanes // (batch * seg)),
            "equal_to_segments": bool(torch.equal(h, r)) and int(nm) == nm_ref}


def _raises(fn) -> str:
    """The exception fn raises, as "Type: message" ("" when none)."""
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def error_paths(dev) -> dict:
    """Each error path and what it raised (an empty string: it did not)."""
    p40, p80 = get_plan(40), get_plan(80)
    st = ve.start_limbs_tensor(p40.range_start, p40, dev)
    acc = torch.zeros(p40.base + 2, dtype=torch.int32, device=dev)
    nm = torch.zeros((), dtype=torch.int32, device=dev)
    stream = ce._stream(st.device)

    def k5_past_2_31():
        n_iters = (1 << 31) // engine.DEFAULT_BATCH_SIZE + 1
        ce.detailed_accum_megaloop(p40, engine.DEFAULT_BATCH_SIZE, n_iters,
                                   acc, st, 0, use_mxu=1)

    def main_k5_on_plan_tier():
        lib = cuda_build.load()
        rc = lib.nice_detailed_megaloop(ce.plan_words(p40), st.data_ptr(), 64,
                                        0, acc.data_ptr(), nm.data_ptr(), 1,
                                        ce.DEFAULT_BLOCK_THREADS, stream)
        if rc != ks.RETURN_CODES["kPlanTierOnly"]:
            raise AssertionError(f"rc {rc}, not kPlanTierOnly")
        ce._raise_on(lib, rc, "detailed_megaloop_mma")

    def other_plan():
        lib = ce.plan_library(p40)
        out = torch.empty(64, dtype=torch.int32, device=dev)
        rc = lib.nice_plan_uniques(ce.plan_words(p80), st.data_ptr(), 64,
                                   out.data_ptr(), stream)
        if rc != ks.RETURN_CODES["kOtherPlan"]:
            raise AssertionError(f"rc {rc}, not kOtherPlan")
        ce._raise_on(lib, rc, "uniques")

    def k5_smem():
        ce.launch_shape("detailed_megaloop_mma", get_plan(2045), 1 << 21)

    def hist_bins():
        p = get_plan(2048)
        ce.detailed_accum_megaloop(
            p, 256, 1, torch.zeros(p.base + 2, dtype=torch.int32, device=dev),
            ve.start_limbs_tensor(p.range_start, p, dev), 256)

    out = {name: _raises(fn) for name, fn in (
        ("k5_past_2^31_lanes", k5_past_2_31),
        ("main_k5_on_plan_tier", main_k5_on_plan_tier),
        ("other_plan", other_plan), ("k5_smem", k5_smem),
        ("base_past_2048_bins", hist_bins))}
    out.update(bad_block_threads(dev))
    torch.cuda.synchronize(dev)
    return out


def bad_block_threads(dev) -> dict:
    """A block size outside the rule at every C entry that takes one (it
    must return kBadThreads before launching; its wrapper's check is
    bypassed here) and at each wrapper: {name: what it raised}."""
    p40, p98 = get_plan(40), get_plan(98)
    st40 = ve.start_limbs_tensor(p40.range_start, p40, dev)
    st98 = ve.start_limbs_tensor(p98.range_start, p98, dev)
    acc = torch.zeros(p40.base + 2, dtype=torch.int32, device=dev)
    nm = torch.zeros((), dtype=torch.int32, device=dev)
    out2 = torch.zeros(2, dtype=torch.int32, device=dev)
    counts = torch.zeros(1, dtype=torch.int32, device=dev)
    desc = torch.zeros((1, ks.DESC_WIDTH), dtype=torch.int64, device=dev)
    res = torch.ones(1, dtype=torch.int64, device=dev)
    classes = ce.niceonly_classes(p98, True, str(dev))
    stream = ce._stream(st40.device)  # an indexed device: dev may be "cuda"
    main, plan40 = cuda_build.load(), ce.plan_library(p40)
    shape = (ctypes.c_int * 5)()
    w40, w98 = ce.plan_words(p40), ce.plan_words(p98)
    entries = {
        "nice_detailed_megaloop": (main, lambda t, mma: (
            w98, st98.data_ptr(), 64, 0,
            torch.zeros(p98.base + 2, dtype=torch.int32,
                        device=dev).data_ptr(), nm.data_ptr(), mma, t,
            stream)),
        "nice_plan_detailed_megaloop_mma": (plan40, lambda t, mma: (
            w40, st40.data_ptr(), 64, 0, acc.data_ptr(), nm.data_ptr(), 1, t,
            stream)),
        "nice_niceonly_dense": (main, lambda t, mma: (
            w98, st98.data_ptr(), classes.data_ptr(), classes.shape[0], 64,
            p98.base, mma, out2.data_ptr(), t, stream)),
        "nice_plan_strided_niceonly": (plan40, lambda t, mma: (
            w40, desc.data_ptr(), 1, res.data_ptr(), 1,
            *ce.u32_divisor(1), 1, 1, p40.base, counts.data_ptr(), t,
            stream)),
        "nice_launch_shape": (main, lambda t, mma: (
            0, w40, 1 << 21, 0, mma, t, shape)),
        "nice_plan_launch_shape": (plan40, lambda t, mma: (
            2 - 2 * mma, w40, 1 << 10, 4, t, shape)),
    }
    out = {}
    for name, (lib, args) in entries.items():
        for mma in ks.SPECS[name].modes:
            for t in (0, ks.block_threads_min(mma) - ks.WARP // 2,
                      ks.THREADS + ks.WARP):
                def call(name=name, lib=lib, args=args, t=t, mma=mma):
                    rc = getattr(lib, name)(*args(t, mma))
                    if rc != ks.RETURN_CODES["kBadThreads"]:
                        raise AssertionError(f"rc {rc}, not kBadThreads")
                    ce._raise_on(lib, rc, name)

                out[f"{name}/mma{mma}@{t}"] = _raises(call)
    wrappers = {
        "detailed_accum_megaloop": lambda t: ce.detailed_accum_megaloop(
            p40, 64, 1, acc, st40, 64, block_threads=t),
        "detailed_accum_megaloop/mma": lambda t: ce.detailed_accum_megaloop(
            p40, 64, 1, acc, st40, 64, use_mxu=1, block_threads=t),
        "niceonly_dense_megaloop": lambda t: ce.niceonly_dense_megaloop(
            p98, 64, 1, classes, st98, 64, block_threads=t),
        "strided_niceonly_batch": lambda t: ce.strided_niceonly_batch(
            p40, 1, res, 1, desc, 1, block_threads=t),
        "launch_shape": lambda t: ce.launch_shape(
            "detailed_megaloop", p40, 1 << 21, block_threads=t),
    }
    for name, fn in wrappers.items():
        bad = 32 if name.endswith("/mma") else 48
        out[f"{name}@{bad}"] = _raises(lambda fn=fn, bad=bad: fn(bad))
    torch.cuda.synchronize(dev)
    return out


def _shape_args(kernel: str, plan) -> tuple:
    if kernel == "strided_niceonly":
        return (K3_PERIODS * 64, 16)
    if kernel.startswith("niceonly_dense"):
        return (plan.base - 1, 1 << 21)
    return (1 << 21,)


def shape_tiers(plan_bases) -> dict:
    """{kernel: {base: [reported tier, predicted tier]}} over the probe
    bases; a kernel the per-base library runs, only at `plan_bases` (the
    bases given a library: a probe elsewhere would build one). A tier of
    None: launch_shape raised, as it must where the spec predicts none."""
    out: dict = {}
    for kernel in ks.SHAPE_KERNELS:
        for base in ks.PROBE_BASES + tuple(plan_bases):
            shape = ks.plan_shape(base)
            want = ks.predicted_tier(kernel, shape, wrapper=False)
            if want == "plan" and base not in plan_bases:
                continue
            plan = get_plan(base)
            try:
                got = ce.launch_shape(kernel, plan, *_shape_args(kernel, plan))
                got = got["tier"]
            except (ValueError, RuntimeError):
                got = None
            out.setdefault(kernel, {})[base] = [got, want]
    return out


def run(dev, plan_bases=(40, 80, 97)) -> dict:
    """Every check above: the report, whose "failures" name what failed
    (none when every claim held)."""
    t0 = time.monotonic()
    w = witnesses(dev)
    edge = clamp_edge(dev)
    errors = error_paths(dev)
    tiers = shape_tiers(plan_bases)
    report = {
        "specs": sorted(ks.all_specs()),
        "witnesses": w,
        "max_abs_diff": max(c["max_abs_diff"] for s in w.values()
                            for c in s.values()),
        "witness_cases": sum(c["cases"] for s in w.values()
                             for c in s.values()),
        "clamp_edge": edge, "errors": errors, "tiers": tiers,
        "secs": time.monotonic() - t0,
    }
    bad = []
    if report["max_abs_diff"] != 0:
        bad.append(f"a witness differs: {w}")
    if not (edge["equal_to_segments"] and edge["bins_sum"] == edge["lanes"]
            and edge["lanes"] <= edge["budget"]):
        bad.append(f"the clamp-edge launch: {edge}")
    if not all(errors.values()):
        bad.append(f"an error path did not raise: {errors}")
    drift = {k: {b: t for b, t in v.items() if t[0] != t[1]}
             for k, v in tiers.items()}
    if any(drift.values()):
        bad.append(f"launch_shape's tiers differ from the spec's: {drift}")
    report["failures"] = bad
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        print("spec_witness: needs a CUDA device", file=sys.stderr)
        return 1
    report = run(dev)
    print(json.dumps({"kernelspec": report}), flush=True)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
