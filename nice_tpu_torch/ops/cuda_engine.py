"""Wrappers of the CUDA kernels (csrc/nice_kernels.cu), with launch
counters — the port's counterpart of nice_tpu/ops/pallas_engine.py's entry
points.

K1 `detailed_accum_megaloop` replaces the TPU's detailed stats kernel
(nice_tpu/ops/pallas_engine.py _stats_callable, pallas_call at :181, under
_detailed_megaloop_callable's lax.scan). K2 `uniques_batch` replaces the
per-lane uniques kernel (_uniques_callable, pallas_call at :466);
`survivors_batch` follows it with the plain-tensor compaction, as JAX left
that outside the pallas_call. K3 `strided_niceonly_batch` replaces the
stride-descriptor niceonly kernel (_strided_callable, pallas_call at :410).
K4 `niceonly_dense_megaloop` replaces the stats kernel's two niceonly modes
(the same pallas_call at :181, entries niceonly_dense_batch and
niceonly_fused_batch) and the jnp megaloops over them. K5, the TPU's MXU
arm of the same kernel (use_mxu, nice_tpu/ops/mxu.py), is the K1 and K4
wrappers called with use_mxu=1: their products then run on the tensor cores
(ops/mxu.py says how), counted under their own LAUNCHES keys. All are bound
by integer operations (little input, little output); see the source note in
nice_kernels.cu for what the design does about it.

Wrapper rule: a CPU tensor goes to the plain version in vector_engine.py; a
CUDA tensor launches the kernel or raises. There is no fallback between the
two. LAUNCHES counts launches, one per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nice_tpu_torch.ops import cuda_build, mxu
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import BasePlan, digit_chunk, log2_fx

# Bases whose histogram (bins 0..base+1) fits 2048 bins — the bases the TPU
# kernels accept (pallas_engine.supports_base); every kernel tier covers them.
MAX_HIST_BINS = 2048

# The strided niceonly pipeline's shapes (nice_tpu/ops/pallas_engine.py
# :274-278): descriptors per launch, the planner's cap on stride periods, the
# cap on candidate lanes per descriptor (periods * residues), and the u32
# words of a descriptor row (n0, lo, hi as four limbs each).
STRIDED_DESC_MAX = 1024
STRIDED_PERIODS_MAX = 1024
STRIDED_OFFS_LANES_MAX = 1 << 20
DESC_WIDTH = 12

LAUNCHES = {"detailed_megaloop": 0, "uniques": 0, "strided_niceonly": 0,
            "niceonly_dense": 0, "detailed_megaloop_mma": 0,
            "niceonly_dense_mma": 0}

_U64_MAX = (1 << 64) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports_base(plan: BasePlan) -> bool:
    return plan.base + 2 <= MAX_HIST_BINS


@functools.lru_cache(maxsize=None)
def plan_words(plan: BasePlan):
    """The kernels' per-base constants as a host uint64 array, in the
    order of nice_kernels.cuh's PlanWord."""
    if not supports_base(plan):
        raise ValueError(f"base {plan.base}: histogram exceeds {MAX_HIST_BINS} bins")
    e, chunk_div = digit_chunk(plan.base)
    words = [
        plan.base, plan.limbs_n, plan.limbs_sq, plan.limbs_cu,
        plan.d_sq, plan.d_cu, plan.n_masks, plan.near_miss_cutoff,
        e, chunk_div, _U64_MAX // chunk_div, _U64_MAX // plan.base,
        log2_fx(plan.base), _U64_MAX // (plan.base - 1),
    ]
    return (ctypes.c_uint64 * len(words))(*words)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
            f"got {t.dtype} {tuple(t.shape)}"
        )


def _check_mxu(plan: BasePlan, use_mxu: int, total: int) -> None:
    """K5 takes the plan (mxu.supports_plan) and lane offsets below 2^31."""
    if use_mxu not in (0, 1):
        raise ValueError(f"use_mxu must be 0 or 1, got {use_mxu!r}")
    if use_mxu and not mxu.supports_plan(plan):
        raise ValueError(f"base {plan.base}: K5 does not take this plan "
                         f"({mxu.smem_bytes(plan)} bytes of shared memory)")
    if use_mxu and total >= 1 << 31:
        raise ValueError(f"{total} lanes: K5's lane offsets are below 2^31")


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed ({rc}): {lib.nice_error_string(rc).decode()}"
        )


def detailed_accum_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            hist_acc: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int, use_mxu: int = 0):
    """K1 (use_mxu=0) or K5 in the detailed mode (use_mxu=1): n_iters *
    batch_size lanes from start_limbs, the first valid_total of them real,
    folded into hist_acc (int32[base+2], updated in place — the port's form
    of JAX's donated accumulator). Returns (hist_acc, near-miss count as a
    0-dim int32 tensor on the device)."""
    device = hist_acc.device
    _check(hist_acc, "hist_acc", torch.int32, (plan.base + 2,), device)
    _check(start_limbs, "start_limbs", torch.int64, (plan.limbs_n,), device)
    total = batch_size * n_iters
    _check_mxu(plan, use_mxu, total)
    if device.type == "cpu":
        return ve.detailed_accum_megaloop(plan, batch_size, n_iters, hist_acc,
                                          start_limbs, valid_total, use_mxu)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    words = plan_words(plan)
    lib = cuda_build.load()
    nm = torch.zeros((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.nice_detailed_megaloop(
            words, start_limbs.data_ptr(), valid_total, total - valid_total,
            hist_acc.data_ptr(), nm.data_ptr(), use_mxu,
            torch.cuda.current_stream(device).cuda_stream,
        )
    name = "detailed_megaloop_mma" if use_mxu else "detailed_megaloop"
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return hist_acc, nm


def uniques_batch(plan: BasePlan, batch_size: int, start_limbs: torch.Tensor):
    """K2: num_uniques of lanes start + [0, batch_size), int32[batch_size]."""
    device = start_limbs.device
    _check(start_limbs, "start_limbs", torch.int64, (plan.limbs_n,), device)
    if device.type == "cpu":
        return ve.uniques_batch(plan, batch_size, start_limbs)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    words = plan_words(plan)
    lib = cuda_build.load()
    out = torch.empty(batch_size, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.nice_uniques(
            words, start_limbs.data_ptr(), batch_size, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, "uniques")
    LAUNCHES["uniques"] += 1
    return out


def survivors_batch(plan: BasePlan, batch_size: int, thresh: int, cap: int,
                    start_limbs: torch.Tensor, valid_count: int):
    """K2 plus the on-device compaction: (count, idx[cap], uniq[cap]) of the
    lanes < valid_count with num_uniques > thresh, in ascending lane order.
    Only these small tensors need to cross to the host."""
    return ve.compact_survivors(
        uniques_batch(plan, batch_size, start_limbs), valid_count, thresh, cap
    )



def strided_niceonly_batch(plan: BasePlan, modulus: int,
                           residues: torch.Tensor, periods: int,
                           desc: torch.Tensor, n_real: int,
                           min_uniques: int | None = None) -> torch.Tensor:
    """K3: per-descriptor nice counts, int32[rows] on desc's device.

    desc: int64 [rows, 12] (rows <= STRIDED_DESC_MAX), u32 values: n0, lo and
    hi as four limbs each, LSW first. Row d counts the candidates
    n = n0 + (i // R) * M + residues[i % R], i < periods * R, with
    lo <= n < hi and min_uniques <= num_uniques(n) <= base; rows at or past
    n_real are padding, are not launched, and count 0. min_uniques defaults
    to base, the nice test the search runs; a check passes a lower one so
    that the counts are not all zero where nice numbers are absent."""
    device = desc.device
    rows = desc.shape[0]
    _check(desc, "desc", torch.int64, (rows, DESC_WIDTH), device)
    num_res = residues.shape[0]
    _check(residues, "residues", torch.int64, (num_res,), device)
    if not 1 <= rows <= STRIDED_DESC_MAX or not 0 <= n_real <= rows:
        raise ValueError(f"{rows} descriptor rows (at most {STRIDED_DESC_MAX}), "
                         f"n_real {n_real}")
    if plan.limbs_n > 4:
        raise ValueError(f"base {plan.base} needs {plan.limbs_n} limbs; "
                         "descriptors carry 4")
    if (num_res < 1 or periods < 1 or periods * modulus >= 1 << 32
            or periods * num_res > STRIDED_OFFS_LANES_MAX):
        raise ValueError(f"stride shape out of range: {periods} periods of "
                         f"{num_res} residues modulo {modulus}")
    if min_uniques is None:
        min_uniques = plan.base
    if not 0 <= min_uniques <= plan.base:
        raise ValueError(f"min_uniques {min_uniques} outside [0, {plan.base}]")
    if device.type == "cpu":
        return ve.niceonly_strided_counts(plan, modulus, residues, periods,
                                          desc, n_real, min_uniques)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    words = plan_words(plan)
    lib = cuda_build.load()
    counts = torch.zeros(rows, dtype=torch.int32, device=device)
    if n_real == 0:
        return counts
    with torch.cuda.device(device):
        rc = lib.nice_strided_niceonly(
            words, desc.data_ptr(), n_real, residues.data_ptr(), num_res,
            modulus, periods, min_uniques, counts.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, "strided_niceonly")
    LAUNCHES["strided_niceonly"] += 1
    return counts


@functools.lru_cache(maxsize=None)
def niceonly_classes(plan: BasePlan, fused: bool, device: str) -> torch.Tensor:
    """K4's class table for one (base, mode) on a device, uploaded once: the
    residue classes mod b-1 that a dense run keeps, ascending, as int64.
    fused (the TPU's "niceonly-fused" mode) keeps the classes the
    congruence (ve.residue_keep_lanes) keeps; the unfused "niceonly" mode
    keeps all b-1."""
    r = torch.arange(plan.base - 1, dtype=torch.int64)
    if fused:
        r = r[ve.residue_keep_lanes(plan, [r])]
    return r.to(device)


def niceonly_dense_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            classes: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int,
                            min_uniques: int | None = None,
                            use_mxu: int = 0) -> torch.Tensor:
    """K4 (use_mxu=0) or K5 in the dense mode (use_mxu=1): the candidates
    start + [0, valid_total) of an n_iters * batch_size megaloop whose n
    mod (b-1) is one of `classes` (int64, from niceonly_classes) are kept;
    returns int32 [count, pruned] on the device:
    the kept lanes with min_uniques <= num_uniques <= base, and the lanes
    not kept. min_uniques defaults to base, the nice test the search runs; a
    check passes a lower one. No lane may pass 2^(32 * limbs_n) (no lane of
    the base's range does). An empty table launches nothing and gives
    [0, valid_total], what the TPU kernel gives after pruning every lane."""
    device = start_limbs.device
    _check(start_limbs, "start_limbs", torch.int64, (plan.limbs_n,), device)
    num_cls = classes.shape[0]
    _check(classes, "classes", torch.int64, (num_cls,), device)
    total = batch_size * n_iters
    if not 0 <= valid_total <= total or total + plan.base >= 1 << 31:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}], or "
                         f"{total} lanes past the kernel's u32 lane index")
    if plan.base < 3 or num_cls > plan.base - 1:
        raise ValueError(f"{num_cls} classes modulo base - 1 = {plan.base - 1}")
    if min_uniques is None:
        min_uniques = plan.base
    if not 0 <= min_uniques <= plan.base:
        raise ValueError(f"min_uniques {min_uniques} outside [0, {plan.base}]")
    _check_mxu(plan, use_mxu, total)
    if device.type == "cpu":
        return ve.niceonly_dense_megaloop(plan, batch_size, n_iters, classes,
                                          start_limbs, valid_total, min_uniques,
                                          use_mxu)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    words = plan_words(plan)
    lib = cuda_build.load()
    if num_cls == 0 or valid_total == 0:
        return torch.tensor([0, valid_total], dtype=torch.int32, device=device)
    out = torch.zeros(2, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.nice_niceonly_dense(
            words, start_limbs.data_ptr(), classes.data_ptr(), num_cls,
            valid_total, min_uniques, use_mxu, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    name = "niceonly_dense_mma" if use_mxu else "niceonly_dense"
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out
