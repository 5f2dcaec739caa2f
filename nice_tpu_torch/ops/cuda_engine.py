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

K3, and K2 and K5's detailed mode at the bases of at most four limbs
(b10-b97), run on the plan tier: a library built for each base with its
plan as constants (csrc/plan_kernels.cu, `plan_library`), as the TPU traced
a kernel per plan. Which plans take it is decided by `plan_tier_takes`
alone; a failed build or launch there raises, as any other. K1 stays in the
main library at every base.

K1, K3, K4 and K5 take their block size at run time (block_threads, the
counterpart of the TPU kernels' block_rows): a whole number of warps up to
BLOCK_THREADS_MAX, from MMA_BLOCK_THREADS_MIN for K5 (block_threads_ok, the
rule of nice_grid.cuh). A value outside the set raises in the wrapper, in
the plain version and in the C entry; nothing clamps it. K2 keeps its block,
as the TPU's uniques kernel took no block_rows.

Wrapper rule: a CPU tensor goes to the plain version in vector_engine.py; a
CUDA tensor launches the kernel or raises. There is no fallback between the
two. LAUNCHES counts launches, one per kernel launch and nowhere else.
DISPATCH_SECONDS keeps each launch call's wall time (a list append, no
lock), and fold_dispatch_seconds() moves them into the
nice_pallas_dispatch_seconds series, once a field (the engine calls it).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time

import torch

from nice_tpu_torch.obs.series import PALLAS_DISPATCH_SECONDS
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

# The plans K2, K3 and K5's detailed mode run on the plan tier: at most this
# many limbs of n (nice_kernels.cuh kPlanTierLimbs), all of K3's domain.
PLAN_TIER_LIMBS = 4

# The block sizes of a grid-stride launch (nice_grid.cuh kWarp, kThreads,
# kMmaMinThreads): whole warps up to the bound every kernel is compiled
# under; K5 needs two warps at least (its setup's products on warp 0, T's
# fill on the others). DEFAULT_BLOCK_THREADS is what a launch takes
# untuned; STRIDED_BLOCK_THREADS is K3's, a module constant that only the
# tuning harness varies (as the TPU's _STRIDED_BLOCK_ROWS_MAX).
WARP = 32
BLOCK_THREADS_MAX = 256
MMA_BLOCK_THREADS_MIN = 64
DEFAULT_BLOCK_THREADS = BLOCK_THREADS_MAX
STRIDED_BLOCK_THREADS = DEFAULT_BLOCK_THREADS

LAUNCHES = {"detailed_megaloop": 0, "uniques": 0, "strided_niceonly": 0,
            "niceonly_dense": 0, "detailed_megaloop_mma": 0,
            "niceonly_dense_mma": 0}

# Wall seconds of each launch call since the last fold, by LAUNCHES key.
DISPATCH_SECONDS: dict = {k: [] for k in LAUNCHES}

_U64_MAX = (1 << 64) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fold_dispatch_seconds() -> None:
    """Observe the launch times kept since the last fold in
    nice_pallas_dispatch_seconds{kernel} and drop them."""
    for name in DISPATCH_SECONDS:
        times, DISPATCH_SECONDS[name] = DISPATCH_SECONDS[name], []
        if times:
            PALLAS_DISPATCH_SECONDS.labels(name).observe_many(times)


def supports_base(plan: BasePlan) -> bool:
    return plan.base + 2 <= MAX_HIST_BINS


def digit_magics(base: int) -> tuple[int, int, int]:
    """The 32-bit magics of one digit step x // base (nice_kernels.cuh
    div_base, div_base_full), with s = ceil(log2 base) - 1: (ceil(2^(32+s) /
    base), exact for x < 2^31; floor(2^(33+s) / base) + 1 - 2^32, the round-
    up magic less its 2^32 bit, exact for every x < 2^32; s)."""
    s = (base - 1).bit_length() - 1
    return (-(-(1 << (32 + s)) // base),
            (1 << (33 + s)) // base + 1 - (1 << 32), s)


def u32_divisor(d: int) -> tuple[int, int, int]:
    """(magic, shift1, shift2) of x // d for every u32 x (nice_kernels.cuh
    div_u32: the round-up magic with the add-and-shift fix-up, as
    div_base_full), 1 <= d < 2^32: with l = ceil(log2 d), floor(2^32 (2^l -
    d) / d) + 1 (below 2^32), min(l, 1) and max(l - 1, 0)."""
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    lg = (d - 1).bit_length()
    return ((1 << 32) * ((1 << lg) - d) // d + 1, min(lg, 1), max(lg - 1, 0))


def block_threads_min(use_mxu: int) -> int:
    """The least block size of K1/K3/K4 (use_mxu 0) or K5 (use_mxu 1)."""
    return MMA_BLOCK_THREADS_MIN if use_mxu else WARP


def block_threads_ok(block_threads: int, use_mxu: int = 0) -> bool:
    """Whether the kernel takes blocks of this many threads (nice_grid.cuh
    block_threads_ok)."""
    return (block_threads_min(use_mxu) <= block_threads <= BLOCK_THREADS_MAX
            and block_threads % WARP == 0)


def admissible_block_threads(use_mxu: int = 0) -> tuple[int, ...]:
    """Every block size the kernel takes, ascending."""
    return tuple(range(block_threads_min(use_mxu), BLOCK_THREADS_MAX + 1,
                       WARP))


def check_block_threads(block_threads, use_mxu: int = 0) -> int:
    """block_threads, or ValueError when the kernel does not take it."""
    if (isinstance(block_threads, bool) or not isinstance(block_threads, int)
            or not block_threads_ok(block_threads, use_mxu)):
        kernel = "K5 takes" if use_mxu else "K1, K3 and K4 take"
        raise ValueError(
            f"block_threads {block_threads!r}: {kernel} a multiple of "
            f"{WARP} from {block_threads_min(use_mxu)} to {BLOCK_THREADS_MAX}")
    return block_threads


def plan_tier_takes(plan: BasePlan) -> bool:
    """Whether K2, K3 and K5's detailed mode run the plan on the plan tier
    (its own build)."""
    return plan.limbs_n <= PLAN_TIER_LIMBS


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
        e, chunk_div, _U64_MAX // chunk_div,
        log2_fx(plan.base), _U64_MAX // (plan.base - 1),
        *digit_magics(plan.base),
    ]
    return (ctypes.c_uint64 * len(words))(*words)


def plan_header(plan: BasePlan, **defines) -> str:
    """nice_plan.h of a build with one base's plan as constants
    (csrc/plan_kernels.cu, csrc/op_count.cu): NICE_PLAN, the plan words in
    PlanWord order (struct Plan's); NICE_PLAN_TIER, the plan's own limb
    counts of n, n^2, n^3 and mask words (the plan tier's capacities); then
    each of `defines` as #define NAME VALUE."""
    words = ", ".join(f"{w}ull" for w in plan_words(plan))
    lines = [f"// nice_plan.h: base {plan.base} (ops/cuda_engine.py plan_header)",
             "#pragma once",
             f"#define NICE_PLAN {words}",
             f"#define NICE_PLAN_TIER {plan.limbs_n}, {plan.limbs_sq}, "
             f"{plan.limbs_cu}, {plan.n_masks}"]
    lines += [f"#define {k} {v}" for k, v in defines.items()]
    return "\n".join(lines) + "\n"


@functools.lru_cache(maxsize=None)
def plan_library(plan: BasePlan):
    """The plan's per-base library (K2, K3 and K5's detailed mode on the
    plan tier), built at the first use of the base and kept for the
    process."""
    return cuda_build.load_plan(plan_header(plan))


# nice_launch_shape's kernel numbers.
_SHAPE_KERNELS = {"detailed_megaloop": (0, 0), "uniques": (1, 0),
                  "strided_niceonly": (2, 0), "niceonly_dense": (3, 0),
                  "detailed_megaloop_mma": (0, 1), "niceonly_dense_mma": (3, 1)}
_TIERS = ("small", "generic", "dense", "plan")
# The kernels the per-base library runs at the plan tier's plans.
_PLAN_TIER_KERNELS = ("uniques", "strided_niceonly", "detailed_megaloop_mma")


def launch_shape(kernel: str, plan: BasePlan, a: int, b: int = 0,
                 block_threads: int = DEFAULT_BLOCK_THREADS) -> dict:
    """The launch shape the kernel takes on the current card (from the code
    its launch runs): grid blocks, threads a block, the blocks an SM holds
    at once at that size, the SMs, and the tier. a and b as the launch
    sees them: K1/K5 detailed and K2 a = lanes; K3 a = lanes a row, b =
    rows; K4/K5 dense a = classes, b = valid_total. block_threads as the
    launch takes it (K2 keeps its own; K4 and K5's dense mode take fewer on
    a small run)."""
    which, mma = _SHAPE_KERNELS[kernel]
    check_block_threads(block_threads, mma)
    out = (ctypes.c_int * 5)()
    if kernel in _PLAN_TIER_KERNELS and plan_tier_takes(plan):
        lib = plan_library(plan)
        rc = lib.nice_plan_launch_shape(which, plan_words(plan), a, b,
                                        block_threads, out)
    else:
        lib = cuda_build.load()
        rc = lib.nice_launch_shape(which, plan_words(plan), a, b, mma,
                                   block_threads, out)
    _raise_on(lib, rc, f"{kernel} shape")
    return {"grid": out[0], "threads": out[1], "blocks_per_sm": out[2],
            "sms": out[3], "tier": _TIERS[out[4]]}


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


def _on_device(device):
    """The context a launch on `device` runs in: nothing when it is already
    the current device (the usual case, and the cheap one), else a device
    guard."""
    if torch._C._cuda_getDevice() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device) -> int:
    """The raw handle of `device`'s current stream (the torch.cuda.Stream
    lookup costs about 10 us a call, a share of a 0.1 ms segment)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed ({rc}): {lib.nice_error_string(rc).decode()}"
        )


def detailed_accum_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            hist_acc: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int, use_mxu: int = 0,
                            nm_out: torch.Tensor | None = None,
                            block_threads: int = DEFAULT_BLOCK_THREADS):
    """K1 (use_mxu=0) or K5 in the detailed mode (use_mxu=1; on the plan
    tier where plan_tier_takes): n_iters * batch_size lanes from
    start_limbs, the first valid_total of them real,
    folded into hist_acc (int32[base+2], updated in place — the port's form
    of JAX's donated accumulator), in blocks of block_threads threads.
    Returns (hist_acc, near-miss count as a 0-dim int32 tensor on the
    device). nm_out, on the card: a zeroed 0-dim int32 device tensor to
    count into (a pipelined caller's ring slot), in place of a fresh one."""
    device = hist_acc.device
    _check(hist_acc, "hist_acc", torch.int32, (plan.base + 2,), device)
    _check(start_limbs, "start_limbs", torch.int64, (plan.limbs_n,), device)
    total = batch_size * n_iters
    _check_mxu(plan, use_mxu, total)
    check_block_threads(block_threads, use_mxu)
    if device.type == "cpu":
        return ve.detailed_accum_megaloop(plan, batch_size, n_iters, hist_acc,
                                          start_limbs, valid_total, use_mxu,
                                          block_threads)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    words = plan_words(plan)
    if use_mxu and plan_tier_takes(plan):
        lib = plan_library(plan)
        launch = lib.nice_plan_detailed_megaloop_mma
    else:
        lib = cuda_build.load()
        launch = lib.nice_detailed_megaloop
    if nm_out is None:
        nm = torch.zeros((), dtype=torch.int32, device=device)
    else:
        _check(nm_out, "nm_out", torch.int32, (), device)
        nm = nm_out
    t0 = time.perf_counter()
    with _on_device(device):
        rc = launch(
            words, start_limbs.data_ptr(), valid_total, total - valid_total,
            hist_acc.data_ptr(), nm.data_ptr(), use_mxu, block_threads,
            _stream(device),
        )
    name = "detailed_megaloop_mma" if use_mxu else "detailed_megaloop"
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    DISPATCH_SECONDS[name].append(time.perf_counter() - t0)
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
    if plan_tier_takes(plan):
        lib = plan_library(plan)
        launch = lib.nice_plan_uniques
    else:
        lib = cuda_build.load()
        launch = lib.nice_uniques
    out = torch.empty(batch_size, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    with _on_device(device):
        rc = launch(words, start_limbs.data_ptr(), batch_size, out.data_ptr(),
                    _stream(device))
    _raise_on(lib, rc, "uniques")
    LAUNCHES["uniques"] += 1
    DISPATCH_SECONDS["uniques"].append(time.perf_counter() - t0)
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
                           min_uniques: int | None = None,
                           block_threads: int = STRIDED_BLOCK_THREADS
                           ) -> torch.Tensor:
    """K3: per-descriptor nice counts, int32[rows] on desc's device.

    desc: int64 [rows, 12] (rows <= STRIDED_DESC_MAX), u32 values: n0, lo and
    hi as four limbs each, LSW first. Row d counts the candidates
    n = n0 + (i // R) * M + residues[i % R], i < periods * R, with
    lo <= n < hi and min_uniques <= num_uniques(n) <= base; rows at or past
    n_real are padding, are not launched, and count 0. min_uniques defaults
    to base, the nice test the search runs; a check passes a lower one so
    that the counts are not all zero where nice numbers are absent.
    block_threads: the threads of a block (STRIDED_BLOCK_THREADS on the
    main path; the tuning harness varies it)."""
    device = desc.device
    rows = desc.shape[0]
    _check(desc, "desc", torch.int64, (rows, DESC_WIDTH), device)
    num_res = residues.shape[0]
    _check(residues, "residues", torch.int64, (num_res,), device)
    if not 1 <= rows <= STRIDED_DESC_MAX or not 0 <= n_real <= rows:
        raise ValueError(f"{rows} descriptor rows (at most {STRIDED_DESC_MAX}), "
                         f"n_real {n_real}")
    if not plan_tier_takes(plan):
        raise ValueError(f"base {plan.base} needs {plan.limbs_n} limbs; "
                         f"descriptors carry {PLAN_TIER_LIMBS}")
    if (num_res < 1 or periods < 1 or periods * modulus >= 1 << 32
            or periods * num_res > STRIDED_OFFS_LANES_MAX):
        raise ValueError(f"stride shape out of range: {periods} periods of "
                         f"{num_res} residues modulo {modulus}")
    if min_uniques is None:
        min_uniques = plan.base
    if not 0 <= min_uniques <= plan.base:
        raise ValueError(f"min_uniques {min_uniques} outside [0, {plan.base}]")
    check_block_threads(block_threads)
    if device.type == "cpu":
        return ve.niceonly_strided_counts(plan, modulus, residues, periods,
                                          desc, n_real, min_uniques,
                                          block_threads)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    words = plan_words(plan)
    lib = plan_library(plan)
    counts = torch.zeros(rows, dtype=torch.int32, device=device)
    if n_real == 0:
        return counts
    t0 = time.perf_counter()
    with _on_device(device):
        rc = lib.nice_plan_strided_niceonly(
            words, desc.data_ptr(), n_real, residues.data_ptr(), num_res,
            *u32_divisor(num_res), modulus, periods, min_uniques,
            counts.data_ptr(), block_threads, _stream(device),
        )
    _raise_on(lib, rc, "strided_niceonly")
    LAUNCHES["strided_niceonly"] += 1
    DISPATCH_SECONDS["strided_niceonly"].append(time.perf_counter() - t0)
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
                            use_mxu: int = 0,
                            out: torch.Tensor | None = None,
                            block_threads: int = DEFAULT_BLOCK_THREADS
                            ) -> torch.Tensor:
    """K4 (use_mxu=0) or K5 in the dense mode (use_mxu=1): the candidates
    start + [0, valid_total) of an n_iters * batch_size megaloop whose n
    mod (b-1) is one of `classes` (int64, from niceonly_classes) are kept;
    returns int32 [count, pruned] on the device:
    the kept lanes with min_uniques <= num_uniques <= base, and the lanes
    not kept. min_uniques defaults to base, the nice test the search runs; a
    check passes a lower one. No lane may pass 2^(32 * limbs_n) (no lane of
    the base's range does). An empty table launches nothing and gives
    [0, valid_total], what the TPU kernel gives after pruning every lane.
    out, on the card: a zeroed int32[2] device tensor to count into (a
    pipelined caller's ring slot), in place of a fresh one. block_threads:
    the threads of a block (a run with fewer lanes than the SMs hold blocks
    of it runs in blocks of 64, where that is fewer; launch_shape says)."""
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
    check_block_threads(block_threads, use_mxu)
    if device.type == "cpu":
        return ve.niceonly_dense_megaloop(plan, batch_size, n_iters, classes,
                                          start_limbs, valid_total, min_uniques,
                                          use_mxu, block_threads)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    words = plan_words(plan)
    lib = cuda_build.load()
    if num_cls == 0 or valid_total == 0:
        return torch.tensor([0, valid_total], dtype=torch.int32, device=device)
    if out is None:
        out = torch.zeros(2, dtype=torch.int32, device=device)
    else:
        _check(out, "out", torch.int32, (2,), device)
    t0 = time.perf_counter()
    with _on_device(device):
        rc = lib.nice_niceonly_dense(
            words, start_limbs.data_ptr(), classes.data_ptr(), num_cls,
            valid_total, min_uniques, use_mxu, out.data_ptr(), block_threads,
            _stream(device),
        )
    name = "niceonly_dense_mma" if use_mxu else "niceonly_dense"
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    DISPATCH_SECONDS[name].append(time.perf_counter() - t0)
    return out
