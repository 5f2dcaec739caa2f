"""Wrappers of the two CUDA kernels (csrc/nice_kernels.cu), with launch
counters — the port's counterpart of nice_tpu/ops/pallas_engine.py's entry
points.

K1 `detailed_accum_megaloop` replaces the TPU's detailed stats kernel
(nice_tpu/ops/pallas_engine.py _stats_callable, pallas_call at :181, under
_detailed_megaloop_callable's lax.scan). K2 `uniques_batch` replaces the
per-lane uniques kernel (_uniques_callable, pallas_call at :466);
`survivors_batch` follows it with the plain-tensor compaction, as JAX left
that outside the pallas_call. Both kernels are bound by integer operations
(no input beyond the start limbs, little output); see the source note in
nice_kernels.cu for what the design does about it.

Wrapper rule: a CPU tensor goes to the plain version in vector_engine.py; a
CUDA tensor launches the kernel or raises. There is no fallback between the
two. LAUNCHES counts launches, one per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nice_tpu_torch.ops import cuda_build
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import BasePlan, digit_chunk, log2_fx

# Bases whose histogram (bins 0..base+1) fits 2048 bins — the bases the TPU
# kernels accept (pallas_engine.supports_base); every kernel tier covers them.
MAX_HIST_BINS = 2048

LAUNCHES = {"detailed_megaloop": 0, "uniques": 0}

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
        log2_fx(plan.base),
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


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed ({rc}): {lib.nice_error_string(rc).decode()}"
        )


def detailed_accum_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            hist_acc: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int):
    """K1: n_iters * batch_size lanes from start_limbs, the first
    valid_total of them real, folded into hist_acc (int32[base+2], updated
    in place — the port's form of JAX's donated accumulator). Returns
    (hist_acc, near-miss count as a 0-dim int32 tensor on the device)."""
    device = hist_acc.device
    _check(hist_acc, "hist_acc", torch.int32, (plan.base + 2,), device)
    _check(start_limbs, "start_limbs", torch.int64, (plan.limbs_n,), device)
    if device.type == "cpu":
        return ve.detailed_accum_megaloop(plan, batch_size, n_iters, hist_acc,
                                          start_limbs, valid_total)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    total = batch_size * n_iters
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    words = plan_words(plan)
    lib = cuda_build.load()
    nm = torch.zeros((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.nice_detailed_megaloop(
            words, start_limbs.data_ptr(), valid_total, total - valid_total,
            hist_acc.data_ptr(), nm.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, "detailed_megaloop")
    LAUNCHES["detailed_megaloop"] += 1
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

