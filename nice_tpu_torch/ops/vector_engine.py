"""Plain PyTorch versions of the two CUDA kernels (the port's counterpart of
nice_tpu/ops/vector_engine.py).

Each function here computes exactly what its kernel in csrc/nice_kernels.cu
computes, on tensors of any device: the CPU tests use them as the kernels'
stand-in, and chip_smoke.py holds each kernel against them on the card.
Nothing on the engine's path calls them for a CUDA tensor
(ops/cuda_engine.py routes only CPU tensors here).

Carrier rule: torch has no u32 arithmetic on the CPU (`+`, `>>`, `<` and
`//` raise on torch.uint32), so every u32 limb is carried in an int64
tensor holding a value in [0, 2^32). A u32 x u32 product can overflow
signed int64, so limb products go through 16-bit halves (mul32), as the
TPU's VPU does. Limb lists are LSW first; entries broadcast, so a start
limb may be a 0-dim tensor beside a (lanes,) lane offset.

Per lane (the same pipeline as the kernel):
    n = start + lane                   multi-limb add of a 64-bit offset
    sq = n * n, cu = sq * n            exact column sums, one carry pass
    digits by long division            chunks of base^e < 2^31 (limbs.py)
    presence bits in u32 mask words    -> popcount -> num_uniques
"""

from __future__ import annotations

import numpy as np
import torch

from nice_tpu_torch.ops.limbs import (
    BasePlan,
    digit_chunk,
    int_to_limbs,
    log2_fx,
    quotient_limbs,
)

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# u32 limb primitives (int64 carriers)
# --------------------------------------------------------------------------

def mul32(a, b):
    """Full 32x32 -> 64 product as (lo, hi) u32 values, via 16-bit halves."""
    a_lo = a & MASK16
    a_hi = a >> 16
    b_lo = b & MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    t = (ll >> 16) + (lh & MASK16) + (hl & MASK16)
    lo = (ll & MASK16) | ((t & MASK16) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return lo, hi


def _resolve(cols: list) -> list:
    """One carry pass over int64 column sums -> u32 limbs. A column holds at
    most 2 * (limb count) terms below 2^32, far inside int64."""
    out = []
    carry = 0
    for c in cols:
        s = c + carry
        out.append(s & MASK32)
        carry = s >> 32
    return out


def _zeros_like_limbs(a: list):
    return torch.zeros_like(torch.as_tensor(a[0]))


def mul_limbs(a: list, b: list, out_len: int) -> list:
    """a * b mod 2^(32 * out_len) as out_len u32 limbs (exact when out_len
    covers the product)."""
    cols = [_zeros_like_limbs(a) for _ in range(out_len)]
    for i, ai in enumerate(a):
        if i >= out_len:
            break
        for j, bj in enumerate(b):
            k = i + j
            if k >= out_len:
                break
            lo, hi = mul32(ai, bj)
            cols[k] = cols[k] + lo
            if k + 1 < out_len:
                cols[k + 1] = cols[k + 1] + hi
    return _resolve(cols)


def sqr_limbs(a: list, out_len: int) -> list:
    """a * a mod 2^(32 * out_len): each off-diagonal product is computed once
    and counted twice."""
    cols = [_zeros_like_limbs(a) for _ in range(out_len)]
    la = len(a)
    for i in range(la):
        if 2 * i >= out_len:
            break
        lo, hi = mul32(a[i], a[i])
        cols[2 * i] = cols[2 * i] + lo
        if 2 * i + 1 < out_len:
            cols[2 * i + 1] = cols[2 * i + 1] + hi
        for j in range(i + 1, la):
            k = i + j
            if k >= out_len:
                break
            lo, hi = mul32(a[i], a[j])
            cols[k] = cols[k] + 2 * lo
            if k + 1 < out_len:
                cols[k + 1] = cols[k + 1] + 2 * hi
    return _resolve(cols)


def add_u32(limbs: list, x) -> list:
    """limbs + x (x a non-negative lane offset below 2^62), truncated to
    len(limbs) limbs: the carry out of each limb carries x's high part on."""
    out = []
    carry = x
    for limb in limbs:
        s = limb + carry
        out.append(s & MASK32)
        carry = s >> 32
    return out


def popcount32(x):
    """Bits set in each u32 value (SWAR shift/mask; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


# --------------------------------------------------------------------------
# Digit extraction
# --------------------------------------------------------------------------

def _set_digit(masks, lane, d, n_masks: int) -> None:
    """OR digit d's presence bit into masks[d >> 5]. masks has one spare row
    (index n_masks) that absorbs words past the plan, which the popcount
    never reads — the kernel drops those the same way."""
    w = torch.clamp(d >> 5, max=n_masks)
    bit = torch.ones_like(d) << (d & 31)
    masks[w, lane] = masks[w, lane] | bit


def accumulate_digit_masks(plan: BasePlan, masks, lane, limbs: list,
                           num_digits: int) -> None:
    """Extract num_digits base digits of a value held in u32 limbs and OR
    each into the presence masks.

    Chunks of e digits come off with one long division by base^e < 2^31
    (each step (rem << 32 | limb) < 2^63), then the chunk remainder splits
    into single digits; the dividend shrinks to quotient_limbs of what is
    left. A value inside the base's valid range has exactly num_digits
    digits, so the trip count is fixed."""
    base = plan.base
    e, chunk_div = digit_chunk(base)
    lfx = log2_fx(base)
    v = list(limbs)
    nl = len(v)
    remaining = num_digits
    while remaining > e:
        remaining -= e
        r = torch.zeros_like(v[0])
        for i in range(nl - 1, -1, -1):
            cur = (r << 32) | v[i]
            q = cur // chunk_div
            r = cur - q * chunk_div
            v[i] = q
        nl = min(nl, quotient_limbs(remaining, lfx))
        for _ in range(e - 1):
            q = r // base
            _set_digit(masks, lane, r - q * base, plan.n_masks)
            r = q
        _set_digit(masks, lane, r, plan.n_masks)
    r = v[0]
    for _ in range(remaining - 1):
        q = r // base
        _set_digit(masks, lane, r - q * base, plan.n_masks)
        r = q
    if remaining > 0:
        _set_digit(masks, lane, r, plan.n_masks)


def num_uniques_lanes(plan: BasePlan, n_limbs: list):
    """num_uniques of (n^2, n^3) per lane, as int32."""
    sq = sqr_limbs(n_limbs, plan.limbs_sq)
    cu = mul_limbs(sq, n_limbs, plan.limbs_cu)
    lanes = sq[0].shape[0]
    lane = torch.arange(lanes, device=sq[0].device)
    masks = torch.zeros((plan.n_masks + 1, lanes), dtype=torch.int64,
                        device=sq[0].device)
    accumulate_digit_masks(plan, masks, lane, sq, plan.d_sq)
    accumulate_digit_masks(plan, masks, lane, cu, plan.d_cu)
    return popcount32(masks[: plan.n_masks]).sum(0).to(torch.int32)


# --------------------------------------------------------------------------
# Kernel twins
# --------------------------------------------------------------------------

def start_limbs_tensor(x: int, plan: BasePlan, device) -> torch.Tensor:
    """The kernels' start argument: n's limbs as an int64 (limbs_n,) tensor
    on `device` (limb values in [0, 2^32))."""
    limbs = int_to_limbs(x, plan.limbs_n).astype(np.int64)
    return torch.from_numpy(limbs).to(device)


def lane_limbs(plan: BasePlan, start_limbs: torch.Tensor, lanes: int) -> list:
    """n = start + lane for lanes 0..lanes-1, as a limb list."""
    g = torch.arange(lanes, dtype=torch.int64, device=start_limbs.device)
    return add_u32([start_limbs[i] for i in range(plan.limbs_n)], g)


def detailed_accum_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            hist_acc: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int):
    """Plain twin of the detailed megaloop kernel (K1).

    Lanes start + [0, valid_total) are real candidates; their num_uniques
    histogram (bins 0..base+1) is added IN PLACE to hist_acc (int32
    [base+2]), and the n_iters * batch_size - valid_total padding lanes land
    in bin 0 without being computed — what the JAX megaloop's masked lanes
    add. Returns (hist_acc, near-miss count as a 0-dim int32 tensor)."""
    total = batch_size * n_iters
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    width = plan.base + 2
    u = num_uniques_lanes(plan, lane_limbs(plan, start_limbs, valid_total))
    hist = torch.bincount(u, minlength=width)[:width]
    hist_acc += hist.to(torch.int32)
    hist_acc[0] += total - valid_total
    nm = (u > plan.near_miss_cutoff).sum().to(torch.int32)
    return hist_acc, nm


def uniques_batch(plan: BasePlan, batch_size: int, start_limbs: torch.Tensor):
    """Plain twin of the per-lane uniques kernel (K2): int32[batch_size]."""
    return num_uniques_lanes(plan, lane_limbs(plan, start_limbs, batch_size))


def compact_survivors(uniques: torch.Tensor, valid_count: int, thresh: int,
                      cap: int):
    """Prefix-sum scatter of the lanes with uniques > thresh (and lane <
    valid_count) into cap-sized outputs: (count int32, idx int32[cap],
    uniq int32[cap]), survivors in ascending lane order, zeros past count.
    Survivors past cap are dropped — callers compare count against cap and
    rescan dense on overflow, keeping the ordered prefix meanwhile."""
    lane = torch.arange(uniques.shape[0], device=uniques.device)
    mask = (lane < valid_count) & (uniques > thresh)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    # Non-survivors and overflow survivors scatter into the spare slot `cap`.
    tgt = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=uniques.device)
    uniq = torch.zeros(cap + 1, dtype=torch.int32, device=uniques.device)
    idx.scatter_(0, tgt, lane.to(torch.int32))
    uniq.scatter_(0, tgt, uniques.to(torch.int32))
    return mask.sum().to(torch.int32), idx[:cap], uniq[:cap]


def survivors_batch(plan: BasePlan, batch_size: int, thresh: int, cap: int,
                    start_limbs: torch.Tensor, valid_count: int):
    """uniques_batch followed by compact_survivors."""
    return compact_survivors(
        uniques_batch(plan, batch_size, start_limbs), valid_count, thresh, cap
    )
