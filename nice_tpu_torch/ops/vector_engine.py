"""Plain PyTorch versions of the four CUDA kernels (the port's counterpart
of nice_tpu/ops/vector_engine.py).

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
    return add_u32_carry(limbs, x)[0]


def add_u32_carry(limbs: list, x):
    """add_u32, and whether the sum wrapped past len(limbs) limbs (a bool
    per lane)."""
    out = []
    carry = x
    for limb in limbs:
        s = limb + carry
        out.append(s & MASK32)
        carry = s >> 32
    return out, carry != 0


def byte_digits(limbs: list, count: int) -> list:
    """The first `count` bytes of the value held in u32 limbs, LS first."""
    return [(limbs[j // 4] >> (8 * (j % 4))) & 0xFF for j in range(count)]


def square_overflows(plan: BasePlan, n_limbs: list):
    """Per lane, n^2 >= 2^(32 * limbs_sq), i.e. n >= 2^(16 * limbs_sq): the
    lanes whose square K1 truncates (none inside the base's range)."""
    h = 16 * plan.limbs_sq
    over = torch.zeros_like(torch.as_tensor(n_limbs[0]), dtype=torch.bool)
    for k, limb in enumerate(n_limbs):
        if 32 * k >= h:
            over = over | (limb != 0)
        elif 32 * k + 32 > h:
            over = over | ((limb >> (h - 32 * k)) != 0)
    return over


def limbs_lt(a: list, b: list):
    """Elementwise a < b for equal-length LSW-first limb lists (entries
    broadcast)."""
    if len(a) != len(b):
        raise ValueError(f"limb lists of lengths {len(a)} and {len(b)}")
    lt = a[-1] < b[-1]
    eq = a[-1] == b[-1]
    for i in range(len(a) - 2, -1, -1):
        lt = lt | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return lt


def limbs_ge(a: list, b: list):
    return ~limbs_lt(a, b)


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
    return uniques_of_products(plan, sq, cu)


def uniques_of_products(plan: BasePlan, sq: list, cu: list):
    """num_uniques per lane from the limbs of n^2 and n^3, as int32."""
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


def check_block_threads(block_threads: int | None, use_mxu: int = 0) -> None:
    """The kernels' block-size rule (cuda_engine.check_block_threads) for a
    plain version: it raises where the kernel's C entry refuses the size.
    None is the default size. The plain versions' results do not depend on
    the size: a kernel's bins and counts are integer sums over its blocks."""
    from nice_tpu_torch.ops import cuda_engine  # it imports this module

    if block_threads is not None:
        cuda_engine.check_block_threads(block_threads, use_mxu)


def detailed_accum_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            hist_acc: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int, use_mxu: int = 0,
                            block_threads: int | None = None):
    """Plain twin of the detailed megaloop kernel (K1), and with use_mxu=1
    of its tensor-core arm (K5, whose products come from mxu.py), at any
    block size the kernel takes (check_block_threads).

    Lanes start + [0, valid_total) are real candidates; their num_uniques
    histogram (bins 0..base+1) is added IN PLACE to hist_acc (int32
    [base+2]), and the n_iters * batch_size - valid_total padding lanes land
    in bin 0 without being computed — what the JAX megaloop's masked lanes
    add. Returns (hist_acc, near-miss count as a 0-dim int32 tensor)."""
    check_block_threads(block_threads, use_mxu)
    total = batch_size * n_iters
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    width = plan.base + 2
    if use_mxu:
        u = _uniques_mxu_chunked(plan, start_limbs, torch.arange(
            valid_total, dtype=torch.int64, device=start_limbs.device))
    else:
        u = num_uniques_lanes(plan, lane_limbs(plan, start_limbs, valid_total))
    hist = torch.bincount(u, minlength=width)[:width]
    hist_acc += hist.to(torch.int32)
    hist_acc[0] += total - valid_total
    nm = (u > plan.near_miss_cutoff).sum().to(torch.int32)
    return hist_acc, nm


# Lanes per chunk of the plain K5: its column sums hold one int64 vector
# per byte column, which a whole 2^21-lane segment would multiply.
MXU_CHUNK_LANES = 1 << 18


def _uniques_mxu_chunked(plan: BasePlan, start_limbs: torch.Tensor, offsets):
    from nice_tpu_torch.ops import mxu

    return torch.cat([
        mxu.uniques_mxu(plan, start_limbs, offsets[c:c + MXU_CHUNK_LANES])
        for c in range(0, offsets.shape[0], MXU_CHUNK_LANES)
    ] or [torch.zeros(0, dtype=torch.int32, device=offsets.device)])


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


# Candidate lanes per chunk of the plain strided count: a 1024-descriptor
# group at b40 (17,408 lanes a descriptor) is walked in pieces of this size
# instead of as one 17.8M-lane set of int64 limb tensors.
STRIDED_CHUNK_LANES = 1 << 18


def strided_offsets(modulus: int, residues: torch.Tensor, periods: int):
    """Candidate offsets (i // R) * M + residues[i % R] of one descriptor,
    i < periods * R, as int64."""
    r = residues.shape[0]
    i = torch.arange(periods * r, dtype=torch.int64, device=residues.device)
    return (i // r) * modulus + residues[i % r]


def niceonly_strided_counts(plan: BasePlan, modulus: int,
                            residues: torch.Tensor, periods: int,
                            desc: torch.Tensor, n_real: int,
                            min_uniques: int | None = None,
                            block_threads: int | None = None):
    """Plain twin of the strided niceonly kernel (K3), at any block size it
    takes (check_block_threads).

    desc: int64 [rows, 12], u32 values: n0, lo and hi as four limbs each,
    LSW first. residues: the stride table's residues modulo `modulus`, int64.
    Row d counts the candidates n = n0 + (i // R) * M + residues[i % R],
    i < periods * R, with n carried through limbs_n limbs (and lo, hi read on
    limbs_n limbs, as the TPU kernel reads them), lo <= n < hi and
    min_uniques <= num_uniques(n) <= base (min_uniques defaults to base:
    num_uniques(n) == base). Returns int32[rows]; rows at or past n_real are
    padding and stay 0. Descriptors go in chunks of about
    STRIDED_CHUNK_LANES candidates, and only the candidates inside [lo, hi)
    reach the digit work."""
    check_block_threads(block_threads)
    rows = desc.shape[0]
    if min_uniques is None:
        min_uniques = plan.base
    counts = torch.zeros(rows, dtype=torch.int32, device=desc.device)
    offs = strided_offsets(modulus, residues, periods)
    step = max(1, STRIDED_CHUNK_LANES // offs.shape[0])
    nl = plan.limbs_n
    for d0 in range(0, n_real, step):
        d = desc[d0:min(n_real, d0 + step)]
        n = add_u32([d[:, i:i + 1] for i in range(nl)], offs[None, :])
        valid = (limbs_ge(n, [d[:, 4 + i:5 + i] for i in range(nl)])
                 & limbs_lt(n, [d[:, 8 + i:9 + i] for i in range(nl)]))
        row, lane = torch.nonzero(valid, as_tuple=True)
        if row.numel() == 0:
            continue
        u = num_uniques_lanes(plan, [x[row, lane] for x in n])
        hit = (u >= min_uniques) & (u <= plan.base)
        counts[d0:d0 + d.shape[0]] = torch.bincount(
            row[hit], minlength=d.shape[0]).to(torch.int32)
    return counts


# --------------------------------------------------------------------------
# The residue congruence and the dense niceonly count (K4)
# --------------------------------------------------------------------------

def lane_residues(plan: BasePlan, n_limbs: list):
    """n mod (b-1) per lane, by JAX's limb fold: the sum of (limb mod m) *
    (2^(32i) mod m) over the limbs, then mod m. Each term is below m^2 <
    2^22, so the sum stays far inside int64."""
    m = plan.base - 1
    acc = torch.zeros_like(torch.as_tensor(n_limbs[0]))
    for i, limb in enumerate(n_limbs):
        acc = acc + (limb % m) * pow(2, 32 * i, m)
    return acc % m


def residue_keep_lanes(plan: BasePlan, n_limbs: list):
    """Per-lane residue-filter membership by direct congruence (copy of
    JAX's residue_keep_lanes): a nice n satisfies n^2 + n^3 == b(b-1)/2
    (mod b-1), since digit sums are kept mod b-1, so a lane survives iff
    r = n mod (b-1) does."""
    m = plan.base - 1
    target = plan.base * (plan.base - 1) // 2 % m
    r = lane_residues(plan, n_limbs)
    t = r * r % m
    return (t + t * r % m) % m == target


# Lanes per chunk of the plain dense count (a full 2^18 x 8 run at b98 would
# otherwise hold 13-limb int64 tensors of 2^21 lanes at once).
DENSE_CHUNK_LANES = 1 << 18


def niceonly_dense_megaloop(plan: BasePlan, batch_size: int, n_iters: int,
                            classes: torch.Tensor, start_limbs: torch.Tensor,
                            valid_total: int, min_uniques: int | None = None,
                            use_mxu: int = 0,
                            block_threads: int | None = None):
    """Plain twin of the dense niceonly kernel (K4), in both TPU modes, and
    with use_mxu=1 of its tensor-core arm (K5, products from mxu.py), at any
    block size the kernel takes (check_block_threads).

    Lanes start + [0, valid_total) of an n_iters * batch_size megaloop are
    the candidates. Every lane's n mod (b-1) is held against `classes` (the
    kept residue classes mod b-1, int64: those residue_keep_lanes keeps in
    the fused mode, all b-1 in the unfused one), as JAX masks every lane; a
    kept lane counts when min_uniques <= num_uniques(n) <= base
    (min_uniques defaults to base, the nice test). Returns int32 [count,
    pruned], pruned being the lanes that are not kept. Lanes go in chunks
    of DENSE_CHUNK_LANES, and only kept lanes reach the digit work."""
    check_block_threads(block_threads, use_mxu)
    total = batch_size * n_iters
    if not 0 <= valid_total <= total:
        raise ValueError(f"valid_total {valid_total} outside [0, {total}]")
    if min_uniques is None:
        min_uniques = plan.base
    dev = start_limbs.device
    member = torch.zeros(plan.base - 1, dtype=torch.bool, device=dev)
    member[classes] = True
    count = kept = 0
    for c0 in range(0, valid_total, DENSE_CHUNK_LANES):
        g = torch.arange(c0, min(valid_total, c0 + DENSE_CHUNK_LANES),
                         dtype=torch.int64, device=dev)
        n = add_u32([start_limbs[i] for i in range(plan.limbs_n)], g)
        idx = torch.nonzero(member[lane_residues(plan, n)]).flatten()
        kept += idx.numel()
        if idx.numel() and use_mxu:
            u = _uniques_mxu_chunked(plan, start_limbs, g[idx])
        elif idx.numel():
            u = num_uniques_lanes(plan, [x[idx] for x in n])
        if idx.numel():
            count += int(((u >= min_uniques) & (u <= plan.base)).sum())
    return torch.tensor([count, valid_total - kept], dtype=torch.int32,
                        device=dev)
