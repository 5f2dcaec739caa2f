"""Field engine: one detailed-mode field on one device (the port's
counterpart of nice_tpu/ops/engine.py process_range_detailed).

Per field:
  * out-of-range slivers go to the scalar oracle (the kernels' fixed-width
    digit extraction holds only inside the base's valid range);
  * the core is dispatched one megaloop segment (batch_size * segment lanes)
    at a time into a device-resident int32 histogram (K1), flushed to the
    host before any bin could saturate and at checkpoints;
  * each segment's near-miss count is read back, and a segment with any
    near miss is re-scanned through K2 plus on-device survivor compaction,
    falling back to the dense per-lane array when the compaction overflows;
  * checkpoint_cb fires at every segment boundary with the JAX engine's
    state dict, and resume= accepts such a state from either engine.

The loop is synchronous (one segment in flight). A kernel failure raises:
there is no downgrade to another backend.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import (
    FieldResults,
    FieldSize,
    NiceNumberSimple,
    UniquesDistributionSimple,
)
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import scalar
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import BasePlan, get_plan

log = logging.getLogger(__name__)

# Lanes per batch and batches per megaloop segment (the JAX defaults).
DEFAULT_BATCH_SIZE = 1 << 18
MEGALOOP_SEGMENT_DEFAULT = 8

# Rare-path re-scan sub-batch (capped at the batch size) and the survivor
# rows compacted per sub-batch before the dense fallback.
RARE_SCAN_BATCH = 1 << 20
SURVIVOR_CAP = 4096

BACKENDS = ("device", "scalar")


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device` argument. A CUDA device
    without CUDA raises: the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def clamp_segment(segment: int, batch_size: int) -> int:
    """Cap the segment so one segment's lanes stay under half the int32
    range: the histogram flush cadence below assumes it."""
    return max(1, min(int(segment), ((1 << 31) - 1) // (2 * batch_size)))


def _clamp_to_base_range(range_: FieldSize, base: int):
    """(pre, core, post): core is the part inside the base's valid range."""
    br = base_range.get_base_range(base)
    if br is None:
        return (range_, None, None)
    lo = max(range_.start(), br[0])
    hi = min(range_.end(), br[1])
    if lo >= hi:
        return (range_, None, None)
    pre = FieldSize(range_.start(), lo) if range_.start() < lo else None
    post = FieldSize(hi, range_.end()) if hi < range_.end() else None
    return (pre, FieldSize(lo, hi), post)


def _resume_segments(resume: dict, start: int, end: int) -> list[tuple[int, int]]:
    """Uncovered [start, end)-clamped segments of a resume state: its
    "remaining" list when present, else [cursor, end)."""
    if resume.get("remaining") is not None:
        segs = [
            (max(start, int(s)), min(end, int(e)))
            for s, e in resume["remaining"]
        ]
        return [(s, e) for s, e in segs if s < e]
    pos = max(start, min(end, int(resume["cursor"])))
    return [(pos, end)] if pos < end else []


def rare_scan_survivors(plan: BasePlan, batch_start: int, valid: int,
                        batch_size: int, device, thresh: int):
    """Yield (number, num_uniques) for every candidate in [batch_start,
    +valid) with num_uniques > thresh, in ascending order: K2 plus on-device
    compaction per sub-batch, so only (count, idx[cap], uniq[cap]) cross to
    the host; a sub-batch whose count overflows cap reads the dense array."""
    sub_size = min(RARE_SCAN_BATCH, batch_size)
    cap = min(SURVIVOR_CAP, sub_size)
    done = 0
    while done < valid:
        sub_valid = min(sub_size, valid - done)
        sub_start = batch_start + done
        start = ve.start_limbs_tensor(sub_start, plan, device)
        count, idx, uniq = ce.survivors_batch(
            plan, sub_size, thresh, cap, start, sub_valid
        )
        count = int(count)
        if 0 < count <= cap:
            for i, u in zip(idx[:count].tolist(), uniq[:count].tolist()):
                yield sub_start + i, u
        elif count > cap:
            u = ce.uniques_batch(plan, sub_size, start)[:sub_valid]
            hits = torch.nonzero(u > thresh).flatten()
            for i, v in zip(hits.tolist(), u[hits].tolist()):
                yield sub_start + i, v
        done += sub_valid


def process_range_detailed(
    range_: FieldSize,
    base: int,
    *,
    device="cuda",
    backend: str = "device",
    batch_size: int | None = None,
    segment: int | None = None,
    progress=None,
    checkpoint_cb=None,
    resume=None,
) -> FieldResults:
    """Histogram (bins 1..base) and near-miss list of a field, exact.

    device: "cuda" (the default) runs the kernels; "cpu" runs their plain
    PyTorch versions. backend "scalar" runs the Python-int oracle instead
    (no checkpoints). progress(done, total) is called after each segment.
    checkpoint_cb(state) fires at every segment boundary with {"cursor",
    "hist" (int64[base+2]), "nice_numbers" [(number, uniques)],
    "remaining" [[start, end]]}, covering the slivers and everything before
    the remaining segments; resume takes such a state (from this engine or
    the JAX engine) and finishes the field without recomputing slivers."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "scalar":
        if checkpoint_cb is not None or resume is not None:
            raise ValueError("backend 'scalar' neither checkpoints nor resumes")
        return scalar.process_range_detailed(range_, base)
    dev = resolve_device(device)
    batch_size = int(batch_size or DEFAULT_BATCH_SIZE)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    seg = clamp_segment(segment or MEGALOOP_SEGMENT_DEFAULT, batch_size)

    pre, core, post = _clamp_to_base_range(range_, base)
    if core is None:
        if resume is not None or checkpoint_cb is not None:
            raise ValueError(
                f"range {range_} lies outside base {base}'s valid range; "
                "only the scalar oracle scans it (no checkpoints)"
            )
        return scalar.process_range_detailed(range_, base)
    plan = get_plan(base)
    if not ce.supports_base(plan):
        raise ValueError(f"base {base} exceeds the kernels' histogram")

    hist = np.zeros(plan.base + 2, dtype=np.int64)
    nice_numbers: list[NiceNumberSimple] = []
    segments = [(core.start(), core.end())]
    if resume is None:
        for part in (pre, post):
            if part is not None:
                sub = scalar.process_range_detailed(part, base)
                for d in sub.distribution:
                    hist[d.num_uniques] += d.count
                nice_numbers.extend(sub.nice_numbers)
    else:
        if resume.get("hist") is None:
            raise ValueError("detailed resume state is missing a histogram")
        h = np.asarray(resume["hist"], dtype=np.int64)
        if h.shape != hist.shape:
            raise ValueError(f"resume histogram shape {h.shape} != {hist.shape}")
        hist[:] = h
        nice_numbers = [
            NiceNumberSimple(number=int(n), num_uniques=int(u))
            for n, u in resume["nice_numbers"]
        ]
        segments = _resume_segments(resume, core.start(), core.end())

    lanes = batch_size * seg
    # Every segment adds at most `lanes` to one bin (padding included), so
    # flushing every flush_every segments keeps int32 bins far from 2^31.
    flush_every = max(1, ((1 << 31) - 1) // (2 * lanes))
    total = core.size()
    done = total - sum(e - s for s, e in segments)
    acc = torch.zeros(plan.base + 2, dtype=torch.int32, device=dev)
    since_flush = 0
    t0 = time.monotonic()

    def flush():
        nonlocal since_flush
        hist[:] += acc.cpu().numpy().astype(np.int64)
        acc.zero_()
        since_flush = 0

    for si, (s, e) in enumerate(segments):
        pos = s
        while pos < e:
            valid = min(lanes, e - pos)
            start = ve.start_limbs_tensor(pos, plan, dev)
            acc, nm = ce.detailed_accum_megaloop(
                plan, batch_size, seg, acc, start, valid
            )
            since_flush += 1
            if int(nm) > 0:
                for number, uniq in rare_scan_survivors(
                    plan, pos, valid, batch_size, dev, plan.near_miss_cutoff
                ):
                    nice_numbers.append(
                        NiceNumberSimple(number=number, num_uniques=uniq)
                    )
            pos += valid
            done += valid
            if checkpoint_cb is not None:
                flush()
                rem = ([(pos, e)] if pos < e else []) + segments[si + 1:]
                checkpoint_cb({
                    "cursor": rem[0][0] if rem else core.end(),
                    "hist": hist.copy(),
                    "nice_numbers": [
                        (n.number, n.num_uniques) for n in nice_numbers
                    ],
                    "remaining": [[a, b] for a, b in rem],
                })
            elif since_flush >= flush_every:
                flush()
            if progress is not None:
                progress(done, total)
    flush()
    log.debug(
        "detailed b%d [%d, %d) on %s: %.3fs, %d near misses",
        base, range_.start(), range_.end(), dev, time.monotonic() - t0,
        len(nice_numbers),
    )

    nice_numbers.sort(key=lambda n: n.number)
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution, nice_numbers=tuple(nice_numbers))
