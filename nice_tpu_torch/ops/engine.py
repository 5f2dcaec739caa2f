"""Field engine: detailed and niceonly fields on one device (the port's
counterpart of nice_tpu/ops/engine.py process_range_detailed and
process_range_niceonly).

Detailed and dense niceonly share the pipelined host loop (the JAX
engine's _SliceFeed, _Collector and _CkptTicker on one device): a feed
thread prepares each item's start limbs FEED_DEPTH_DEFAULT items ahead and
uploads them from a ring of pinned buffers without a stream sync; the
dispatcher enqueues one kernel an item and hands its count, copied to
pinned memory with one CUDA event, to a collector thread that keeps
DISPATCH_WINDOW items in flight and alone does the readbacks, the rare-path
re-scans, the histogram folds and the checkpoints, which follow a ticker
(every CKPT_EVERY_BATCHES items or CKPT_EVERY_SECS seconds). On the CPU the
same threads run the kernels' plain versions; only the event waits vanish.

Detailed, per field:
  * out-of-range slivers go to the scalar oracle (the kernels' fixed-width
    digit extraction holds only inside the base's valid range);
  * the core is dispatched one megaloop segment (batch_size * segment lanes)
    at a time into a device-resident int32 histogram (K1, or K5 where
    use_mxu resolves to 1), handed to the collector before any bin could
    saturate and at checkpoints; the shape comes from resolve_tuning (an
    explicit argument, else the tuned winner, else the JAX defaults);
  * a segment whose near-miss count is nonzero is re-scanned through K2
    plus on-device survivor compaction, falling back to the dense per-lane
    array when the compaction overflows;
  * checkpoint_cb gets the JAX engine's state dict, and resume= accepts
    such a state from either engine.

Niceonly, per field, bases of at most 4 u32 limbs (b10-b97): the strided
pipeline of three threads. MSD filter threads (the host library) turn the
core into surviving ranges; the dispatcher packs them into stride
descriptors, 1024 to a group, and launches K3 on each group; the collector
reads each group's counts back, re-scans the descriptors with hits on the
host (a count that disagrees is an error), audits a sample of the
zero-count ones and checkpoints on its ticker.

Niceonly, bases above 4 u32 limbs (b98 and up): the dense loop. The MSD
filter turns the core into surviving ranges up front, each cut into runs
of at most batch_size * segment lanes (resolve_tuning, as above); K4 (or
K5) counts a run's nice lanes among the residue classes the congruence
keeps, and the collector re-scans a run that counts any through K2 (a
count that disagrees is an error).

A kernel failure raises: there is no downgrade to another backend.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from nice_tpu_torch import native
from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import (
    FieldResults,
    FieldSize,
    NiceNumberSimple,
    UniquesDistributionSimple,
)
from nice_tpu_torch.ops import adaptive_floor, autotune, cuda_build, msd_filter, mxu
from nice_tpu_torch.ops import stride_filter
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import scalar
from nice_tpu_torch.ops.limbs import BasePlan, get_plan, int_to_limbs

log = logging.getLogger(__name__)

# Lanes per batch and batches per megaloop segment (the JAX defaults), the
# shape an untuned run takes (resolve_tuning).
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


def resolve_tuning(mode: str, base: int, device, batch_size: int | None = None,
                   segment: int | None = None, use_mxu: int | None = None,
                   backend: str = "device") -> tuple[int, int, int]:
    """(batch_size, segment, use_mxu) of one field: each an explicit
    argument, else the tuned winner of (mode, base, device type)
    (ops/autotune.py), else the default (DEFAULT_BATCH_SIZE,
    MEGALOOP_SEGMENT_DEFAULT, 0). The explicit argument takes the place of
    the JAX engine's NICE_TPU_* pin. use_mxu selects K5 in place of K1/K4;
    it is forced to 0 where mxu.supports_plan rejects the base's plan, so a
    stale winner or argument never selects a kernel that cannot take it.
    backend "scalar" has none of these knobs and gets plain defaults.

    JAX's other knobs, block_rows and carry_interval, have no counterpart:
    the kernels carry in 64-bit registers at a fixed block size."""
    if backend == "scalar":
        return batch_size or DEFAULT_BATCH_SIZE, 1, 0
    dev = torch.device(device)
    batch = autotune.choose(mode, base, dev, "batch_size", DEFAULT_BATCH_SIZE,
                            batch_size)
    seg = autotune.choose(mode, base, dev, "megaloop", MEGALOOP_SEGMENT_DEFAULT,
                          segment)
    arm = autotune.choose(mode, base, dev, "use_mxu", 0, use_mxu)
    if arm and not mxu.supports_plan(get_plan(base)):
        arm = 0
    return batch, max(1, seg), 1 if arm else 0


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


# ---------------------------------------------------------------------------
# The pipelined host loop: feed thread, collector and checkpoint ticker (the
# JAX engine's _SliceFeed, _Collector and _CkptTicker, on one device)
# ---------------------------------------------------------------------------

# Items (detailed segments, dense runs) in flight between the dispatcher and
# the collector, and how many items the feed's producer thread prepares
# ahead of the dispatcher (0 prepares them inline: the synchronous A/B).
DISPATCH_WINDOW = 32
FEED_DEPTH_DEFAULT = 2

# Items a feed block carries: the producer computes a block's start limbs
# at once, the dispatcher uploads them in one copy and reads the block's
# counts back in one copy. Every hand-off between the threads costs a
# wake-up under the interpreter lock (and every torch call releases it), so
# they go a block at a time, not an item at a time.
FEED_BLOCK = 16

# Blocks of the feed's pinned upload ring: the device may lag the
# dispatcher by this many blocks before an upload waits for a copy.
FEED_RING_SLOTS = 4

# Periodic-checkpoint cadence defaults (overridable per call).
CKPT_EVERY_BATCHES = 256
CKPT_EVERY_SECS = 30.0

# Feed stats of the most recent detailed or dense loop, the keys of the JAX
# engine's _record_feed_stats (one device: no reshards) plus ring_waits, the
# uploads that found their ring slot's last copy still in flight.
LAST_FEED_STATS: dict = {}


class _Collector:
    """Bounded-queue worker thread applying `fn` to put() items (readbacks,
    rare-path re-scans, folds and checkpoints run off the dispatch thread).

    On worker failure the queue is drained so producers' put() calls never
    block forever; shutdown() joins without raising (safe in a finally) and
    raise_if_failed() re-raises the worker's exception on the caller. As a
    context manager, __exit__ always shuts the worker down. With `stream`
    the worker enqueues on that stream (_adopt)."""

    def __init__(self, fn, maxsize: int, name: str, on_fail=None,
                 stream=None):
        self._fn = fn
        self._err: list = [None]
        self._on_fail = on_fail
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._t = threading.Thread(target=self._run, name=name, daemon=True)
        self._t.start()

    def _run(self):
        try:
            _adopt(self._stream)
            while True:
                item = self._q.get()
                if item is None:
                    return
                self._fn(*item)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            self._err[0] = e
            if self._on_fail is not None:
                self._on_fail()  # lets the producer stop at its next chunk
            while self._q.get() is not None:
                pass  # drain so producers' puts never block forever

    def __enter__(self) -> "_Collector":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def failed(self) -> bool:
        return self._err[0] is not None

    def put(self, item) -> None:
        self._q.put(item)

    def shutdown(self) -> None:
        self._q.put(None)
        self._t.join()

    def raise_if_failed(self) -> None:
        if self._err[0] is not None:
            raise self._err[0]


class _CkptTicker:
    """Decides when a periodic checkpoint is due: every N batches or every T
    seconds, whichever fires first (either can be 0 to disable that trigger).
    Single-threaded by construction — each dispatch path owns one ticker and
    tick()s it from exactly one thread."""

    def __init__(self, every_batches=None, every_secs=None):
        self.every_batches = int(
            every_batches if every_batches is not None else CKPT_EVERY_BATCHES
        )
        self.every_secs = float(
            every_secs if every_secs is not None else CKPT_EVERY_SECS
        )
        self._batches = 0
        self._last = time.monotonic()

    def tick(self) -> bool:
        self._batches += 1
        now = time.monotonic()
        if (self.every_batches > 0 and self._batches >= self.every_batches) or (
            self.every_secs > 0 and now - self._last >= self.every_secs
        ):
            self._batches = 0
            self._last = now
            return True
        return False


class _HostRing:
    """Uploads of small int64 arrays to the device without a stream sync: R
    pinned host slots, R device slots and R events, each slot of `shape`.
    upload(values) writes the next host slot (values may fill fewer rows
    than the slot has), copies it into its device slot with
    non_blocking=True on the current stream, records the slot's event on
    `stream` and returns the device slot. A host slot is written again only
    once the event recorded after its last copy has completed (`waits`
    counts the uploads that had to wait for it). A device slot is
    overwritten by the copy enqueued R uploads later, on the same stream,
    so the caller must have enqueued every kernel that reads a slot by then
    (the feed uploads a block only once the block before is enqueued). On
    the CPU each upload is a fresh tensor and nothing waits."""

    def __init__(self, slots: int, shape: tuple, dev: torch.device,
                 stream=None):
        self._cuda = dev.type == "cuda"
        self._slots = max(1, slots)
        self._shape = tuple(shape)
        self._next = 0
        self.waits = 0
        if not self._cuda:
            return
        self._stream = stream if stream is not None else \
            torch.cuda.current_stream(dev)
        host = torch.empty((self._slots, *shape), dtype=torch.int64,
                           pin_memory=True)
        self._host_np = host.numpy()
        self._host = list(host)
        self._dev = list(torch.empty((self._slots, *shape), dtype=torch.int64,
                                     device=dev))
        self._events = [torch.cuda.Event() for _ in range(self._slots)]
        self._used = [False] * self._slots

    def upload(self, values: np.ndarray) -> torch.Tensor:
        if (values.shape[1:] != self._shape[1:]
                or len(values) > self._shape[0]):
            raise ValueError(f"{values.shape} does not fit a ring slot of "
                             f"{self._shape}")
        if not self._cuda:
            return torch.from_numpy(np.array(values, dtype=np.int64))
        i = self._next
        self._next = (i + 1) % self._slots
        ev = self._events[i]
        if self._used[i] and not ev.query():
            self.waits += 1
            ev.synchronize()
        n = len(values)
        self._host_np[i][:n] = values
        self._dev[i][:n].copy_(self._host[i][:n], non_blocking=True)
        ev.record(self._stream)
        self._used[i] = True
        return self._dev[i]


class _Readbacks:
    """Small per-item device outputs (a segment's near-miss count, a run's
    [count, pruned]) read back a block at a time without a stream sync: R
    device blocks of FEED_BLOCK zeroed slots that kernels count into, R
    pinned host blocks and R events. slot() is the next item's device slot
    (None on the CPU, where the plain version makes its own); add(t, meta)
    takes the item's output (copied into its slot on the card when the
    kernel did not count into it) and what the collector needs to know of
    the item; fetch() copies the pending slots into the block's host rows
    with non_blocking=True, records its event, zeroes the device block
    after the copy and returns (the items' metas, host rows, event) for
    the collector. A host block is written again R fetches later, by which time
    the collector's bounded window has read it (R > the window + 2)."""

    def __init__(self, shape: tuple, dev: torch.device, window: int,
                 stream=None):
        self._cuda = dev.type == "cuda"
        self._blocks = window + 3
        self._b = 0
        self._pending: list = []
        self._metas: list = []
        if not self._cuda:
            return
        self._stream = stream if stream is not None else \
            torch.cuda.current_stream(dev)
        dev_all = torch.zeros((self._blocks, FEED_BLOCK, *shape),
                              dtype=torch.int32, device=dev)
        self._dev = list(dev_all)
        self._dev_rows = [list(b) for b in dev_all]
        self._host = list(torch.empty((self._blocks, FEED_BLOCK, *shape),
                                      dtype=torch.int32, pin_memory=True))
        self._events = [torch.cuda.Event() for _ in range(self._blocks)]

    def __len__(self) -> int:
        return len(self._pending)

    def slot(self):
        if not self._cuda:
            return None
        return self._dev_rows[self._b][len(self._pending)]

    def add(self, t: torch.Tensor, meta) -> None:
        if self._cuda:
            row = self._dev_rows[self._b][len(self._pending)]
            if t is not row:
                row.copy_(t)  # a result the kernel did not count into
        self._pending.append(t)
        self._metas.append(meta)

    def fetch(self):
        n = len(self._pending)
        metas = tuple(self._metas)
        self._metas.clear()
        if not self._cuda:
            out = torch.stack(self._pending)
            self._pending.clear()
            return metas, out, None
        i = self._b
        self._b = (i + 1) % self._blocks
        self._pending.clear()
        host = self._host[i][:n]
        host.copy_(self._dev[i][:n], non_blocking=True)
        ev = self._events[i]
        ev.record(self._stream)
        self._dev[i].zero_()
        return metas, host, ev


def _to_host(tensors, dev: torch.device, stream=None):
    """(host copies, event): device tensors copied into fresh pinned host
    tensors with non_blocking=True on the current stream and one event
    recorded on `stream` after the copies; read the copies only after
    _wait(event). On the CPU the tensors themselves and no event."""
    if dev.type == "cpu":
        return tuple(tensors), None
    hosts = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    ev = torch.cuda.Event()
    ev.record(stream if stream is not None else torch.cuda.current_stream(dev))
    return tuple(hosts), ev


def _adopt(stream) -> None:
    """Make `stream` (the caller's, captured once) the current stream of a
    pipeline thread, so that what it enqueues is ordered with the
    dispatcher's kernels; nothing on the CPU."""
    if stream is not None:
        torch.cuda.set_stream(stream)


def _wait(event) -> None:
    """Block until the copies before `event` have landed (a no-op on the
    CPU, where there is no event)."""
    if event is not None:
        event.synchronize()


class _FeedItem(NamedTuple):
    start: torch.Tensor  # the segment's start limbs, on the device
    seg: tuple           # (start, valid) as Python ints
    markers: tuple       # ((seg_idx, cursor),) AFTER this item
    lanes: int           # valid lanes of the item


class _SliceFeed:
    """Host->device feed over one work queue (the JAX engine's _SliceFeed on
    one device: queues holds a single list of ascending disjoint [start,
    end) segments). Each get() yields the next item of at most `lanes`
    candidates, never across a segment boundary, its start limbs on their
    way to the device. Items come FEED_BLOCK at a time: the producer
    computes a block's start limbs (numpy, no torch call) and the
    dispatcher, in get(), uploads them through a _HostRing in one copy (no
    stream sync). With depth > 0 a producer thread computes blocks ahead
    of the dispatcher, at least `depth` items (whole blocks); depth == 0
    computes each block inline (the synchronous A/B). Only the dispatcher
    uploads, after it has enqueued every kernel of the block before, so a
    ring of any size keeps each device block until its kernels are
    enqueued.

    markers are the resume vocabulary: item.markers = ((seg_idx, cursor),)
    AFTER the item, so remaining(queues, markers-of-the-last-dispatched-
    item) is exactly the uncovered range."""

    def __init__(self, plan: BasePlan, queues, lanes: int, dev: torch.device,
                 depth: int, ring_slots: int | None = None, stream=None):
        self.ring = _HostRing(FEED_RING_SLOTS if ring_slots is None
                              else ring_slots, (FEED_BLOCK, plan.limbs_n),
                              dev, stream)
        self._blocks = self._generate(plan, queues, lanes)
        self._items: deque = deque()
        self._depth = depth
        if depth > 0:
            self._q: queue.Queue = queue.Queue(
                maxsize=-(-depth // FEED_BLOCK))
            self._err: list = [None]
            self._stop = threading.Event()
            self._t = threading.Thread(target=self._fill, name="engine-feed",
                                       daemon=True)
            self._t.start()

    @staticmethod
    def start_markers(queues) -> tuple:
        return tuple((0, q[0][0] if q else 0) for q in queues)

    @staticmethod
    def _generate(plan, queues, lanes):
        """(start limbs int64[n, limbs_n], [(seg, markers)] * n) of up to
        FEED_BLOCK items at a time."""
        (q,) = queues
        si, cur = 0, (q[0][0] if q else 0)
        while si < len(q):
            metas = []
            while si < len(q) and len(metas) < FEED_BLOCK:
                take = min(lanes, q[si][1] - cur)
                seg = (cur, take)
                cur += take
                if cur >= q[si][1]:
                    si += 1
                    if si < len(q):
                        cur = q[si][0]
                if take > 0:  # an empty segment has nothing to dispatch
                    metas.append((seg, ((si, cur),)))
            if not metas:
                return
            yield (np.stack([int_to_limbs(seg[0], plan.limbs_n)
                             for seg, _ in metas]).astype(np.int64), metas)

    @staticmethod
    def remaining(queues, markers) -> list[tuple[int, int]]:
        """Uncovered [start, end) segments given the markers of the last
        successfully dispatched item (sorted, merged)."""
        rem = []
        for q, (si, cur) in zip(queues, markers):
            if si < len(q):
                if cur < q[si][1]:
                    rem.append((max(cur, q[si][0]), q[si][1]))
                rem.extend((s, e) for s, e in q[si + 1:])
        rem.sort()
        merged: list[list[int]] = []
        for s, e in rem:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def _fill(self):
        try:
            for block in self._blocks:
                while not self._stop.is_set():
                    try:
                        self._q.put(block, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by get()
            self._err[0] = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def get(self):
        """Next _FeedItem, or None once the queue is exhausted."""
        if not self._items:
            if self._depth == 0:
                block = next(self._blocks, None)
            else:
                block = self._q.get()
                if block is None and self._err[0] is not None:
                    raise self._err[0]
            if block is None:
                return None
            rows, metas = block
            starts = self.ring.upload(rows)
            self._items.extend(_FeedItem(starts[j], seg, markers, seg[1])
                               for j, (seg, markers) in enumerate(metas))
        return self._items.popleft()

    def stop(self) -> None:
        """Tear the producer down (idempotent; safe mid-stream: the queue is
        drained until the producer thread exits, so no put() deadlocks)."""
        if self._depth == 0:
            self._blocks.close()
            return
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._t.join(timeout=0.05)
        self._t.join()


def _record_feed_stats(mode: str, gaps, dispatches: int, depth: int,
                       ring_waits: int) -> None:
    g = np.asarray(gaps, dtype=np.float64)
    LAST_FEED_STATS.clear()
    LAST_FEED_STATS.update({
        "mode": mode,
        "feed_depth": int(depth),
        "dispatches": int(dispatches),
        "gaps": int(g.size),
        "idle_p50": float(np.percentile(g, 50)) if g.size else 0.0,
        "idle_p95": float(np.percentile(g, 95)) if g.size else 0.0,
        "idle_mean": float(g.mean()) if g.size else 0.0,
        "idle_total": float(g.sum()) if g.size else 0.0,
        "n_dev_start": 1,
        "n_dev_end": 1,
        "reshards": 0,
        "reshard_secs": 0.0,
        "ring_waits": int(ring_waits),
    })


def _dispatch_loop(feed: _SliceFeed, collector: _Collector, dispatch,
                   after, progress, total: int, done: int):
    """The dispatcher shared by the detailed and dense loops: take each item
    from the feed, dispatch(item) (enqueue its kernel and hand its readback
    to the collector), then after(markers) (ticker, flushes), then
    progress(done, total). Stops when the feed is exhausted or the collector
    failed. Returns (dispatches, the host's gaps between dispatches)."""
    gaps: list[float] = []
    n_batch = 0
    t_prev = None
    try:
        while not collector.failed():
            item = feed.get()
            if item is None:
                break
            now = time.monotonic()
            if t_prev is not None and len(gaps) < 65536:
                gaps.append(now - t_prev)
            dispatch(item)
            t_prev = time.monotonic()
            n_batch += 1
            done += item.lanes
            after(item.markers)
            if progress is not None:
                progress(done, total)
    finally:
        feed.stop()
    return n_batch, gaps


def rare_scan_survivors(plan: BasePlan, batch_start: int, valid: int,
                        batch_size: int, device, thresh: int,
                        ring: _HostRing | None = None):
    """Yield (number, num_uniques) for every candidate in [batch_start,
    +valid) with num_uniques > thresh, in ascending order: K2 plus on-device
    compaction per sub-batch, so only (count, idx[cap], uniq[cap]) cross to
    the host (one non-blocking copy and event a sub-batch); a sub-batch
    whose count overflows cap reads the dense array. Start limbs go up
    through `ring` (a two-slot _HostRing when None)."""
    dev = torch.device(device)
    sub_size = min(RARE_SCAN_BATCH, batch_size)
    cap = min(SURVIVOR_CAP, sub_size)
    if ring is None:
        ring = _HostRing(2, (plan.limbs_n,), dev)
    done = 0
    while done < valid:
        sub_valid = min(sub_size, valid - done)
        sub_start = batch_start + done
        start = ring.upload(
            int_to_limbs(sub_start, plan.limbs_n).astype(np.int64))
        (count, idx, uniq), ev = _to_host(ce.survivors_batch(
            plan, sub_size, thresh, cap, start, sub_valid), dev)
        _wait(ev)
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
    use_mxu: int | None = None,
    progress=None,
    checkpoint_cb=None,
    resume=None,
    checkpoint_batches: int | None = None,
    checkpoint_secs: float | None = None,
    feed_depth: int = FEED_DEPTH_DEFAULT,
) -> FieldResults:
    """Histogram (bins 1..base) and near-miss list of a field, exact.

    device: "cuda" (the default) runs the kernels; "cpu" runs their plain
    PyTorch versions, through the same feed, window, ticker and markers.
    backend "scalar" runs the Python-int oracle instead (no checkpoints).
    batch_size, segment and use_mxu (1: K5 in place of K1) resolve through
    resolve_tuning: the argument, else the tuned winner, else the default.
    feed_depth: segments the feed thread prepares ahead (0: inline).
    progress(done, total) is called after each dispatched segment.

    checkpoint_cb(state) fires every checkpoint_batches segments or
    checkpoint_secs seconds (CKPT_EVERY_BATCHES / CKPT_EVERY_SECS when
    None), on the collector thread, the only thread that touches the
    histogram and near misses, with {"cursor", "hist" (int64[base+2]),
    "nice_numbers" [(number, uniques)], "remaining" [[start, end]]}: every
    candidate outside the remaining segments, slivers included, is folded
    in. resume takes such a state (from this engine or the JAX engine) and
    finishes the field without recomputing slivers. A failure in the feed,
    a kernel or the collector (checkpoint_cb included) is raised here, with
    every thread joined."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "scalar":
        if checkpoint_cb is not None or resume is not None:
            raise ValueError("backend 'scalar' neither checkpoints nor resumes")
        return scalar.process_range_detailed(range_, base)
    dev = resolve_device(device)
    batch_size, seg, arm = resolve_tuning("detailed", base, dev, batch_size,
                                          segment, use_mxu)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    seg = clamp_segment(seg, batch_size)

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
    done0 = total - sum(e - s for s, e in segments)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    rare_ring = _HostRing(2, (plan.limbs_n,), dev, stream)
    window = -(-DISPATCH_WINDOW // FEED_BLOCK)  # blocks of segments
    readbacks = _Readbacks((), dev, window, stream)
    ticker = (_CkptTicker(checkpoint_batches, checkpoint_secs)
              if checkpoint_cb is not None else None)
    t0 = time.monotonic()

    def collect_item(kind, *payload):
        if kind == "nm":  # a block of segments' near-miss counts
            segs, nms, ev = payload
            _wait(ev)
            for (seg_start, seg_valid), nm in zip(segs, nms.tolist()):
                if nm > 0:
                    nice_numbers.extend(
                        NiceNumberSimple(number=number, num_uniques=uniq)
                        for number, uniq in rare_scan_survivors(
                            plan, seg_start, seg_valid, batch_size, dev,
                            plan.near_miss_cutoff, rare_ring))
        elif kind == "stats":  # an accumulator handed over by a flush
            (h,), ev = payload
            _wait(ev)
            hist[:] += h.numpy().astype(np.int64)
        else:  # "ckpt": after its "nm" and "stats", so the state matches
            # its cursor
            (rem,) = payload
            checkpoint_cb({
                "cursor": rem[0][0] if rem else core.end(),
                "hist": hist.copy(),
                "nice_numbers": [
                    (n.number, n.num_uniques) for n in nice_numbers
                ],
                "remaining": [[s, e] for s, e in rem],
            })

    queues = [segments]
    st = {"acc": torch.zeros(plan.base + 2, dtype=torch.int32, device=dev),
          "since_flush": 0}

    with _Collector(collect_item, window, "detailed-collect",
                    stream=stream) as collector:

        def read_back():
            if len(readbacks):
                collector.put(("nm", *readbacks.fetch()))

        def flush():
            read_back()
            collector.put(("stats", *_to_host((st["acc"],), dev, stream)))
            st["acc"] = torch.zeros(plan.base + 2, dtype=torch.int32,
                                    device=dev)
            st["since_flush"] = 0

        def dispatch(item):
            st["acc"], nm = ce.detailed_accum_megaloop(
                plan, batch_size, seg, st["acc"], item.start, item.seg[1], arm,
                nm_out=readbacks.slot())
            readbacks.add(nm, item.seg)
            st["since_flush"] += 1
            if len(readbacks) == FEED_BLOCK:
                read_back()

        def after(markers):
            if ticker is not None and ticker.tick():
                flush()
                collector.put(("ckpt", _SliceFeed.remaining(queues, markers)))
            elif st["since_flush"] >= flush_every:
                flush()

        feed = _SliceFeed(plan, queues, lanes, dev, feed_depth, stream=stream)
        n_batch, gaps = _dispatch_loop(feed, collector, dispatch, after,
                                       progress, total, done0)
        if not collector.failed():
            read_back()
            if st["since_flush"]:
                flush()
    _record_feed_stats("detailed", gaps, n_batch, feed_depth, feed.ring.waits)
    collector.raise_if_failed()
    log.debug(
        "detailed b%d [%d, %d) on %s (batch %d x %d, use_mxu %d, feed depth "
        "%d): %.3fs, %d segments, %d near misses", base, range_.start(),
        range_.end(), dev, batch_size, seg, arm, feed_depth,
        time.monotonic() - t0, n_batch, len(nice_numbers),
    )

    nice_numbers.sort(key=lambda n: n.number)
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution, nice_numbers=tuple(nice_numbers))


# ---------------------------------------------------------------------------
# Niceonly: the strided pipeline
# ---------------------------------------------------------------------------

# Descriptor groups in flight between the dispatcher and the collector: each
# holds one int32 count per row and six u64 columns, so memory stays small.
STRIDE_WINDOW = 16

# The collector re-scans every STRIDE_AUDIT_EVERY'th zero-count descriptor
# on the host (0 disables). Descriptors with hits are always re-scanned, so
# an overcount fails at once; the sample catches an undercount to zero.
STRIDE_AUDIT_EVERY = 1024

# Threads of the MSD filter pool: one per CPU.
FILTER_THREADS = os.cpu_count() or 1

# The last niceonly field's phase split (what its log line prints), for a
# caller that reports where the time went, and its first descriptor group's
# columns ("first_group", None when it had none): the inputs of the field's
# first K3 launch. The last field wins.
LAST_NICEONLY_STATS: dict = {}


def _pick_stride_depth(base: int, typical: int, max_k: int = 3) -> tuple[int, int]:
    """The CRT stride depth k and the periods per descriptor.

    Deeper k (modulus (b-1) * b^k filters k low digits of n^2 and n^3)
    trades a bigger modulus (coarser descriptor spans, more masked lanes on
    narrow MSD ranges) for fewer candidate lanes per number. The score is
    the expected device lanes per covered number on a surviving range of
    width `typical`; a deeper k must beat the shallower by more than 5 %.
    Callers derive `typical` from the MSD floor alone (1.5 x floor: leaves
    lie in (floor, 2 * floor]), so the choice is fixed per (base, floor).
    Depths are scored by stride_residue_count (no table build); periods is
    a power of two."""
    typical = max(1, typical)
    best: tuple[float, int, int] | None = None
    for k in range(1, max_k + 1):
        modulus = (base - 1) * base**k
        if modulus >= 1 << 32:
            break  # the kernel's offset arithmetic is u32
        num_res = stride_filter.stride_residue_count(base, k)
        if num_res == 0:
            return k, 1  # provably nothing to search at any depth
        if num_res > ce.STRIDED_OFFS_LANES_MAX:
            continue  # one period alone exceeds the lanes of a descriptor
        cap = min(
            ce.STRIDED_PERIODS_MAX,
            ((1 << 32) - 1) // modulus,  # u32 span
            max(1, ce.STRIDED_OFFS_LANES_MAX // num_res),  # lanes/descriptor
        )
        raw = max(1, min(cap, typical // modulus))
        periods = 1 << (raw.bit_length() - 1)
        span = periods * modulus
        descs = -(-typical // span)
        score = descs * periods * num_res / typical
        if best is None or score < best[0] * 0.95:
            best = (score, k, periods)
    if best is None:
        raise ValueError(f"base {base}: no stride depth fits a descriptor")
    return best[1], best[2]


def _msd_depth_for(size: int, floor: int) -> int:
    """Recursion depth that reaches `floor`-sized leaves: the filter's fixed
    depth cap grows with the field (1e13 / 2^22 leaves would exceed any
    floor)."""
    need = max(0, (max(1, size) // max(1, floor)).bit_length()) + 1
    return max(msd_filter.MSD_RECURSIVE_MAX_DEPTH, need)


def _host_strided_scan(table, base: int, start: int, end: int) -> list[int]:
    """Exact nice numbers among stride candidates in [start, end), through
    the host library."""
    if start >= end:
        return []
    first, idx = table.first_valid_at_or_after(start)
    if first >= end:
        return []
    return native.iterate_range_strided(first, idx, end, base, table.gap_array)


def host_niceonly(range_: FieldSize, base: int) -> list[int]:
    """Nice numbers of a range on the host alone: the library's MSD filter at
    its default floor, then its stride iteration over each surviving range
    (the depth-1 table). The yardstick a device field's slice is held to."""
    table = stride_filter.get_stride_table(base, 1)
    if table.num_residues == 0:
        return []
    found: list[int] = []
    for r in msd_filter.get_valid_ranges(range_, base):
        found.extend(_host_strided_scan(table, base, r.start(), r.end()))
    return found


def _strided_floor(ctrl, field_size: int) -> int:
    """Effective MSD floor of a field: the controller's floor, raised so a
    field never spans more than ~2^21 recursion leaves (a 1e13 field at a
    floor tuned for 1e9 fields would make ~5e5 leaves whose boundaries waste
    half of each descriptor). A pinned floor is honoured exactly."""
    if ctrl.pinned:
        return ctrl.current()
    return max(ctrl.current(), min(field_size >> 21, adaptive_floor.FLOOR_MAX))


class StridedSetup(NamedTuple):
    plan: BasePlan
    ctrl: adaptive_floor.AdaptiveFloor
    floor: int
    k: int
    periods: int
    table: stride_filter.StrideTable


def strided_setup(base: int, field_size: int) -> StridedSetup | None:
    """The shapes of a field's strided run: MSD floor (from the process's
    floor controller), stride depth, periods and table, as the JAX engine
    derives them on one device. None when the base needs more than 4 limbs
    or provably holds no nice number."""
    plan = get_plan(base)
    if plan.limbs_n > 4 or stride_filter.stride_residue_count(base, 1) == 0:
        return None
    ctrl = adaptive_floor.get_floor_controller("strided")
    floor = _strided_floor(ctrl, field_size)
    k, periods = _pick_stride_depth(base, floor + floor // 2)
    table = stride_filter.get_stride_table(base, k)
    if table.num_residues == 0:
        return None  # a deeper refinement emptied out: nothing can be nice
    return StridedSetup(plan, ctrl, floor, k, periods, table)


# Descriptors travel as numpy columns, two u64 halves per value (strided
# bases reach four u32 limbs, and b60-b95 have range ends above 2^64):
# (n0_lo, n0_hi, lo_lo, lo_hi, hi_lo, hi_hi).
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_MASK32 = np.uint64(0xFFFFFFFF)


def coalesce_runs(ranges, flush_limit: int):
    """Merge ascending (lo, hi) ranges that touch into maximal runs, each
    flushed once it spans flush_limit numbers: every run boundary costs
    about half a descriptor of masked lanes, and the flush keeps a gap-free
    field streaming instead of held back whole."""
    cur_lo = cur_hi = None
    for lo, hi in ranges:
        if cur_hi == lo:
            cur_hi = hi
        else:
            if cur_lo is not None:
                yield cur_lo, cur_hi
            cur_lo, cur_hi = lo, hi
        if cur_hi - cur_lo >= flush_limit:
            yield cur_lo, cur_hi
            cur_lo = cur_hi = None
    if cur_lo is not None:
        yield cur_lo, cur_hi


def _halves(x: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    return (np.full(k, x & 0xFFFFFFFFFFFFFFFF, dtype=np.uint64),
            np.full(k, x >> 64, dtype=np.uint64))


def desc_columns(runs, modulus: int, span: int):
    """Per run [lo, hi): descriptors n0 = first + i * span from the run's
    modulus-aligned start, each covering [n0, n0 + span) clipped to the
    run, as six u64 columns."""
    for lo, hi in runs:
        first = (lo // modulus) * modulus
        k = -(-(hi - first) // span)
        if k <= 0:
            continue
        offs = np.arange(k, dtype=np.uint64) * np.uint64(span)
        n0_lo = (np.uint64(first & 0xFFFFFFFFFFFFFFFF) + offs) & _M64
        carry = (n0_lo < offs).astype(np.uint64)
        n0_hi = np.uint64(first >> 64) + carry
        yield (n0_lo, n0_hi, *_halves(lo, k), *_halves(hi, k))


def grouped_columns(columns, group_cap: int):
    """Re-chunk per-run columns into groups of group_cap descriptors (the
    last group ragged)."""
    bufs: list[list[np.ndarray]] = [[] for _ in range(6)]
    buffered = 0
    for cols in columns:
        for b, c in zip(bufs, cols):
            b.append(c)
        buffered += len(cols[0])
        while buffered >= group_cap:
            cat = [np.concatenate(b) for b in bufs]
            yield tuple(c[:group_cap] for c in cat)
            bufs = [[c[group_cap:]] for c in cat]
            buffered = len(bufs[0][0])
    if buffered:
        yield tuple(np.concatenate(b) for b in bufs)


def pack_descriptors(cols, group_cap: int) -> np.ndarray:
    """u32[group_cap, 12] rows (n0, lo, hi as four LSW-first limbs each),
    zero past the group's descriptors: the TPU kernel's descriptor table."""
    arr = np.zeros((group_cap, ce.DESC_WIDTH), dtype=np.uint32)
    k = len(cols[0])
    for j in range(6):  # u64 half j fills u32 limb pair (2j, 2j + 1)
        arr[:k, 2 * j] = (cols[j] & _MASK32).astype(np.uint32)
        arr[:k, 2 * j + 1] = (cols[j] >> np.uint64(32)).astype(np.uint32)
    return arr


def desc_value(cols, j: int, g: int) -> int:
    """Value j (0 n0, 1 lo, 2 hi) of descriptor g of a group's columns."""
    return int(cols[2 * j][g]) | (int(cols[2 * j + 1][g]) << 64)


def _filter_chunks(core: FieldSize, floor: int):
    """The producer's chunks of a field: enough leaves that each library
    call amortizes its overhead, and at most ~256 chunks per field."""
    chunk = max(floor * 256, core.size() // 256)
    pos = core.start()
    while pos < core.end():
        end = min(pos + chunk, core.end())
        yield pos, end
        pos = end


@functools.lru_cache(maxsize=None)
def _device_residues(base: int, k: int, device: str) -> torch.Tensor:
    """The (base, k) stride table's residues on a device, uploaded once."""
    table = stride_filter.get_stride_table(base, k)
    return torch.from_numpy(table.residues_u32.astype(np.int64)).to(device)


def _niceonly_strided(core: FieldSize, base: int, s: StridedSetup, dev,
                      progress, checkpoint, ticker=None) -> list[int]:
    """Nice numbers of the core through the three-thread pipeline.

    producer (a pool of FILTER_THREADS): the MSD filter over the field's
        chunks, results kept in chunk order, into a bounded queue;
    dispatcher (this thread): coalesced runs -> descriptor columns ->
        groups of STRIDED_DESC_MAX -> one K3 launch per group;
    collector: each group's counts back to the host; re-scan of every
        descriptor with hits (a disagreeing count raises), the zero-count
        audit, and checkpoint(watermark, found) when the ticker (ticked
        once a group) fires, where `found` holds every nice number below
        the watermark (groups are collected in order and the filters' gaps
        hold none). Descriptor tables go up through a pinned _HostRing."""
    plan, table, periods = s.plan, s.table, s.periods
    modulus = table.modulus
    span = periods * modulus
    group_cap = ce.STRIDED_DESC_MAX
    filter_threads, audit_every = FILTER_THREADS, STRIDE_AUDIT_EVERY
    residues = _device_residues(base, s.k, str(dev))
    ring = _HostRing(2 * STRIDE_WINDOW, (group_cap, ce.DESC_WIDTH), dev)
    nice: list[int] = []

    host_busy = [0.0]  # filter seconds, summed over the pool's threads
    dev_busy = [0.0]   # collector seconds: readback and re-scans
    prod_err: list = [None]
    stop = threading.Event()
    q_ranges: queue.Queue = queue.Queue(maxsize=8)
    n_ranges = [0]

    def produce():
        def filt(span_):
            t0 = time.monotonic()
            rs = msd_filter.get_valid_ranges(
                FieldSize(span_[0], span_[1]), base, min_range_size=s.floor,
                max_depth=_msd_depth_for(span_[1] - span_[0], s.floor),
            )
            return rs, time.monotonic() - t0

        try:
            with ThreadPoolExecutor(max_workers=filter_threads,
                                    thread_name_prefix="niceonly-msd") as pool:
                pending: deque = deque()
                it = _filter_chunks(core, s.floor)
                done = False
                while not stop.is_set():
                    while not done and len(pending) < filter_threads + 2:
                        span_ = next(it, None)
                        if span_ is None:
                            done = True
                            break
                        pending.append((span_, pool.submit(filt, span_)))
                    if not pending:
                        break
                    span_, fut = pending.popleft()
                    rs, secs = fut.result()
                    host_busy[0] += secs
                    while not stop.is_set():
                        try:
                            q_ranges.put(rs, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if progress is not None:
                        # The filter front: dispatch and device trail it by
                        # at most the bounded queues.
                        progress(span_[1] - core.start(), core.size())
                if stop.is_set():
                    for _, fut in pending:
                        fut.cancel()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            prod_err[0] = e
        finally:
            while True:
                try:
                    q_ranges.put(None, timeout=0.2)  # sentinel
                    break
                except queue.Full:
                    if stop.is_set():
                        break  # the dispatcher has left; nobody waits

    def range_stream():
        while True:
            rs = q_ranges.get()
            if rs is None:
                if prod_err[0] is not None:
                    raise prod_err[0]
                return
            n_ranges[0] += len(rs)
            for r in rs:
                yield r.start(), r.end()

    audit_seen = [0]  # zero-count descriptors seen so far

    def collect(cols, counts_dev, launched):
        t0 = time.monotonic()
        if launched is not None:
            launched.synchronize()  # the group's kernel has finished
        k = len(cols[0])
        flat = counts_dev.cpu().numpy()[:k]
        for g in np.nonzero(flat)[0].tolist():
            n0, lo, hi = (desc_value(cols, j, g) for j in range(3))
            count = int(flat[g])
            found = _host_strided_scan(table, base, max(lo, n0),
                                       min(hi, n0 + span))
            if len(found) != count:
                raise RuntimeError(
                    f"device/host nice-count mismatch in descriptor "
                    f"(n0={n0}, [{lo},{hi})): device {count}, host {len(found)}"
                )
            nice.extend(found)
        if audit_every:
            zeros = np.nonzero(flat == 0)[0]
            for j in range((-audit_seen[0]) % audit_every, len(zeros),
                           audit_every):
                g = int(zeros[j])
                n0, lo, hi = (desc_value(cols, j2, g) for j2 in range(3))
                found = _host_strided_scan(table, base, max(lo, n0),
                                           min(hi, n0 + span))
                if found:
                    raise RuntimeError(
                        f"device undercount: descriptor (n0={n0}, "
                        f"[{lo},{hi})) counted 0 on device but host found "
                        f"{len(found)} nice numbers (audit)"
                    )
            audit_seen[0] += len(zeros)
        if checkpoint is not None and (ticker is None or ticker.tick()):
            # The coverage frontier of this group: the end of its last
            # descriptor.
            watermark = min(desc_value(cols, 2, k - 1),
                            desc_value(cols, 0, k - 1) + span)
            checkpoint(watermark, list(nice))
        dev_busy[0] += time.monotonic() - t0

    producer = threading.Thread(target=produce, name="niceonly-msd",
                                daemon=True)
    t_wall0 = time.monotonic()
    producer.start()
    n_desc = n_groups = 0
    first_group = None
    # Dispatcher time: gen (descriptor columns and waiting on the filter),
    # disp (packing, upload and launch), put (waiting on the collector).
    t_gen = t_disp = t_put = 0.0
    try:
        with _Collector(collect, STRIDE_WINDOW, "niceonly-collect",
                        on_fail=stop.set) as collector:
            try:
                runs = coalesce_runs(range_stream(), span * 64)
                t0 = time.monotonic()
                for cols in grouped_columns(desc_columns(runs, modulus, span),
                                            group_cap):
                    t1 = time.monotonic()
                    t_gen += t1 - t0
                    if collector.failed():
                        break
                    k_real = len(cols[0])
                    n_desc += k_real
                    n_groups += 1
                    if first_group is None:
                        first_group = cols
                    desc = ring.upload(
                        pack_descriptors(cols, group_cap).astype(np.int64))
                    counts = ce.strided_niceonly_batch(
                        plan, modulus, residues, periods, desc, k_real)
                    launched = None
                    if dev.type == "cuda":
                        launched = torch.cuda.Event()
                        launched.record(torch.cuda.current_stream(dev))
                    t2 = time.monotonic()
                    t_disp += t2 - t1
                    collector.put((cols, counts, launched))
                    t0 = time.monotonic()
                    t_put += t0 - t2
            finally:
                # Stop the producer before the collector drains, so a failed
                # run does not filter on for a whole chunk.
                stop.set()
    finally:
        producer.join()
    if prod_err[0] is not None:
        raise prod_err[0]
    collector.raise_if_failed()
    wall = time.monotonic() - t_wall0
    # The controller balances the two stages' wall times: the pool's busy
    # seconds over its real parallelism against the collector's. A floor the
    # huge-field guard raised was not the controller's, so it learns nothing.
    if s.floor == s.ctrl.current():
        eff = max(1, min(filter_threads, os.cpu_count() or 1))
        s.ctrl.observe(host_busy[0] / eff, dev_busy[0], core.size())
    LAST_NICEONLY_STATS.clear()
    LAST_NICEONLY_STATS.update(
        base=base, start=core.start(), end=core.end(), wall=wall,
        msd_busy=host_busy[0], floor=s.floor, ranges=n_ranges[0],
        collect_busy=dev_busy[0], k=s.k, periods=periods,
        descriptors=n_desc, groups=n_groups, gen=t_gen, disp=t_disp,
        put=t_put, nice=len(nice), filter_threads=filter_threads,
        first_group=first_group,
    )
    log.info(
        "niceonly b%d [%d, %d): wall %.3fs | msd %.3fs busy (floor %d, %d "
        "ranges) | collect %.3fs busy (k=%d periods=%d, %d descriptors, %d "
        "groups) | dispatch gen %.3fs disp %.3fs put %.3fs | %d nice",
        base, core.start(), core.end(), wall, host_busy[0], s.floor,
        n_ranges[0], dev_busy[0], s.k, periods, n_desc, n_groups,
        t_gen, t_disp, t_put, len(nice),
    )
    return nice


# ---------------------------------------------------------------------------
# Niceonly: the dense loop (bases above 4 u32 limbs)
# ---------------------------------------------------------------------------

def _niceonly_dense(core: FieldSize, base: int, dev, nice_numbers: list, *,
                    progress=None, checkpoint_cb=None, resume=None,
                    batch_size: int | None = None,
                    segment: int | None = None,
                    use_mxu: int | None = None,
                    checkpoint_batches: int | None = None,
                    checkpoint_secs: float | None = None,
                    feed_depth: int = FEED_DEPTH_DEFAULT) -> None:
    """Append the nice numbers of the core to nice_numbers: the twin of the
    JAX engine's single-device dense loop, on the pipelined host loop.

    The MSD filter (the "dense" floor controller's floor) turns the core
    into surviving ranges up front; each is cut into runs of at most
    batch_size * segment lanes, and K4 (K5 where use_mxu resolves to 1; the
    shape comes from resolve_tuning) counts each run's nice lanes among the
    residue classes the congruence keeps (the TPU's fused mode: the count
    equals the unfused one's, since no other class holds a nice number). The
    collector reads each run's [count, pruned] from pinned memory and sends
    a run that counts any through rare_scan_survivors (K2 above base - 1),
    which must find as many. progress(done, total) follows the dispatched
    lanes. checkpoint_cb fires on the ticker (checkpoint_batches runs or
    checkpoint_secs seconds) with the JAX dense loop's state {"cursor",
    "hist": None, "nice_numbers" (nice_numbers so far, prior entries
    included), "remaining", "filtered": True}; a resume state marked
    "filtered" has its remaining segments scanned as they are (the filters'
    gaps are proven empty), any other is filtered again."""
    plan = get_plan(base)
    batch_size, seg, arm = resolve_tuning("niceonly", base, dev, batch_size,
                                          segment, use_mxu)
    seg = clamp_segment(seg, batch_size)
    lanes = batch_size * seg
    classes = ce.niceonly_classes(plan, True, str(dev))
    nice0 = len(nice_numbers)
    ctrl = adaptive_floor.get_floor_controller("dense")
    floor = ctrl.current()
    t0 = time.monotonic()
    ran_filter = resume is None or not resume.get("filtered")
    segments = ([(core.start(), core.end())] if resume is None
                else _resume_segments(resume, core.start(), core.end()))
    if ran_filter:
        segments = [
            (r.start(), r.end()) for s, e in segments
            for r in msd_filter.get_valid_ranges(
                FieldSize(s, e), base, min_range_size=floor,
                max_depth=_msd_depth_for(e - s, floor))
        ]
    msd_secs = time.monotonic() - t0
    total = sum(e - s for s, e in segments)
    runs: list[tuple[int, int]] = []
    tally = {"kept": 0, "pruned": 0}
    kernel = "niceonly_dense_mma" if arm else "niceonly_dense"
    launches0 = ce.LAUNCHES[kernel]
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    rare_ring = _HostRing(2, (plan.limbs_n,), dev, stream)
    window = -(-DISPATCH_WINDOW // FEED_BLOCK)  # blocks of runs
    readbacks = _Readbacks((2,), dev, window, stream)
    ticker = (_CkptTicker(checkpoint_batches, checkpoint_secs)
              if checkpoint_cb is not None else None)

    def collect_item(kind, *payload):
        if kind == "count":  # a block of runs' [count, pruned]
            block, counts, ev = payload
            _wait(ev)
            for (pos, valid), (count, n_pruned) in zip(block, counts.tolist()):
                tally["kept"] += valid - n_pruned
                tally["pruned"] += n_pruned
                if count == 0:
                    continue
                found = [n for n, _ in rare_scan_survivors(
                    plan, pos, valid, batch_size, dev, base - 1, rare_ring)]
                if len(found) != count:
                    raise RuntimeError(
                        f"K4 counted {count} nice numbers in [{pos}, "
                        f"{pos + valid}), the rare scan found {len(found)}")
                nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=base)
                                    for n in found)
        else:  # "ckpt": every run before the marker is collected
            (rem,) = payload
            checkpoint_cb({
                "cursor": rem[0][0] if rem else core.end(),
                "hist": None,
                "nice_numbers": [(n.number, n.num_uniques)
                                 for n in nice_numbers],
                "remaining": [[a, b] for a, b in rem],
                "filtered": True,
            })

    queues = [segments]
    t1 = time.monotonic()
    with _Collector(collect_item, window, "dense-collect",
                    stream=stream) as collector:

        def read_back():
            if len(readbacks):
                collector.put(("count", *readbacks.fetch()))

        def dispatch(item):
            readbacks.add(ce.niceonly_dense_megaloop(
                plan, batch_size, seg, classes, item.start, item.seg[1],
                use_mxu=arm, out=readbacks.slot()), item.seg)
            runs.append(item.seg)
            if len(readbacks) == FEED_BLOCK:
                read_back()

        def after(markers):
            if ticker is not None and ticker.tick():
                read_back()
                collector.put(("ckpt", _SliceFeed.remaining(queues, markers)))

        feed = _SliceFeed(plan, queues, lanes, dev, feed_depth, stream=stream)
        n_batch, gaps = _dispatch_loop(feed, collector, dispatch, after,
                                       progress, total, 0)
        if not collector.failed():
            read_back()
    loop_secs = time.monotonic() - t1
    _record_feed_stats("niceonly", gaps, n_batch, feed_depth, feed.ring.waits)
    collector.raise_if_failed()
    if ran_filter:
        ctrl.observe(msd_secs, loop_secs, core.size())
    median = sorted(runs, key=lambda r: r[1])[len(runs) // 2] if runs else None
    done = sum(v for _, v in runs)
    LAST_NICEONLY_STATS.clear()
    LAST_NICEONLY_STATS.update(
        base=base, start=core.start(), end=core.end(), msd_secs=msd_secs,
        floor=floor, ranges=len(segments), loop_secs=loop_secs,
        runs=len(runs), lanes=done, kept=tally["kept"],
        pruned=tally["pruned"], classes=int(classes.shape[0]),
        launches=ce.LAUNCHES[kernel] - launches0, batch_size=batch_size,
        segment=seg, use_mxu=arm, feed_depth=feed_depth,
        nice=len(nice_numbers) - nice0, first_run=runs[0] if runs else None,
        median_run=median,
    )
    log.info(
        "niceonly-dense b%d [%d, %d): msd %.3fs (floor %d, %d ranges) | "
        "loop %.3fs (%d runs, %d lanes, %d kept, %d pruned, feed depth %d) | "
        "%d nice", base, core.start(), core.end(), msd_secs, floor,
        len(segments), loop_secs, len(runs), done, tally["kept"],
        tally["pruned"], feed_depth, len(nice_numbers) - nice0,
    )


def process_range_niceonly(
    range_: FieldSize,
    base: int,
    *,
    device="cuda",
    backend: str = "device",
    batch_size: int | None = None,
    segment: int | None = None,
    use_mxu: int | None = None,
    progress=None,
    checkpoint_cb=None,
    resume=None,
    checkpoint_batches: int | None = None,
    checkpoint_secs: float | None = None,
    feed_depth: int = FEED_DEPTH_DEFAULT,
) -> FieldResults:
    """The nice numbers of a field (distribution empty), exact.

    device: "cuda" (the default) runs the kernels; "cpu" runs their plain
    PyTorch versions. backend "scalar" runs the Python-int oracle instead
    (no checkpoints). Out-of-range slivers go to the oracle. Bases of at
    most 4 u32 limbs (b10-b97) take the strided pipeline (K3); bases above
    (b98 and up) the dense loop (K4, _niceonly_dense). batch_size, segment
    and use_mxu (1: K5 in place of K4) shape the dense loop's runs through
    resolve_tuning; the strided pipeline's shapes come from the MSD floor
    (K3 has no tensor-core arm), and it takes none of them; feed_depth is
    the dense loop's (runs its feed thread prepares ahead, 0: inline).
    checkpoint_cb fires on a ticker, every checkpoint_batches descriptor
    groups or runs or checkpoint_secs seconds (CKPT_EVERY_BATCHES /
    CKPT_EVERY_SECS when None), from the collector thread.

    Strided: progress(done, total) reports the filter front, from a worker
    thread; checkpoint_cb(state) gets {"cursor", "hist": None,
    "nice_numbers" [(number, base)]}: every nice number below the cursor is
    listed; a resume state's "remaining" segments collapse to their lowest
    start. Dense: progress follows the dispatched lanes and checkpoint_cb
    gets the JAX dense loop's state (see _niceonly_dense). resume takes a
    state of this engine or of the JAX engine and finishes the field
    without recomputing slivers."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "scalar":
        if checkpoint_cb is not None or resume is not None:
            raise ValueError("backend 'scalar' neither checkpoints nor resumes")
        return scalar.process_range_niceonly(range_, base)
    dev = resolve_device(device)
    pre, core, post = _clamp_to_base_range(range_, base)
    if core is None:
        if resume is not None or checkpoint_cb is not None:
            raise ValueError(
                f"range {range_} lies outside base {base}'s valid range; "
                "only the scalar oracle scans it (no checkpoints)"
            )
        return scalar.process_range_niceonly(range_, base)

    nice_numbers: list[NiceNumberSimple] = []
    if resume is None:
        for part in (pre, post):
            if part is not None:
                nice_numbers.extend(
                    scalar.process_range_niceonly(part, base).nice_numbers)
    else:
        nice_numbers = [
            NiceNumberSimple(number=int(n), num_uniques=int(u))
            for n, u in resume["nice_numbers"]
        ]
        segments = _resume_segments(resume, core.start(), core.end())
        if not segments:
            nice_numbers.sort(key=lambda n: n.number)
            return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))

    if get_plan(base).limbs_n > 4:
        _niceonly_dense(core, base, dev, nice_numbers, progress=progress,
                        checkpoint_cb=checkpoint_cb, resume=resume,
                        batch_size=batch_size, segment=segment,
                        use_mxu=use_mxu, checkpoint_batches=checkpoint_batches,
                        checkpoint_secs=checkpoint_secs, feed_depth=feed_depth)
        nice_numbers.sort(key=lambda n: n.number)
        return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))

    if (batch_size, segment, use_mxu) != (None, None, None):
        raise ValueError(f"base {base} takes the strided pipeline, which has "
                         "no batch_size, segment or use_mxu")
    if resume is not None:
        # The pipeline scans one contiguous core: resume from the lowest
        # uncovered number, dropping restored numbers the rescan will find
        # again (slivers and numbers past the core stay).
        pos, core_end = segments[0][0], core.end()
        nice_numbers = [n for n in nice_numbers
                        if n.number < pos or n.number >= core_end]
        core = FieldSize(pos, core_end)

    found: list[int] = []
    s = strided_setup(base, core.size())
    if s is not None:
        ckpt = None
        if checkpoint_cb is not None:
            prior = [(n.number, n.num_uniques) for n in nice_numbers]

            def ckpt(watermark, nice_so_far):
                checkpoint_cb({
                    "cursor": watermark,
                    "hist": None,
                    "nice_numbers": prior + [(n, base) for n in nice_so_far],
                })

        found = _niceonly_strided(
            core, base, s, dev, progress, ckpt,
            _CkptTicker(checkpoint_batches, checkpoint_secs))
    nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=base)
                        for n in found)
    nice_numbers.sort(key=lambda n: n.number)
    return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))


# ---------------------------------------------------------------------------
# Warm-up: a field's builds, made before the field runs
# ---------------------------------------------------------------------------

def _device_type(device) -> str:
    """"cuda" or "cpu" of an entry point's `device` argument, without a torch
    call (a client warms on a thread of its own while a field runs)."""
    kind = str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return kind


def warm_detailed(base: int, *, device="cuda", backend: str = "device") -> None:
    """Build and load the libraries a detailed field of this base launches:
    the main library (K1; K2 and K5 above b97) and, at the plan tier's bases
    (b10-b97), the base's own library (K2 of the rare path and K5's detailed
    arm). The JAX engine's warm_detailed compiles the executables of the
    field's tuned shape; here either arm of any shape runs from these two
    libraries, so no tuning is resolved. On the CPU (the plain versions) and
    for the scalar oracle there is nothing to build.

    No kernel launch and no torch call: the client's prefetch runs this on
    its own thread while another field runs, and nvcc runs as a subprocess.
    A failed build raises; the field's own first launch would build again
    and raise too."""
    if backend == "scalar" or _device_type(device) == "cpu":
        return
    plan = get_plan(base)
    if not ce.supports_base(plan):
        raise ValueError(f"base {base} exceeds the kernels' histogram")
    cuda_build.load()
    if ce.plan_tier_takes(plan):
        ce.plan_library(plan)


def warm_niceonly(base: int, field_size: int = 0, *, device="cuda",
                  backend: str = "device") -> None:
    """Make what a niceonly field of this base and size needs before its
    first number: the host library of the MSD filter; at the strided bases
    (b10-b97) the field's strided setup (MSD floor, stride depth and table,
    as strided_setup derives them from field_size) and, on the card, the
    base's own library (K3); above b97 the main library (K4, K5 and K2).
    The host work runs on the CPU too. No kernel launch and no torch call
    (see warm_detailed); a failed build raises."""
    if backend == "scalar":
        return
    on_card = _device_type(device) == "cuda"
    native.load()
    plan = get_plan(base)
    if plan.limbs_n > 4:
        if on_card:
            cuda_build.load()
        return
    if strided_setup(base, max(1, field_size)) is not None and on_card:
        ce.plan_library(plan)
