"""Field engine: detailed and niceonly fields on one device or on a mesh of
slices (the port's counterpart of nice_tpu/ops/engine.py
process_range_detailed and process_range_niceonly).

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

A kernel failure raises: there is no downgrade to another backend, and
neither has the engine.dispatch fault site (faults/injector.py), whose
injected fault raises out of the field.

On a mesh (resolve_mesh: a device list of at least two live slices, one
process driving them all; parallel/mesh.py) the core's remaining segments
are partitioned into one queue a slice, a _MeshFeed yields an item of one
segment a slice, and each slice's kernel (K1, K3 or K4) is enqueued on the
slice's own stream by the one dispatcher thread (_mesh_loop); the detailed
rows fold at each flush. A failed dispatch downshifts onto the surviving
slices (elastic) or raises DispatchError with a resume state.

Observability (obs/): each device field runs in an engine.detailed /
engine.niceonly-strided / -dense / -host span (engine.scalar for the
oracle) and feeds the JAX engine's series (dispatches, numbers, readback
bytes, stats transfers, batch kernel seconds, descriptors, audits, filter
pruned, host fallback, feed idle, kernel dispatch seconds). On the
dispatcher and collector threads the instrumentation is list appends and
int increments; the series take them once a field, after the collector has
drained, so no registry lock is taken a segment. The detailed and dense
loops carry the device-step profiler (obs/stepprof.py): h2d_feed around
the feed's get, device_compute and a fence after each dispatch, readback
and fold on the collector; off, it costs one attribute check an item.
On one device a detailed field's engine.detailed span runs from the
route's choice to the return, tiled by the steps engine.setup (tuning,
slivers, rings, threads), engine.loop, engine.drain (the last hand-offs
to the collector's join) and engine.finish; when the field is recorded
(obs.trace.field: a sink, or torch's profiler at its entry) the
collector's items and rare.scan are profiler ranges, and the same clock
reads the loop takes for its gaps sum its gets, launches and waits into
the record. Off, that costs the loop one boolean check an item.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from nice_tpu_torch import native, obs
from nice_tpu_torch.core import base_range, number_stats
from nice_tpu_torch.core.types import (
    FieldResults,
    FieldSize,
    NiceNumberSimple,
    UniquesDistributionSimple,
)
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.obs import stepprof, trace
from nice_tpu_torch.obs.series import (
    CKPT_BATCHES_SKIPPED,
    CKPT_RESTORES,
    ENGINE_AUDITS,
    ENGINE_BATCH_KERNEL_SECONDS,
    ENGINE_DESCRIPTORS,
    ENGINE_DISPATCHES,
    ENGINE_FILTER_PRUNED,
    ENGINE_HOST_FALLBACK,
    ENGINE_NUMBERS,
    ENGINE_READBACK_BYTES,
    ENGINE_STATS_TRANSFERS,
    ENGINE_SURVIVOR_OVERFLOW,
    MESH_FEED_IDLE,
    MESH_RESHARD_SECONDS,
    MESH_RESHARDS,
    MESH_SLICE_CURSOR,
)
from nice_tpu_torch.ops import adaptive_floor, autotune, cuda_build, msd_filter, mxu
from nice_tpu_torch.ops import stride_filter
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import scalar
from nice_tpu_torch.ops.limbs import BasePlan, get_plan, int_to_limbs
from nice_tpu_torch.parallel import mesh as pmesh
from nice_tpu_torch.utils import lockdep

log = logging.getLogger(__name__)

# Lanes per batch and batches per megaloop segment (the JAX defaults), the
# shape an untuned run takes (resolve_tuning).
DEFAULT_BATCH_SIZE = 1 << 18
MEGALOOP_SEGMENT_DEFAULT = 8

# Rare-path re-scan sub-batch (capped at the batch size) and the survivor
# rows compacted per sub-batch before the dense fallback.
RARE_SCAN_BATCH = 1 << 20
SURVIVOR_CAP = 4096

# device: the kernels (or their plain versions on the CPU); scalar: the
# Python-int oracle; native: the host library on a thread pool.
BACKENDS = ("device", "scalar", "native")


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
                   backend: str = "device", block_threads: int | None = None
                   ) -> tuple[int, int, int, int]:
    """(batch_size, segment, use_mxu, block_threads) of one field: each an
    explicit argument, else the tuned winner of (mode, base, device type)
    (ops/autotune.py), else the default (DEFAULT_BATCH_SIZE,
    MEGALOOP_SEGMENT_DEFAULT, 0, cuda_engine.DEFAULT_BLOCK_THREADS). The
    explicit argument takes the place of the JAX engine's NICE_TPU_* pin.
    use_mxu selects K5 in place of K1/K4; it is forced to 0 where
    mxu.supports_plan rejects the base's plan, so a stale winner or argument
    never selects a kernel that cannot take it. block_threads, the threads
    of a block of K1/K4/K5 (JAX's block_rows), is not forced: a value the
    resolved kernel does not take (cuda_engine.check_block_threads) raises,
    whether an argument or a stale winner. backend "scalar" has none of
    these knobs and gets plain defaults.

    JAX's carry_interval has no counterpart: the kernels carry in 64-bit
    registers."""
    if backend == "scalar":
        return batch_size or DEFAULT_BATCH_SIZE, 1, 0, ce.DEFAULT_BLOCK_THREADS
    dev = torch.device(device)
    batch = autotune.choose(mode, base, dev, "batch_size", DEFAULT_BATCH_SIZE,
                            batch_size)
    seg = autotune.choose(mode, base, dev, "megaloop", MEGALOOP_SEGMENT_DEFAULT,
                          segment)
    arm = autotune.choose(mode, base, dev, "use_mxu", 0, use_mxu)
    if arm and not mxu.supports_plan(get_plan(base)):
        arm = 0
    arm = 1 if arm else 0
    threads = autotune.choose(mode, base, dev, "block_threads",
                              ce.DEFAULT_BLOCK_THREADS, block_threads)
    return batch, max(1, seg), arm, ce.check_block_threads(threads, arm)


# The int32 histogram bins' budget: a flush hands the accumulator to the
# collector before any bin could pass half of it.
ACC_LIMIT = (1 << 31) - 1


def clamp_segment(segment: int, batch_size: int, n_dev: int = 1) -> int:
    """Cap the segment so that one dispatch's lanes, batch_size * segment on
    each of n_dev slices, stay under half the int32 range: the histogram
    flush cadence (_flush_every) assumes it. The reference's rule
    (_clamp_segment), which budgets every slice's lanes against one row:
    the bound holds for the folded sum as well as for each slice's row."""
    return max(1, min(int(segment), ACC_LIMIT // (2 * batch_size * n_dev)))


def _flush_every(lanes: int) -> int:
    """Dispatches between flushes when each adds at most `lanes` to a bin
    (padding included): the bins stay under half of ACC_LIMIT."""
    return max(1, ACC_LIMIT // (2 * lanes))


def niceonly_takes_batch(base: int, backend: str = "device") -> bool:
    """Whether a niceonly field of this base takes a batch_size: the dense
    loop (b98 and up) and the oracle's checkpoint chunks do; the strided
    pipeline (b10-b97 on the device) takes its shapes from the MSD floor
    and refuses one."""
    return backend == "scalar" or get_plan(base).limbs_n > 4


def page_quantum(mode: str, base: int, *, device="cuda",
                 backend: str = "device", batch_size: int | None = None) -> int:
    """Numbers per loop segment of this workload's shape: batch_size x
    clamp_segment(segment, batch_size), each resolved as the field's own
    loop resolves it (resolve_tuning: the argument, else the tuned winner,
    else the default). The scheduler's page alignment quantum: a page cut
    at a multiple of it from its field's start starts and ends on a segment
    boundary of the field's uninterrupted detailed loop, so a page handoff
    never splits a segment."""
    batch, seg, _, _ = resolve_tuning(mode, base, device, batch_size,
                                      backend=backend)
    # nicelint: allow C2 (ROADMAP queue 3: batch_size has a lower check only, as in the reference)
    return max(1, batch) * clamp_segment(seg, max(1, batch))


def detailed_dispatches(range_: FieldSize, base: int, *, device="cuda",
                        batch_size: int | None = None) -> int:
    """Dispatches of an uninterrupted detailed field on one slice, each one
    call of the engine.dispatch fault site: the part inside the base's valid
    range cut into segments of page_quantum numbers (the shape resolved as
    process_range_detailed resolves it); 0 when no part is in range (the
    oracle runs it)."""
    _, core, _ = _clamp_to_base_range(range_, base)
    if core is None:
        return 0
    return -(-core.size() // page_quantum("detailed", base, device=device,
                                          batch_size=batch_size))


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
# engine's _record_feed_stats (n_dev_start and n_dev_end are 1 and reshards
# 0 off a mesh) plus ring_waits, the uploads that found their ring slot's
# last copy still in flight (summed over the slices on a mesh).
LAST_FEED_STATS: dict = {}


class _Collector:
    """Bounded-queue worker thread applying `fn` to put() items (readbacks,
    rare-path re-scans, folds and checkpoints run off the dispatch thread).

    On worker failure the queue is drained so producers' put() calls never
    block forever; shutdown() joins without raising (safe in a finally) and
    raise_if_failed() re-raises the worker's exception on the caller. As a
    context manager, __exit__ always shuts the worker down. With `stream`
    the worker enqueues on that stream (_adopt); with `prof` (a
    StepProfiler) a build on the worker counts as the field's compile; with
    `timed`, put() counts the hand-offs that found the queue full
    (`blocked`) and the seconds they waited (`blocked_s`)."""

    def __init__(self, fn, maxsize: int, name: str, on_fail=None,
                 stream=None, prof=None, timed: bool = False):
        self._fn = fn
        self._err: list = [None]
        self._on_fail = on_fail
        self._stream = stream
        self._prof = prof
        self._timed = timed
        self.blocked = 0
        self.blocked_s = 0.0
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._t = threading.Thread(target=self._run, name=name, daemon=True)
        self._t.start()

    def _run(self):
        lockdep.mark_loop_thread()  # a long hold here stalls the card
        try:
            _adopt(self._stream)
            if self._prof is not None:
                self._prof.bind()  # its builds are the field's compile
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
        if not self._timed:
            self._q.put(item)
            return
        try:
            self._q.put_nowait(item)
        except queue.Full:
            t = time.perf_counter()
            self._q.put(item)
            self.blocked += 1
            self.blocked_s += time.perf_counter() - t

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
    the CPU each upload is a fresh tensor and nothing waits. With `timed`,
    `wait_s` sums the seconds the waits took."""

    def __init__(self, slots: int, shape: tuple, dev: torch.device,
                 stream=None, timed: bool = False):
        self._cuda = dev.type == "cuda"
        self._slots = max(1, slots)
        self._shape = tuple(shape)
        self._next = 0
        self.waits = 0
        self._timed = timed
        self.wait_s = 0.0
        if not self._cuda:
            return
        self._stream = stream if stream is not None else \
            torch.cuda.current_stream(dev)
        host = torch.empty((self._slots, *shape), dtype=torch.int64,
                           pin_memory=True)
        # nicelint: allow D1 (a view of the pinned ring: no device read)
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
            t = time.perf_counter() if self._timed else 0.0
            # nicelint: fence (the slot's copy lands before it is rewritten)
            ev.synchronize()
            if self._timed:
                self.wait_s += time.perf_counter() - t
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

    def clear(self) -> None:
        """Drop what is pending and zero every device block: a cached
        mesh step's readbacks start a field as new ones."""
        self._pending.clear()
        self._metas.clear()
        self._b = 0
        if self._cuda:
            for blk in self._dev:
                blk.zero_()

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


def _wait(event, rec=trace.OFF, name: str = "") -> None:
    """Block until the copies before `event` have landed (a no-op on the
    CPU, where there is no event); in a recorded field (rec) the wait's
    seconds go into its record under `name`."""
    if event is not None:
        t = time.perf_counter() if rec.on else 0.0
        # nicelint: fence (the collectors' one wait on the card)
        event.synchronize()
        if rec.on:
            rec.add(name, time.perf_counter() - t)


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
    enqueued. With `timed`, the ring times its waits and the producer sums
    the seconds it computes blocks (`produce_s`) and waits on a full queue
    (`full_s`) over its `produced` blocks.

    markers are the resume vocabulary: item.markers = ((seg_idx, cursor),)
    AFTER the item, so remaining(queues, markers-of-the-last-dispatched-
    item) is exactly the uncovered range."""

    def __init__(self, plan: BasePlan, queues, lanes: int, dev: torch.device,
                 depth: int, ring_slots: int | None = None, stream=None,
                 timed: bool = False):
        self.ring = _HostRing(FEED_RING_SLOTS if ring_slots is None
                              else ring_slots, (FEED_BLOCK, plan.limbs_n),
                              dev, stream, timed)
        self._blocks = self._generate(plan, queues, lanes)
        self._start(depth, timed)

    def _start(self, depth: int, timed: bool = False) -> None:
        self._items: deque = deque()
        self._depth = depth
        self._timed = timed
        self.produced = 0
        self.produce_s = self.full_s = 0.0
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
        lockdep.mark_loop_thread()
        timed = self._timed
        try:
            t = time.perf_counter() if timed else 0.0
            for block in self._blocks:
                if timed:
                    t_made = time.perf_counter()
                    self.produce_s += t_made - t
                while not self._stop.is_set():
                    try:
                        self._q.put(block, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if timed:
                    t = time.perf_counter()
                    self.full_s += t - t_made
                    self.produced += 1
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

    def _next_block(self):
        """The next block, inline or from the producer; None at the end."""
        if self._depth == 0:
            return next(self._blocks, None)
        block = self._q.get()
        if block is None and self._err[0] is not None:
            raise self._err[0]
        return block

    def get(self):
        """Next _FeedItem, or None once the queue is exhausted."""
        if not self._items:
            block = self._next_block()
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


class _MeshItem(NamedTuple):
    starts: tuple   # per slice: its start limbs on its device (None: no lanes)
    segs: tuple     # per slice: (start, valid) as Python ints
    markers: tuple  # per slice: (seg_idx, cursor) AFTER this item
    lanes: int      # valid lanes of the item, over its slices


class _MeshFeed(_SliceFeed):
    """The feed over one work queue a slice (the JAX engine's _SliceFeed in
    full): each item takes up to `lanes` candidates from the head of every
    slice's queue, never across a segment boundary within a slice; a slice
    whose queue is exhausted contributes (core_end, 0) and launches
    nothing, so its markers stay put. The producer computes a block's start
    limbs for every slice at once (numpy, no torch call); get() uploads each
    slice's column of the block with upload(d, rows), through the slice's
    own ring on its stream, on the dispatcher thread only. markers, start
    markers and remaining() are _SliceFeed's, one marker a slice."""

    def __init__(self, plan: BasePlan, queues, lanes: int, core_end: int,
                 upload, depth: int):
        self._upload = upload
        self._n = len(queues)
        self._blocks = self._generate_mesh(plan, queues, lanes, core_end)
        self._start(depth)

    @staticmethod
    def _generate_mesh(plan, queues, lanes, core_end):
        """(start limbs int64[n, slices, limbs_n], [(segs, markers, lanes)]
        * n) of up to FEED_BLOCK items at a time."""
        pos = [[0, q[0][0] if q else 0] for q in queues]
        while True:
            metas = []
            while len(metas) < FEED_BLOCK:
                segs, markers, total = [], [], 0
                for d, q in enumerate(queues):
                    si, cur = pos[d]
                    if si >= len(q):
                        segs.append((core_end, 0))
                        markers.append((si, cur))
                        continue
                    take = min(lanes, q[si][1] - cur)
                    segs.append((cur, take))
                    total += take
                    cur += take
                    if cur >= q[si][1]:
                        si += 1
                        if si < len(q):
                            cur = q[si][0]
                    pos[d] = [si, cur]
                    markers.append((si, cur))
                if total == 0:
                    break
                metas.append((tuple(segs), tuple(markers), total))
            if not metas:
                return
            yield (np.array([[int_to_limbs(st if v else 0, plan.limbs_n)
                              for st, v in segs] for segs, _, _ in metas],
                            dtype=np.int64), metas)
            if len(metas) < FEED_BLOCK:
                return

    def get(self):
        """Next _MeshItem, or None once every slice's queue is exhausted."""
        if not self._items:
            block = self._next_block()
            if block is None:
                return None
            rows, metas = block
            starts = [self._upload(d, rows[:, d])
                      if any(segs[d][1] for segs, _, _ in metas) else None
                      for d in range(self._n)]
            self._items.extend(
                _MeshItem(tuple(st[j] if segs[d][1] else None
                                for d, st in enumerate(starts)),
                          segs, markers, total)
                for j, (segs, markers, total) in enumerate(metas))
        return self._items.popleft()


def _record_feed_stats(mode: str, gaps, dispatches: int, depth: int,
                       ring_waits: int, n_dev_start: int = 1,
                       n_dev_end: int = 1, reshards: int = 0,
                       reshard_secs: float = 0.0, *,
                       block_threads: int) -> None:
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
        "n_dev_start": int(n_dev_start),
        "n_dev_end": int(n_dev_end),
        "reshards": int(reshards),
        "reshard_secs": float(reshard_secs),
        "ring_waits": int(ring_waits),
        "block_threads": int(block_threads),
    })


def _fire_dispatch_fault(n_batch: int, start: int) -> None:
    """The engine.dispatch fault site: any action configured there raises
    out of the field (the port has no downgrade chain to exercise)."""
    act = faults.fire("engine.dispatch", batch=n_batch, start=start)
    if act is not None:
        raise RuntimeError(f"injected engine.dispatch fault: {act}")


class DispatchError(RuntimeError):
    """A field on a mesh of slices failed mid-dispatch and did not (or could
    not) downshift: elastic off, no slice left, or a failure no probe
    pinned on a slice. state: a resume state (the checkpoint_cb contract)
    covering everything folded before the failure, or None when nothing
    could be salvaged; cause: the original exception. The JAX engine's
    BackendDispatchError, which there starts the downgrade chain; the port
    has none, so the field raises."""

    def __init__(self, state, cause: BaseException):
        super().__init__(f"mesh dispatch failed: {cause!r}")
        self.state = state
        self.cause = cause


def _fire_mesh_fault(n_batch: int, n_dev: int, batch_start: int) -> None:
    """The mesh.dispatch fault site: "dead[:i[+j...]]" loses the mesh
    positions i... (default: the last slice) by raising MeshDeviceLost, the
    signal the elastic downshift consumes; "raise" raises a plain
    RuntimeError."""
    act = faults.fire("mesh.dispatch", batch=n_batch, n_dev=n_dev,
                      start=batch_start)
    if act is None:
        return
    if act == "dead" or act.startswith("dead:"):
        lost = ([int(x) for x in act.split(":", 1)[1].split("+")]
                if ":" in act else [n_dev - 1])
        lost = [i for i in lost if 0 <= i < n_dev]
        if lost:
            raise pmesh.MeshDeviceLost(lost)
    raise RuntimeError(f"injected mesh.dispatch fault: {act}")


def _diagnose_survivors(mesh: pmesh.Mesh, err: BaseException):
    """After a failed mesh dispatch: (surviving slices, reason) when one or
    more slices dropped while at least one survives, else (None, "").
    MeshDeviceLost names the positions (and registers the lost slices, so
    the fields after this one start without them); any other failure
    probes every slice."""
    slices = list(mesh.slices)
    if isinstance(err, pmesh.MeshDeviceLost):
        lost = set(i for i in err.lost if i < len(slices))
        if lost and len(lost) < len(slices):
            pmesh.simulate_device_loss(slices[i].id for i in lost)
            return ([s for i, s in enumerate(slices) if i not in lost],
                    "device_lost")
        return None, ""
    alive, lost = pmesh.probe_devices(slices)
    if lost and alive:
        return alive, "probe"
    return None, ""


# Slice tuple -> mesh, as the JAX engine's _MESH_CACHE: a store lands only
# if no invalidation (a downshift) happened while the mesh was built.
_MESH_CACHE: dict = {}
_MESH_CACHE_GEN = 0
_mesh_cache_lock = lockdep.make_lock("ops.engine._mesh_cache_lock")


def _cached_mesh(slices: tuple) -> pmesh.Mesh:
    with _mesh_cache_lock:
        mesh = _MESH_CACHE.get(slices)
        gen = _MESH_CACHE_GEN
    if mesh is not None:
        return mesh
    built = pmesh.make_mesh(slices)
    with _mesh_cache_lock:
        if _MESH_CACHE_GEN == gen:
            return _MESH_CACHE.setdefault(slices, built)
    return built


def _invalidate_mesh_cache() -> None:
    global _MESH_CACHE_GEN
    with _mesh_cache_lock:
        _MESH_CACHE_GEN += 1
        _MESH_CACHE.clear()


def resolve_mesh(dev: torch.device, devices=None, shard: bool = True):
    """(device, mesh) of a field on `dev` (resolve_device's) over `devices`
    (the JAX engine's _mesh_or_none, with the device list an argument where
    JAX takes jax.devices()): devices=None means every visible card on a
    bare "cuda" (cuda:0, cuda:1, ...) and one slice anywhere else. A list
    of at least two live slices (live_devices: the slices no downshift
    marked lost) gives a mesh over them; fewer, or shard=False, give None
    and the one-device path on the list's first live entry (`dev` when
    devices is None). A device list of another kind than `dev`'s raises, and
    so does one whose every slice is marked lost."""
    if devices is None:
        if dev.type != "cuda" or dev.index is not None or not shard:
            return dev, None
        n = torch.cuda.device_count()
        if n < 2:
            return dev, None
        devices = [f"cuda:{i}" for i in range(n)]
    if pmesh.device_kind(devices) != dev.type:
        raise ValueError(f"devices {list(map(str, devices))} are not of "
                         f"device {str(dev)!r}'s kind")
    slices = pmesh.slices_of(devices)
    if not shard:
        return slices[0].device, None
    live = pmesh.live_devices(slices)
    if not live:
        raise RuntimeError(f"every slice of {list(map(str, devices))} is "
                           "marked lost (parallel/mesh.heal_devices)")
    if len(live) < 2:
        return live[0].device, None
    return live[0].device, _cached_mesh(tuple(live))


def _dispatch_loop(feed: _SliceFeed, collector: _Collector, dispatch,
                   after, progress, total: int, done: int,
                   prof: stepprof.StepProfiler, rec=trace.OFF):
    """The dispatcher shared by the detailed and dense loops: take each item
    from the feed, dispatch(item) (enqueue its kernel, hand its readback to
    the collector, return the device tensor the kernel writes), then
    after(markers) (ticker, flushes), then progress(done, total). Stops
    when the feed is exhausted or the collector failed. With the profiler
    on, the feed's get is h2d_feed, and the dispatch with a fence on its
    tensor device_compute. In a recorded field (rec.on: the feed and the
    collector built `timed`) the same clock reads sum the seconds in the
    feed's get and in dispatch, and the loop's end adds them to the record
    beside the ring's waits, the hand-offs that blocked on a full collector
    and the producer's blocks. Returns (dispatches, the host's gaps between
    dispatches)."""
    gaps: list[float] = []
    n_batch = 0
    t_prev = None
    prof_on = prof.enabled
    rec_on = rec.on
    timed = prof_on or rec_on  # hoisted: the disabled per-item cost is a load
    get_s = dispatch_s = 0.0
    faults_on = faults.armed("engine.dispatch")
    try:
        while not collector.failed():
            t_feed = time.perf_counter() if timed else 0.0
            item = feed.get()
            if item is None:
                break
            now = time.perf_counter()
            if timed:
                get_s += now - t_feed
                if prof_on:
                    prof.add("h2d_feed", now - t_feed)
            if t_prev is not None and len(gaps) < 65536:
                gaps.append(now - t_prev)
            if faults_on:
                _fire_dispatch_fault(n_batch, item.seg[0])
            out = dispatch(item)
            if prof_on:
                prof.add("device_compute", time.perf_counter() - now)
                prof.fence(out)
            t_prev = time.perf_counter()
            if rec_on:
                dispatch_s += t_prev - now
            n_batch += 1
            done += item.lanes
            after(item.markers)
            if progress is not None:
                progress(done, total)
    finally:
        feed.stop()
    if rec_on:
        rec.add("feed.get", get_s, n_batch)
        rec.add("feed.dispatch", dispatch_s, n_batch)
        rec.add("feed.ring_wait", feed.ring.wait_s, feed.ring.waits)
        rec.add("feed.handoff", collector.blocked_s, collector.blocked)
        rec.add("feed.produce", feed.produce_s, feed.produced)
        rec.add("feed.full", feed.full_s, feed.produced)
    return n_batch, gaps


def rare_scan_survivors(plan: BasePlan, batch_start: int, valid: int,
                        batch_size: int, device, thresh: int,
                        ring: _HostRing | None = None, rec=trace.OFF):
    """Yield (number, num_uniques) for every candidate in [batch_start,
    +valid) with num_uniques > thresh, in ascending order: K2 plus on-device
    compaction per sub-batch, so only (count, idx[cap], uniq[cap]) cross to
    the host (one non-blocking copy and event a sub-batch); a sub-batch
    whose count overflows cap reads the dense array. Start limbs go up
    through `ring` (a two-slot _HostRing when None). In a recorded field
    (rec) each sub-batch adds its launch calls' seconds to rare.k2 and its
    wait on the copies to rare.wait."""
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
        t = time.perf_counter() if rec.on else 0.0
        (count, idx, uniq), ev = _to_host(ce.survivors_batch(
            plan, sub_size, thresh, cap, start, sub_valid), dev)
        if rec.on:
            rec.add("rare.k2", time.perf_counter() - t)
        _wait(ev, rec, "rare.wait")
        count = int(count)
        if count == 0:
            ENGINE_READBACK_BYTES.labels("survivors").inc(4)
        elif count <= cap:
            ENGINE_READBACK_BYTES.labels("survivors").inc(
                4 + idx.nbytes + uniq.nbytes)
            # nicelint: fence (the survivors, landed at the event above)
            for i, u in zip(idx[:count].tolist(), uniq[:count].tolist()):
                yield sub_start + i, u
        else:
            ENGINE_SURVIVOR_OVERFLOW.inc()
            u = ce.uniques_batch(plan, sub_size, start)
            ENGINE_READBACK_BYTES.labels("survivors-dense").inc(
                4 + u.numel() * u.element_size())
            u = u[:sub_valid]
            hits = torch.nonzero(u > thresh).flatten()
            # nicelint: fence (the overflow's dense re-scan, read back)
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
    block_threads: int | None = None,
    progress=None,
    checkpoint_cb=None,
    resume=None,
    checkpoint_batches: int | None = None,
    checkpoint_secs: float | None = None,
    feed_depth: int = FEED_DEPTH_DEFAULT,
    threads: int | None = None,
    devices=None,
    shard: bool = True,
    elastic: bool = True,
) -> FieldResults:
    """Histogram (bins 1..base) and near-miss list of a field, exact.

    device: "cuda" (the default) runs the kernels; "cpu" runs their plain
    PyTorch versions, through the same feed, window, ticker and markers.
    backend "scalar" runs the Python-int oracle instead, in resumable
    chunks of batch_size numbers when it checkpoints or resumes
    (_chunked_host_scan); backend "native" runs the host library on a pool
    of `threads` (None: one a core), and neither checkpoints nor resumes.
    batch_size, segment, use_mxu (1: K5 in place of K1) and block_threads
    (the threads of a block of K1/K5) resolve through resolve_tuning: the
    argument, else the tuned winner, else the default; LAST_FEED_STATS
    records the block size that ran.
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
    every thread joined. A range wholly outside the base's valid range runs
    on the scalar oracle (chunked when it checkpoints or resumes).

    devices, shard and elastic (resolve_mesh; the reference's device set,
    NICE_TPU_SHARD and NICE_TPU_ELASTIC): a list of at least two live
    slices ("cuda:0", "cuda:1", ..., or "cuda:0" repeated: logical slices
    of one card; "cpu" repeated on the CPU) runs the core on a mesh
    (_detailed_on_mesh): partition_segments gives each slice a queue, K1
    runs a slice on its own stream, and the rows fold at each flush. The
    shape resolves as above, but the mesh runs K1 whatever use_mxu
    resolves to (the reference's sharded steps take no MXU arm). Checkpoint
    states are the same contract, their "remaining" list one segment or
    more a slice. A failed dispatch with `elastic` on downshifts onto the
    surviving slices and finishes the field; otherwise (or with no
    survivor) the field raises DispatchError, whose state resumes it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "native":
        _native_refuses_state(checkpoint_cb, resume)
        return _native_detailed(range_, base, resolve_threads(threads),
                                progress)
    if backend == "scalar":
        if checkpoint_cb is None and resume is None:
            with obs.span("engine.scalar", base=base, size=range_.size(),
                          mode="detailed", backend="scalar"):
                return scalar.process_range_detailed(range_, base)
        chunk = resolve_tuning("detailed", base, "cpu", batch_size,
                               backend="scalar")[0]
        return _chunked_host_scan(range_, base, "detailed", chunk, progress,
                                  checkpoint_cb, resume, checkpoint_batches,
                                  checkpoint_secs)
    dev, mesh = resolve_mesh(resolve_device(device), devices, shard)
    n_dev = 1 if mesh is None else mesh.size
    shape = {"batch_size": batch_size, "segment": segment, "use_mxu": use_mxu,
             "block_threads": block_threads}
    pre, core, post = _clamp_to_base_range(range_, base)
    if core is None:
        batch_size = _detailed_shape(base, dev, n_dev, **shape)[0]
        if resume is None and checkpoint_cb is None:
            return scalar.process_range_detailed(range_, base)
        return _chunked_host_scan(range_, base, "detailed", batch_size,
                                  progress, checkpoint_cb, resume,
                                  checkpoint_batches, checkpoint_secs)
    if mesh is not None:
        prep = _detailed_start(range_, base, dev, n_dev, pre, core, post,
                               resume, shape)
        return _detailed_on_mesh(
            range_, base, prep.plan, core, mesh, prep.hist, prep.nice_numbers,
            prep.segments, batch_size=prep.batch_size, seg=prep.seg,
            block_threads=prep.block_threads, progress=progress,
            checkpoint_cb=checkpoint_cb, checkpoint_batches=checkpoint_batches,
            checkpoint_secs=checkpoint_secs, feed_depth=feed_depth,
            elastic=elastic)
    # One device: the span and its four steps tile the field from here to
    # the return (trace.field: recorded when a sink or the profiler is on).
    with trace.field(base, range_.start(), range_.end()) as rec, \
            obs.span("engine.detailed", base=base, size=core.size(),
                     backend=dev.type):
        steps = rec.steps()
        steps.to("engine.setup")
        try:
            prep = _detailed_start(range_, base, dev, n_dev, pre, core,
                                   post, resume, shape)
            return _detailed_one_device(
                range_, base, dev, core, prep, progress=progress,
                checkpoint_cb=checkpoint_cb,
                checkpoint_batches=checkpoint_batches,
                checkpoint_secs=checkpoint_secs, feed_depth=feed_depth,
                rec=rec, steps=steps)
        finally:
            steps.to(None)


def _detailed_shape(base: int, dev: torch.device, n_dev: int, *, batch_size,
                    segment, use_mxu, block_threads):
    """(batch_size, segment, use_mxu, block_threads) of a detailed field on
    n_dev slices: resolve_tuning's, the segment clamped."""
    batch_size, seg, arm, bt = resolve_tuning(
        "detailed", base, dev, batch_size, segment, use_mxu,
        block_threads=block_threads)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    # nicelint: allow C2 (ROADMAP queue 3: batch_size has a lower check only, as in the reference)
    seg = clamp_segment(seg, batch_size, n_dev)
    return batch_size, seg, arm, bt


class _DetailedStart(NamedTuple):
    plan: BasePlan
    batch_size: int
    seg: int
    arm: int
    block_threads: int
    hist: np.ndarray  # int64[base + 2]
    nice_numbers: list
    segments: list  # the core's [start, end) segments left to dispatch


def _detailed_start(range_: FieldSize, base: int, dev: torch.device,
                    n_dev: int, pre, core: FieldSize, post, resume,
                    shape: dict) -> _DetailedStart:
    """A detailed field's shape and the state its core starts from: the
    slivers (pre, post) on the scalar oracle, or the resume state's
    histogram, near misses and segments."""
    batch_size, seg, arm, bt = _detailed_shape(base, dev, n_dev, **shape)
    plan = get_plan(base)
    if not ce.supports_base(plan):
        raise ValueError(f"base {base} exceeds the kernels' histogram")

    hist = np.zeros(plan.base + 2, dtype=np.int64)
    nice_numbers: list[NiceNumberSimple] = []
    segments = [(core.start(), core.end())]
    if resume is None:
        for part in (pre, post):
            if part is not None:
                ENGINE_HOST_FALLBACK.labels("sliver").inc()
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
        CKPT_RESTORES.inc()
        CKPT_BATCHES_SKIPPED.inc(
            (core.size() - sum(e - s for s, e in segments))
            // (batch_size * seg))
    return _DetailedStart(plan, batch_size, seg, arm, bt, hist, nice_numbers,
                          segments)


def _detailed_one_device(range_: FieldSize, base: int, dev: torch.device,
                         core: FieldSize, prep: _DetailedStart, *, progress,
                         checkpoint_cb, checkpoint_batches, checkpoint_secs,
                         feed_depth: int, rec, steps) -> FieldResults:
    """The core of a detailed field on one device, through the pipelined
    loop, from prep (process_range_detailed's arguments). rec is the
    field's record and steps its engine steps, in engine.setup: the loop,
    the drain (the last hand-offs, to the collector's join) and the finish
    each start a step; the collector's items are ranges, and rec.on times
    its waits, its hand-offs and the rare path's scans."""
    plan, batch_size, seg, arm, bt = (prep.plan, prep.batch_size, prep.seg,
                                      prep.arm, prep.block_threads)
    hist, nice_numbers = prep.hist, prep.nice_numbers
    lanes = batch_size * seg
    # Every segment adds at most `lanes` to one bin (padding included), so
    # flushing every flush_every segments keeps int32 bins far from 2^31.
    flush_every = _flush_every(lanes)
    total = core.size()
    done0 = total - sum(e - s for s, e in prep.segments)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    rare_ring = _HostRing(2, (plan.limbs_n,), dev, stream)
    window = -(-DISPATCH_WINDOW // FEED_BLOCK)  # blocks of segments
    readbacks = _Readbacks((), dev, window, stream)
    ticker = (_CkptTicker(checkpoint_batches, checkpoint_secs)
              if checkpoint_cb is not None else None)
    t0 = time.monotonic()
    # Started here, stopped once the collector has drained, so that fold
    # and readback attribution is complete.
    prof = stepprof.StepProfiler("detailed", base, dev.type).start()
    # The collector's tallies, folded into the series once the field ends.
    item_secs: list[float] = []
    tally = {"nm_bytes": 0, "stats_bytes": 0, "transfers": 0}

    def collect_item(kind, *payload):
        name = "engine.collect." + kind  # a range and a record name
        with rec.range(name):
            t_item = time.perf_counter()
            if kind == "nm":  # a block of segments' near-miss counts
                segs, nms, ev = payload
                _wait(ev, rec, "engine.collect.wait")
                tally["nm_bytes"] += 4 * len(segs)
                # nicelint: fence (near-miss counts, landed at the event above)
                for (seg_start, seg_valid), nm in zip(segs, nms.tolist()):
                    if nm > 0:
                        with rec.timed("rare.scan"):
                            nice_numbers.extend(
                                NiceNumberSimple(number=number,
                                                 num_uniques=uniq)
                                for number, uniq in rare_scan_survivors(
                                    plan, seg_start, seg_valid, batch_size,
                                    dev, plan.near_miss_cutoff, rare_ring,
                                    rec))
            elif kind == "stats":  # an accumulator handed over by a flush
                (h,), ev = payload
                _wait(ev, rec, "engine.collect.wait")
                # nicelint: fence (a flushed accumulator, landed at the event above)
                hist[:] += h.numpy().astype(np.int64)
                tally["stats_bytes"] += h.numel() * h.element_size()
                tally["transfers"] += 1
            else:  # "ckpt": after its "nm" and "stats", so the state
                # matches its cursor
                (rem,) = payload
                checkpoint_cb({
                    "cursor": rem[0][0] if rem else core.end(),
                    "hist": hist.copy(),
                    "nice_numbers": [
                        (n.number, n.num_uniques) for n in nice_numbers
                    ],
                    "remaining": [[s, e] for s, e in rem],
                })
            dt = time.perf_counter() - t_item
        item_secs.append(dt)
        rec.add(name, dt)
        if prof.enabled:
            if kind == "nm":
                prof.add("readback", dt)
            elif kind == "stats":
                prof.add("fold", dt)

    queues = [prep.segments]
    st = {"acc": torch.zeros(plan.base + 2, dtype=torch.int32, device=dev),
          "since_flush": 0}

    try:
        with _Collector(collect_item, window, "detailed-collect",
                        stream=stream, prof=prof, timed=rec.on) as collector:

            def read_back():
                if len(readbacks):
                    collector.put(("nm", *readbacks.fetch()))

            def flush():
                read_back()
                collector.put(("stats",
                               *_to_host((st["acc"],), dev, stream)))
                st["acc"] = torch.zeros(plan.base + 2, dtype=torch.int32,
                                         device=dev)
                st["since_flush"] = 0

            def dispatch(item):
                st["acc"], nm = ce.detailed_accum_megaloop(
                    plan, batch_size, seg, st["acc"], item.start,
                    item.seg[1], arm, nm_out=readbacks.slot(),
                    block_threads=bt)
                readbacks.add(nm, item.seg)
                st["since_flush"] += 1
                if len(readbacks) == FEED_BLOCK:
                    read_back()
                return nm

            def after(markers):
                if ticker is not None and ticker.tick():
                    flush()
                    collector.put(("ckpt",
                                   _SliceFeed.remaining(queues, markers)))
                elif st["since_flush"] >= flush_every:
                    flush()

            feed = _SliceFeed(plan, queues, lanes, dev, feed_depth,
                              stream=stream, timed=rec.on)
            steps.to("engine.loop")
            n_batch, gaps = _dispatch_loop(feed, collector, dispatch, after,
                                           progress, total, done0, prof, rec)
            steps.to("engine.drain")
            if not collector.failed():
                read_back()
                if st["since_flush"]:
                    flush()
        steps.to("engine.finish")
    finally:
        prof.stop()
        ce.fold_dispatch_seconds()
    ENGINE_DISPATCHES.labels("detailed").inc(n_batch)
    MESH_FEED_IDLE.labels("detailed").observe_many(gaps)
    ENGINE_BATCH_KERNEL_SECONDS.labels("detailed").observe_many(item_secs)
    ENGINE_READBACK_BYTES.labels("nm").inc(tally["nm_bytes"])
    ENGINE_READBACK_BYTES.labels("stats").inc(tally["stats_bytes"])
    ENGINE_STATS_TRANSFERS.labels("detailed").inc(tally["transfers"])
    _record_feed_stats("detailed", gaps, n_batch, feed_depth, feed.ring.waits,
                       block_threads=bt)
    collector.raise_if_failed()
    log.debug(
        "detailed b%d [%d, %d) on %s (batch %d x %d, use_mxu %d, feed depth "
        "%d): %.3fs, %d segments, %d near misses", base, range_.start(),
        range_.end(), dev, batch_size, seg, arm, feed_depth,
        time.monotonic() - t0, n_batch, len(nice_numbers),
    )
    ENGINE_NUMBERS.labels("detailed").inc(range_.size())

    nice_numbers.sort(key=lambda n: n.number)
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution, nice_numbers=tuple(nice_numbers))


# ---------------------------------------------------------------------------
# The mesh path: a field's detailed or dense loop over a mesh of slices (the
# JAX engine's sharded dispatch, elastic downshift and per-slice cursors)
# ---------------------------------------------------------------------------

class _MeshRun(NamedTuple):
    dispatches: int
    gaps: list
    n_dev_start: int
    n_dev_end: int
    reshards: int
    reshard_secs: float
    ring_waits: int
    err: tuple | None  # (failure, remaining segments or None) when it raised


def _mesh_loop(mode: str, plan: BasePlan, base: int, core: FieldSize,
               mesh: pmesh.Mesh, segments, *, batch_size: int, seg: int,
               block_threads: int, collector: _Collector, accumulate: bool,
               ticker, progress, total: int, done: int,
               prof: stepprof.StepProfiler,
               feed_depth: int, elastic: bool) -> _MeshRun:
    """The dispatcher of a field on a mesh (detailed: accumulate, K1 a slice
    into its histogram row; dense: K4 a slice). partition_segments cuts the
    remaining segments into one queue a slice; a _MeshFeed yields items of
    up to batch_size * seg lanes a slice; each item fires the engine.dispatch
    and mesh.dispatch fault sites, then enqueues each slice's launch on the
    slice's stream, its output into the slice's readbacks, which go to the
    collector a block at a time as ("rb", mesh, slice, its rare-path ring,
    metas, host rows, event). Detailed flushes fold the rows through
    make_sharded_stats_fold as ("stats", host, event), every flush_every
    items (the reference's budget over every slice's lanes) and before each
    checkpoint; ("ckpt", remaining) follows each ticker flush.

    Markers are per slice, and a slice's advances only once its launch is
    enqueued, so remaining() stays exact when a launch fails part-way
    through an item. On a failure with `elastic` on, _diagnose_survivors
    names the survivors: the dispatched work is read back, the rows folded
    synchronously (("stats_host", int64 rows)), the dead mesh's steps
    evicted, the mesh rebuilt over the survivors (their slice ids kept) and
    the remaining segments re-sliced. With elastic off, no survivor, or a
    fold that fails, the run ends with err = (failure, remaining or None)
    once what was dispatched has reached the collector."""
    lanes = batch_size * seg
    make = (pmesh.make_sharded_megaloop_accum_step if accumulate
            else pmesh.make_sharded_megaloop_count_step)
    restore = mesh.saved_streams()
    n_dev0 = mesh.size
    gaps: list[float] = []
    n_batch = reshards = ring_waits = since_flush = 0
    reshard_secs = 0.0
    prof_on = prof.enabled
    faults_on = faults.armed("engine.dispatch")
    mesh_faults_on = faults.armed("mesh.dispatch")
    err = None
    markers: tuple = ()

    def read_back(d):
        rb = step.loops[d].readbacks
        if len(rb):
            mesh.use(d)
            collector.put(("rb", mesh, d, step.loops[d].rare_ring,
                           *rb.fetch()))

    def flush():
        """Everything dispatched so far on its way to the collector."""
        nonlocal since_flush
        for d in range(mesh.size):
            read_back(d)
        if accumulate and since_flush:
            collector.put(("stats", *fold([lp.acc for lp in step.loops])))
        since_flush = 0

    def cursors():
        for d, (_si, cur) in enumerate(markers):
            MESH_SLICE_CURSOR.labels(str(d)).set(cur)

    try:
        step = make(plan, batch_size, seg, mesh, block_threads)
        step.begin()
        fold = pmesh.make_sharded_stats_fold(mesh) if accumulate else None
        flush_every = _flush_every(lanes * mesh.size)
        while segments and not collector.failed():
            queues = pmesh.partition_segments(segments, mesh.size, lanes)

            def upload(d, rows):
                mesh.use(d)
                return step.loops[d].ring.upload(rows)

            feed = _MeshFeed(plan, queues, lanes, core.end(), upload,
                             feed_depth)
            markers = _SliceFeed.start_markers(queues)
            failure = None
            t_prev = None
            try:
                while not collector.failed():
                    t_feed = time.monotonic() if prof_on else 0.0
                    item = feed.get()
                    if item is None:
                        segments = []
                        break
                    now = time.monotonic()
                    if prof_on:
                        prof.add("h2d_feed", now - t_feed)
                    if t_prev is not None and len(gaps) < 65536:
                        gaps.append(now - t_prev)
                    launched = list(markers)
                    try:
                        if faults_on:
                            _fire_dispatch_fault(n_batch, item.segs[0][0])
                        if mesh_faults_on:
                            _fire_mesh_fault(n_batch, mesh.size,
                                             item.segs[0][0])
                        for d, (start, valid) in enumerate(item.segs):
                            if valid:
                                mesh.use(d)
                                out = step.launch(d, item.starts[d], valid)
                                rb = step.loops[d].readbacks
                                rb.add(out, (start, valid))
                                if len(rb) == FEED_BLOCK:
                                    read_back(d)
                                if prof_on:
                                    prof.fence(out)
                            launched[d] = item.markers[d]
                    except Exception as e:  # noqa: BLE001 — the boundary
                        failure = e
                    markers = tuple(launched)
                    if failure is not None:
                        break
                    t_prev = time.monotonic()
                    if prof_on:
                        prof.add("device_compute", t_prev - now)
                    n_batch += 1
                    since_flush += 1
                    done += item.lanes
                    if n_batch % FEED_BLOCK == 0:
                        cursors()
                    if ticker is not None and ticker.tick():
                        flush()
                        collector.put(("ckpt",
                                       _SliceFeed.remaining(queues, markers)))
                    elif accumulate and since_flush >= flush_every:
                        flush()
                    if progress is not None:
                        progress(done, total)
            finally:
                feed.stop()
                ring_waits += sum(lp.ring.waits for lp in step.loops)
            if failure is None:
                continue  # exhausted, or the collector failed
            rem = _SliceFeed.remaining(queues, markers)
            survivors, reason = None, ""
            if elastic:
                survivors, reason = _diagnose_survivors(mesh, failure)
                obs.flight.record(
                    "device_loss", mode=mode, base=base,
                    survivors=len(survivors) if survivors else 0,
                    reason=reason if survivors else "fatal",
                    error=repr(failure)[:200])
            if not survivors:
                err = (failure, rem)
                break
            # The elastic downshift: what the old layout dispatched reaches
            # the collector, and its rows are folded before its steps go.
            t_r0 = time.monotonic()
            try:
                for d in range(mesh.size):
                    read_back(d)
                if accumulate:
                    host, ev = fold([lp.acc for lp in step.loops])
                    _wait(ev)
                    # nicelint: fence (the folded rows, landed at the event above)
                    collector.put(("stats_host", host.numpy().copy()))
                    since_flush = 0
            except Exception as fold_err:  # noqa: BLE001 — nothing to salvage
                log.warning("downshift abandoned: the partial rows could not "
                            "be folded: %r", fold_err)
                err = (failure, None)
                break
            cursors()
            pmesh.clear_step_cache(pmesh.mesh_device_ids(mesh))
            _invalidate_mesh_cache()
            prev_n = mesh.size
            mesh = _cached_mesh(tuple(survivors))
            step = make(plan, batch_size, seg, mesh, block_threads)
            step.begin()
            fold = pmesh.make_sharded_stats_fold(mesh) if accumulate else None
            # seg stays fixed (the budget only grows as slices go), so the
            # survivors run the same shape.
            flush_every = _flush_every(lanes * mesh.size)
            segments = rem
            reshards += 1
            dt = time.monotonic() - t_r0
            reshard_secs += dt
            MESH_RESHARDS.labels(reason).inc()
            MESH_RESHARD_SECONDS.observe(dt)
            obs.flight.record("mesh_reshard", mode=mode, base=base,
                              reason=reason, n_dev=mesh.size,
                              lost=prev_n - mesh.size)
            obs.trace_event("mesh.reshard", mode=mode, base=base,
                            reason=reason, n_dev=mesh.size)
            log.warning("mesh downshift (%s b%d): %d -> %d slices (%s, %r); "
                        "re-sliced %d remaining segment(s)", mode, base,
                        prev_n, mesh.size, reason, failure, len(rem))
        try:
            flush()
        except Exception as e:  # noqa: BLE001 — raised below or with err
            if err is None:
                raise
            log.warning("the failed field's last flush failed too: %r", e)
            err = (err[0], None)
        cursors()
    finally:
        restore()
    return _MeshRun(n_batch, gaps, n_dev0, mesh.size, reshards, reshard_secs,
                    ring_waits, err)


def _detailed_on_mesh(range_: FieldSize, base: int, plan: BasePlan,
                      core: FieldSize, mesh: pmesh.Mesh, hist: np.ndarray,
                      nice_numbers: list, segments, *, batch_size: int,
                      seg: int, block_threads: int, progress, checkpoint_cb,
                      checkpoint_batches, checkpoint_secs, feed_depth: int,
                      elastic: bool) -> FieldResults:
    """process_range_detailed's core on a mesh of slices (_mesh_loop): the
    collector reads each slice's near-miss counts, re-scans a segment with
    near misses through K2 on its slice's device, stream and rare-path
    ring, folds the histogram handed over by flushes and downshifts and
    writes the checkpoints. A field that failed without a downshift raises
    DispatchError with the resume state of what was folded."""
    total = core.size()
    done0 = total - sum(e - s for s, e in segments)
    ticker = (_CkptTicker(checkpoint_batches, checkpoint_secs)
              if checkpoint_cb is not None else None)
    t0 = time.monotonic()
    prof = stepprof.StepProfiler("detailed", base,
                                 mesh.devices[0].type).start()
    item_secs: list[float] = []
    tally = {"nm_bytes": 0, "stats_bytes": 0, "transfers": 0}

    def ckpt_state(rem):
        return {
            "cursor": rem[0][0] if rem else core.end(),
            "hist": hist.copy(),
            "nice_numbers": [(n.number, n.num_uniques) for n in nice_numbers],
            "remaining": [[s, e] for s, e in rem],
        }

    def collect_item(kind, *payload):
        t_item = time.monotonic()
        if kind == "rb":  # a block of one slice's near-miss counts
            m, d, ring, segs, nms, ev = payload
            _wait(ev)
            tally["nm_bytes"] += 4 * len(segs)
            # nicelint: fence (a slice's near-miss counts, landed at the event)
            for (seg_start, seg_valid), nm in zip(segs, nms.tolist()):
                if nm > 0:
                    m.use(d)
                    nice_numbers.extend(
                        NiceNumberSimple(number=number, num_uniques=uniq)
                        for number, uniq in rare_scan_survivors(
                            plan, seg_start, seg_valid, batch_size,
                            m.devices[d], plan.near_miss_cutoff, ring))
        elif kind == "stats":  # the slices' rows, folded by a flush
            h, ev = payload
            _wait(ev)
            # nicelint: fence (the folded rows, landed at the event above)
            hist[:] += h.numpy()
            tally["stats_bytes"] += h.numel() * h.element_size()
            tally["transfers"] += 1
        elif kind == "stats_host":  # folded already, at a downshift
            (h,) = payload
            hist[:] += h
            tally["transfers"] += 1
        else:  # "ckpt": after its "rb" and "stats", so the state matches
            (rem,) = payload
            checkpoint_cb(ckpt_state(rem))
        dt = time.monotonic() - t_item
        item_secs.append(dt)
        if prof.enabled:
            if kind == "rb":
                prof.add("readback", dt)
            elif kind in ("stats", "stats_host"):
                prof.add("fold", dt)

    window = -(-DISPATCH_WINDOW // FEED_BLOCK) * mesh.size
    try:
        with obs.span("engine.detailed", base=base, size=total,
                      backend=mesh.devices[0].type, n_dev=mesh.size), \
                _Collector(collect_item, window, "detailed-collect",
                           prof=prof) as collector:
            run = _mesh_loop("detailed", plan, base, core, mesh, segments,
                             batch_size=batch_size, seg=seg,
                             block_threads=block_threads,
                             collector=collector, accumulate=True,
                             ticker=ticker, progress=progress, total=total,
                             done=done0, prof=prof, feed_depth=feed_depth,
                             elastic=elastic)
    finally:
        prof.stop()
        ce.fold_dispatch_seconds()
    ENGINE_DISPATCHES.labels("detailed").inc(run.dispatches)
    MESH_FEED_IDLE.labels("detailed").observe_many(run.gaps)
    ENGINE_BATCH_KERNEL_SECONDS.labels("detailed").observe_many(item_secs)
    ENGINE_READBACK_BYTES.labels("nm").inc(tally["nm_bytes"])
    ENGINE_READBACK_BYTES.labels("stats").inc(tally["stats_bytes"])
    ENGINE_STATS_TRANSFERS.labels("detailed").inc(tally["transfers"])
    _record_feed_stats("detailed", run.gaps, run.dispatches, feed_depth,
                       run.ring_waits, run.n_dev_start, run.n_dev_end,
                       run.reshards, run.reshard_secs,
                       block_threads=block_threads)
    if run.err is not None:
        failure, rem = run.err
        state = (ckpt_state(rem)
                 if rem is not None and not collector.failed() else None)
        raise DispatchError(state, failure) from failure
    collector.raise_if_failed()
    log.info("detailed b%d [%d, %d) on %d slices (batch %d x %d, feed depth "
             "%d): %.3fs, %d items, %d reshards, %d near misses", base,
             range_.start(), range_.end(), run.n_dev_start, batch_size, seg,
             feed_depth, time.monotonic() - t0, run.dispatches,
             run.reshards, len(nice_numbers))
    ENGINE_NUMBERS.labels("detailed").inc(range_.size())
    nice_numbers.sort(key=lambda n: n.number)
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution,
                        nice_numbers=tuple(nice_numbers))


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


def _group_counts(counts, launched) -> np.ndarray:
    """A descriptor group's counts on the host, once its launches are done:
    one device tensor and its event, or (on a mesh) one a slice,
    concatenated in slice order (a slice past the group's rows has None)."""
    if not isinstance(counts, list):
        counts, launched = [counts], [launched]
    parts = []
    for c, ev in zip(counts, launched):
        if c is not None:
            _wait(ev)
            # nicelint: fence (a group's counts, after its event)
            parts.append(c.cpu().numpy())
    return np.concatenate(parts)


def _niceonly_strided(core: FieldSize, base: int, s: StridedSetup, dev,
                      progress, checkpoint, ticker=None,
                      mesh: pmesh.Mesh | None = None) -> list[int]:
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
        hold none). Descriptor tables go up through a pinned _HostRing.

    On a mesh of slices a group holds STRIDED_DESC_MAX descriptors a slice
    and goes through make_sharded_strided_step: one K3 launch a slice, on
    its stream, the counts concatenated in descriptor order; the collector
    and its audit are the same (the reference has no downshift here)."""
    plan, table, periods = s.plan, s.table, s.periods
    modulus = table.modulus
    span = periods * modulus
    n_dev = 1 if mesh is None else mesh.size
    group_cap = ce.STRIDED_DESC_MAX * n_dev
    filter_threads, audit_every = FILTER_THREADS, STRIDE_AUDIT_EVERY
    if mesh is None:
        residues = _device_residues(base, s.k, str(dev))
        ring = _HostRing(2 * STRIDE_WINDOW, (group_cap, ce.DESC_WIDTH), dev)
    else:
        step = pmesh.make_sharded_strided_step(plan, base, s.k, modulus,
                                               periods, ce.STRIDED_DESC_MAX,
                                               mesh)
        restore = mesh.saved_streams()
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
    audits = [0]      # zero-count descriptors re-scanned
    group_secs: list[float] = []

    def collect(cols, counts_dev, launched):
        t0 = time.monotonic()
        k = len(cols[0])
        flat = _group_counts(counts_dev, launched)[:k]
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
                audits[0] += 1
            audit_seen[0] += len(zeros)
        if checkpoint is not None and (ticker is None or ticker.tick()):
            # The coverage frontier of this group: the end of its last
            # descriptor.
            watermark = min(desc_value(cols, 2, k - 1),
                            desc_value(cols, 0, k - 1) + span)
            checkpoint(watermark, list(nice))
        secs = time.monotonic() - t0
        dev_busy[0] += secs
        group_secs.append(secs)

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
                    _fire_dispatch_fault(n_groups, desc_value(cols, 0, 0))
                    n_desc += k_real
                    n_groups += 1
                    if first_group is None:
                        first_group = cols
                    packed = pack_descriptors(cols, group_cap).astype(np.int64)
                    if mesh is not None:
                        counts, launched = step(packed, k_real)
                    else:
                        desc = ring.upload(packed)
                        # At K3's module block size, the wrapper's default
                        # (ce.STRIDED_BLOCK_THREADS): no winner sets it.
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
        ce.fold_dispatch_seconds()
        if mesh is not None:
            restore()
    ENGINE_DESCRIPTORS.inc(n_desc)
    ENGINE_AUDITS.inc(audits[0])
    ENGINE_BATCH_KERNEL_SECONDS.labels("strided").observe_many(group_secs)
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
        route="device", base=base, start=core.start(), end=core.end(),
        wall=wall, msd_busy=host_busy[0], floor=s.floor, ranges=n_ranges[0],
        collect_busy=dev_busy[0], k=s.k, periods=periods,
        descriptors=n_desc, groups=n_groups, gen=t_gen, disp=t_disp,
        put=t_put, nice=len(nice), filter_threads=filter_threads,
        first_group=first_group, n_dev=n_dev,
        block_threads=ce.STRIDED_BLOCK_THREADS,
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
                    block_threads: int | None = None,
                    checkpoint_batches: int | None = None,
                    checkpoint_secs: float | None = None,
                    feed_depth: int = FEED_DEPTH_DEFAULT,
                    mesh: pmesh.Mesh | None = None,
                    elastic: bool = True) -> None:
    """Append the nice numbers of the core to nice_numbers: the twin of the
    JAX engine's dense loop, on the pipelined host loop (on a mesh of
    slices, _dense_on_mesh: K4 a slice, whatever use_mxu resolves to, with
    the elastic downshift; a failure that does not downshift raises
    DispatchError with the state of what was collected).

    The MSD filter (the "dense" floor controller's floor) turns the core
    into surviving ranges up front; each is cut into runs of at most
    batch_size * segment lanes, and K4 (K5 where use_mxu resolves to 1; the
    shape, block_threads included, comes from resolve_tuning) counts each
    run's nice lanes among the residue classes the congruence keeps (the
    TPU's fused mode: the count equals the unfused one's, since no other
    class holds a nice number). The
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
    batch_size, seg, arm, bt = resolve_tuning(
        "niceonly", base, dev, batch_size, segment, use_mxu,
        block_threads=block_threads)
    # nicelint: allow C2 (ROADMAP queue 3; past the domain K4's wrapper raises)
    seg = clamp_segment(seg, batch_size, 1 if mesh is None else mesh.size)
    lanes = batch_size * seg
    classes = ce.niceonly_classes(plan, True, str(dev))
    nice0 = len(nice_numbers)
    ctrl = adaptive_floor.get_floor_controller("dense")
    floor = ctrl.current()
    # As in the JAX dense loop, the MSD filter up front lands in host_other.
    prof = stepprof.StepProfiler("niceonly", base, dev.type).start()
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
    if mesh is not None:
        _dense_on_mesh(core, base, plan, mesh, nice_numbers, segments, prof,
                       batch_size=batch_size, seg=seg, block_threads=bt,
                       progress=progress,
                       checkpoint_cb=checkpoint_cb,
                       checkpoint_batches=checkpoint_batches,
                       checkpoint_secs=checkpoint_secs, feed_depth=feed_depth,
                       elastic=elastic, msd_secs=msd_secs, floor=floor,
                       ctrl=ctrl if ran_filter else None)
        return
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
    item_secs: list[float] = []

    def collect_item(kind, *payload):
        t_item = time.monotonic()
        if kind == "count":  # a block of runs' [count, pruned]
            block, counts, ev = payload
            _wait(ev)
            # nicelint: fence (runs' [count, pruned], landed at the event above)
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
        dt = time.monotonic() - t_item
        item_secs.append(dt)
        if prof.enabled and kind == "count":
            prof.add("readback", dt)

    queues = [segments]
    t1 = time.monotonic()
    try:
        with obs.span("engine.niceonly-dense", base=base, size=core.size(),
                      backend=dev.type), \
                _Collector(collect_item, window, "dense-collect",
                           stream=stream, prof=prof) as collector:

            def read_back():
                if len(readbacks):
                    collector.put(("count", *readbacks.fetch()))

            def dispatch(item):
                out = ce.niceonly_dense_megaloop(
                    plan, batch_size, seg, classes, item.start, item.seg[1],
                    use_mxu=arm, out=readbacks.slot(), block_threads=bt)
                readbacks.add(out, item.seg)
                runs.append(item.seg)
                if len(readbacks) == FEED_BLOCK:
                    read_back()
                return out

            def after(markers):
                if ticker is not None and ticker.tick():
                    read_back()
                    collector.put(("ckpt",
                                   _SliceFeed.remaining(queues, markers)))

            feed = _SliceFeed(plan, queues, lanes, dev, feed_depth,
                              stream=stream)
            n_batch, gaps = _dispatch_loop(feed, collector, dispatch, after,
                                           progress, total, 0, prof)
            if not collector.failed():
                read_back()
    finally:
        prof.stop()
        ce.fold_dispatch_seconds()
    loop_secs = time.monotonic() - t1
    ENGINE_DISPATCHES.labels("niceonly").inc(n_batch)
    MESH_FEED_IDLE.labels("niceonly").observe_many(gaps)
    ENGINE_BATCH_KERNEL_SECONDS.labels("dense").observe_many(item_secs)
    ENGINE_READBACK_BYTES.labels("count").inc(8 * len(runs))
    ENGINE_FILTER_PRUNED.labels("niceonly", str(base)).inc(tally["pruned"])
    _record_feed_stats("niceonly", gaps, n_batch, feed_depth, feed.ring.waits,
                       block_threads=bt)
    collector.raise_if_failed()
    if ran_filter:
        ctrl.observe(msd_secs, loop_secs, core.size())
    median = sorted(runs, key=lambda r: r[1])[len(runs) // 2] if runs else None
    done = sum(v for _, v in runs)
    LAST_NICEONLY_STATS.clear()
    LAST_NICEONLY_STATS.update(
        route="device", base=base, start=core.start(), end=core.end(),
        msd_secs=msd_secs, floor=floor, ranges=len(segments),
        loop_secs=loop_secs,
        runs=len(runs), lanes=done, kept=tally["kept"],
        pruned=tally["pruned"], classes=int(classes.shape[0]),
        launches=ce.LAUNCHES[kernel] - launches0, batch_size=batch_size,
        segment=seg, use_mxu=arm, block_threads=bt, feed_depth=feed_depth,
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


def _dense_on_mesh(core: FieldSize, base: int, plan: BasePlan,
                   mesh: pmesh.Mesh, nice_numbers: list, segments,
                   prof: stepprof.StepProfiler, *,
                   batch_size: int, seg: int, block_threads: int, progress,
                   checkpoint_cb, checkpoint_batches, checkpoint_secs,
                   feed_depth: int, elastic: bool, msd_secs: float,
                   floor: int, ctrl) -> None:
    """The dense loop's runs on a mesh of slices (_mesh_loop): the collector
    reads each slice's [count, pruned] a block at a time and re-scans a run
    that counts any through K2 on its slice's device, stream and rare-path
    ring (a count the re-scan does not confirm is an error). prof: the
    field's started profiler (stopped here); ctrl: the floor controller to
    teach (None when the filter did not run)."""
    nice0 = len(nice_numbers)
    total = sum(e - s for s, e in segments)
    runs: list[tuple[int, int]] = []
    tally = {"kept": 0, "pruned": 0}
    launches0 = ce.LAUNCHES["niceonly_dense"]
    ticker = (_CkptTicker(checkpoint_batches, checkpoint_secs)
              if checkpoint_cb is not None else None)
    item_secs: list[float] = []

    def ckpt_state(rem):
        return {
            "cursor": rem[0][0] if rem else core.end(),
            "hist": None,
            "nice_numbers": [(n.number, n.num_uniques) for n in nice_numbers],
            "remaining": [[a, b] for a, b in rem],
            "filtered": True,
        }

    def collect_item(kind, *payload):
        t_item = time.monotonic()
        if kind == "rb":  # a block of one slice's runs' [count, pruned]
            m, d, ring, block, counts, ev = payload
            _wait(ev)
            # nicelint: fence (a slice's [count, pruned], landed at the event)
            for (pos, valid), (count, n_pruned) in zip(block, counts.tolist()):
                runs.append((pos, valid))
                tally["kept"] += valid - n_pruned
                tally["pruned"] += n_pruned
                if count == 0:
                    continue
                m.use(d)
                found = [n for n, _ in rare_scan_survivors(
                    plan, pos, valid, batch_size, m.devices[d], base - 1,
                    ring)]
                if len(found) != count:
                    raise RuntimeError(
                        f"K4 counted {count} nice numbers in [{pos}, "
                        f"{pos + valid}), the rare scan found {len(found)}")
                nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=base)
                                    for n in found)
        else:  # "ckpt": every run before the marker is collected
            (rem,) = payload
            checkpoint_cb(ckpt_state(rem))
        dt = time.monotonic() - t_item
        item_secs.append(dt)
        if prof.enabled and kind == "rb":
            prof.add("readback", dt)

    window = -(-DISPATCH_WINDOW // FEED_BLOCK) * mesh.size
    t1 = time.monotonic()
    try:
        with obs.span("engine.niceonly-dense", base=base, size=core.size(),
                      backend=mesh.devices[0].type, n_dev=mesh.size), \
                _Collector(collect_item, window, "dense-collect",
                           prof=prof) as collector:
            run = _mesh_loop("niceonly", plan, base, core, mesh, segments,
                             batch_size=batch_size, seg=seg,
                             block_threads=block_threads,
                             collector=collector, accumulate=False,
                             ticker=ticker, progress=progress, total=total,
                             done=0, prof=prof, feed_depth=feed_depth,
                             elastic=elastic)
    finally:
        prof.stop()
        ce.fold_dispatch_seconds()
    loop_secs = time.monotonic() - t1
    ENGINE_DISPATCHES.labels("niceonly").inc(run.dispatches)
    MESH_FEED_IDLE.labels("niceonly").observe_many(run.gaps)
    ENGINE_BATCH_KERNEL_SECONDS.labels("dense").observe_many(item_secs)
    ENGINE_READBACK_BYTES.labels("count").inc(8 * len(runs))
    ENGINE_FILTER_PRUNED.labels("niceonly", str(base)).inc(tally["pruned"])
    _record_feed_stats("niceonly", run.gaps, run.dispatches, feed_depth,
                       run.ring_waits, run.n_dev_start, run.n_dev_end,
                       run.reshards, run.reshard_secs,
                       block_threads=block_threads)
    if run.err is not None:
        failure, rem = run.err
        state = (ckpt_state(rem)
                 if rem is not None and not collector.failed() else None)
        raise DispatchError(state, failure) from failure
    collector.raise_if_failed()
    if ctrl is not None:
        ctrl.observe(msd_secs, loop_secs, core.size())
    runs.sort()
    median = sorted(runs, key=lambda r: r[1])[len(runs) // 2] if runs else None
    LAST_NICEONLY_STATS.clear()
    LAST_NICEONLY_STATS.update(
        route="device", base=base, start=core.start(), end=core.end(),
        msd_secs=msd_secs, floor=floor, ranges=len(segments),
        loop_secs=loop_secs, runs=len(runs), lanes=sum(v for _, v in runs),
        kept=tally["kept"], pruned=tally["pruned"],
        classes=int(ce.niceonly_classes(plan, True, "cpu").shape[0]),
        launches=ce.LAUNCHES["niceonly_dense"] - launches0,
        batch_size=batch_size, segment=seg, use_mxu=0,
        block_threads=block_threads, feed_depth=feed_depth,
        nice=len(nice_numbers) - nice0, first_run=runs[0] if runs else None,
        median_run=median, n_dev=run.n_dev_start,
    )
    log.info(
        "niceonly-dense b%d [%d, %d) on %d slices: msd %.3fs (floor %d, %d "
        "ranges) | loop %.3fs (%d runs, %d kept, %d pruned, %d reshards) | "
        "%d nice", base, core.start(), core.end(), run.n_dev_start, msd_secs,
        floor, len(segments), loop_secs, len(runs), tally["kept"],
        tally["pruned"], run.reshards, len(nice_numbers) - nice0,
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
    block_threads: int | None = None,
    progress=None,
    checkpoint_cb=None,
    resume=None,
    checkpoint_batches: int | None = None,
    checkpoint_secs: float | None = None,
    feed_depth: int = FEED_DEPTH_DEFAULT,
    threads: int | None = None,
    host_niceonly_max: int | None = None,
    devices=None,
    shard: bool = True,
    elastic: bool = True,
) -> FieldResults:
    """The nice numbers of a field (distribution empty), exact.

    device: "cuda" (the default) runs the kernels; "cpu" runs their plain
    PyTorch versions. backend "scalar" runs the Python-int oracle instead,
    in resumable chunks of batch_size numbers when it checkpoints or
    resumes; backend "native" the host library's filter cascade on a pool
    of `threads` (None: one a core), which neither checkpoints nor resumes.
    Out-of-range slivers go to the oracle, and so does a range wholly
    outside the base's valid range (chunked when it checkpoints or
    resumes). Bases of at most 4 u32 limbs (b10-b97) take the strided
    pipeline (K3), except that a core of at most host_niceonly_max numbers
    that the polynomial-residue kernel's gate admits goes to the host
    engine on `threads` (the host route; None: HOST_NICEONLY_MAX on a CUDA
    device, 0 on the CPU); LAST_NICEONLY_STATS["route"] says which ran.
    Bases above (b98 and up) take the dense loop (K4, _niceonly_dense).
    batch_size, segment, use_mxu (1: K5 in place of K4) and block_threads
    shape the dense loop's runs through resolve_tuning; the strided
    pipeline's shapes come from the MSD floor (K3 has no tensor-core arm,
    and its block size is cuda_engine.STRIDED_BLOCK_THREADS), and it takes
    none of them; feed_depth is the dense loop's (runs its feed thread prepares
    ahead, 0: inline).
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
    without recomputing slivers.

    devices, shard and elastic as process_range_detailed's (resolve_mesh):
    on a mesh the strided pipeline launches K3 a slice on groups of
    STRIDED_DESC_MAX descriptors a slice (no downshift there, as in the
    reference), and the dense loop runs K4 a slice with the elastic
    downshift (DispatchError where it does not downshift)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "native":
        _native_refuses_state(checkpoint_cb, resume)
        return _native_niceonly(range_, base, None, resolve_threads(threads),
                                progress)
    chunk = resolve_tuning("niceonly", base, "cpu", batch_size,
                           backend="scalar")[0]
    if backend == "scalar":
        if checkpoint_cb is None and resume is None:
            with obs.span("engine.scalar", base=base, size=range_.size(),
                          mode="niceonly", backend="scalar"):
                return scalar.process_range_niceonly(range_, base)
        return _chunked_host_scan(range_, base, "niceonly", chunk, progress,
                                  checkpoint_cb, resume, checkpoint_batches,
                                  checkpoint_secs)
    dev, mesh = resolve_mesh(resolve_device(device), devices, shard)
    pre, core, post = _clamp_to_base_range(range_, base)
    if core is None:
        if resume is None and checkpoint_cb is None:
            return scalar.process_range_niceonly(range_, base)
        return _chunked_host_scan(range_, base, "niceonly", chunk, progress,
                                  checkpoint_cb, resume, checkpoint_batches,
                                  checkpoint_secs)

    nice_numbers: list[NiceNumberSimple] = []
    if resume is None:
        for part in (pre, post):
            if part is not None:
                ENGINE_HOST_FALLBACK.labels("sliver").inc()
                nice_numbers.extend(
                    scalar.process_range_niceonly(part, base).nice_numbers)
    else:
        nice_numbers = [
            NiceNumberSimple(number=int(n), num_uniques=int(u))
            for n, u in resume["nice_numbers"]
        ]
        segments = _resume_segments(resume, core.start(), core.end())
        CKPT_RESTORES.inc()
        CKPT_BATCHES_SKIPPED.inc(
            (core.size() - sum(e - s for s, e in segments)) // max(1, chunk))
        if not segments:
            ENGINE_NUMBERS.labels("niceonly").inc(range_.size())
            nice_numbers.sort(key=lambda n: n.number)
            return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))

    if get_plan(base).limbs_n > 4:
        _niceonly_dense(core, base, dev, nice_numbers, progress=progress,
                        checkpoint_cb=checkpoint_cb, resume=resume,
                        batch_size=batch_size, segment=segment,
                        use_mxu=use_mxu, block_threads=block_threads,
                        checkpoint_batches=checkpoint_batches,
                        checkpoint_secs=checkpoint_secs, feed_depth=feed_depth,
                        mesh=mesh, elastic=elastic)
        ENGINE_NUMBERS.labels("niceonly").inc(range_.size())
        nice_numbers.sort(key=lambda n: n.number)
        return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))

    if (batch_size, segment, use_mxu, block_threads) != (None,) * 4:
        raise ValueError(f"base {base} takes the strided pipeline, which has "
                         "no batch_size, segment, use_mxu or block_threads")
    if resume is not None:
        # The pipeline scans one contiguous core: resume from the lowest
        # uncovered number, dropping restored numbers the rescan will find
        # again (slivers and numbers past the core stay).
        pos, core_end = segments[0][0], core.end()
        nice_numbers = [n for n in nice_numbers
                        if n.number < pos or n.number >= core_end]
        core = FieldSize(pos, core_end)

    limit = resolve_host_niceonly_max(host_niceonly_max, dev.type)
    if _host_route_niceonly(core, base, limit):
        # The host route: the field is small enough that the host library
        # finishes before the strided pipeline would, and the poly kernel's
        # gate admits it. A coarse MSD floor keeps the per-range Python and
        # ctypes overhead small; the filters are those of the strided path.
        t0 = time.monotonic()
        n_threads = resolve_threads(threads)
        ENGINE_HOST_FALLBACK.labels("host-route").inc()
        with obs.span("engine.niceonly-host", base=base, size=core.size(),
                      backend="native"):
            routed = _native_niceonly(core, base, None, n_threads, progress,
                                      msd_floor=max(1 << 20,
                                                    core.size() // 8))
        LAST_NICEONLY_STATS.clear()
        LAST_NICEONLY_STATS.update(
            route="host", base=base, start=core.start(), end=core.end(),
            wall=time.monotonic() - t0, threads=n_threads,
            k=_host_stride_depth(base), nice=len(routed.nice_numbers),
            first_group=None)
        nice_numbers.extend(routed.nice_numbers)
        ENGINE_NUMBERS.labels("niceonly").inc(range_.size())
        nice_numbers.sort(key=lambda n: n.number)
        return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))

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

        with obs.span("engine.niceonly-strided", base=base,
                      size=core.size(), backend=dev.type):
            found = _niceonly_strided(
                core, base, s, dev, progress, ckpt,
                _CkptTicker(checkpoint_batches, checkpoint_secs), mesh)
    nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=base)
                        for n in found)
    ENGINE_NUMBERS.labels("niceonly").inc(range_.size())
    nice_numbers.sort(key=lambda n: n.number)
    return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))


def surviving_field(base: int, size: int, seed: int, *, device="cuda",
                    tries: int = 1000) -> FieldSize:
    """The first field of `size` numbers, drawn with random.Random(seed)
    from the grid of such fields over the base's range, that the MSD filter
    does not prune whole, as the niceonly pipeline itself finds: it forms a
    descriptor group (K3) or, at b98 and up, a dense run (K4). At 1e9
    numbers a field it prunes about 19 fields in 20 at b80 and 99 in 100 at
    b98, the range's first among them. Raises if none of `tries` draws
    survives."""
    plan = get_plan(base)
    n_fields = (plan.range_end - plan.range_start) // size
    rng = random.Random(seed)
    for _ in range(tries):
        start = plan.range_start + rng.randrange(n_fields) * size
        field = FieldSize(range_start=start, range_end=start + size)
        process_range_niceonly(field, base, device=device)
        if LAST_NICEONLY_STATS.get("groups") or LAST_NICEONLY_STATS.get("runs"):
            return field
    raise RuntimeError(f"no b{base} field of {size} numbers in {tries} "
                       f"draws survives the MSD filter")


# ---------------------------------------------------------------------------
# Host engines: the scalar oracle in resumable chunks, the native backend
# (the host library on a thread pool) and the small-field niceonly host route
# ---------------------------------------------------------------------------

def _chunked_host_scan(range_: FieldSize, base: int, mode: str, chunk: int,
                       progress, checkpoint_cb, resume, every_batches,
                       every_secs) -> FieldResults:
    """The scalar oracle over the range in resumable chunks of `chunk`
    numbers: backend "scalar" with a checkpoint_cb or a resume, and a range
    wholly outside the base's valid range under either (the JAX engine's
    _chunked_host_scan). A checkpoint state covers every candidate outside
    its "remaining" segments: {"cursor", "hist" (int64[base + 2], None in
    niceonly mode), "nice_numbers", "remaining", "filtered"}, on the
    _CkptTicker cadence, one tick a chunk. A resume state's "filtered"
    flag (the gaps between its segments were proven empty by the filters)
    is carried on."""
    detailed = mode == "detailed"
    hist = np.zeros(base + 2, dtype=np.int64) if detailed else None
    nice: list[NiceNumberSimple] = []
    start, end, total = range_.start(), range_.end(), range_.size()
    chunk = max(1, chunk)
    segs = [(start, end)] if total else []
    filtered = False
    if resume is not None:
        segs = _resume_segments(resume, start, end)
        filtered = bool(resume.get("filtered"))
        if detailed:
            if resume.get("hist") is None:
                raise ValueError("detailed resume state is missing a histogram")
            h = np.asarray(resume["hist"], dtype=np.int64)
            if h.shape != hist.shape:
                raise ValueError(
                    f"resume histogram shape {h.shape} != {hist.shape}")
            hist[:] = h
        nice = [NiceNumberSimple(number=int(n), num_uniques=int(u))
                for n, u in resume["nice_numbers"]]
        done0 = total - sum(e - s for s, e in segs)
        CKPT_RESTORES.inc()
        CKPT_BATCHES_SKIPPED.inc(done0 // chunk)
        log.info("%s scalar resume: %d segment(s) remaining (%d of %d "
                 "numbers already done)", mode, len(segs), done0, total)
    ticker = (_CkptTicker(every_batches, every_secs)
              if checkpoint_cb is not None else None)
    done = total - sum(e - s for s, e in segs)
    n_batch = 0
    with obs.span("engine.scalar", base=base, size=total, mode=mode,
                  backend="scalar"):
        while segs:
            s, e = segs[0]
            n = min(chunk, e - s)
            _fire_dispatch_fault(n_batch, s)
            n_batch += 1
            sub = FieldSize(s, s + n)
            if detailed:
                part = scalar.process_range_detailed(sub, base)
                for d in part.distribution:
                    hist[d.num_uniques] += d.count
            else:
                part = scalar.process_range_niceonly(sub, base)
            nice.extend(part.nice_numbers)
            done += n
            if s + n >= e:
                segs.pop(0)
            else:
                segs[0] = (s + n, e)
            if progress is not None:
                progress(done, total)
            if ticker is not None and ticker.tick():
                checkpoint_cb({
                    "cursor": segs[0][0] if segs else end,
                    "hist": None if hist is None else hist.copy(),
                    "nice_numbers": [(x.number, x.num_uniques) for x in nice],
                    "remaining": [[s_, e_] for s_, e_ in segs],
                    "filtered": filtered,
                })
    nice.sort(key=lambda x: x.number)
    if not detailed:
        return FieldResults(distribution=(), nice_numbers=tuple(nice))
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution, nice_numbers=tuple(nice))


def _native_refuses_state(checkpoint_cb, resume) -> None:
    """The native backend's pool has no consistent cursor: it neither
    resumes (as in the JAX engine) nor checkpoints (the JAX engine ignores
    a checkpoint_cb; the port refuses it)."""
    if resume is not None:
        raise ValueError(
            "backend 'native' does not support resuming from a checkpoint")
    if checkpoint_cb is not None:
        raise ValueError("backend 'native' does not support checkpoints")


def resolve_threads(threads: int | None) -> int:
    """The native backend's pool size: `threads`, else (None or 0) one
    thread a CPU core (the JAX engine reads NICE_THREADS instead)."""
    return max(1, threads or os.cpu_count() or 1)


def _native_detailed(range_: FieldSize, base: int, threads: int,
                     progress=None) -> FieldResults:
    """The native backend's detailed field: the host library's detailed
    loop over spans of the range on a pool of `threads` (the JAX engine's
    _native_detailed). The library loads as ctypes.CDLL, so each call
    releases the GIL and the pool runs in parallel. A base or value the
    library does not take raises."""
    native.load()
    cutoff = number_stats.get_near_miss_cutoff(base)
    total = range_.size()
    chunk = max(65536, total // (threads * 8) or 1)
    spans = [(range_.start() + off, min(chunk, total - off))
             for off in range(0, total, chunk)]
    hist = np.zeros(base + 2, dtype=np.int64)
    nice_numbers: list[NiceNumberSimple] = []
    done = 0
    with ThreadPoolExecutor(max_workers=threads,
                            thread_name_prefix="nice-native") as pool:
        for span_, (sub_hist, misses) in zip(spans, pool.map(
                lambda sp: native.process_range_detailed(sp[0], sp[1], base,
                                                         cutoff), spans)):
            hist += np.asarray(sub_hist, dtype=np.int64)
            nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=u)
                                for n, u in misses)
            done += span_[1]
            if progress is not None:
                progress(done, total)
    nice_numbers.sort(key=lambda n: n.number)
    distribution = tuple(
        UniquesDistributionSimple(num_uniques=i, count=int(hist[i]))
        for i in range(1, base + 1)
    )
    return FieldResults(distribution=distribution,
                        nice_numbers=tuple(nice_numbers))


def _host_stride_depth(base: int) -> int:
    """The deepest CRT table worth building for host iteration (the JAX
    engine's _host_stride_depth): a deeper k strictly shrinks the candidate
    fraction, bounded by the table's memory and build time (about 16 bytes
    a residue) and the kernels' u32 modulus."""
    best = 1
    for k in (2, 3):
        if (base - 1) * base**k >= 1 << 25:
            break
        if stride_filter.stride_residue_count(base, k) > 2_000_000:
            break
        best = k
    return best


def _native_niceonly(range_: FieldSize, base: int, stride_table,
                     threads: int, progress=None,
                     msd_floor: int | None = None) -> FieldResults:
    """The native filter cascade (the JAX engine's _native_niceonly): the
    host library's MSD filter, then its stride iteration over each surviving
    range with `stride_table` (None: the table at _host_stride_depth),
    through the polynomial-residue kernel where it takes the table and the
    range, fanned over a pool of `threads`.

    msd_floor overrides the MSD recursion floor: the small-field host route
    passes a coarse one, so that the per-range Python and ctypes overhead
    stays small beside the library's per-candidate time."""
    native.load()
    table = stride_table
    if table is None:
        table = stride_filter.get_stride_table(base, _host_stride_depth(base))
    if table.num_residues == 0:
        return FieldResults(distribution=(), nice_numbers=())
    gaps, modulus, residues = table.gap_array, table.modulus, table.residues_u32

    def run(sub: FieldSize) -> list[int]:
        first, idx = table.first_valid_at_or_after(sub.start())
        if first >= sub.end():
            return []
        return native.iterate_range_strided(first, idx, sub.end(), base, gaps,
                                            modulus=modulus, residues=residues)

    if msd_floor is not None:
        ranges = msd_filter.get_valid_ranges(
            range_, base, min_range_size=msd_floor,
            max_depth=_msd_depth_for(range_.size(), msd_floor))
    else:
        ranges = msd_filter.get_valid_ranges(range_, base)
    total = sum(r.size() for r in ranges)
    done = 0
    nice_numbers: list[NiceNumberSimple] = []
    with ThreadPoolExecutor(max_workers=threads,
                            thread_name_prefix="nice-native") as pool:
        for sub, found in zip(ranges, pool.map(run, ranges)):
            nice_numbers.extend(NiceNumberSimple(number=n, num_uniques=base)
                                for n in found)
            done += sub.size()
            if progress is not None:
                progress(done, total)
    nice_numbers.sort(key=lambda n: n.number)
    return FieldResults(distribution=(), nice_numbers=tuple(nice_numbers))


# The largest niceonly core (numbers) that process_range_niceonly sends to
# the host route on the card when the polynomial-residue kernel's gate
# admits it. The JAX engine's 1 << 25 was set for a TPU's readback round
# trip; this value was measured on the card's machine (an H100 host with 8
# cores; scripts/host_route_sweep.py, also chip_smoke.py's host_engines
# phase): the largest power of two from 2^20 to 2^27 at which the host
# route's median is no slower than K3's on b50 fields. The two tied at 2^20
# (0.45-1.17 of K3's time over seven runs) and the host lost from 2^21 up
# (1.2-10 times slower), so the route is off by default; host_niceonly_max
# turns it on.
HOST_NICEONLY_MAX = 0


def resolve_host_niceonly_max(limit: int | None, device_type: str) -> int:
    """The host route's limit of one field: `limit`, else HOST_NICEONLY_MAX
    on a CUDA device and 0 (no route) on the CPU, whose strided path exists
    to run K3's plain version."""
    if limit is not None:
        return max(0, int(limit))
    return HOST_NICEONLY_MAX if device_type == "cuda" else 0


def _host_route_niceonly(core: FieldSize, base: int, limit: int) -> bool:
    """Whether a niceonly core of at most `limit` numbers goes to the host
    engine: the JAX engine's _host_route_niceonly with its limit as an
    argument, mirroring the fast path's eligibility in nice_native.cpp
    (candidates and digit masks in u64, the poly kernel's u64 bounds)."""
    if core.size() > limit:
        return False
    if base > 64 or core.end() >= (1 << 63) // (base - 1):
        return False
    d3 = base**3
    return core.end() ** 2 < (1 << 62) * d3**3


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


def _warm_kind(device, devices) -> str:
    """"cuda" or "cpu" of a warm's field: its device list's kind when it has
    one (parallel/mesh.device_kind, from the names alone), else its
    device's."""
    if devices is not None:
        return pmesh.device_kind(devices)
    return _device_type(device)


def warm_detailed(base: int, *, device="cuda", backend: str = "device",
                  devices=None) -> None:
    """Build and load the library a detailed field of this base launches:
    at the plan tier's bases (b10-b97) the base's own library (K1, K2 of
    the rare path and K5's detailed arm), above them the main library. The
    JAX engine's warm_detailed compiles the executables of the field's
    tuned shape; here either arm of any shape runs from that one library,
    so no tuning is resolved. On the CPU (the plain versions) and
    for the scalar oracle there is nothing to build; the native backend
    loads the host library. devices: the field's device list, if it has
    one; every slice of a mesh runs from the same libraries, which one
    process loads once for all its cards.

    No kernel launch and no torch call: the client's prefetch runs this on
    its own thread while another field runs, and nvcc runs as a subprocess.
    A failed build raises; the field's own first launch would build again
    and raise too."""
    if backend == "native":
        native.load()
        return
    if backend == "scalar" or _warm_kind(device, devices) == "cpu":
        return
    plan = get_plan(base)
    if not ce.supports_base(plan):
        raise ValueError(f"base {base} exceeds the kernels' histogram")
    if ce.plan_tier_takes(plan):
        ce.plan_library(plan)
    else:
        cuda_build.load()


def _warm_probe_routes(base: int, field_size: int, field_start, limit: int
                       ) -> bool:
    """Whether a niceonly field of field_size numbers at field_start (None:
    the top of the base's range) would take the host route."""
    br = base_range.get_base_range(base)
    if not field_size or br is None or br[1] <= br[0]:
        return False
    if field_start is not None:
        probe = FieldSize(max(br[0], min(field_start, br[1] - 1)),
                          max(br[0] + 1, min(field_start + field_size, br[1])))
    else:
        probe = FieldSize(max(br[0], br[1] - field_size), br[1])
    return _host_route_niceonly(probe, base, limit)


def warm_niceonly(base: int, field_size: int = 0, *, device="cuda",
                  backend: str = "device", field_start: int | None = None,
                  host_niceonly_max: int | None = None,
                  devices=None) -> None:
    """Make what a niceonly field of this base and size needs before its
    first number: the host library of the MSD filter; at the strided bases
    (b10-b97) the field's strided setup (MSD floor, stride depth and table,
    as strided_setup derives them from field_size) and, on the card, the
    base's own library (K3); above b97 the main library (K4, K5 and K2).
    A field that would take the host route (probed at field_start when
    given, else at the top of the base's range, the gate's worst case)
    gets the host stride table at _host_stride_depth instead, and no
    library of the base; so does the native backend. The host work runs on
    the CPU too. devices as warm_detailed's. No kernel launch and no torch
    call (see warm_detailed); a failed build raises."""
    if backend == "scalar":
        return
    kind = _warm_kind(device, devices)
    on_card = kind == "cuda"
    native.load()
    if backend == "native" or _warm_probe_routes(
            base, field_size, field_start,
            resolve_host_niceonly_max(host_niceonly_max, kind)):
        stride_filter.get_stride_table(base, _host_stride_depth(base))
        return
    plan = get_plan(base)
    if plan.limbs_n > 4:
        if on_card:
            cuda_build.load()
        return
    if strided_setup(base, max(1, field_size)) is not None and on_card:
        ce.plan_library(plan)
