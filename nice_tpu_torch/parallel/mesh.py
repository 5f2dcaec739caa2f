"""Slices of a field over a list of devices, in one process (the port's twin
of nice_tpu/parallel/mesh.py), and the multi-tenant scheduler's occupancy
meter.

The reference shards the number line over a 1-D jax Mesh: one process
shard_maps each step over jax.devices(), every device runs the one-device
kernel on its own (start, valid) row, and the per-device histogram rows are
psum'd once a field. The port runs the same single-controller design over a
list of devices, the mesh's *slices*: each slice is an indexed torch.device
("cuda:0", or "cpu") with its own CUDA stream, upload ring, readbacks, rare-
path ring and int32 accumulator; the engine's one dispatcher thread enqueues
every slice's launch asynchronously on that slice's stream, and the fold
(make_sharded_stats_fold) waits on every slice, copies each row to the first
slice's device (a peer copy across distinct cards, none on one card) and
sums the rows in int64 there: the psum's twin. A list may repeat a device:
["cuda:0"] * 4 is four logical slices of one card, each on its own stream
(the twin of the reference suite's 8 virtual CPU devices); ["cpu"] * k runs
the kernels' plain versions.

A slice's identity is its position in the caller's device list (Slice.id),
not its device: liveness (simulate_device_loss, live_devices,
probe_devices) and the step cache are keyed by it, so losing slice 3 of
four logical slices of one card loses that slice alone. MeshDeviceLost
names positions along the current mesh, as the reference's axis positions.

The reference's segment == 1 steps (make_sharded_stats_step, _accum_step,
_detailed_step, _niceonly_step) are the megaloop steps below at seg=1, as
on the port's one-device path. No step takes the tensor-core arm (K5): the
reference's sharded steps never take use_mxu either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nice_tpu_torch.obs.series import MESH_DEVICES
from nice_tpu_torch.ops.cuda_engine import DEFAULT_BLOCK_THREADS
from nice_tpu_torch.utils import lockdep


class MeshDeviceLost(RuntimeError):
    """A mesh dispatch failed because one or more slices dropped.

    lost: positions along the current mesh (NOT slice ids) of the slices
    believed dead. Raised by the chaos hook (fault site mesh.dispatch,
    action dead[:i[+j...]]); ops/engine.py catches it at the elastic
    downshift boundary."""

    def __init__(self, lost, cause: BaseException | None = None):
        self.lost = tuple(sorted(set(int(i) for i in lost)))
        self.cause = cause
        super().__init__(f"mesh slice(s) lost at position(s) {self.lost}")


class Slice(NamedTuple):
    id: int               # position in the caller's device list
    device: torch.device  # "cuda:<i>" or "cpu"


# --- slice liveness (real probes + simulated loss for drills) --------------

_dead_lock = lockdep.make_lock("parallel.mesh._dead_lock")
_simulated_dead: set[int] = set()


def simulate_device_loss(slice_ids) -> None:
    """Mark slice ids as dead for live_devices/probe_devices: the fault
    injector's dead:<i> action and drills drive the elastic downshift with
    it on hardware that cannot lose a device."""
    with _dead_lock:
        _simulated_dead.update(int(i) for i in slice_ids)


def heal_devices() -> None:
    """Clear every simulated loss (test and drill teardown)."""
    with _dead_lock:
        _simulated_dead.clear()


def live_devices(slices) -> list:
    """The slices not marked dead (cheap; no probe dispatch)."""
    with _dead_lock:
        dead = set(_simulated_dead)
    return [s for s in slices if s.id not in dead]


def probe_devices(slices) -> tuple[list, list]:
    """Partition slices into (alive, lost) by a one-element add and its
    readback on each slice's device, caught per slice. Simulated-dead
    slices always count as lost."""
    with _dead_lock:
        dead = set(_simulated_dead)
    alive, lost = [], []
    for s in slices:
        if s.id in dead:
            lost.append(s)
            continue
        try:
            x = torch.ones((), dtype=torch.int32, device=s.device) + 1
            if int(x) != 2:
                raise RuntimeError("device probe computed garbage")
            alive.append(s)
        except Exception:  # noqa: BLE001 — any failure means "not usable"
            lost.append(s)
    return alive, lost


# --- device lists and meshes -------------------------------------------------

def device_kind(devices) -> str:
    """"cuda" or "cpu" of a device list, from the names alone (no torch
    call: a client warms on a thread of its own while a field runs). Each
    entry is "cpu" or "cuda:<index>"; a bare "cuda", a mix of the two kinds
    and an empty list raise ValueError."""
    names = [str(d) for d in devices]
    if not names:
        raise ValueError("an empty device list")
    kinds = set()
    for name in names:
        kind, _, index = name.partition(":")
        if kind == "cuda":
            if not index.isdigit():
                raise ValueError(f"device {name!r}: a slice names its card "
                                 "(cuda:0, cuda:1, ...)")
        elif kind != "cpu" or index not in ("", "0"):
            raise ValueError(f"unsupported device {name!r} (cuda:<i> or cpu)")
        kinds.add(kind)
    if len(kinds) > 1:
        raise ValueError(f"a device list mixes CPU and CUDA: {names}")
    return kinds.pop()


def slices_of(devices) -> list[Slice]:
    """The slices of a device list, ids by position. A CUDA list without
    CUDA, or naming a card the process cannot see, raises: a mesh never
    carries on on the CPU unasked."""
    kind = device_kind(devices)
    devs = [torch.device(str(d)) for d in devices]
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass a list of 'cpu' "
                               "devices to run the plain PyTorch path")
        n = torch.cuda.device_count()
        for d in devs:
            if d.index >= n:
                raise ValueError(f"device {d} is not visible ({n} cards)")
    else:
        devs = [torch.device("cpu")] * len(devs)
    return [Slice(i, d) for i, d in enumerate(devs)]


class Mesh:
    """An ordered tuple of slices and, on CUDA, one stream a slice. use(d)
    makes slice d's stream (and with it its card) current on the calling
    thread, so whatever that thread enqueues next lands on slice d's stream;
    the current stream is per thread, so the dispatcher and the collector
    each select their own."""

    def __init__(self, slices):
        self.slices = tuple(slices)
        self.devices = tuple(s.device for s in self.slices)
        self.ids = tuple(s.id for s in self.slices)
        self.cuda = self.devices[0].type == "cuda"
        self.streams = (tuple(torch.cuda.Stream(device=d) for d in self.devices)
                        if self.cuda else (None,) * len(self.slices))

    @property
    def size(self) -> int:
        return len(self.slices)

    def use(self, d: int) -> None:
        if self.cuda:
            torch.cuda.set_stream(self.streams[d])

    def saved_streams(self):
        """A callable that puts back the calling thread's current device
        and the current stream of each card of the mesh, as they are now."""
        if not self.cuda:
            return lambda: None
        cur = torch.cuda.current_device()
        saved = [torch.cuda.current_stream(d) for d in sorted(
            set(self.devices), key=lambda d: d.index)]

        def restore():
            for s in saved:
                torch.cuda.set_stream(s)
            torch.cuda.set_device(cur)

        return restore


def make_mesh(devices) -> Mesh:
    """A mesh over a device list (names or torch.devices; slice ids by
    position) or over Slices (a downshift's survivors keep their ids)."""
    devices = list(devices)
    slices = (devices if devices and all(isinstance(d, Slice) for d in devices)
              else slices_of(devices))
    MESH_DEVICES.set(len(slices))
    return Mesh(slices)


def mesh_device_ids(mesh: Mesh) -> tuple[int, ...]:
    """The cache identity of a mesh: its slice ids in order."""
    return mesh.ids


# --- the step cache ------------------------------------------------------------
# Per-slice state (rings, readbacks, accumulators) is cached per (kind,
# slice ids, shape key): a process's fields on the same mesh reuse it, and a
# downshift evicts every entry of the mesh that lost a slice. A cached step
# serves one field at a time (begin() resets it), as a process runs one
# field at a time.

_step_lock = lockdep.make_lock("parallel.mesh._step_lock")
_STEP_CACHE: dict = {}


def _step_cached(kind: str, mesh: Mesh, extra_key, build):
    key = (kind, mesh_device_ids(mesh), tuple(map(str, mesh.devices)),
           extra_key)
    with _step_lock:
        step = _STEP_CACHE.get(key)
    if step is not None:
        return step
    step = build()
    with _step_lock:
        return _STEP_CACHE.setdefault(key, step)


def clear_step_cache(device_ids=None) -> int:
    """Evict cached steps. device_ids (slice ids, order-insensitive) evicts
    every entry whose mesh contains ANY of them; None clears everything.
    Returns the entries dropped."""
    with _step_lock:
        if device_ids is None:
            n = len(_STEP_CACHE)
            _STEP_CACHE.clear()
            return n
        ids = set(int(i) for i in device_ids)
        doomed = [k for k in _STEP_CACHE if ids.intersection(k[1])]
        for k in doomed:
            del _STEP_CACHE[k]
        return len(doomed)


def partition_segments(segments, n_slices: int, batch_size: int) -> list[list]:
    """Split ascending, disjoint [start, end) segments into n_slices work
    queues (lists of segments) of near-equal total size, cut points aligned
    to batch_size so every slice dispatches whole batches until its tail.

    This is the pod-slicing primitive: a field's (remaining) cursor range
    becomes one queue per slice, and a downshift re-runs it over the
    survivors' count — slices may span several segments after a reshard."""
    segs = [(int(s), int(e)) for s, e in segments if int(e) > int(s)]
    n_slices = max(1, int(n_slices))
    if not segs:
        return [[] for _ in range(n_slices)]
    total = sum(e - s for s, e in segs)
    per = -(-total // n_slices)
    per = -(-per // batch_size) * batch_size
    out: list[list] = []
    cur: list = []
    room = per
    i = 0
    while i < len(segs):
        s, e = segs[i]
        if len(out) >= n_slices - 1:
            cur.append((s, e))
            i += 1
            continue
        take = min(room, e - s)
        cur.append((s, s + take))
        room -= take
        if take < e - s:
            segs[i] = (s + take, e)
        else:
            i += 1
        if room == 0:
            out.append(cur)
            cur = []
            room = per
    out.append(cur)
    while len(out) < n_slices:
        out.append([])
    return out


# --- sharded steps -----------------------------------------------------------

class _SliceLoop:
    """One slice's share of a detailed or dense loop, made on the slice's
    device under its stream: the feed's upload ring, the readbacks of its
    per-item outputs, the rare path's ring and (detailed) its int32
    histogram row."""

    def __init__(self, plan, mesh: Mesh, d: int, out_shape: tuple,
                 acc_width: int, window: int):
        from nice_tpu_torch.ops import engine

        dev, stream = mesh.devices[d], mesh.streams[d]
        mesh.use(d)
        self.ring = engine._HostRing(engine.FEED_RING_SLOTS,
                                     (engine.FEED_BLOCK, plan.limbs_n), dev,
                                     stream)
        self.readbacks = engine._Readbacks(out_shape, dev, window, stream)
        self.rare_ring = engine._HostRing(2, (plan.limbs_n,), dev, stream)
        self.acc = (torch.zeros(acc_width, dtype=torch.int32, device=dev)
                    if acc_width else None)

    def begin(self) -> None:
        self.readbacks.clear()
        self.ring.waits = 0
        if self.acc is not None:
            self.acc.zero_()


def _window(mesh: Mesh) -> int:
    """Readback blocks a slice keeps: the engine's collector holds the
    blocks of every slice (DISPATCH_WINDOW items a slice in flight)."""
    from nice_tpu_torch.ops import engine

    return -(-engine.DISPATCH_WINDOW // engine.FEED_BLOCK) * mesh.size


class _LoopStep:
    """A detailed or dense step: one _SliceLoop a slice."""

    mesh: Mesh
    loops: list

    def begin(self) -> None:
        """Ready the cached step for a field: empty readbacks, zero rows."""
        for d, lp in enumerate(self.loops):
            self.mesh.use(d)
            lp.begin()


class ShardedAccumStep(_LoopStep):
    """K1 a slice (make_sharded_megaloop_accum_step)."""

    def __init__(self, plan, batch_size: int, seg: int, mesh: Mesh,
                 block_threads: int):
        self.plan, self.batch_size, self.seg, self.mesh = (plan, batch_size,
                                                           seg, mesh)
        self.block_threads = block_threads
        restore = mesh.saved_streams()
        try:
            self.loops = [_SliceLoop(plan, mesh, d, (), plan.base + 2,
                                     _window(mesh)) for d in range(mesh.size)]
        finally:
            restore()

    def launch(self, d: int, start: torch.Tensor, valid: int) -> torch.Tensor:
        """Slice d's K1 segment into its row; its near-miss count lands in
        the slice's next readback slot (returned). The caller has made slice
        d's stream current (mesh.use(d))."""
        from nice_tpu_torch.ops import cuda_engine as ce

        lp = self.loops[d]
        lp.acc, nm = ce.detailed_accum_megaloop(
            self.plan, self.batch_size, self.seg, lp.acc, start, valid, 0,
            nm_out=lp.readbacks.slot(), block_threads=self.block_threads)
        return nm


def make_sharded_megaloop_accum_step(
        plan, batch_size: int, seg: int, mesh: Mesh,
        block_threads: int = DEFAULT_BLOCK_THREADS) -> ShardedAccumStep:
    """The detailed step: each slice runs K1 over its own (start, valid)
    segment of batch_size * seg lanes in blocks of block_threads threads
    (the field's resolved size), on its stream, into its own int32
    histogram row, which stays on its device until make_sharded_stats_fold
    folds the rows (one fold a flush, as the reference's one psum a
    field). Each slice's near-miss counts are read back a block at a time
    from its own readbacks."""
    return _step_cached("stats-accum-mega", mesh,
                        (plan, batch_size, seg, block_threads),
                        lambda: ShardedAccumStep(plan, batch_size, seg, mesh,
                                                 block_threads))


def make_sharded_stats_fold(mesh: Mesh):
    """The reduction paired with the accumulate step: fold(rows) waits on
    each slice's stream, copies each int32 row to the first slice's device,
    sums them in int64 on the first slice's stream, starts one copy of the
    sum to pinned host memory and zeroes every row once the sum has read
    it. Returns (host int64[width], event): read the host tensor after the
    event (None on the CPU, where the sum is ready)."""
    return _step_cached("stats-fold", mesh, None, lambda: _build_fold(mesh))


def _build_fold(mesh: Mesh):
    def fold_cpu(rows):
        total = torch.stack(list(rows)).sum(0, dtype=torch.int64)
        for r in rows:
            r.zero_()
        return total, None

    if not mesh.cuda:
        return fold_cpu
    dev0, s0 = mesh.devices[0], mesh.streams[0]

    def fold(rows):
        # A row on the first card is read on its stream after the event;
        # a row on another card is copied on its own stream, which torch
        # orders before the first card's stream.
        on0 = []
        for d, r in enumerate(rows):
            mesh.use(d)
            if d:
                ev = torch.cuda.Event()
                ev.record(mesh.streams[d])
                on0.append((ev, r.to(dev0, non_blocking=True)))
        mesh.use(0)
        for ev, _ in on0:
            s0.wait_event(ev)
        total = torch.stack([rows[0]] + [r for _, r in on0]).sum(
            0, dtype=torch.int64)
        host = torch.empty(total.shape, dtype=torch.int64, pin_memory=True)
        host.copy_(total, non_blocking=True)
        done = torch.cuda.Event()
        done.record(s0)
        for d, r in enumerate(rows):
            mesh.use(d)
            mesh.streams[d].wait_event(done)
            r.zero_()
        return host, done

    return fold


class ShardedCountStep(_LoopStep):
    """K4 a slice (make_sharded_megaloop_count_step)."""

    def __init__(self, plan, batch_size: int, seg: int, mesh: Mesh,
                 block_threads: int):
        from nice_tpu_torch.ops import cuda_engine as ce

        self.plan, self.batch_size, self.seg, self.mesh = (plan, batch_size,
                                                           seg, mesh)
        self.block_threads = block_threads
        restore = mesh.saved_streams()
        try:
            self.loops = [_SliceLoop(plan, mesh, d, (2,), 0, _window(mesh))
                          for d in range(mesh.size)]
            self.classes = [ce.niceonly_classes(plan, True, str(dev))
                            for dev in mesh.devices]
        finally:
            restore()

    def launch(self, d: int, start: torch.Tensor, valid: int) -> torch.Tensor:
        """Slice d's K4 run: its [count, pruned] in the slice's next
        readback slot (returned); slice d's stream is current."""
        from nice_tpu_torch.ops import cuda_engine as ce

        return ce.niceonly_dense_megaloop(
            self.plan, self.batch_size, self.seg, self.classes[d], start,
            valid, use_mxu=0, out=self.loops[d].readbacks.slot(),
            block_threads=self.block_threads)


def make_sharded_megaloop_count_step(
        plan, batch_size: int, seg: int, mesh: Mesh,
        block_threads: int = DEFAULT_BLOCK_THREADS) -> ShardedCountStep:
    """The dense niceonly step: each slice runs K4 (the fused mode: the
    residue classes the congruence keeps) over its own (start, valid) run
    of batch_size * seg lanes in blocks of block_threads threads, on its
    stream. Where the reference psums the
    slices' counts and re-scans every slice's run on a nonzero total, each
    slice's [count, pruned] is read back with its run, so the collector
    re-scans only the runs that count and holds each to its own count."""
    return _step_cached("stats-mega", mesh,
                        (plan, batch_size, seg, block_threads),
                        lambda: ShardedCountStep(plan, batch_size, seg, mesh,
                                                 block_threads))


class ShardedStridedStep:
    """K3 a slice (make_sharded_strided_step)."""

    def __init__(self, plan, base: int, k: int, modulus: int, periods: int,
                 desc_max: int, mesh: Mesh):
        from nice_tpu_torch.ops import cuda_engine as ce
        from nice_tpu_torch.ops import engine

        self.plan, self.modulus, self.periods = plan, modulus, periods
        self.desc_max, self.mesh = desc_max, mesh
        restore = mesh.saved_streams()
        try:
            self.rings, self.residues = [], []
            for d, dev in enumerate(mesh.devices):
                mesh.use(d)
                self.rings.append(engine._HostRing(
                    2 * engine.STRIDE_WINDOW, (desc_max, ce.DESC_WIDTH), dev,
                    mesh.streams[d]))
                self.residues.append(engine._device_residues(base, k,
                                                             str(dev)))
        finally:
            restore()

    def __call__(self, packed: np.ndarray, k_real: int):
        """packed: int64 [desc_max * n, 12] descriptor rows, the first
        k_real real. Slice d counts rows [d * desc_max, (d + 1) * desc_max)
        on its stream. Returns (counts, events), one a slice: slice d's
        int32[desc_max] device counts and the event after its launch (None
        and None for a slice with no real row; an event None on the CPU).
        Concatenated in slice order, the counts are the group's, row for
        row."""
        from nice_tpu_torch.ops import cuda_engine as ce

        counts, events = [], []
        for d in range(self.mesh.size):
            n_real = min(max(k_real - d * self.desc_max, 0), self.desc_max)
            if n_real == 0:
                counts.append(None)
                events.append(None)
                continue
            self.mesh.use(d)
            rows = packed[d * self.desc_max:(d + 1) * self.desc_max]
            desc = self.rings[d].upload(rows)
            counts.append(ce.strided_niceonly_batch(
                self.plan, self.modulus, self.residues[d], self.periods, desc,
                n_real))
            ev = None
            if self.mesh.cuda:
                ev = torch.cuda.Event()
                ev.record(self.mesh.streams[d])
            events.append(ev)
        return counts, events


def make_sharded_strided_step(plan, base: int, k: int, modulus: int,
                              periods: int, desc_max: int,
                              mesh: Mesh) -> ShardedStridedStep:
    """The strided niceonly step: a group of up to desc_max * n descriptors
    split into one K3 launch a slice, each on its stream, at K3's module
    block size (cuda_engine.STRIDED_BLOCK_THREADS); the per-
    descriptor counts are concatenated in descriptor order, not reduced
    (the host needs every descriptor's count to pick its re-scans)."""
    return _step_cached(
        "strided", mesh, (plan, k, modulus, periods, desc_max),
        lambda: ShardedStridedStep(plan, base, k, modulus, periods, desc_max,
                                   mesh))


class OccupancyMeter:
    """Accumulates device-busy wall time against an observation window so
    the multi-tenant scheduler can report occupancy (busy/wall) per tenant
    and overall. Busy intervals are attributed by tenant label;
    thread-safe because the scheduler's page loop and its SLO periodic
    both read it."""

    def __init__(self):
        self._lock = lockdep.make_lock("parallel.mesh.OccupancyMeter._lock")
        self._busy: dict[str, float] = {}
        self._started: float | None = None
        self._stopped: float | None = None

    def start(self, now: float) -> None:
        with self._lock:
            if self._started is None:
                self._started = now
            self._stopped = None

    def stop(self, now: float) -> None:
        with self._lock:
            self._stopped = now

    def add_busy(self, tenant: str, secs: float) -> None:
        if secs <= 0:
            return
        with self._lock:
            self._busy[tenant] = self._busy.get(tenant, 0.0) + secs

    def busy_secs(self, tenant: str | None = None) -> float:
        with self._lock:
            if tenant is not None:
                return self._busy.get(tenant, 0.0)
            return sum(self._busy.values())

    def wall_secs(self, now: float | None = None) -> float:
        with self._lock:
            if self._started is None:
                return 0.0
            end = self._stopped if self._stopped is not None else now
            if end is None:
                return 0.0
            return max(0.0, end - self._started)

    def occupancy(self, now: float | None = None) -> float:
        """Overall busy/wall in [0, 1]; 0 before the window opens."""
        wall = self.wall_secs(now)
        if wall <= 0:
            return 0.0
        return min(1.0, self.busy_secs() / wall)

    def shares(self) -> dict[str, float]:
        """Each tenant's fraction of total busy time (sums to ~1)."""
        with self._lock:
            total = sum(self._busy.values())
            if total <= 0:
                return {t: 0.0 for t in self._busy}
            return {t: b / total for t, b in self._busy.items()}
