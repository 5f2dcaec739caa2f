"""Adaptive MSD recursion floor for the niceonly pipelines, strided and
dense (copy of nice_tpu/ops/adaptive_floor.py, with a plain lock and a
`pinned` argument in place of the NICE_TPU_MSD_FLOOR variable).

The niceonly device path is a two-phase pipeline per field: the HOST runs the
MSD prefix filter down to a recursion floor (coarse floor = cheap host work,
more surviving lanes for the device; fine floor = expensive host recursion,
fewer lanes), then the DEVICE scans the surviving stride candidates. The
controller nudges the floor between fields so that the two phases' busy
times meet (msd_time ~= device_tail_time).

A pinned floor disables adaptation.
"""

from __future__ import annotations

import os

from nice_tpu_torch.utils import lockdep

# Below ~250 the device receives virtually the dense range; the cap bounds
# descriptor-span growth.
FLOOR_MIN = 250
FLOOR_MAX = 1 << 24

# Fields to observe before adapting (one-time build costs would skew the
# first ratios).
WARMUP_FIELDS = 2

# Max multiplicative nudge per field, either direction.
MAX_STEP = 1.5

# Phases shorter than this are measurement noise; treat as "free".
MIN_SECS = 0.002

# Fields whose whole pipeline ran faster than this carry no tuning signal
# (warm-up probes, benchmark 1-number fields, fully-filtered ranges): one
# fixed dispatch latency dwarfs the phase split.
TRIVIAL_SECS = 0.25

# Fields spanning fewer than this many recursion leaves at the current floor
# carry no phase-split signal either: their "device" time is one-time build
# cost and fixed dispatch latency, not lane throughput.
SIGNAL_MIN_LEAVES = 16

# Seed floor: 2^21 / cores (2^16 on 32 cores, 2^18 on 8); fewer cores ->
# coarser floor (host recursion is the bottleneck).
_SEED_CORE_PRODUCT = 2_097_152


class AdaptiveFloor:
    """Per-process controller; thread-safe (client workers share one)."""

    def __init__(self, pinned: int | None = None, seed: int | None = None):
        self._lock = lockdep.make_lock(
            "ops.adaptive_floor.AdaptiveFloor._lock")
        self.pinned = pinned is not None
        if pinned is not None:
            self.floor = float(max(1, pinned))
            self._warmup = 0
        else:
            if seed is None:
                cores = os.cpu_count() or 32
                seed = _SEED_CORE_PRODUCT // cores
            self.floor = float(min(max(seed, FLOOR_MIN), FLOOR_MAX))
            self._warmup = WARMUP_FIELDS

    def current(self) -> int:
        return int(self.floor)

    def observe(
        self, host_secs: float, device_secs: float, numbers: int | None = None
    ) -> None:
        """Record one field's phase split and nudge the floor toward
        host_secs ~= device_secs. No-op when pinned or warming up.

        `numbers` is the field size; fields spanning < SIGNAL_MIN_LEAVES
        recursion leaves at the current floor are ignored (their timing is
        build/dispatch latency, not throughput). The warm-up counter is
        consumed only by signal-bearing fields."""
        if self.pinned:
            return
        with self._lock:
            down_only = False
            if numbers is not None and numbers < SIGNAL_MIN_LEAVES * self.floor:
                # Too few leaves for a trustworthy split. Probe-sized fields
                # carry no signal at all; larger fields that merely fall
                # under the gate may still refine DOWNWARD, or a too-coarse
                # seed would freeze the controller for small fields forever.
                if numbers < SIGNAL_MIN_LEAVES * FLOOR_MIN:
                    return
                down_only = True
            if host_secs + device_secs < TRIVIAL_SECS:
                return  # field too small to tell anything
            if self._warmup > 0:
                self._warmup -= 1
                return
            if device_secs < MIN_SECS:
                ratio = MAX_STEP  # device idle: host filter is over-working
            elif host_secs < MIN_SECS:
                ratio = 1.0 / MAX_STEP  # host free: refine the filter
            else:
                ratio = host_secs / device_secs
            ratio = min(max(ratio, 1.0 / MAX_STEP), MAX_STEP)
            if down_only and ratio >= 1.0:
                return  # sub-gate fields may refine, never coarsen
            new_floor = self.floor * ratio
            if ratio > 1.0 and numbers is not None:
                # Never coarsen past the point where fields of the size just
                # observed would fall below the leaf gate, or a few
                # host-dominated fields would ratchet the floor one way until
                # the controller freezes.
                new_floor = min(new_floor, numbers / SIGNAL_MIN_LEAVES)
                new_floor = max(new_floor, self.floor)  # cap, not a shrink
            self.floor = min(max(new_floor, FLOOR_MIN), FLOOR_MAX)


_CONTROLLERS: dict[str, AdaptiveFloor] = {}
_CONTROLLERS_LOCK = lockdep.make_lock("ops.adaptive_floor._CONTROLLERS_LOCK")


def get_floor_controller(pipeline: str = "strided") -> AdaptiveFloor:
    """The per-pipeline adaptive controller, shared by every field of the
    process."""
    with _CONTROLLERS_LOCK:
        ctrl = _CONTROLLERS.get(pipeline)
        if ctrl is None:
            ctrl = _CONTROLLERS[pipeline] = AdaptiveFloor()
        return ctrl


def reset_for_tests(pinned: int | None = None) -> None:
    """Forget every controller; with `pinned`, the strided and the dense
    pipelines' are each fixed at that floor."""
    with _CONTROLLERS_LOCK:
        _CONTROLLERS.clear()
        if pinned is not None:
            for pipeline in ("strided", "dense"):
                _CONTROLLERS[pipeline] = AdaptiveFloor(pinned=pinned)
