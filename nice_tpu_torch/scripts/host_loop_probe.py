"""Where the pipelined host loop's time goes, on the card.

    python -m nice_tpu_torch.scripts.host_loop_probe [--out FILE]

Prints one JSON line: the host cost of single calls the loop makes (a
pinned allocation, a non-blocking copy, an event, a stream lookup and a
stream context, a ring upload, a block readback, the K1 and K4 wrappers),
then the extra-large field (b40 detailed) and the b98-surviving field
(dense niceonly, floor pinned at 262144) through the engine at feed depth
0 and 2, each field twice (the first 1e9 field of a process is timed
apart), with the wall seconds of each stage of the loop summed by thread:
the feed's get and upload, the wrappers, the readbacks, the collector's
waits and puts. Needs a card; the kernels build at first use.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def _per_call_us(fn, n: int = 2000) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def call_costs() -> dict:
    """Microseconds of host time per call, back to back."""
    import numpy as np
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev)
    x = torch.zeros(1, dtype=torch.int32, device=dev)
    h = torch.empty(1, dtype=torch.int32, pin_memory=True)
    plan, dense = get_plan(40), get_plan(98)

    def event():
        torch.cuda.Event().record(stream)

    def stream_context():
        with torch.cuda.stream(stream):
            pass

    ring = engine._HostRing(4, (engine.FEED_BLOCK, plan.limbs_n), dev, stream)
    rows = np.stack([int_to_limbs(plan.range_start + i, plan.limbs_n)
                     for i in range(engine.FEED_BLOCK)]).astype(np.int64)
    readbacks = engine._Readbacks((), dev, 2, stream)

    def readback_block():
        for _ in range(engine.FEED_BLOCK):
            readbacks.add(readbacks.slot(), None)
        readbacks.fetch()

    acc = torch.zeros(plan.base + 2, dtype=torch.int32, device=dev)
    start = ring.upload(rows)[0]
    nm = torch.zeros((), dtype=torch.int32, device=dev)
    classes = ce.niceonly_classes(dense, True, "cuda")
    dstart = torch.from_numpy(int_to_limbs(dense.range_start, dense.limbs_n)
                              .astype(np.int64)).to(dev)
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    return {
        "pinned_empty": _per_call_us(
            lambda: torch.empty(1, dtype=torch.int32, pin_memory=True)),
        "copy_d2h_non_blocking": _per_call_us(
            lambda: h.copy_(x, non_blocking=True)),
        "event_record": _per_call_us(event),
        "current_stream": _per_call_us(lambda: torch.cuda.current_stream(dev)),
        "stream_context": _per_call_us(stream_context),
        "ring_upload_block": _per_call_us(lambda: ring.upload(rows), 500),
        "readback_block": _per_call_us(readback_block, 500),
        "k1_wrapper_1024_lanes": _per_call_us(
            lambda: ce.detailed_accum_megaloop(plan, 1024, 1, acc, start,
                                               1024, 0, nm_out=nm)),
        "k4_wrapper_small_run": _per_call_us(
            lambda: ce.niceonly_dense_megaloop(dense, 1024, 1, classes,
                                               dstart, 1024, out=out)),
    }


class _StageTimes:
    """Wraps engine and wrapper functions to sum wall seconds per (stage,
    thread); restore() puts the originals back."""

    STAGES = (("engine", "_SliceFeed", "get", "feed.get"),
              ("engine", "_HostRing", "upload", "ring.upload"),
              ("engine", "_Readbacks", "fetch", "readbacks.fetch"),
              ("engine", "_Collector", "put", "collector.put"),
              ("engine", None, "_wait", "collector._wait"),
              ("ce", None, "detailed_accum_megaloop", "K1 wrapper"),
              ("ce", None, "niceonly_dense_megaloop", "K4 wrapper"))

    def __init__(self):
        from nice_tpu_torch.ops import cuda_engine as ce
        from nice_tpu_torch.ops import engine

        self.mods = {"engine": engine, "ce": ce}
        self.sums: dict = {}
        self._saved = []
        for mod, cls, attr, label in self.STAGES:
            owner = self.mods[mod] if cls is None else getattr(self.mods[mod],
                                                               cls)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(label, fn))

    def _timed(self, label, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                key = f"{label} [{threading.current_thread().name}]"
                n, secs = self.sums.get(key, (0, 0.0))
                self.sums[key] = (n + 1, secs + time.perf_counter() - t0)
        return wrapper

    def restore(self) -> None:
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def field_runs() -> list:
    import torch

    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import adaptive_floor, engine

    dev = torch.device("cuda")
    xl = FieldSize(1916284264916, 1916284264916 + 10**9)
    b98 = 413428759798923141071530212209627033363
    fields = [("extra-large", engine.process_range_detailed, xl, 40),
              ("b98-surviving", engine.process_range_niceonly,
               FieldSize(b98, b98 + 10**9), 98)]
    adaptive_floor.reset_for_tests(pinned=262144)
    out = []
    for name, process, field, base in fields:
        for depth in (0, 2, 2, 0):
            stages = _StageTimes()
            try:
                t0 = time.perf_counter()
                process(field, base, device=dev, feed_depth=depth)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                stages.restore()
            row = {"field": name, "feed_depth": depth, "secs": secs,
                   "feed": dict(engine.LAST_FEED_STATS),
                   "stages_ms": {k: round(v[1] * 1e3, 3)
                                 for k, v in sorted(stages.sums.items())},
                   "stage_calls": {k: v[0] for k, v in stages.sums.items()}}
            if base == 98:
                row["loop_secs"] = engine.LAST_NICEONLY_STATS["loop_secs"]
                row["msd_secs"] = engine.LAST_NICEONLY_STATS["msd_secs"]
            out.append(row)
    adaptive_floor.reset_for_tests()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("host_loop_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from nice_tpu_torch.ops import cuda_build

    cuda_build.load()
    report = {"card": torch.cuda.get_device_name(0),
              "call_us": call_costs(), "fields": field_runs()}
    line = json.dumps(report)
    if args.out:
        # nicelint: allow A1 (a report, not state)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
