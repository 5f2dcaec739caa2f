"""Scaling of one field over a mesh of slices: seconds by slice count, the
feed A/B and a reshard drill (the port's twin of scripts/multichip_scaling.py).

    python -m nice_tpu_torch.scripts.multichip_scaling \\
        --devices cuda:0,cuda:0,cuda:0,cuda:0 [--slices 1,2,4] [--out R.json]
    python -m nice_tpu_torch.scripts.multichip_scaling --devices cpu,cpu,cpu

One process drives every count (the reference re-execs itself a count under
a forced virtual mesh; the port's device list is an argument): count k runs
the field on the first k entries of --devices ("cuda:0" repeated: logical
slices of one card, each on its own stream; cuda:0,cuda:1,...: distinct
cards; k = 1 is the one-device path). For each count, after an untimed warm
pass: --reps timed passes at the default feed depth (their median, min and
max), one at feed depth 0 (the synchronous A/B), the launches of a pass, and
LAST_FEED_STATS (dispatches, the host's idle gaps p50/p95, slices at the
start and end); with --profile one more pass under torch.profiler (the
device's busy time, its idle share, and how much the slices' kernels
overlapped across their streams). At the highest count, the drill: the fault site
mesh.dispatch loses a slice mid-field (--drill), and the field must
downshift onto the survivors (reshards 1, one slice fewer at the end).

Every result is held to the reference: the scalar oracle on the default
field (the reference harness's 24,576 numbers @ b40, per-batch dispatch at
batch 256), or, for a field too large for the oracle, a reference result
the caller passes (chip_smoke.py's mesh phase passes the one-device run of
the same field). Prints one line, MULTICHIP_SCALING {json}; exit code 0
when every pass and the drill agree.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

BASE = 40
FIELD_SIZE = 24_576
BATCH_SIZE = 256
DRILL = "mesh.dispatch:dead@3"


def result_pairs(results) -> tuple:
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _pass(field, base: int, mode: str, devices, feed_depth: int, **kw):
    """One field: (results, seconds, launches, feed stats). The strided
    pipeline (niceonly to b97) has no feed: its stats are the dispatcher's
    (LAST_NICEONLY_STATS), with n_dev_start and n_dev_end its slices."""
    from nice_tpu_torch.ops import cuda_engine as ce
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.parallel import mesh as pmesh

    process = (engine.process_range_detailed if mode == "detailed"
               else engine.process_range_niceonly)
    before = dict(ce.LAUNCHES)
    t0 = time.monotonic()
    results = process(field, base, device=pmesh.device_kind(devices),
                      devices=devices, feed_depth=feed_depth, **kw)
    secs = time.monotonic() - t0
    launches = {k: v - before[k] for k, v in ce.LAUNCHES.items()
                if v != before[k]}
    if mode == "detailed" or engine.niceonly_takes_batch(base):
        return results, secs, launches, dict(engine.LAST_FEED_STATS)
    st = engine.LAST_NICEONLY_STATS
    return results, secs, launches, {
        "mode": "niceonly-strided", "n_dev_start": st["n_dev"],
        "n_dev_end": st["n_dev"], "groups": st["groups"],
        "descriptors": st["descriptors"], "wall": st["wall"]}


def profile_pass(field, base: int, mode: str, devices, **kw) -> dict:
    """One pass at the default feed depth under torch.profiler (the card's
    activity alone, sparing the host loop the profiler's call tracing):
    the wall, the kernels' summed device time, the device's busy time (the
    union of the kernels' intervals, so kernels of several streams that
    run at once count once), their overlap (summed less busy) and the
    device's idle share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_tpu_torch.ops import engine

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _pass(field, base, mode, devices, engine.FEED_DEPTH_DEFAULT, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    summed_ms = sum(b - a for a, b in spans) / 1e3
    return {"wall_ms": wall_ms, "kernels": len(spans),
            "kernel_ms_summed": summed_ms, "device_busy_ms": busy_us / 1e3,
            "overlap_ms": summed_ms - busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms}


def _drill(field, base: int, mode: str, devices, spec: str, want, **kw):
    """The field on `devices` with `spec` configured at mesh.dispatch:
    equal to `want`, one reshard, the lost slices gone at the end."""
    from nice_tpu_torch.faults import injector as faults
    from nice_tpu_torch.ops import engine
    from nice_tpu_torch.parallel import mesh as pmesh

    try:
        faults.configure(spec)
        results, secs, launches, feed = _pass(
            field, base, mode, devices, engine.FEED_DEPTH_DEFAULT, **kw)
    finally:
        faults.reset()
        pmesh.heal_devices()
    action = spec.split(":", 1)[1].split("@")[0]
    lost = (len(action.split(":", 1)[1].split("+")) if ":" in action else 1)
    equal = result_pairs(results) == want
    return {"spec": spec, "secs": secs, "launches": launches,
            "reshards": feed["reshards"], "reshard_secs": feed["reshard_secs"],
            "n_dev_start": feed["n_dev_start"], "n_dev_end": feed["n_dev_end"],
            "equal": equal,
            "ok": (equal and feed["reshards"] == 1
                   and feed["n_dev_end"] == len(devices) - lost)}


def scaling(field, base: int, devices, counts, *, mode: str = "detailed",
            reps: int = 3, want=None, drill: str | None = DRILL,
            profile: bool = False, **kw) -> dict:
    """The report of `field` (a FieldSize) at each slice count of `counts`
    over the first k entries of `devices`; kw goes to the engine's entry
    point (batch_size, segment, ...). want: the (distribution, nice)
    pairs every pass must give; None computes them with the port's scalar
    oracle. drill: the mesh.dispatch spec of the drill at the highest
    count (None: no drill). profile: one more pass a count under the
    profiler (profile_pass; on the card)."""
    from nice_tpu_torch.ops import engine, scalar

    if want is None:
        oracle = (scalar.process_range_detailed if mode == "detailed"
                  else scalar.process_range_niceonly)
        want = result_pairs(oracle(field, base))
    rows = []
    for k in counts:
        devs = list(devices[:k])
        _pass(field, base, mode, devs, engine.FEED_DEPTH_DEFAULT, **kw)
        passes = [_pass(field, base, mode, devs, engine.FEED_DEPTH_DEFAULT,
                        **kw) for _ in range(reps)]
        sync = _pass(field, base, mode, devs, 0, **kw)
        secs = [p[1] for p in passes]
        feed = passes[-1][3]
        rows.append({
            "slices": k, "devices": devs, "secs": secs,
            "median_secs": statistics.median(secs), "min_secs": min(secs),
            "max_secs": max(secs),
            "numbers_per_sec": field.size() / statistics.median(secs),
            "launches": passes[-1][2], "feed": feed,
            "idle_p50_us": 1e6 * feed.get("idle_p50", 0.0),
            "idle_p95_us": 1e6 * feed.get("idle_p95", 0.0),
            "depth0_secs": sync[1], "depth0_feed": sync[3],
            "equal": all(result_pairs(p[0]) == want for p in (*passes, sync)),
        })
        if profile:
            rows[-1]["profile"] = profile_pass(field, base, mode, devs, **kw)
    base_row = rows[0]
    for row in rows:
        row["secs_vs_first"] = row["median_secs"] / base_row["median_secs"]
    report = {"harness": "multichip_scaling", "mode": mode, "base": base,
              "start": field.start(), "size": field.size(), "counts": rows,
              "ok": all(r["equal"] for r in rows)}
    if drill is not None and max(counts) > 1:
        report["drill"] = _drill(field, base, mode,
                                 list(devices[:max(counts)]), drill, want,
                                 **kw)
        report["ok"] = report["ok"] and report["drill"]["ok"]
    return report


def main(argv=None) -> int:
    from nice_tpu_torch.core import base_range
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.parallel import mesh as pmesh

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", required=True,
                   help="comma-separated slices, e.g. cuda:0,cuda:0,cuda:0,"
                   "cuda:0 or cpu,cpu,cpu,cpu")
    p.add_argument("--slices", default=None,
                   help="comma-separated slice counts (default: 1, 2, 4, "
                   "... up to the list's length)")
    p.add_argument("--mode", default="detailed",
                   choices=["detailed", "niceonly"])
    p.add_argument("--base", type=int, default=BASE)
    p.add_argument("--size", type=int, default=FIELD_SIZE,
                   help="numbers of the field, from the base range's start")
    p.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    p.add_argument("--segment", type=int, default=1,
                   help="batches a dispatch (1: per-batch, as the reference "
                   "harness pins it)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--drill", default=DRILL,
                   help="the mesh.dispatch spec of the drill at the highest "
                   "count ('' for none)")
    p.add_argument("--profile", action="store_true",
                   help="one more pass a count under torch.profiler (on the "
                   "card): device busy, overlap across streams, idle share")
    p.add_argument("--out", default="", help="also write the report here")
    args = p.parse_args(argv)

    devices = [d.strip() for d in args.devices.split(",") if d.strip()]
    pmesh.device_kind(devices)
    counts = ([int(c) for c in args.slices.split(",")] if args.slices
              else [1 << i for i in range(len(devices).bit_length())])
    if max(counts) > len(devices):
        p.error(f"{max(counts)} slices from {len(devices)} devices")
    lo, hi = base_range.get_base_range(args.base)
    field = FieldSize(lo, min(lo + args.size, hi))
    kw = {"batch_size": args.batch_size}
    if args.mode == "detailed" or args.base >= 98:
        kw["segment"] = args.segment
    else:
        kw.pop("batch_size")  # the strided pipeline takes no shape
    report = scaling(field, args.base, devices, counts, mode=args.mode,
                     reps=args.reps, drill=args.drill or None,
                     profile=args.profile, **kw)
    if pmesh.device_kind(devices) == "cuda":
        import torch

        report["card"] = torch.cuda.get_device_name(0)
        report["cards"] = torch.cuda.device_count()
    print("MULTICHIP_SCALING " + json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
