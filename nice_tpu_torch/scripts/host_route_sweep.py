"""The niceonly host route against the strided pipeline (K3), field by field,
on the card: the measurement behind engine.HOST_NICEONLY_MAX.

    python -m nice_tpu_torch.scripts.host_route_sweep [--sizes 20-27]
        [--reps 5] [--threads N] [--device cuda|cpu] [--out FILE]

Each field is b50's, from the msd-ineffective cell's start (a stretch of
the valid range that the MSD filter does not prune, below the poly
kernel's gate), 2^k numbers for each k of --sizes, plus the msd-ineffective
cell itself (1e7). Every field runs through the engine twice in this
process: with host_niceonly_max=2^27 (the host route) and with 0 (K3), each
a warm pass and then --reps timed passes. The two must give the same nice
numbers, the route must launch no K3 and the device path at least one
(on the card: the wrappers count kernel launches only).
Prints one JSON line a field (the median, min and max seconds of each
route, the passes, K3's launches, the card as nvidia-smi names it, the host
threads) and last {"chosen_host_niceonly_max": N, ...}: the largest size of
the sweep at which the host route's median is no slower than K3's there and
at every smaller size of the sweep, 0 when the host loses at the smallest.
On the CPU (--device cpu) K3 runs its plain version: a check of the
harness, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

ROUTE_LIMIT = 1 << 27  # above every size of the sweep
BASE = 50


def _sizes(spec: str) -> list[int]:
    lo, _, hi = spec.partition("-")
    return [1 << k for k in range(int(lo), int(hi or lo) + 1)]


def _median(times: list[float]) -> float:
    s = sorted(times)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def card_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()


def fields(sizes: list[int]) -> list[tuple[str, int, int]]:
    """(name, start, numbers) of the sweep's fields, in ascending size."""
    from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field

    cell = get_benchmark_field(BenchmarkMode.MSD_INEFFECTIVE)
    out = [(f"2^{n.bit_length() - 1}", cell.range_start, n) for n in sizes]
    out.append(("msd-ineffective", cell.range_start, cell.range_size))
    return sorted(out, key=lambda f: f[2])


def _timed(run, reps: int):
    """(results of the last pass, pass seconds, K3 launches a pass): a warm
    pass, then reps timed passes that must all give the warm pass's
    results."""
    import torch

    from nice_tpu_torch.ops import cuda_engine as ce

    want = run()
    if torch.cuda.is_available():
        # The route makes no CUDA call: without this the process's first
        # synchronize (the context's creation) lands in a timed pass.
        torch.cuda.synchronize()
    times, launches = [], []
    for _ in range(reps):
        before = ce.LAUNCHES["strided_niceonly"]
        t0 = time.monotonic()
        got = run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        launches.append(ce.LAUNCHES["strided_niceonly"] - before)
        if got != want:
            raise RuntimeError("a timed pass changed the results")
    return want, times, launches


def measure(name: str, start: int, size: int, reps: int, threads, device
            ) -> dict:
    """One field through the host route and through K3."""
    from nice_tpu_torch.core.types import FieldSize
    from nice_tpu_torch.ops import engine

    rng = FieldSize(start, start + size)
    row: dict = {"field": name, "base": BASE, "start": start, "numbers": size}
    results = {}
    for route, limit in (("host", ROUTE_LIMIT), ("k3", 0)):
        def run():
            return engine.process_range_niceonly(
                rng, BASE, device=device, threads=threads,
                host_niceonly_max=limit)

        results[route], times, launches = _timed(run, reps)
        taken = engine.LAST_NICEONLY_STATS.get("route")
        want = "host" if route == "host" else "device"
        if taken != want:
            raise RuntimeError(f"{name}: route {taken!r}, expected {want!r}")
        row[route] = {"median_secs": _median(times), "min_secs": min(times),
                      "max_secs": max(times), "secs": times,
                      "k3_launches": launches}
    if results["host"] != results["k3"]:
        raise RuntimeError(f"{name}: the host route and K3 differ")
    # The wrappers count kernel launches only: on the CPU both read 0.
    if any(row["host"]["k3_launches"]) or (
            device != "cpu" and not all(row["k3"]["k3_launches"])):
        raise RuntimeError(f"{name}: K3 launches {row['host']['k3_launches']}"
                           f" on the route, {row['k3']['k3_launches']} on K3")
    row["nice"] = len(results["host"].nice_numbers)
    row["host_over_k3"] = row["host"]["median_secs"] / row["k3"]["median_secs"]
    row["host_wins"] = row["host"]["median_secs"] <= row["k3"]["median_secs"]
    return row


def choose(rows: list[dict], sizes: list[int]) -> int:
    """The largest size of the sweep at which the host route wins there and
    at every smaller field of the sweep; 0 when it loses at the smallest."""
    chosen = 0
    for size in sorted(sizes):
        if not all(r["host_wins"] for r in rows if r["numbers"] <= size):
            break
        chosen = size
    return chosen


def sweep(sizes: list[int], reps: int = 5, threads=None, device="cuda",
          emit=print) -> dict:
    """Every field of the sweep measured (one JSON line each through emit),
    and the chosen limit."""
    from nice_tpu_torch.ops import engine

    card = card_name(device)
    n_threads = engine.resolve_threads(threads)
    rows = []
    for name, start, size in fields(sizes):
        row = measure(name, start, size, reps, threads, device)
        row.update(device=card, threads=n_threads, cores=os.cpu_count())
        rows.append(row)
        emit(json.dumps(row))
    chosen = choose(rows, sizes)
    summary = {"chosen_host_niceonly_max": chosen,
               "engine_host_niceonly_max": engine.HOST_NICEONLY_MAX,
               "sizes": sizes, "reps": reps, "threads": n_threads,
               "cores": os.cpu_count(), "device": card}
    emit(json.dumps(summary))
    return {"rows": rows, **summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="20-27",
                    help="exponents k of the 2^k fields, LO-HI")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--threads", type=int, default=0,
                    help="host threads of the route; 0 = all cores")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    from nice_tpu_torch.ops import engine

    engine.resolve_device(args.device)
    report = sweep(_sizes(args.sizes), args.reps, args.threads or None,
                   args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        # nicelint: allow A1 (a report, not state)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
