"""Per-(mode, base, device) kernel-shape autotuner with a persistent winners
table (the port's counterpart of nice_tpu/ops/autotune.py).

`sweep()` times configurations through the tuning harness
(`python -m nice_tpu_torch.scripts.tune_kernels`, --json) in a subprocess,
on the real dispatch path with the kernels built and warmed first, and
stores the best one per key in a JSON table at WINNERS_PATH. The engine reads
it through engine.resolve_tuning, whose precedence is:

    1. an explicit argument (batch_size / segment / use_mxu /
       block_threads)                                         - `override`
    2. the tuned winner from this table                      - `hit`
    3. the built-in default                                   - `miss`

Every entry carries a signature: the base's limb widths, the runtime
(`torch-{ver}-cuda{ver}-sm{cc}` on a card, `torch-{ver}-cpu` on the CPU) and
the hash of the kernel sources. A lookup whose stored signature differs is
dropped and counted `invalidated`, so a new torch, another card or an edited
kernel re-tunes instead of running stale shapes. A signature that cannot be
computed (a base without a plan) raises. A table that does not parse reads
as empty.

The table is a module constant, not an environment variable: the port reads
none. Tests and chip_smoke.py point WINNERS_PATH at a file of their own.
EVENTS counts the lookups, and each one also goes to the
nice_autotune_events_total series ("override", an explicit argument, is
the port's counterpart of the reference's "env_override").
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from nice_tpu_torch.obs.series import AUTOTUNE_EVENTS
from nice_tpu_torch.ops import cuda_build
from nice_tpu_torch.ops.limbs import get_plan
from nice_tpu_torch.utils import fsio, lockdep

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)

# Where the winners live: beside the built kernels, inside the package's
# git-ignored build directory.
WINNERS_PATH = os.path.join(PKG_DIR, "_build", "autotune.json")

# The knobs a winner holds (JAX's names: "megaloop" is the segment length;
# "block_threads", the threads of a block of K1/K4/K5, is the port's
# counterpart of JAX's "block_rows").
PARAMS = ("batch_size", "megaloop", "use_mxu", "block_threads")

EVENTS = {"hit": 0, "miss": 0, "invalidated": 0, "store": 0, "sweep": 0,
          "override": 0}

# The harness's records of the last sweep (every config, with its mean,
# min and max pass seconds), beside the table, whose entries keep their
# format.
LAST_SWEEP: list = []

_lock = lockdep.make_lock("ops.autotune._lock")
_cache: dict = {"path": None, "mtime": None, "table": None}


def key(mode: str, base: int, device) -> str:
    """Winners-table key: mode, base and the device's type."""
    return f"{mode}|b{base}|{torch.device(device).type}"


def runtime(device) -> str:
    """The runtime a winner was measured on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"torch-{torch.__version__}-cuda{torch.version.cuda}-sm{major}{minor}"
    return f"torch-{torch.__version__}-{dev.type}"


def signature(base: int, device) -> dict:
    """Invalidation fingerprint of one key (raises when it cannot be
    computed, e.g. for a base without a valid range)."""
    plan = get_plan(base)
    return {
        "base": base,
        "limbs": [plan.limbs_n, plan.limbs_sq, plan.limbs_cu],
        "runtime": runtime(device),
        "sources": cuda_build.source_hash(),
    }


def reset_for_tests() -> None:
    """Drop the in-process copy of the table (the file is left alone)."""
    with _lock:
        _cache.update(path=None, mtime=None, table=None)


def reset_events() -> None:
    for k in EVENTS:
        EVENTS[k] = 0


def _count(event: str) -> None:
    EVENTS[event] += 1
    AUTOTUNE_EVENTS.labels(event).inc()


def _load() -> dict:
    """The winners table, cached per (path, mtime)."""
    path = WINNERS_PATH
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    # One span: the check, the read and the store, so that a read of an
    # older file never lands over a newer one's (the file changes only when
    # a sweep records a winner, so the read under the lock is rare).
    with _lock:
        if _cache["path"] == path and _cache["mtime"] == mtime:
            return _cache["table"]
        try:
            with open(path) as f:
                table = json.load(f)
            if not isinstance(table, dict):
                table = {}
        except (OSError, ValueError):
            table = {}
        _cache.update(path=path, mtime=mtime, table=table)
        return table


def params(mode: str, base: int, device) -> dict | None:
    """The tuned winner's params for one key, or None. A stale signature
    counts as `invalidated` and reads as absent."""
    entry = _load().get(key(mode, base, device))
    if not isinstance(entry, dict):
        return None
    if entry.get("signature") != signature(base, device):
        _count("invalidated")
        return None
    return entry.get("params") or None


def choose(mode: str, base: int, device, param: str, default: int,
           explicit: int | None = None) -> int:
    """One knob under the explicit > tuned > default precedence."""
    if explicit is not None:
        _count("override")
        return int(explicit)
    tuned = params(mode, base, device)
    if tuned is not None and param in tuned:
        _count("hit")
        return int(tuned[param])
    _count("miss")
    return default


def tenant_report(workloads, device="cuda") -> list[dict]:
    """Tuning status for a set of scheduler tenants: one row a (name, mode,
    base, backend) workload saying whether a signature-valid winner exists
    on `device` and the shape the tenant will run with (resolve_tuning's
    precedence applied per tenant, not per process): batch_size, megaloop
    (the segment), use_mxu, block_threads (where the reference reports
    block_rows) and the page quantum. The reference's carry_interval has no
    counterpart (resolve_tuning)."""
    from nice_tpu_torch.ops import engine

    out = []
    for name, mode, base, backend in workloads:
        batch, seg, arm, threads = engine.resolve_tuning(mode, base, device,
                                                         backend=backend)
        out.append({
            "tenant": name,
            "key": key(mode, base, device),
            "tuned": params(mode, base, device) is not None,
            "batch_size": batch,
            "megaloop": seg,
            "use_mxu": arm,
            "block_threads": threads,
            "page_quantum": engine.page_quantum(mode, base, device=device,
                                                backend=backend),
        })
    return out


def record(mode: str, base: int, device, new_params: dict,
           throughput: float | None = None, swept: list | None = None) -> str:
    """Store a winner; the file is replaced whole through fsio (tmp + fsync
    + rename), so a reader never sees half a table. Returns the table's
    path."""
    unknown = set(new_params) - set(PARAMS)
    if unknown:
        raise ValueError(f"unknown tuning params {sorted(unknown)}")
    path = WINNERS_PATH
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    table = dict(_load())
    table[key(mode, base, device)] = {
        "params": {k: int(v) for k, v in new_params.items()},
        "signature": signature(base, device),
        "throughput": throughput,
        "swept": swept or [],
    }
    fsio.atomic_write_json(path, table, indent=1, sort_keys=True)
    _count("store")
    reset_for_tests()
    return path


def sweep(mode: str, device, *, bench_mode: str | None = None,
          field: tuple[int, int, int] | None = None,
          batch_shifts: list[int], segments: list[int] | None = None,
          mxu: str = "auto", floors: list[int] | None = None,
          threads: list[int] | None = None,
          slice_size: int = 1_000_000, timeout: float = 900.0) -> dict:
    """Time the cartesian config grid through the tuning harness in a
    subprocess and record the best-throughput config as this key's winner.
    threads: the block sizes to sweep (--sweep-threads; None: the engine's
    resolved one).

    The field is a benchmark mode (bench_mode) or (base, start, size).
    Unlike the JAX sweep, which records the best of whatever configs
    finished, any config that fails makes the harness exit non-zero and
    this raise: a kernel that fails to launch never hides behind a partial
    winner. Returns the winner's params."""
    if (bench_mode is None) == (field is None):
        raise ValueError("give exactly one of bench_mode and field")
    cmd = [sys.executable, "-m", "nice_tpu_torch.scripts.tune_kernels", mode,
           "--device", str(device), "--json", "--slice", str(slice_size),
           "--batches", ",".join(str(s) for s in batch_shifts),
           "--mxu", mxu]
    if bench_mode is not None:
        cmd += ["--mode", bench_mode]
    else:
        cmd += ["--field", ":".join(str(x) for x in field)]
    if segments:
        cmd += ["--segments", ",".join(str(s) for s in segments)]
    if floors:
        cmd += ["--floors", ",".join(str(f) for f in floors)]
    if threads:
        cmd += ["--sweep-threads", ",".join(str(t) for t in threads)]
    _count("sweep")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO_DIR)
    if proc.returncode != 0:
        raise RuntimeError(f"tune_kernels failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    results = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
    if not results or not all(r.get("numbers_per_sec") for r in results):
        raise RuntimeError(f"tune_kernels timed nothing:\n{proc.stdout[-2000:]}")
    LAST_SWEEP[:] = results
    best = max(results, key=lambda r: r["numbers_per_sec"])
    new_params = {k: best[k] for k in PARAMS if best.get(k) is not None}
    record(mode, int(best["base"]), device, new_params,
           throughput=float(best["numbers_per_sec"]),
           swept=[{k: r.get(k) for k in PARAMS + ("msd_floor", "numbers_per_sec")}
                  for r in results])
    return new_params
