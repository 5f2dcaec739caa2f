"""nice-tpu-torch search client CLI (the port's cut of nice_tpu/client/main.py).

  * single shot: claim one field (detailed or niceonly) from --api-base,
    process it on the card, submit it; niceonly takes every base, b10-b97
    through the strided pipeline and b98 and up through the dense loop;
  * --benchmark <field>: process a built-in benchmark field offline and
    print one JSON summary line (the JAX client's keys).

The default device is cuda; --device cpu runs the kernels' plain PyTorch
versions, and --backend scalar the Python-int oracle.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import sys
import time
from typing import Optional

from nice_tpu_torch import CLIENT_VERSION
from nice_tpu_torch.client import api_client
from nice_tpu_torch.core import number_stats
from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import (
    DataToClient,
    DataToServer,
    FieldResults,
    SearchMode,
)
from nice_tpu_torch.ops import engine

log = logging.getLogger("nice_tpu_torch.client")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nice-tpu-torch-client",
        description="Distributed search client for square-cube pandigitals "
        "(PyTorch/CUDA)",
    )
    p.add_argument("mode", nargs="?", default="detailed",
                   choices=["detailed", "niceonly"],
                   help="search mode: detailed (histogram and near misses) or "
                   "niceonly (nice numbers only: strided up to b97, dense "
                   "from b98)")
    p.add_argument("--api-base", default="https://api.nicenumbers.net",
                   help="API base URL")
    p.add_argument("--username", default="anonymous",
                   help="username credited with submissions")
    p.add_argument("--backend", default="device", choices=list(engine.BACKENDS),
                   help="device: the kernels (or their plain versions with "
                   "--device cpu); scalar: the Python-int oracle")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the device backend runs")
    p.add_argument("--benchmark", default=None,
                   choices=[m.value for m in BenchmarkMode],
                   help="process a benchmark field offline")
    return p


def process_field(data: DataToClient, args) -> tuple[FieldResults, float]:
    """Process one field in args.mode; returns results and elapsed seconds."""
    process = (engine.process_range_detailed if args.mode == "detailed"
               else engine.process_range_niceonly)
    t0 = time.monotonic()
    results = process(data.to_field_size(), data.base, device=args.device,
                      backend=args.backend)
    elapsed = time.monotonic() - t0
    rate = data.range_size / elapsed if elapsed > 0 else float("inf")
    log.info("processed %s numbers in %.2fs (%s numbers/sec)",
             f"{data.range_size:,}", elapsed, f"{rate:,.0f}")
    return results, elapsed


def compile_results(data: DataToClient, results: FieldResults,
                    mode: SearchMode, username: str) -> DataToServer:
    """The submission payload (no distribution in niceonly mode), stamped
    with the exactly-once submit_id (claim id + content hash), computed as
    the JAX client computes it."""
    payload = DataToServer(
        claim_id=data.claim_id,
        username=username,
        client_version=CLIENT_VERSION,
        unique_distribution=(list(results.distribution)
                             if mode == SearchMode.DETAILED else None),
        nice_numbers=list(results.nice_numbers),
    )
    content = json.dumps(payload.to_json(), sort_keys=True).encode()
    payload.submit_id = (
        f"{data.claim_id}-{hashlib.sha256(content).hexdigest()[:16]}"
    )
    return payload


def run_benchmark(args) -> int:
    bench = BenchmarkMode(args.benchmark)
    data = get_benchmark_field(bench)
    log.info("benchmark %s: base %d, range [%d, %d) (%s numbers), backend %s "
             "on %s", bench.value, data.base, data.range_start, data.range_end,
             f"{data.range_size:,}", args.backend, args.device)
    results, elapsed = process_field(data, args)
    summary = {
        "benchmark": bench.value,
        "base": data.base,
        "range_size": data.range_size,
        "mode": args.mode,
        "backend": args.backend,
        "device": args.device,
        "elapsed_secs": round(elapsed, 4),
        "numbers_per_sec": round(data.range_size / elapsed, 1),
        "nice_count": sum(
            1 for n in results.nice_numbers if n.num_uniques == data.base
        ),
        "near_miss_cutoff": number_stats.get_near_miss_cutoff(data.base),
        "near_misses": len(results.nice_numbers),
    }
    print(json.dumps(summary), flush=True)
    return 0


def run_single_iteration(args) -> tuple[DataToClient, DataToServer, dict]:
    """Claim one field of args.mode, process it, submit it; returns the
    claimed field, the submission and the server's reply."""
    mode = (SearchMode.DETAILED if args.mode == "detailed"
            else SearchMode.NICEONLY)
    data = api_client.get_field_from_server(mode, args.api_base, args.username)
    log.info("claimed field (claim %d): base %d, range [%d, %d)",
             data.claim_id, data.base, data.range_start, data.range_end)
    results, _ = process_field(data, args)
    submission = compile_results(data, results, mode, args.username)
    resp = api_client.submit_field_to_server(args.api_base, submission)
    log.info("submitted claim %d%s", submission.claim_id,
             " (duplicate)" if resp.get("duplicate") else "")
    return data, submission, resp


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    if args.benchmark:
        return run_benchmark(args)
    run_single_iteration(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
