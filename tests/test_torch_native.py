"""The port's host library (nice_tpu_torch/native) and its native backend
(ops/engine.py _native_detailed / _native_niceonly) on the CPU, held against
the JAX package's bindings and engine and the scalar oracle on the same
inputs: the detailed range loop, the polynomial-residue strided kernel
against the generic loop (every comparison non-empty, with the kernel shown
to have run), both native engines at several thread counts, and the
client's --backend native with --threads against the JAX package's server
in this process.
"""

import json
import logging
import threading

import numpy as np
import pytest

from nice_tpu import native as jnative
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import stride_filter as jstride
from nice_tpu.server import app as server_app
from nice_tpu.server.db import Db
from nice_tpu_torch import native
from nice_tpu_torch.client import api_client
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core import base_range, number_stats
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import engine, stride_filter

# In-process client runs start no sampler thread and no telemetry beat:
# those would outlive the test in this worker and post to its JAX server.
QUIET = ("--telemetry-secs", "0", "--pyprof-hz", "0", "--memwatch-secs", "0",
         "--history-secs", "0")

# b50 values far below its valid range: the squares and cubes are short, so
# many candidates have all-distinct digits, the accept-rich range on which
# the polynomial-residue kernel is held to the generic loop.
POLY_LO, POLY_HI = 10**8, 10**8 + 3 * 10**6


def _pairs(results):
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _detailed_cases():
    out = []
    for base, width in ((10, 53), (17, 7720), (40, 200_000)):
        lo, hi = base_range.get_base_range(base)
        out.append((base, lo, min(width, hi - lo)))
        if base == 40:
            out.append((base, (lo + hi) // 2, width))
    return out


@pytest.mark.parametrize("base,start,count", _detailed_cases())
def test_process_range_detailed_equals_jax_and_oracle(base, start, count):
    cutoff = number_stats.get_near_miss_cutoff(base)
    hist, misses = native.process_range_detailed(start, count, base, cutoff)
    assert (hist, misses) == jnative.process_range_detailed(start, count, base,
                                                            cutoff)
    want = jscalar.process_range_detailed(JFieldSize(start, start + count),
                                          base)
    assert hist[1:base + 1] == [d.count for d in want.distribution]
    assert hist[0] == hist[base + 1] == 0 and sum(hist) == count
    assert misses == [(n.number, n.num_uniques) for n in want.nice_numbers]
    if base == 10:
        assert (69, 10) in misses


def _strided(table, lo, hi, base, poly: bool):
    first, idx = table.first_valid_at_or_after(lo)
    kw = ({"modulus": table.modulus, "residues": table.residues_u32}
          if poly else {})
    found = native.iterate_range_strided(first, idx, hi, base,
                                         table.gap_array, **kw)
    return found, native.used_poly()


def test_poly_kernel_equals_generic_loop_and_jax_poly():
    table = stride_filter.get_stride_table(50, 3)
    assert table.modulus % 50**3 == 0 and table.modulus < 1 << 32
    found, used = _strided(table, POLY_LO, POLY_HI, 50, poly=True)
    assert used and len(found) > 100  # the kernel ran, and found many
    prev = native.strided_fast_enabled(False)
    try:
        generic, used = _strided(table, POLY_LO, POLY_HI, 50, poly=True)
        assert not used  # the hook turned the kernel off: the generic loop
    finally:
        native.strided_fast_enabled(prev)
    assert generic == found
    jt = jstride.get_stride_table(50, 3)
    first, idx = jt.first_valid_at_or_after(POLY_LO)
    jfound = jnative.iterate_range_strided(
        first, idx, POLY_HI, 50, jt.gap_array, modulus=jt.modulus,
        residues=jt.residues_u32)
    assert jfound == found
    # Every reported number is one the oracle's early-exit test accepts.
    assert all(jscalar.get_is_nice(n, 50) for n in found[::17])


def test_poly_kernel_declines_what_it_does_not_take():
    # A k=1 table's modulus is no multiple of base^3, and b10's [47, 100)
    # lies below base^4.5: both take the generic loop, with the same
    # results as the loop alone.
    t1 = stride_filter.get_stride_table(50, 1)
    found, used = _strided(t1, POLY_LO, POLY_LO + 200_000, 50, poly=True)
    assert not used and found
    assert found == _strided(t1, POLY_LO, POLY_LO + 200_000, 50,
                             poly=False)[0]
    t3 = stride_filter.get_stride_table(10, 3)
    found, used = _strided(t3, 47, 100, 10, poly=True)
    assert not used and found == [69]


@pytest.mark.parametrize("threads", [1, 4])
def test_native_detailed_equals_jax(threads):
    lo = base_range.get_base_range(40)[0]
    for base, rng in ((10, (40, 130)), (40, (lo, lo + 300_000))):
        got = engine._native_detailed(FieldSize(*rng), base, threads)
        want = jengine._native_detailed(JFieldSize(*rng), base, threads)
        assert _pairs(got) == _pairs(want)
        assert got == engine._native_detailed(FieldSize(*rng), base, 3)
    assert [n.number for n in got.nice_numbers] == [
        n.number for n in jscalar.process_range_detailed(
            JFieldSize(*rng), 40).nice_numbers]


@pytest.mark.parametrize("threads", [1, 4])
def test_native_niceonly_equals_jax(threads):
    seen = []
    got = engine._native_niceonly(FieldSize(POLY_LO, POLY_HI), 50, None,
                                  threads, lambda d, t: seen.append((d, t)))
    want = jengine._native_niceonly(JFieldSize(POLY_LO, POLY_HI), 50, None,
                                    threads)
    assert _pairs(got) == _pairs(want) and len(got.nice_numbers) > 100
    assert seen[-1][0] == seen[-1][1]
    assert got == engine._native_niceonly(FieldSize(POLY_LO, POLY_HI), 50,
                                          None, 3, msd_floor=1 << 20)
    # b10's one nice number, and the oracle's niceonly scan at b40.
    assert [n.number for n in engine._native_niceonly(
        FieldSize(40, 130), 10, None, threads).nice_numbers] == [69]
    mid = sum(base_range.get_base_range(40)) // 2
    got = engine._native_niceonly(FieldSize(mid, mid + 400_000), 40, None,
                                  threads)
    assert _pairs(got) == _pairs(jscalar.process_range_niceonly(
        JFieldSize(mid, mid + 400_000), 40))


def test_native_backend_entry_points():
    rng = FieldSize(40, 130)
    assert engine.process_range_detailed(rng, 10, backend="native",
                                         threads=2) == \
        engine.process_range_detailed(rng, 10, backend="scalar")
    assert engine.process_range_niceonly(rng, 10, backend="native") == \
        engine.process_range_niceonly(rng, 10, backend="scalar")
    assert engine.resolve_threads(None) >= 1 and engine.resolve_threads(3) == 3
    for process in (engine.process_range_detailed,
                    engine.process_range_niceonly):
        with pytest.raises(ValueError, match="native"):
            process(rng, 10, backend="native",
                    resume={"cursor": 50, "hist": None, "nice_numbers": []})
        with pytest.raises(ValueError, match="native"):
            process(rng, 10, backend="native", checkpoint_cb=print)
    with pytest.raises(ValueError):  # above the library's u128 digit masks
        engine.process_range_detailed(FieldSize(10**40, 10**40 + 5), 200,
                                      backend="native")


def test_host_stride_depth_equals_jax():
    for base in range(10, 98):
        assert engine._host_stride_depth(base) == \
            jengine._host_stride_depth(base), base
    assert np.array_equal(
        stride_filter.get_stride_table(50, engine._host_stride_depth(50))
        .residues_u32, jstride.get_stride_table(50, 3).residues_u32)


# --------------------------------------------------------------------------
# The client's --backend native and --threads
# --------------------------------------------------------------------------

def _summary(capsys, *argv):
    assert client.main([*argv, *QUIET]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return {k: v for k, v in out.items()
            if k not in ("elapsed_secs", "numbers_per_sec", "backend",
                         "device")}


@pytest.mark.parametrize("mode", ["detailed", "niceonly"])
def test_client_native_benchmark_equals_scalar(capsys, mode):
    native_line = _summary(capsys, mode, "--backend", "native", "--threads",
                           "2", "--benchmark", "default")
    # The oracle's detailed default field takes ~10 s of Python here; the
    # plain path stands in for it there (held to the oracle elsewhere), and
    # base-ten is held to the oracle itself.
    other = ("--backend", "scalar") if mode == "niceonly" else (
        "--device", "cpu")
    assert native_line == _summary(capsys, mode, *other, "--benchmark",
                                   "default")
    assert _summary(capsys, mode, "--backend", "native", "--threads", "2",
                    "--benchmark", "base-ten") == \
        _summary(capsys, mode, "--backend", "scalar", "--benchmark",
                 "base-ten")


@pytest.fixture
def server(tmp_path):
    def reset():
        with api_client._epoch_lock:
            api_client._last_epoch = 0
        with api_client._failover_lock:
            api_client._failover_idx.clear()
            api_client._failover_gen.clear()
        with api_client._dead_hosts_lock:
            api_client._dead_hosts.clear()
        api_client.close_connections()

    reset()
    db_path = str(tmp_path / "nice.db")
    db = Db(db_path)
    db.seed_base(17, field_size=4_000)
    db.close()
    httpd = server_app.serve(db_path, host="127.0.0.1", port=0, prefill=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    reset()
    httpd.shutdown()


def test_client_native_drops_checkpoint_dir(server, tmp_path, caplog,
                                            monkeypatch):
    ckpt_dir = tmp_path / "ckpt"
    seen = {}
    real = client.process_field

    def spy(data, args, **kw):
        seen.update(checkpointer=kw.get("checkpointer"),
                    threads=args.threads, backend=args.backend)
        results, secs = real(data, args, **kw)
        seen["results"], seen["data"] = results, data
        return results, secs

    monkeypatch.setattr(client, "process_field", spy)
    with caplog.at_level(logging.WARNING, logger="nice_tpu_torch.client"):
        assert client.main(["detailed", "--api-base", server, "--backend",
                            "native", "--threads", "2", "--checkpoint-dir",
                            str(ckpt_dir), "--renew-secs", "0",
                            *QUIET]) == 0
    assert any("--checkpoint-dir is not supported with backend 'native'"
               in r.getMessage() for r in caplog.records)
    assert seen["checkpointer"] is None and seen["threads"] == 2
    assert not ckpt_dir.exists()  # no snapshot, spool or server list
    assert seen["results"] == engine.process_range_detailed(
        seen["data"].to_field_size(), 17, backend="scalar")
