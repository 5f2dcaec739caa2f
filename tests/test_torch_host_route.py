"""The small-field niceonly host route of the port's engine
(ops/engine.py _host_route_niceonly, process_range_niceonly's
host_niceonly_max, warm_niceonly) on the CPU, held against the JAX engine's
route (its NICE_TPU_HOST_NICEONLY_MAX knob set per test: the repository's
conftest sets it to 0) and the scalar oracle, and the sweep harness that
sets HOST_NICEONLY_MAX (scripts/host_route_sweep.py).
"""

import json
import math

import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine, stride_filter
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.scripts import bench, host_route_sweep

LIMITS = (0, 1 << 20, 1 << 25)


def _gate_ends(base: int) -> list[int]:
    """Range ends on both sides of each of the gate's two bounds (the poly
    kernel's end^2 < 2^62 * base^9 and end < 2^63 / (base - 1)), and the
    base's range end."""
    edge = math.isqrt((1 << 62) * base**9 - 1)  # largest end admitted
    cap = (1 << 63) // (base - 1)
    ends = [edge, edge + 1, cap - 1, cap]
    br = base_range.get_base_range(base)
    if br is not None:
        ends.append(br[1])
    return ends


@pytest.mark.parametrize("base", [10, 17, 40, 50, 63, 64, 65, 80])
def test_host_route_gate_equals_jax(base, monkeypatch):
    sizes = (1, 1 << 20, (1 << 20) + 1, 1 << 25, (1 << 25) + 1)
    admitted = 0
    for limit in LIMITS:
        monkeypatch.setenv("NICE_TPU_HOST_NICEONLY_MAX", str(limit))
        for end in _gate_ends(base):
            for size in sizes:
                if end - size < 1:
                    continue
                got = engine._host_route_niceonly(
                    FieldSize(end - size, end), base, limit)
                assert got == jengine._host_route_niceonly(
                    JFieldSize(end - size, end), base), (limit, end, size)
                admitted += got
    if base <= 64:
        assert admitted > 0  # the grid reaches the admitted side too


def test_cpu_host_route_finds_69_without_k3(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K3 (its plain version) ran on the host route")

    monkeypatch.setattr(ce, "strided_niceonly_batch", refuse)
    monkeypatch.setattr(ve, "niceonly_strided_counts", refuse)
    ce.reset_launches()
    got = engine.process_range_niceonly(FieldSize(40, 130), 10, device="cpu",
                                        host_niceonly_max=1 << 25, threads=2)
    assert [(n.number, n.num_uniques) for n in got.nice_numbers] == [(69, 10)]
    stats = engine.LAST_NICEONLY_STATS
    assert stats["route"] == "host" and stats["nice"] == 1
    assert stats["threads"] == 2 and stats["k"] == 3
    assert sum(ce.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", [BenchmarkMode.BASE_TEN,
                                  BenchmarkMode.DEFAULT])
def test_host_route_equals_jax_route(mode, monkeypatch):
    # Both engines take their route: the JAX one through its
    # _native_niceonly (counted here), with backend="pallas" as on a TPU.
    data = get_benchmark_field(mode)
    monkeypatch.setenv("NICE_TPU_HOST_NICEONLY_MAX", str(1 << 25))
    calls = []
    real = jengine._native_niceonly

    def counted(*a, **k):
        calls.append(k.get("msd_floor"))
        return real(*a, **k)

    monkeypatch.setattr(jengine, "_native_niceonly", counted)
    want = jengine.process_range_niceonly(
        JFieldSize(data.range_start, data.range_end), data.base,
        backend="pallas")
    got = engine.process_range_niceonly(data.to_field_size(), data.base,
                                        device="cpu",
                                        host_niceonly_max=1 << 25)
    assert calls == [1 << 20]
    assert engine.LAST_NICEONLY_STATS["route"] == "host"
    assert [(n.number, n.num_uniques) for n in got.nice_numbers] == \
        [(n.number, n.num_uniques) for n in want.nice_numbers]
    if mode == BenchmarkMode.BASE_TEN:
        assert [n.number for n in got.nice_numbers] == [69]


def test_cpu_default_keeps_the_strided_path():
    assert engine.resolve_host_niceonly_max(None, "cpu") == 0
    assert engine.resolve_host_niceonly_max(None, "cuda") == \
        engine.HOST_NICEONLY_MAX
    assert engine.resolve_host_niceonly_max(7, "cpu") == 7
    data = get_benchmark_field(BenchmarkMode.BASE_TEN)
    got = engine.process_range_niceonly(data.to_field_size(), data.base,
                                        device="cpu")
    assert [n.number for n in got.nice_numbers] == [69]
    stats = engine.LAST_NICEONLY_STATS
    assert stats["route"] == "device" and stats["groups"] >= 1


def test_resumed_field_takes_the_route_from_its_cursor(monkeypatch):
    # A resume state collapses to its lowest uncovered number before the
    # route is chosen, as in the JAX engine.
    st = {"cursor": 60, "hist": None, "nice_numbers": [(41, 4)],
          "remaining": [[60, 100]]}
    got = engine.process_range_niceonly(FieldSize(40, 130), 10, device="cpu",
                                        resume=st, host_niceonly_max=1 << 25)
    assert engine.LAST_NICEONLY_STATS["start"] == 60
    assert engine.LAST_NICEONLY_STATS["route"] == "host"
    assert [n.number for n in got.nice_numbers] == [41, 69]


def test_warm_takes_the_host_route_without_the_plan_library(monkeypatch):
    # On the card's device type, a field the route takes gets the host
    # stride table and no per-base library; with the route off, the warm
    # asks for that library (refused here: there is no nvcc).
    def refuse(plan):
        raise RuntimeError(f"plan library of b{plan.base} requested")

    monkeypatch.setattr(ce, "plan_library", refuse)
    data = get_benchmark_field(BenchmarkMode.MSD_INEFFECTIVE)
    stride_filter.get_stride_table.cache_clear()
    engine.warm_niceonly(data.base, data.range_size, device="cuda",
                         field_start=data.range_start,
                         host_niceonly_max=1 << 25)
    depth = engine._host_stride_depth(data.base)
    assert stride_filter.get_stride_table.cache_info().currsize == 1
    assert stride_filter.get_stride_table(data.base, depth).num_residues > 0
    engine.warm_niceonly(data.base, data.range_size, device="cuda",
                         backend="native")
    with pytest.raises(RuntimeError, match="plan library of b50"):
        engine.warm_niceonly(data.base, data.range_size, device="cuda",
                             field_start=data.range_start,
                             host_niceonly_max=0)
    # Probed at the range's top (no start given), b50 lies past the gate.
    with pytest.raises(RuntimeError, match="plan library of b50"):
        engine.warm_niceonly(data.base, data.range_size, device="cuda",
                             host_niceonly_max=1 << 25)
    # The default limit on the card is HOST_NICEONLY_MAX.
    monkeypatch.setattr(engine, "HOST_NICEONLY_MAX", 1 << 25)
    engine.warm_niceonly(data.base, data.range_size, device="cuda",
                         field_start=data.range_start)
    monkeypatch.setattr(engine, "HOST_NICEONLY_MAX", 0)
    with pytest.raises(RuntimeError, match="plan library of b50"):
        engine.warm_niceonly(data.base, data.range_size, device="cuda",
                             field_start=data.range_start)


def test_bench_niceonly_lines_report_their_route(capsys):
    assert bench.main(["--suite", "msd-ineffective:niceonly", "--size",
                       "4096", "--reps", "1", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["route"] == "device"  # the CPU's default: no route
    assert lines[0]["niceonly_stats"]["route"] == "device"


def test_route_sweep_harness_and_its_choice():
    # The harness behind HOST_NICEONLY_MAX, at sizes the CPU runs quickly
    # (its times here are no measurement: K3 runs its plain version).
    lines = []
    report = host_route_sweep.sweep([1 << 10, 1 << 12], reps=1,
                                    device="cpu", emit=lines.append)
    assert [r["field"] for r in report["rows"]] == \
        ["2^10", "2^12", "msd-ineffective"]
    assert len(lines) == 4 and json.loads(lines[-1])["device"] == "cpu"
    for row in report["rows"]:
        assert row["host"]["k3_launches"] == [0] and row["nice"] == 0
        assert row["start"] == get_benchmark_field(
            BenchmarkMode.MSD_INEFFECTIVE).range_start
    rows = [{"numbers": n, "host_wins": w} for n, w in
            ((1 << 20, True), (1 << 22, True), (10**7, False),
             (1 << 24, True))]
    sizes = [1 << 20, 1 << 22, 1 << 24]
    assert host_route_sweep.choose(rows, sizes) == 1 << 22
    rows[0]["host_wins"] = False
    assert host_route_sweep.choose(rows, sizes) == 0
