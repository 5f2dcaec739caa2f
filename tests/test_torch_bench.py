"""The port's bench (nice_tpu_torch/scripts/bench.py) on the CPU, where it
is a correctness witness: the headline line first and last with the suite
embedded, the clamped extra-large field's distribution equal to the JAX
engine's (jnp backend) on the same slice, the budget's skip lines, the
scheduler case's line (the interleaved fields equal to the sequential ones,
pages by tenant), the critpath block of a --stepprof line, and no run
without a card unless asked.
"""

import json

import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu_torch.core.benchmark import BenchmarkMode, get_benchmark_field
from nice_tpu_torch.ops import engine
from nice_tpu_torch.scripts import bench

SIZE = 65536
BATCH = 8192  # the JAX engine's batch (results do not depend on it)


def _lines(capsys, *argv) -> tuple[int, list[dict]]:
    rc = bench.main(list(argv))
    out = capsys.readouterr().out
    return rc, [json.loads(line) for line in out.splitlines() if line]


def test_extra_large_headline_first_and_last(capsys):
    rc, lines = _lines(capsys, "--only", "extra-large", "--size", str(SIZE),
                       "--device", "cpu")
    assert rc == 0
    first, niceonly, last = lines
    assert first["metric"] == "numbers/sec/chip detailed (extra-large, base 40)"
    assert niceonly["metric"] == \
        "numbers/sec/chip niceonly (extra-large, base 40)"
    assert {k: v for k, v in last.items()
            if k not in ("suite", "budget_secs", "budget_used_secs")} == first
    assert set(last["suite"]) == {"detailed/extra-large",
                                  "niceonly/extra-large"}
    for line in (first, niceonly):
        assert line["witness"] == "cpu" and line["device"] == "cpu"
        assert line["range_size"] == SIZE and line["range_clamped"] is True
        assert line["min_secs"] <= line["elapsed_secs"] <= line["max_secs"]
        assert len(line["pass_secs"]) == line["reps"] == bench.DEFAULT_REPS
        assert line["first_field_secs"] > 0 and line["unit"] == \
            "numbers/sec/chip"
        assert line["value"] == SIZE / line["elapsed_secs"]
    assert sum(first["distribution"]) == SIZE
    assert set(first["feed_ab"]) == {"0", "2"}
    lanes = engine.DEFAULT_BATCH_SIZE * engine.MEGALOOP_SEGMENT_DEFAULT
    assert first["feed_stats"]["dispatches"] == -(-SIZE // lanes)
    assert first["launches"] == {}  # the plain versions launch nothing
    assert niceonly["niceonly_stats"]["groups"] >= 1
    assert "first_group" not in niceonly["niceonly_stats"]

    # The distribution equals the JAX engine's on the same slice.
    data = get_benchmark_field(BenchmarkMode.EXTRA_LARGE)
    want = jengine.process_range_detailed(
        JFieldSize(data.range_start, data.range_start + SIZE), 40,
        backend="jnp", batch_size=BATCH)
    assert first["distribution"] == [d.count for d in want.distribution]
    assert first["nice_numbers"] == [[n.number, n.num_uniques]
                                     for n in want.nice_numbers]


def test_budget_skips_and_the_scheduler_case(capsys):
    rc, lines = _lines(
        capsys, "--suite",
        "msd-ineffective:niceonly,multi-tenant:detailed,massive:niceonly",
        "--size", "4096", "--reps", "1", "--budget", "25", "--device", "cpu")
    assert rc == 0
    ineffective, tenants, massive, last = lines
    assert ineffective["hits"] == 0 and "skipped" not in ineffective
    assert "skipped" not in tenants and "error" not in tenants
    assert tenants["metric"] == \
        "numbers/sec/chip sched (multi-tenant, base 40)"
    assert tenants["results_equal"] is True
    assert tenants["pages"] == {"det": 1, "nice": 1}  # one page a tenant
    assert tenants["preemptions"] == {"det": 0, "nice": 0}
    assert tenants["range_size"] == 2 * 4096 and tenants["witness"] == "cpu"
    assert tenants["vs_sequential"] == \
        tenants["sequential_secs"] / tenants["elapsed_secs"]
    assert tenants["launches"] == {}  # the plain versions launch nothing
    assert massive["skipped"] == "budget"  # its estimate exceeds 25 s
    assert massive["budget_remaining_secs"] < 25
    assert last["suite"]["niceonly/massive"]["skipped"] == "budget"


def test_bad_suite_is_an_error_line(capsys):
    rc, lines = _lines(capsys, "--suite", "extra-large", "--device", "cpu")
    assert rc == 1 and "error" in lines[0]


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--only", "extra-large"])


def test_stepprof_lines_carry_critpath(capsys):
    from nice_tpu.obs import critpath as jcritpath
    from nice_tpu_torch.obs import critpath, stepprof

    try:
        rc, lines = _lines(capsys, "--only", "default", "--size", "4096",
                           "--reps", "1", "--stepprof", "--device", "cpu")
    finally:
        stepprof.reset()  # the profiler off again for the worker's next test
    assert rc == 0
    case, last = lines
    for line in (case, last):
        assert set(line["phase_breakdown"]) == {"detailed|b40|cpu"}
        assert line["critpath"] == critpath.phase_shares(
            line["phase_breakdown"])
        assert line["critpath"] == jcritpath.phase_shares(
            line["phase_breakdown"])
        assert line["critpath"]["dominant"] == "device_compute"
    # The headline's table is the whole run's: here the one case's.
    assert last["phase_breakdown"] == case["phase_breakdown"]
