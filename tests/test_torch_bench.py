"""The port's bench (nice_tpu_torch/scripts/bench.py) on the CPU, where it
is a correctness witness: the headline line first and last with the suite
embedded, the clamped extra-large field's distribution equal to the JAX
engine's (jnp backend) on the same slice, the budget's skip lines, the
scheduler case's "not ported" line, and no run without a card unless asked.
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
    assert tenants["skipped"] == \
        "not ported: scheduler (ROADMAP queue 1 item 7)"
    assert massive["skipped"] == "budget"  # its estimate exceeds 25 s
    assert massive["budget_remaining_secs"] < 25
    assert last["suite"]["niceonly/massive"]["skipped"] == "budget"


def test_bad_suite_is_an_error_line(capsys):
    rc, lines = _lines(capsys, "--suite", "extra-large", "--device", "cpu")
    assert rc == 1 and "error" in lines[0]


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--only", "extra-large"])
