"""The port's autotuner (nice_tpu_torch/ops/autotune.py) and shape resolver
(engine.resolve_tuning) on the CPU: the contracts of tests/test_autotune.py
carried over (an explicit argument takes the place of the NICE_TPU_* pin),
parity with the JAX resolver on one sequence, and a sweep through the
tuning harness whose winner a fresh process reads back.
"""

import json
import os
import subprocess
import sys

import pytest

from nice_tpu.ops import autotune as jautotune
from nice_tpu.ops import engine as jengine
from nice_tpu_torch.ops import autotune, engine, mxu
from nice_tpu_torch.ops.limbs import get_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_WINNERS = autotune.WINNERS_PATH  # before any test repoints it
JAX_PINS = ("NICE_TPU_BATCH", "NICE_TPU_BLOCK_ROWS", "NICE_TPU_CARRY_INTERVAL",
            "NICE_TPU_MXU", "NICE_TPU_MEGALOOP", "NICE_TPU_MEGALOOP_SEGMENT")


@pytest.fixture(autouse=True)
def _isolated_table(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "WINNERS_PATH", str(tmp_path / "winners.json"))
    autotune.reset_for_tests()
    autotune.reset_events()
    yield
    autotune.reset_for_tests()


def _table() -> dict:
    with open(autotune.WINNERS_PATH) as f:
        return json.load(f)


def _rewrite(table: dict) -> None:
    with open(autotune.WINNERS_PATH, "w") as f:
        json.dump(table, f)
    autotune.reset_for_tests()


def test_winners_path_is_a_module_constant_in_the_build_dir(tmp_path):
    """The table lives in the package's git-ignored build directory unless
    a caller repoints the constant (as this file's fixture does)."""
    assert DEFAULT_WINNERS == os.path.join(
        REPO, "nice_tpu_torch/_build/autotune.json")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "nice_tpu_torch/_build/" in f.read().split()
    assert autotune.WINNERS_PATH == str(tmp_path / "winners.json")
    autotune.record("detailed", 40, "cpu", {"batch_size": 2048})
    assert os.path.isfile(tmp_path / "winners.json")


def test_choose_defaults_when_untuned():
    assert autotune.choose("detailed", 40, "cpu", "batch_size", 123) == 123
    assert autotune.EVENTS["miss"] == 1 and autotune.EVENTS["hit"] == 0
    assert engine.resolve_tuning("detailed", 40, "cpu") == (
        engine.DEFAULT_BATCH_SIZE, engine.MEGALOOP_SEGMENT_DEFAULT, 0)


def test_record_then_choose_roundtrip():
    path = autotune.record("detailed", 40, "cpu",
                           {"batch_size": 4096, "megaloop": 3, "use_mxu": 1},
                           throughput=1e6)
    assert path == autotune.WINNERS_PATH
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".tmp" in f]
    assert autotune.choose("detailed", 40, "cpu", "batch_size", 1) == 4096
    assert autotune.choose("detailed", 40, "cpu", "megaloop", 1) == 3
    assert autotune.choose("detailed", 40, "cpu", "use_mxu", 0) == 1
    # Other keys are unaffected.
    assert autotune.choose("niceonly", 40, "cpu", "batch_size", 7) == 7
    assert autotune.choose("detailed", 17, "cpu", "batch_size", 7) == 7
    assert autotune.key("detailed", 40, "cuda:0") == "detailed|b40|cuda"
    assert autotune.EVENTS["store"] == 1
    with pytest.raises(ValueError, match="block_rows"):
        autotune.record("detailed", 40, "cpu", {"block_rows": 64})


def test_restart_persistence_hit_counter():
    autotune.record("detailed", 40, "cpu", {"batch_size": 2048})
    autotune.reset_for_tests()  # a fresh loader reads the file again
    hits = autotune.EVENTS["hit"]
    assert autotune.choose("detailed", 40, "cpu", "batch_size", 1) == 2048
    assert autotune.EVENTS["hit"] == hits + 1


def test_argument_overrides_tuned():
    autotune.record("detailed", 40, "cpu", {"megaloop": 3})
    assert autotune.choose("detailed", 40, "cpu", "megaloop", 8, 5) == 5
    assert autotune.EVENTS["override"] == 1 and autotune.EVENTS["hit"] == 0


@pytest.mark.parametrize("field,value", [("runtime", "torch-9.9.9-cuda99.9-sm99"),
                                         ("limbs", [9, 9, 9]),
                                         ("sources", "0" * 16)])
def test_signature_change_invalidates(field, value):
    """Another torch or card, another plan, or edited kernel sources: the
    winner is refused until re-tuned."""
    autotune.record("detailed", 40, "cpu", {"batch_size": 2048})
    table = _table()
    table["detailed|b40|cpu"]["signature"][field] = value
    _rewrite(table)
    assert autotune.choose("detailed", 40, "cpu", "batch_size", 55) == 55
    assert autotune.EVENTS["invalidated"] == 1


def test_signature_that_cannot_be_computed_raises():
    autotune.record("detailed", 40, "cpu", {"batch_size": 2048})
    table = _table()
    table["detailed|b11|cpu"] = table["detailed|b40|cpu"]
    _rewrite(table)
    with pytest.raises(ValueError, match="no valid range"):
        autotune.params("detailed", 11, "cpu")


def test_signature_names_the_runtime():
    sig = autotune.signature(40, "cpu")
    plan = get_plan(40)
    assert sig["limbs"] == [plan.limbs_n, plan.limbs_sq, plan.limbs_cu]
    assert sig["runtime"].startswith("torch-") and sig["runtime"].endswith("-cpu")
    assert len(sig["sources"]) == 16


def test_corrupt_table_reads_as_empty():
    with open(autotune.WINNERS_PATH, "w") as f:
        f.write("{not json")
    assert autotune.params("detailed", 40, "cpu") is None
    assert autotune.choose("detailed", 40, "cpu", "batch_size", 77) == 77
    with open(autotune.WINNERS_PATH, "w") as f:
        f.write("[1, 2]")
    autotune.reset_for_tests()
    assert autotune.params("detailed", 40, "cpu") is None


def test_resolve_tuning_precedence():
    autotune.record("detailed", 40, "cpu",
                    {"batch_size": 4096, "megaloop": 4, "use_mxu": 1})
    assert engine.resolve_tuning("detailed", 40, "cpu") == (4096, 4, 1)
    assert engine.resolve_tuning("detailed", 40, "cpu", 512) == (512, 4, 1)
    assert engine.resolve_tuning("detailed", 40, "cpu", use_mxu=0) == (4096, 4, 0)
    # The untuned mode and the scalar backend take the defaults.
    assert engine.resolve_tuning("niceonly", 40, "cpu") == (
        engine.DEFAULT_BATCH_SIZE, engine.MEGALOOP_SEGMENT_DEFAULT, 0)
    assert engine.resolve_tuning("detailed", 40, "cpu", backend="scalar") == (
        engine.DEFAULT_BATCH_SIZE, 1, 0)
    assert engine.resolve_tuning("detailed", 40, "cpu", 64, backend="scalar")[0] == 64


def test_segment_precedence():
    autotune.record("detailed", 40, "cpu", {"batch_size": 4096, "megaloop": 4})
    autotune.reset_for_tests()
    assert engine.resolve_tuning("detailed", 40, "cpu")[1] == 4
    assert engine.resolve_tuning("detailed", 40, "cpu", segment=2)[1] == 2
    assert engine.resolve_tuning("niceonly", 40, "cpu")[1] == \
        engine.MEGALOOP_SEGMENT_DEFAULT
    assert engine.resolve_tuning("detailed", 40, "cpu", segment=0)[1] == 1


def test_use_mxu_roundtrip():
    autotune.record("niceonly", 98, "cpu", {"use_mxu": 1})
    autotune.reset_for_tests()
    assert autotune.choose("niceonly", 98, "cpu", "use_mxu", 0) == 1
    assert engine.resolve_tuning("niceonly", 98, "cpu")[2] == 1
    assert engine.resolve_tuning("niceonly", 98, "cpu", use_mxu=0)[2] == 0
    assert engine.resolve_tuning("detailed", 98, "cpu")[2] == 0


def test_use_mxu_forced_off_past_the_bound(monkeypatch):
    """A winner or an argument cannot select K5 for a plan it does not
    take (here b1100's: n's 70 limbs pass the reference's own bound)."""
    autotune.record("detailed", 40, "cpu", {"use_mxu": 1})
    assert engine.resolve_tuning("detailed", 40, "cpu")[2] == 1
    assert engine.resolve_tuning("detailed", 40, "cpu", use_mxu=1)[2] == 1
    fat = get_plan(1100)
    assert not mxu.supports_plan(fat)
    monkeypatch.setattr(engine, "get_plan", lambda base: fat)
    assert engine.resolve_tuning("detailed", 40, "cpu")[2] == 0
    assert engine.resolve_tuning("detailed", 40, "cpu", use_mxu=1)[2] == 0


def test_resolver_parity_with_jax(tmp_path, monkeypatch):
    """The same winners and pins in both packages resolve to the same
    (batch, segment, use_mxu): JAX's resolve_tuning fields 0, 4 and 3."""
    monkeypatch.setenv("NICE_TPU_AUTOTUNE_FILE", str(tmp_path / "jax.json"))
    for var in JAX_PINS:
        monkeypatch.delenv(var, raising=False)
    jautotune.reset_for_tests()

    def jax_fields(batch=None):
        r = jengine.resolve_tuning("detailed", 40, "jax", batch)
        return r[0], r[4], r[3]

    def port(batch=None, **kw):
        return engine.resolve_tuning("detailed", 40, "cpu", batch, **kw)

    try:
        assert port() == jax_fields()
        winner = {"batch_size": 4096, "megaloop": 4, "use_mxu": 1}
        jautotune.record("detailed", 40, "jax", winner)
        autotune.record("detailed", 40, "cpu", winner)
        assert port() == jax_fields() == (4096, 4, 1)
        assert port(512) == jax_fields(512) == (512, 4, 1)
        monkeypatch.setenv("NICE_TPU_MEGALOOP_SEGMENT", "2")
        assert port(segment=2) == jax_fields() == (4096, 2, 1)
        monkeypatch.setenv("NICE_TPU_MXU", "0")
        assert port(segment=2, use_mxu=0) == jax_fields() == (4096, 2, 0)
        monkeypatch.setenv("NICE_TPU_MXU", "1")

        class _FatPlan:
            limbs_n = 1 << 20

        monkeypatch.setattr("nice_tpu.ops.engine.get_plan", lambda b: _FatPlan())
        monkeypatch.setattr(engine, "get_plan", lambda b: get_plan(1100))
        assert port(segment=2, use_mxu=1) == jax_fields() == (4096, 2, 0)
        r = jengine.resolve_tuning("detailed", 40, "scalar")
        assert engine.resolve_tuning("detailed", 40, "cpu", backend="scalar") \
            == (r[0], r[4], r[3])
    finally:
        jautotune.reset_for_tests()


def test_sweep_records_a_winner_a_fresh_process_reads():
    """autotune.sweep over 2 configs of a 1e4 slice runs the harness in a
    subprocess and records the faster; a fresh Python process pointed at the
    table resolves the winner as a hit."""
    won = autotune.sweep("detailed", "cpu", bench_mode="default",
                         batch_shifts=[10, 11], segments=[2], mxu="off",
                         slice_size=10_000, timeout=300)
    assert autotune.EVENTS["sweep"] == 1 and autotune.EVENTS["store"] == 1
    assert won["batch_size"] in (1024, 2048) and won["megaloop"] == 2
    assert won["use_mxu"] == 0
    entry = _table()["detailed|b40|cpu"]
    assert entry["params"] == won and len(entry["swept"]) == 2
    code = ("import json; from nice_tpu_torch.ops import autotune, engine; "
            f"autotune.WINNERS_PATH = {autotune.WINNERS_PATH!r}; "
            "r = engine.resolve_tuning('detailed', 40, 'cpu'); "
            "print(json.dumps([list(r), autotune.EVENTS]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    resolved, events = json.loads(out)
    assert resolved == [won["batch_size"], 2, 0]
    assert events["hit"] == 3 and events["miss"] == 0


def test_sweep_raises_when_a_config_fails():
    """Unlike the JAX sweep, a failing config is never dropped for a partial
    winner: here the harness cannot even take the field."""
    with pytest.raises(RuntimeError, match="tune_kernels failed"):
        autotune.sweep("detailed", "cpu", field=(11, 1000, 100),
                       batch_shifts=[10], slice_size=100, timeout=300)
    assert not os.path.exists(autotune.WINNERS_PATH)
