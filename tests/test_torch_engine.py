"""The port's field engine (nice_tpu_torch/ops/engine.py) on the CPU, held
against the JAX package's engine on the same fields: histograms and near-miss
lists must be identical. Also the checkpoint contract across the two engines,
the plan bridge and the no-silent-CPU rule.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from nice_tpu.core import benchmark as jbench
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import limbs as jlimbs
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops import limbs
from nice_tpu_torch.ops import scalar

BATCH = 256


def _as_pairs(results):
    """A FieldResults of either package as plain tuples."""
    return (
        [(d.num_uniques, d.count) for d in results.distribution],
        [(n.number, n.num_uniques) for n in results.nice_numbers],
    )


def _field(name: str):
    plan = jlimbs.get_plan
    if name == "base-ten":
        f = jbench.get_benchmark_field(jbench.BenchmarkMode.BASE_TEN)
        return 10, f.range_start, f.range_end
    if name == "default-20k":
        f = jbench.get_benchmark_field(jbench.BenchmarkMode.DEFAULT)
        return 40, f.range_start, f.range_start + 20_000
    if name == "b40-straddle":  # slivers below the range go to the oracle
        s = plan(40).range_start
        return 40, s - 500, s + 3_000
    if name == "b17-end-straddle":  # and past its end
        e = plan(17).range_end
        return 17, e - 2_000, e + 300
    if name == "b80-slice":
        s = plan(80).range_start + 123_456_789
        return 80, s, s + 3_000
    if name == "b510-slice":
        s = plan(510).range_start + 987_654_321
        return 510, s, s + 300
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    base, s, e = _field(name)
    # The JAX engine's jnp backend compiles a 29/58/87-limb graph for b510
    # for many minutes on the CPU (tests/test_megaloop.py keeps that out of
    # tier 1); the same engine entry point with its scalar backend is the
    # reference there.
    backend = "scalar" if base == 510 else "jnp"
    return _as_pairs(jengine.process_range_detailed(
        JFieldSize(s, e), base, backend=backend, batch_size=BATCH))


FIELDS = ["base-ten", "default-20k", "b40-straddle", "b17-end-straddle",
          "b80-slice", "b510-slice"]


@pytest.mark.parametrize("name", FIELDS)
def test_engine_matches_jax_engine(name):
    base, s, e = _field(name)
    got = engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                        batch_size=BATCH)
    assert _as_pairs(got) == _reference(name)
    if name == "base-ten":
        assert _as_pairs(got)[1] == [(69, 10)]


@pytest.mark.parametrize("segment", [1, 3])
def test_engine_segment_lengths(segment):
    base, s, e = _field("default-20k")
    got = engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                        batch_size=1024, segment=segment)
    assert _as_pairs(got) == _reference("default-20k")


def test_engine_default_shape_on_cpu():
    # The defaults (2^18 lanes x 8 per segment) over a small field: one
    # segment, nearly all of it padding.
    base, s, e = _field("base-ten")
    got = engine.process_range_detailed(FieldSize(s, e), base, device="cpu")
    assert _as_pairs(got) == _reference("base-ten")


def test_rare_path_overflow_falls_back_dense(monkeypatch):
    # A lowered threshold makes b17 survivors plentiful; with a 2-row cap the
    # compaction overflows and the sub-batch is read dense. Every survivor
    # must still come out, in ascending order.
    monkeypatch.setattr(engine, "SURVIVOR_CAP", 2)
    plan = limbs.get_plan(17)
    start, valid, thresh = plan.range_start, 500, plan.base - 6
    got = list(engine.rare_scan_survivors(plan, start, valid, 512, "cpu",
                                          thresh))
    want = [(n, u) for n in range(start, start + valid)
            if (u := scalar.get_num_unique_digits(n, 17)) > thresh]
    assert got == want
    assert len(want) > 2  # past the cap: only the dense read yields them all


def test_resume_from_jax_checkpoint(monkeypatch):
    # Per-batch JAX dispatch (megaloop off) gives a checkpoint every batch;
    # the port resumes one from the middle of the field and must finish it
    # exactly as the uninterrupted run does.
    monkeypatch.setenv("NICE_TPU_MEGALOOP", "0")
    base, s, e = _field("default-20k")
    states = []
    jengine.process_range_detailed(
        JFieldSize(s, e), base, backend="jnp", batch_size=512,
        checkpoint_cb=states.append, checkpoint_batches=1)
    assert len(states) >= 2
    mid = states[len(states) // 2 - 1]
    assert s < mid["cursor"] < e
    got = engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                        batch_size=BATCH, resume=mid)
    assert _as_pairs(got) == _reference("default-20k")


def test_port_checkpoint_resume_roundtrip():
    base, s, e = _field("b40-straddle")
    states = []
    full = engine.process_range_detailed(
        FieldSize(s, e), base, device="cpu", batch_size=BATCH, segment=2,
        checkpoint_cb=states.append, checkpoint_batches=1)
    assert len(states) == -(-(e - (s + 500)) // (BATCH * 2))
    assert states[-1]["remaining"] == []
    for st in states[:2]:
        assert set(st) == {"cursor", "hist", "nice_numbers", "remaining"}
        got = engine.process_range_detailed(
            FieldSize(s, e), base, device="cpu", batch_size=BATCH, resume=st)
        assert got == full
    assert _as_pairs(full) == _reference("b40-straddle")


def test_plan_from_reference_equals_own_plan_every_base():
    checked = 0
    for base in range(10, 601):
        try:
            ref = jlimbs.get_plan(base)
        except ValueError:
            with pytest.raises(ValueError):
                limbs.get_plan(base)
            continue
        assert limbs.plan_from_reference(dataclasses.asdict(ref)) == \
            limbs.get_plan(base)
        checked += 1
    assert checked > 450
    with pytest.raises(ValueError):
        limbs.plan_from_reference({"base": 10})


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    rng = FieldSize(47, 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.process_range_detailed(rng, 10)  # the default device is cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.process_range_detailed(rng, 10, device="cuda")
    with pytest.raises(ValueError):
        engine.process_range_detailed(rng, 10, device="cpu", backend="jnp")


def test_scalar_backend_and_out_of_range_field():
    # backend="scalar" is the oracle; a field wholly outside the base's range
    # goes to the oracle too (the kernels' digit counts hold only inside).
    rng = FieldSize(5, 40)
    assert engine.process_range_detailed(rng, 10, device="cpu") == \
        scalar.process_range_detailed(rng, 10)
    rng = FieldSize(47, 100)
    assert engine.process_range_detailed(rng, 10, backend="scalar") == \
        scalar.process_range_detailed(rng, 10)


def test_engine_histogram_sums_and_progress():
    base, s, e = _field("b40-straddle")
    seen = []
    got = engine.process_range_detailed(
        FieldSize(s, e), base, device="cpu", batch_size=BATCH,
        progress=lambda done, total: seen.append((done, total)))
    assert sum(d.count for d in got.distribution) == e - s
    assert [d.num_uniques for d in got.distribution] == list(range(1, base + 1))
    core = e - (s + 500)
    assert seen[-1] == (core, core)
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)
    assert np.all(np.diff([d for d, _ in seen]) > 0)
