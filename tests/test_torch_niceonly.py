"""The port's niceonly path (nice_tpu_torch) on the CPU, held against the JAX
package: the stride tables, the host library (MSD filter and strided scan),
the descriptor planner and the adaptive floor, the engine end to end (the
JAX engine's strided Pallas path in interpret mode, and the scalar oracle),
checkpoint and resume across the two engines, and the pipeline's failure
handling. Every comparison is exact; seeded inputs come from numpy.
"""

import threading

import numpy as np
import pytest
import torch

from nice_tpu.core import benchmark as jbench
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import adaptive_floor as jadaptive
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import msd_filter as jmsd
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import stride_filter as jstride
from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, engine, msd_filter, scalar
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import stride_filter

# A b40 stretch around a near miss of the detailed path: its MSD ranges
# survive (the first 1e8 numbers of b40's range are pruned whole).
B40_MID = 3621949312977 - 300_000


@pytest.fixture(autouse=True)
def _fresh_floor_controller():
    # The strided floor controller is shared by the process: each test
    # starts from its seed, whatever ran before.
    adaptive_floor.reset_for_tests()
    yield
    adaptive_floor.reset_for_tests()


def _numbers(results):
    return [(n.number, n.num_uniques) for n in results.nice_numbers]


def _spans(base: int, count: int, width: int) -> list[tuple[int, int]]:
    """Seeded [start, start + width) spans inside the base's range."""
    lo, hi = base_range.get_base_range(base)
    rng = np.random.default_rng(base)
    return [(s, s + width) for s in (
        lo + int(f) * ((hi - lo - width) >> 52)
        for f in rng.integers(0, 1 << 52, size=count))]


# --------------------------------------------------------------------------
# Filters and the host library
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("base", [10, 17, 20, 40, 50, 80])
def test_stride_table_equals_jax(base, k):
    mine, ref = stride_filter.StrideTable(base, k), jstride.StrideTable(base, k)
    assert mine.modulus == ref.modulus
    assert mine.valid_residues == ref.valid_residues
    assert mine.gap_table == ref.gap_table
    assert np.array_equal(mine.gap_array, ref.gap_array)
    assert np.array_equal(mine.residues_u32, ref.residues_u32)
    assert stride_filter.stride_residue_count(base, k) == \
        jstride.stride_residue_count(base, k) == mine.num_residues
    assert mine.num_residues > 0


@pytest.mark.parametrize("base", [40, 50, 80])
def test_native_msd_ranges_equal_jax_recursion(base):
    checked = 0
    spans = _spans(base, 6, 2_000_000)
    if base == 40:
        spans[0] = (B40_MID, B40_MID + 2_000_000)
    for (s, e), floor in zip(spans, [250, 4096, 65536] * 2):
        mine = msd_filter.get_valid_ranges(FieldSize(s, e), base,
                                           min_range_size=floor)
        ref = jmsd.get_valid_ranges_recursive(JFieldSize(s, e), base,
                                              min_range_size=floor)
        assert [(r.start(), r.end()) for r in mine] == \
            [(r.start(), r.end()) for r in ref]
        checked += len(ref)
    assert checked > 0 or base == 80  # b80 prunes most of its spans whole


@pytest.mark.parametrize("base,k", [(10, 1), (40, 1), (40, 2), (50, 2), (80, 1)])
def test_native_strided_scan_equals_jax_host_scan(base, k):
    mine, ref = stride_filter.get_stride_table(base, k), \
        jstride.get_stride_table(base, k)
    spans = [(47, 100)] if base == 10 else _spans(base, 3, 300_000)
    for s, e in spans:
        got = engine._host_strided_scan(mine, base, s, e)
        assert got == jengine._host_strided_scan(ref, base, s, e)
        assert got == [n.number for n in
                       mine.iterate_range(FieldSize(s, e), base)]
    if base == 10:
        assert got == [69]


def test_host_niceonly_equals_scalar_oracle():
    field = FieldSize(B40_MID, B40_MID + 600_000)
    assert engine.host_niceonly(field, 40) == [
        n.number for n in
        jscalar.process_range_niceonly(JFieldSize(B40_MID, B40_MID + 600_000),
                                       40).nice_numbers]
    assert engine.host_niceonly(FieldSize(47, 100), 10) == [69]


# --------------------------------------------------------------------------
# Planner and adaptive floor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["extra-large", "hi-base", "massive",
                                  "msd-ineffective"])
@pytest.mark.parametrize("pinned", [None, 4096])
def test_planner_equals_jax(mode, pinned):
    f = jbench.get_benchmark_field(jbench.BenchmarkMode(mode))
    floor = engine._strided_floor(
        adaptive_floor.AdaptiveFloor(pinned=pinned), f.range_size)
    assert floor == jengine._strided_floor(
        jadaptive.AdaptiveFloor(pinned=pinned), f.range_size)
    typical = floor + floor // 2
    assert engine._pick_stride_depth(f.base, typical) == \
        jengine._pick_stride_depth(f.base, typical)
    assert engine._msd_depth_for(f.range_size, floor) == \
        jengine._msd_depth_for(f.range_size, floor)
    adaptive_floor.reset_for_tests(pinned=pinned)
    s = engine.strided_setup(f.base, f.range_size)
    assert (s.floor, s.k, s.periods) == (
        floor, *jengine._pick_stride_depth(f.base, typical))
    assert ce.STRIDED_DESC_MAX == 1024


def test_adaptive_floor_follows_jax_controller():
    mine, ref = adaptive_floor.AdaptiveFloor(seed=65536), \
        jadaptive.AdaptiveFloor(seed=65536)
    rng = np.random.default_rng(7)
    for host, dev, numbers in zip(rng.uniform(0, 3, 40), rng.uniform(0, 3, 40),
                                  rng.integers(10**5, 10**10, 40)):
        mine.observe(float(host), float(dev), int(numbers))
        ref.observe(float(host), float(dev), int(numbers))
        assert mine.current() == ref.current()
    assert mine.current() != 65536  # the sequence moved the floor
    assert adaptive_floor.get_floor_controller("strided") is \
        adaptive_floor.get_floor_controller("strided")
    adaptive_floor.reset_for_tests(pinned=5000)
    pinned = adaptive_floor.get_floor_controller("strided")
    pinned.observe(5.0, 0.0, 10**9)
    assert pinned.pinned and pinned.current() == 5000


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

def _jax_pallas(monkeypatch, s: int, e: int, base: int, **kw):
    monkeypatch.setenv("NICE_TPU_SHARD", "0")  # one device, as the port
    return _numbers(jengine.process_range_niceonly(
        JFieldSize(s, e), base, backend="pallas", **kw))


@pytest.mark.parametrize("base,s,e", [
    (10, 47, 100),                    # the whole b10 range: [69]
    (20, 58945, 58945 + 9_000),       # the first 9,000 of b20's range
])
def test_engine_equals_jax_pallas_engine(monkeypatch, base, s, e):
    want = _jax_pallas(monkeypatch, s, e, base)
    got = engine.process_range_niceonly(FieldSize(s, e), base, device="cpu")
    assert _numbers(got) == want
    assert got.distribution == ()
    # A fine floor (many small descriptors) and a full audit agree too.
    adaptive_floor.reset_for_tests(pinned=256)
    monkeypatch.setattr(engine, "STRIDE_AUDIT_EVERY", 1)
    fine = engine.process_range_niceonly(FieldSize(s, e), base, device="cpu")
    assert _numbers(fine) == want
    if base == 10:
        assert want == [(69, 10)]


@pytest.mark.parametrize("floor", [None, 4096])
def test_engine_equals_scalar_oracle_b40(floor):
    s, e = B40_MID, B40_MID + 600_000
    adaptive_floor.reset_for_tests(pinned=floor)
    got = engine.process_range_niceonly(FieldSize(s, e), 40, device="cpu")
    assert _numbers(got) == _numbers(
        jscalar.process_range_niceonly(JFieldSize(s, e), 40))
    assert engine.LAST_NICEONLY_STATS["descriptors"] > 0  # K3 had work


def test_slivers_go_to_the_oracle():
    # [40, 47) lies below b10's range and [100, 130) above it.
    got = engine.process_range_niceonly(FieldSize(40, 130), 10, device="cpu")
    assert _numbers(got) == _numbers(
        jscalar.process_range_niceonly(JFieldSize(40, 130), 10))
    outside = engine.process_range_niceonly(FieldSize(5, 40), 10, device="cpu")
    assert _numbers(outside) == _numbers(
        jscalar.process_range_niceonly(JFieldSize(5, 40), 10))


def test_scalar_backend_limits_and_no_silent_cpu():
    rng = FieldSize(47, 100)
    assert engine.process_range_niceonly(rng, 10, backend="scalar") == \
        scalar.process_range_niceonly(rng, 10)
    # The oracle checkpoints in chunks (tests/test_torch_scalar_ckpt.py
    # holds its states against the JAX engine's).
    states = []
    assert engine.process_range_niceonly(
        rng, 10, backend="scalar", checkpoint_cb=states.append,
        batch_size=20, checkpoint_batches=1) == \
        scalar.process_range_niceonly(rng, 10)
    assert [st["cursor"] for st in states] == [67, 87, 100]
    lo98 = base_range.get_base_range(98)[0]
    b98 = FieldSize(lo98, lo98 + 100)  # 5 limbs: the dense path
    assert engine.process_range_niceonly(b98, 98, device="cpu") == \
        scalar.process_range_niceonly(b98, 98)
    assert engine.LAST_NICEONLY_STATS["base"] == 98
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.process_range_niceonly(rng, 10)  # the default is cuda


def test_progress_reports_the_filter_front():
    s, e = B40_MID, B40_MID + 600_000
    seen = []
    adaptive_floor.reset_for_tests(pinned=4096)
    engine.process_range_niceonly(
        FieldSize(s, e), 40, device="cpu",
        progress=lambda done, total: seen.append((done, total)))
    assert seen[-1] == (e - s, e - s)
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)


# --------------------------------------------------------------------------
# Checkpoint and resume
# --------------------------------------------------------------------------

def test_checkpoint_resume_roundtrip(monkeypatch):
    # Groups of 8 descriptors at a fine floor: many groups, a checkpoint
    # after each (the ticker fires every group).
    monkeypatch.setattr(ce, "STRIDED_DESC_MAX", 8)
    s, e = B40_MID - 500, B40_MID + 400_000  # no sliver: b40's range is wide
    states = []
    adaptive_floor.reset_for_tests(pinned=4096)
    full = engine.process_range_niceonly(
        FieldSize(s, e), 40, device="cpu", checkpoint_cb=states.append,
        checkpoint_batches=1)
    assert len(states) >= 4
    cursors = [st["cursor"] for st in states]
    assert cursors == sorted(cursors) and s < cursors[0] and cursors[-1] <= e
    for st in states[:: max(1, len(states) // 4)]:
        assert set(st) == {"cursor", "hist", "nice_numbers"}
        assert st["hist"] is None
        got = engine.process_range_niceonly(
            FieldSize(s, e), 40, device="cpu", resume=st)
        assert got == full


def test_resume_from_jax_niceonly_states():
    # The JAX engine's niceonly states (its chunked scan: one per 10
    # numbers) over [40, 100) of b10, which holds a sliver and 69.
    states = []
    want = jengine.process_range_niceonly(
        JFieldSize(40, 100), 10, backend="scalar", batch_size=10,
        checkpoint_cb=states.append, checkpoint_batches=1)
    assert _numbers(want) == [(69, 10)] and len(states) >= 4
    holds = [any(n == 69 for n, _ in st["nice_numbers"]) for st in states]
    assert not holds[0] and holds[-1]  # states before and after 69
    for st in states:
        got = engine.process_range_niceonly(FieldSize(40, 100), 10,
                                            device="cpu", resume=st)
        assert _numbers(got) == [(69, 10)]
    # A state with "remaining" segments collapses to their lowest start.
    st = {"cursor": 47, "hist": None, "nice_numbers": [],
          "remaining": [[60, 70], [90, 100]]}
    got = engine.process_range_niceonly(FieldSize(40, 100), 10, device="cpu",
                                        resume=st)
    assert _numbers(got) == [(69, 10)]


def test_resume_from_jax_pallas_state(monkeypatch):
    monkeypatch.setenv("NICE_TPU_SHARD", "0")
    s, e = 58945, 58945 + 9_000
    states = []
    want = jengine.process_range_niceonly(
        JFieldSize(s, e), 20, backend="pallas", checkpoint_cb=states.append,
        checkpoint_batches=1)
    assert states
    for st in [{"cursor": s, "hist": None, "nice_numbers": []}] + states:
        got = engine.process_range_niceonly(FieldSize(s, e), 20, device="cpu",
                                            resume=st)
        assert _numbers(got) == _numbers(want)


# --------------------------------------------------------------------------
# Pipeline failures
# --------------------------------------------------------------------------

def _run_bounded(fn, secs: float = 120.0):
    """fn() on a thread; its exception, or None. Fails on a hang."""
    out: list = []

    def target():
        try:
            fn()
            out.append(None)
        except Exception as e:  # noqa: BLE001 — handed to the test
            out.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(secs)
    assert not t.is_alive(), "the pipeline hung"
    return out[0]


def test_zero_count_audit_catches_undercount(monkeypatch):
    def zeroed(plan, modulus, residues, periods, desc, n_real):
        return torch.zeros(desc.shape[0], dtype=torch.int32)

    monkeypatch.setattr(ce, "strided_niceonly_batch", zeroed)
    monkeypatch.setattr(engine, "STRIDE_AUDIT_EVERY", 1)
    err = _run_bounded(lambda: engine.process_range_niceonly(
        FieldSize(47, 100), 10, device="cpu"))
    assert isinstance(err, RuntimeError) and "undercount" in str(err)


def test_audit_passes_on_honest_counts(monkeypatch):
    monkeypatch.setattr(engine, "STRIDE_AUDIT_EVERY", 1)
    got = engine.process_range_niceonly(FieldSize(47, 100), 10, device="cpu")
    assert _numbers(got) == [(69, 10)]


def test_count_mismatch_is_an_error(monkeypatch):
    real = ce.strided_niceonly_batch

    def overcount(plan, modulus, residues, periods, desc, n_real):
        out = real(plan, modulus, residues, periods, desc, n_real)
        out[:n_real] += 1
        return out

    monkeypatch.setattr(ce, "strided_niceonly_batch", overcount)
    adaptive_floor.reset_for_tests(pinned=4096)
    err = _run_bounded(lambda: engine.process_range_niceonly(
        FieldSize(B40_MID, B40_MID + 200_000), 40, device="cpu"))
    assert isinstance(err, RuntimeError) and "mismatch" in str(err)


def test_producer_failure_propagates(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("filter exploded")

    monkeypatch.setattr(msd_filter, "get_valid_ranges", boom)
    err = _run_bounded(lambda: engine.process_range_niceonly(
        FieldSize(47, 100), 10, device="cpu"))
    assert isinstance(err, RuntimeError) and "filter exploded" in str(err)


def test_dispatch_failure_propagates(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("dispatch exploded")

    monkeypatch.setattr(ce, "strided_niceonly_batch", boom)
    monkeypatch.setattr(engine, "FILTER_THREADS", 4)
    adaptive_floor.reset_for_tests(pinned=256)
    err = _run_bounded(lambda: engine.process_range_niceonly(
        FieldSize(B40_MID, B40_MID + 600_000), 40, device="cpu"))
    assert isinstance(err, RuntimeError) and "dispatch exploded" in str(err)


def test_msd_filter_fans_out_across_threads(monkeypatch):
    # With 4 filter threads and a stub that waits until two calls are in
    # flight, the field completes only if the calls really overlap; chunk
    # results must still come out in order.
    real = msd_filter.get_valid_ranges
    barrier = threading.Barrier(2)
    overlapped = threading.Event()
    starts = []
    lock = threading.Lock()

    def instrumented(range_, base, **kw):
        if not overlapped.is_set():
            try:
                barrier.wait(timeout=10)
                overlapped.set()
            except threading.BrokenBarrierError:
                pass
        with lock:
            starts.append(range_.start())
        return real(range_, base, **kw)

    monkeypatch.setattr(msd_filter, "get_valid_ranges", instrumented)
    s, e = B40_MID, B40_MID + 600_000
    monkeypatch.setattr(engine, "FILTER_THREADS", 4)
    adaptive_floor.reset_for_tests(pinned=256)
    got = engine.process_range_niceonly(FieldSize(s, e), 40, device="cpu")
    assert _numbers(got) == _numbers(
        jscalar.process_range_niceonly(JFieldSize(s, e), 40))
    assert overlapped.is_set(), "filter calls never overlapped"
    assert len(starts) >= 4
