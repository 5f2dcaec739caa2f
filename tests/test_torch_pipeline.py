"""The pipelined host loop of the port's engine (nice_tpu_torch/ops/engine.py:
the feed thread, the collector, the checkpoint ticker) on the CPU, held
against the JAX package's engine on the same inputs: the detailed and dense
loops at feed depths 0 and 2 give the JAX engine's (or the scalar oracle's)
results exactly; every checkpoint state matches the oracle over the part it
covers and resumes to the uninterrupted result on both engines; the feed's
items and remaining sets are the JAX _SliceFeed's; a failure in a callback,
the collector, the feed or a kernel is raised on the caller with every
thread joined.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import limbs as jlimbs
from nice_tpu.ops import scalar as jscalar
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.ops import adaptive_floor, engine
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

CPU = torch.device("cpu")
BATCH = 256
DEPTHS = [0, 2]
# A b40 near miss in the middle of the range (chip_smoke's mid-range field
# holds it), and the first b98 field of 1e9 the MSD filter keeps.
B40_NEAR_MISS = 3621949312977
B98_FIELD = 413428759798923141071530212209627033363
B100_FIELD = 8828019138762881829106236139006375885885 + 350_000


@pytest.fixture(autouse=True)
def _fresh_floor_controller():
    adaptive_floor.reset_for_tests()
    yield
    adaptive_floor.reset_for_tests()


def _pairs(results):
    """A FieldResults of either package as plain tuples."""
    return (
        [(d.num_uniques, d.count) for d in results.distribution],
        [(n.number, n.num_uniques) for n in results.nice_numbers],
    )


FIELDS = {
    "b10": (10, 40, 130),  # slivers on both sides, 69 inside
    "b17": (17, 4_800, 9_300),  # a sliver below; near misses 6788, 9278
    "b40-mid": (40, B40_NEAR_MISS - 2_500, B40_NEAR_MISS + 2_500),
}


@functools.lru_cache(maxsize=None)
def _jax(name: str):
    base, s, e = FIELDS[name]
    return _pairs(jengine.process_range_detailed(
        JFieldSize(s, e), base, backend="jnp", batch_size=BATCH))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_pipelined_detailed_matches_jax(name, depth):
    base, s, e = FIELDS[name]
    got = engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                        batch_size=BATCH, segment=1,
                                        feed_depth=depth)
    assert _pairs(got) == _jax(name)
    assert _pairs(got)[1], "a field without near misses proves nothing here"
    stats = engine.LAST_FEED_STATS
    assert stats["mode"] == "detailed" and stats["feed_depth"] == depth
    core = min(e, get_plan(base).range_end) - max(s, get_plan(base).range_start)
    assert stats["dispatches"] == -(-core // BATCH)
    assert stats["gaps"] == stats["dispatches"] - 1


@pytest.fixture
def small_runs(monkeypatch):
    # Runs of 2 x 1024 lanes: a b98 field of tens of thousands makes many.
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1024)
    monkeypatch.setattr(engine, "MEGALOOP_SEGMENT_DEFAULT", 2)
    adaptive_floor.reset_for_tests(pinned=4096)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("base,start,width", [(98, B98_FIELD, 30_000),
                                              (100, B100_FIELD, 20_000)])
def test_pipelined_dense_matches_oracle(small_runs, base, start, width, depth):
    field = FieldSize(start, start + width)
    got = engine.process_range_niceonly(field, base, device="cpu",
                                        feed_depth=depth)
    want = jscalar.process_range_niceonly(JFieldSize(start, start + width),
                                          base)
    assert _pairs(got) == _pairs(want)
    stats = engine.LAST_NICEONLY_STATS
    assert stats["runs"] == engine.LAST_FEED_STATS["dispatches"] > 1
    assert stats["kept"] + stats["pruned"] == stats["lanes"]
    assert engine.LAST_FEED_STATS["mode"] == "niceonly"
    assert engine.LAST_FEED_STATS["feed_depth"] == depth


@pytest.mark.parametrize("depth", DEPTHS)
def test_dense_loop_collects_a_nice_number(depth):
    # b10's range through the dense loop: 69 reaches the collector's K2
    # re-scan, which must find as many as K4 counted.
    got: list = []
    engine._niceonly_dense(FieldSize(47, 100), 10, CPU, got, batch_size=16,
                           segment=1, feed_depth=depth)
    assert [(n.number, n.num_uniques) for n in got] == [(69, 10)]
    assert engine.LAST_NICEONLY_STATS["runs"] == 4


# --------------------------------------------------------------------------
# Checkpoint states
# --------------------------------------------------------------------------

def _covered(s: int, e: int, remaining) -> list[tuple[int, int]]:
    """[s, e) less the remaining segments."""
    out, pos = [], s
    for a, b in sorted(remaining):
        if pos < a:
            out.append((pos, a))
        pos = max(pos, b)
    if pos < e:
        out.append((pos, e))
    return out


def _oracle_over(base: int, parts):
    hist = np.zeros(base + 2, dtype=np.int64)
    near = []
    for a, b in parts:
        r = jscalar.process_range_detailed(JFieldSize(a, b), base)
        for d in r.distribution:
            hist[d.num_uniques] += d.count
        near += [(n.number, n.num_uniques) for n in r.nice_numbers]
    return hist, sorted(near)


@pytest.mark.parametrize("every", [1, 2, 3])
def test_every_checkpoint_state_matches_the_oracle(every):
    base, s, e = 40, B40_NEAR_MISS - 1_900, B40_NEAR_MISS + 1_700
    states = []
    full = engine.process_range_detailed(
        FieldSize(s, e), base, device="cpu", batch_size=BATCH, segment=1,
        checkpoint_cb=states.append, checkpoint_batches=every,
        checkpoint_secs=0)
    segments = -(-(e - s) // BATCH)
    assert len(states) == segments // every
    for st in states:
        hist, near = _oracle_over(base, _covered(s, e, st["remaining"]))
        assert list(st["hist"][1:base + 1]) == list(hist[1:base + 1])
        assert sorted(st["nice_numbers"]) == near
        assert st["cursor"] == (st["remaining"][0][0] if st["remaining"]
                                else e)
    # Resumed on the port and on the JAX engine: the uninterrupted result.
    want = _pairs(full)
    for st in states[::2]:
        got = engine.process_range_detailed(FieldSize(s, e), base,
                                            device="cpu", batch_size=BATCH,
                                            resume=st)
        assert _pairs(got) == want
        jgot = jengine.process_range_detailed(JFieldSize(s, e), base,
                                              backend="jnp", batch_size=BATCH,
                                              resume=st)
        assert _pairs(jgot) == want


def test_jax_ticker_states_resume_on_the_port():
    # The JAX megaloop's states (one per dispatch of a fused segment) on its
    # own ticker, resumed by the port's pipelined loop.
    base, s, e = 40, B40_NEAR_MISS - 30_000, B40_NEAR_MISS + 30_000
    states = []
    want = _pairs(jengine.process_range_detailed(
        JFieldSize(s, e), base, backend="jnp", batch_size=BATCH,
        checkpoint_cb=states.append, checkpoint_batches=1))
    assert len(states) >= 3 and all("remaining" in st for st in states)
    assert want[1] == [(B40_NEAR_MISS, 37)]
    for st in states:
        got = engine.process_range_detailed(FieldSize(s, e), base,
                                            device="cpu", batch_size=BATCH,
                                            resume=st, feed_depth=2)
        assert _pairs(got) == want


def test_dense_checkpoint_states_on_the_ticker(small_runs):
    field = FieldSize(B98_FIELD, B98_FIELD + 40_000)
    states = []
    full = engine.process_range_niceonly(field, 98, device="cpu",
                                         checkpoint_cb=states.append,
                                         checkpoint_batches=3)
    runs = engine.LAST_NICEONLY_STATS["runs"]
    assert len(states) == runs // 3 >= 2
    for st in states:
        assert st["filtered"] is True and st["hist"] is None
        got = engine.process_range_niceonly(field, 98, device="cpu",
                                            resume=st)
        assert got == full


def test_strided_checkpoints_follow_the_ticker(monkeypatch):
    monkeypatch.setattr(ce, "STRIDED_DESC_MAX", 8)
    adaptive_floor.reset_for_tests(pinned=4096)
    s, e = B40_NEAR_MISS - 200_000, B40_NEAR_MISS + 200_000
    every, per_group = [], []
    engine.process_range_niceonly(FieldSize(s, e), 40, device="cpu",
                                  checkpoint_cb=per_group.append,
                                  checkpoint_batches=1)
    engine.process_range_niceonly(FieldSize(s, e), 40, device="cpu",
                                  checkpoint_cb=every.append,
                                  checkpoint_batches=4)
    assert len(per_group) == engine.LAST_NICEONLY_STATS["groups"] >= 8
    assert [st["cursor"] for st in every] == \
        [st["cursor"] for st in per_group][3::4]


# --------------------------------------------------------------------------
# The feed, the ticker and the stats against the reference's
# --------------------------------------------------------------------------

def test_feed_items_and_remaining_match_jax():
    rng = np.random.default_rng(9)
    plan, jplan = get_plan(40), jlimbs.get_plan(40)
    lo = plan.range_start + 10_000
    for trial in range(20):
        cuts = np.sort(rng.choice(50_000, size=8, replace=False)) + lo
        queue = [(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])]
        lanes = int(rng.integers(100, 5_000))
        jfeed = jengine._SliceFeed(jplan, [queue], lanes, plan.range_end, 0)
        feed = engine._SliceFeed(plan, [queue], lanes, CPU,
                                 depth=trial % 3, ring_slots=1 + trial % 2)
        try:
            while True:
                j, p = jfeed.get(), feed.get()
                if j is None:
                    assert p is None
                    break
                assert p.seg == j.segs[0] and p.markers == j.markers
                assert p.lanes == j.lanes
                assert p.start.tolist() == [int(x) for x in j.starts[0]]
                assert engine._SliceFeed.remaining([queue], p.markers) == \
                    jengine._SliceFeed.remaining([queue], j.markers)
        finally:
            jfeed.stop()
            feed.stop()
        assert engine._SliceFeed.start_markers([queue]) == \
            jengine._SliceFeed.start_markers([queue])


def test_ticker_fires_on_batches_and_seconds(monkeypatch):
    t = engine._CkptTicker(3, 0)
    assert [t.tick() for _ in range(7)] == [False, False, True] * 2 + [False]
    clock = [100.0]
    monkeypatch.setattr(engine.time, "monotonic", lambda: clock[0])
    t = engine._CkptTicker(0, 5.0)
    assert not t.tick()
    clock[0] += 5.0
    assert t.tick() and not t.tick()
    d = engine._CkptTicker()
    assert (d.every_batches, d.every_secs) == (256, 30.0)
    assert (engine.CKPT_EVERY_BATCHES, engine.CKPT_EVERY_SECS) == (
        jengine.CKPT_EVERY_BATCHES, jengine.CKPT_EVERY_SECS)
    assert (engine.DISPATCH_WINDOW, engine.FEED_DEPTH_DEFAULT) == (
        jengine.DISPATCH_WINDOW, jengine.FEED_DEPTH_DEFAULT)


def test_feed_stats_hold_the_jax_keys():
    base, s, e = FIELDS["b10"]
    jengine.process_range_detailed(JFieldSize(s, e), base, backend="jnp",
                                   batch_size=16)
    engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                  batch_size=16, segment=1)
    assert set(jengine.LAST_FEED_STATS) <= set(engine.LAST_FEED_STATS)
    assert engine.LAST_FEED_STATS["n_dev_start"] == 1
    assert engine.LAST_FEED_STATS["dispatches"] == 4


def test_host_ring_hands_out_each_upload():
    ring = engine._HostRing(2, (3,), CPU)
    outs = [ring.upload(np.array([i, i + 1, i + 2])) for i in range(5)]
    assert [o.tolist() for o in outs] == [[i, i + 1, i + 2] for i in range(5)]
    assert ring.waits == 0  # no events on the CPU
    blocks = engine._HostRing(2, (4, 3), CPU)
    assert blocks.upload(np.ones((2, 3), dtype=np.int64)).shape == (2, 3)
    for bad in (np.ones((5, 3)), np.ones((4, 2)), np.ones(12)):
        with pytest.raises(ValueError, match="does not fit"):
            blocks.upload(bad)


# --------------------------------------------------------------------------
# Failures surface on the caller, with every thread joined
# --------------------------------------------------------------------------

def _field_run(depth, **kw):
    base, s, e = FIELDS["b40-mid"]
    return engine.process_range_detailed(FieldSize(s, e), base, device="cpu",
                                         batch_size=BATCH, segment=1,
                                         feed_depth=depth, **kw)


@pytest.mark.parametrize("depth", DEPTHS)
def test_failing_checkpoint_cb_is_raised(depth):
    threads = threading.active_count()

    def boom(state):
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        _field_run(depth, checkpoint_cb=boom, checkpoint_batches=2)
    assert threading.active_count() == threads


@pytest.mark.parametrize("depth", DEPTHS)
def test_failing_collector_is_raised(depth, monkeypatch):
    threads = threading.active_count()

    def rare_boom(*a, **kw):
        raise RuntimeError("rare path failed")
        yield  # a generator, as the real one

    monkeypatch.setattr(engine, "rare_scan_survivors", rare_boom)
    with pytest.raises(RuntimeError, match="rare path failed"):
        _field_run(depth)
    assert threading.active_count() == threads


@pytest.mark.parametrize("depth", DEPTHS)
def test_failing_feed_is_raised(depth, monkeypatch):
    threads = threading.active_count()
    real, calls = engine.int_to_limbs, [0]

    def limbs_boom(x, n):
        calls[0] += 1
        if calls[0] == 4:
            raise ValueError("feed failed")
        return real(x, n)

    monkeypatch.setattr(engine, "int_to_limbs", limbs_boom)
    with pytest.raises(ValueError, match="feed failed"):
        _field_run(depth)
    assert threading.active_count() == threads


@pytest.mark.parametrize("depth", DEPTHS)
def test_failing_kernel_is_raised(depth, monkeypatch):
    threads = threading.active_count()
    real, calls = ce.detailed_accum_megaloop, [0]

    def kernel_boom(*a, **kw):
        calls[0] += 1
        if calls[0] == 5:
            raise RuntimeError("launch failed")
        return real(*a, **kw)

    monkeypatch.setattr(ce, "detailed_accum_megaloop", kernel_boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        _field_run(depth)
    assert threading.active_count() == threads


def test_failing_dense_collector_is_raised(small_runs, monkeypatch):
    # A count the re-scan cannot reproduce is an error, raised here.
    threads = threading.active_count()
    got: list = []

    def wrong(*a, **kw):
        return iter([])

    monkeypatch.setattr(engine, "rare_scan_survivors", wrong)
    with pytest.raises(RuntimeError, match="the rare scan found 0"):
        engine._niceonly_dense(FieldSize(47, 100), 10, CPU, got,
                               batch_size=16, segment=1)
    assert threading.active_count() == threads
    assert got == []


def test_feed_rows_are_the_reference_limbs():
    plan = get_plan(98)
    feed = engine._SliceFeed(plan, [[(B98_FIELD, B98_FIELD + 10)]], 4, CPU, 0)
    starts = []
    while (item := feed.get()) is not None:
        starts.append(item.start.tolist())
    assert starts == [int_to_limbs(B98_FIELD + k, plan.limbs_n).tolist()
                      for k in (0, 4, 8)]
