"""The port's dense niceonly path (bases above 4 u32 limbs, b98 and up) on
the CPU, held against the JAX package: the MSD filter above 2^128 (the
FieldSize repair), the residue congruence, the plain K4 (K4's CPU twin,
nice_tpu_torch/ops/vector_engine.py niceonly_dense_megaloop) against the
JAX stats kernel's two niceonly modes in interpret mode and the jnp
megaloops, the dense loop against the JAX dense engine, and b98/b100 fields
against the scalar oracle, checkpoint and resume included. Every comparison
is exact.

Where the JAX comparisons stop: the JAX jnp graph at b98 (5/9/13 limbs) does
not finish compiling on a CPU in minutes, so the port is held against JAX at
b10, b17 and b40, and at b98, b100 and b510 against Python ints.
"""

import numpy as np
import pytest
import torch

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import msd_filter as jmsd
from nice_tpu.ops import pallas_engine as pe
from nice_tpu.ops import residue_filter as jresidue
from nice_tpu.ops import scalar as jscalar
from nice_tpu.ops import vector_engine as jve
from nice_tpu.ops.limbs import get_plan as jget_plan
from nice_tpu_torch.core.types import FieldSize, NiceNumberSimple
from nice_tpu_torch.ops import adaptive_floor, engine, msd_filter
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import vector_engine as ve
from nice_tpu_torch.ops.limbs import get_plan, int_to_limbs

CPU = torch.device("cpu")
# The first b98 field of 1e9 in a seeded draw that the MSD filter does not
# prune whole (chip_smoke.py's main-path field), above 2^128, and a stretch
# of a surviving b100 field.
B98_FIELD = 413428759798923141071530212209627033363
B100_RANGE = 8828019138762881829106236139006375885885
B40_MID = 3621949312977 - 300_000


@pytest.fixture(autouse=True)
def _fresh_floor_controller():
    adaptive_floor.reset_for_tests()
    yield
    adaptive_floor.reset_for_tests()


def _numbers(results):
    return [(n.number, n.num_uniques) for n in results.nice_numbers]


def _carry_start(base: int, lanes: int) -> int:
    """A start whose lanes cross the largest limb carry inside the base's
    range: the first multiple of 2^w above range_start, for the largest w
    (a multiple of 32) that has one inside the range."""
    plan = get_plan(base)
    for w in range(32 * (plan.limbs_n - 1), 0, -32):
        b = ((plan.range_start >> w) + 1) << w
        if plan.range_start + lanes < b < plan.range_end - lanes:
            return b - lanes // 2
    raise AssertionError(f"b{base}: no limb carry inside the range")


def _k4(base: int, start: int, valid: int, *, fused: bool, batch: int,
        n_iters: int = 1, min_uniques=None):
    plan = get_plan(base)
    return ce.niceonly_dense_megaloop(
        plan, batch, n_iters, ce.niceonly_classes(plan, fused, "cpu"),
        torch.from_numpy(int_to_limbs(start, plan.limbs_n).astype(np.int64)),
        valid, min_uniques).tolist()


# --------------------------------------------------------------------------
# The repair: the MSD filter above 2^128
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base,start", [(98, B98_FIELD),
                                        (100, B100_RANGE - 300_000)])
def test_msd_filter_above_2_128_equals_jax(base, start):
    # Above 2^128 the host library cannot take the range, so both packages
    # run the Python recursion (it reads FieldSize.first()/last()).
    assert start > 1 << 128
    field = FieldSize(start, start + 2_000_000)
    assert (field.first(), field.last()) == (start, start + 1_999_999)
    mine = msd_filter.get_valid_ranges(field, base, min_range_size=4096)
    ref = jmsd.get_valid_ranges(JFieldSize(start, start + 2_000_000), base,
                                min_range_size=4096)
    assert [(r.start(), r.end()) for r in mine] == \
        [(r.start(), r.end()) for r in ref]
    assert 1 < len(mine) and sum(r.size() for r in mine) < field.size()


# --------------------------------------------------------------------------
# The residue congruence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base", [10, 40])
def test_residue_keep_lanes_equals_jax(base):
    plan = get_plan(base)
    rng = np.random.default_rng(base)
    ns = [int(x) for x in rng.integers(plan.range_start, plan.range_end, 500)]
    ns += list(range(plan.range_start, plan.range_start + 300))
    limbs = np.stack([int_to_limbs(n, plan.limbs_n) for n in ns], axis=1)
    mine = ve.residue_keep_lanes(
        plan, [torch.from_numpy(x.astype(np.int64)) for x in limbs])
    ref = np.asarray(jve.residue_keep_lanes(jget_plan(base), list(limbs)))
    assert mine.tolist() == ref.tolist()
    assert 0 < int(mine.sum()) < len(ns)


@pytest.mark.parametrize("base", [98, 99, 100, 510])
def test_residue_keep_lanes_equals_filter_membership(base):
    plan = get_plan(base)
    allowed = set(jresidue.get_residue_filter(base))
    rng = np.random.default_rng(base)
    ns = [plan.range_start + int(f) * ((plan.range_end - plan.range_start) >> 40)
          for f in rng.integers(0, 1 << 40, 400)]
    ns += list(range(plan.range_start, plan.range_start + 2 * (base - 1)))
    limbs = [torch.tensor([(n >> (32 * i)) & 0xFFFFFFFF for n in ns],
                          dtype=torch.int64) for i in range(plan.limbs_n)]
    assert ve.residue_keep_lanes(plan, limbs).tolist() == \
        [n % (base - 1) in allowed for n in ns]
    # K4's class tables: the fused one is the filter, the unfused all b-1.
    assert tuple(ce.niceonly_classes(plan, True, "cpu").tolist()) == \
        tuple(sorted(allowed))
    assert ce.niceonly_classes(plan, False, "cpu").tolist() == \
        list(range(base - 1))
    assert (len(allowed) == 0) == (base == 99)  # b99 keeps no class


# --------------------------------------------------------------------------
# The plain K4 against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base,fused", [(10, True), (10, False), (17, True),
                                        (17, False), (40, True), (40, False)])
def test_plain_k4_equals_pallas_kernel(base, fused):
    # One 1024-lane batch in block_rows=8 tiles, ragged valid, as
    # tests/test_pallas_engine.py runs the stats kernel in interpret mode.
    # The lanes lie inside the base's range (b10's is [47, 100)): outside
    # it the two packages' fixed-width digit extractions differ.
    plan = get_plan(base)
    start = 47 if base == 10 else plan.range_start + 11
    valid = 53 if base == 10 else 1000
    sl = int_to_limbs(start, plan.limbs_n)
    if fused:
        want = [int(x) for x in pe.niceonly_fused_batch(
            jget_plan(base), 1024, sl, np.int32(valid), block_rows=8)]
    else:
        want = [int(pe.niceonly_dense_batch(
            jget_plan(base), 1024, sl, np.int32(valid), block_rows=8)), 0]
    assert _k4(base, start, valid, fused=fused, batch=1024) == want
    if base == 10:
        assert want[0] == 1  # 69
    assert (want[1] > 0) == fused


@pytest.mark.parametrize("base,batch", [(10, 32), (40, 256)])
def test_plain_k4_equals_jnp_megaloops(base, batch):
    # Three iterations with a ragged valid_total, inside the range.
    plan = get_plan(base)
    start = 47 if base == 10 else plan.range_start + 5
    sl = int_to_limbs(start, plan.limbs_n)
    valid = 53 if base == 10 else 3 * batch - 77
    jp = jget_plan(base)
    count, pruned = jve.niceonly_filtered_megaloop(jp, batch, 3, sl,
                                                   np.int32(valid))
    assert _k4(base, start, valid, fused=True, batch=batch, n_iters=3) == \
        [int(count), int(pruned)]
    dense = jve.niceonly_dense_megaloop(jp, batch, 3, sl, np.int32(valid))
    assert _k4(base, start, valid, fused=False, batch=batch, n_iters=3) == \
        [int(dense), 0]
    assert int(count) == int(dense) and int(pruned) > 0
    assert int(count) == (1 if base == 10 else 0)


@pytest.mark.parametrize("where", ["range_start", "carry"])
@pytest.mark.parametrize("base,lanes", [(98, 3000), (100, 3000), (510, 600)])
def test_plain_k4_threshold_counts_equal_bigint(base, lanes, where):
    # No lane here is nice, so at min_uniques = base the counts are 0 and
    # would hide a lost carry; at 5/8 of the base (about the median of
    # num_uniques) each mode counts many lanes, each held to the JAX
    # package's Python-int num_uniques.
    plan = get_plan(base)
    start = plan.range_start if where == "range_start" else \
        _carry_start(base, lanes)
    valid = lanes - 37
    min_u = (5 * base + 7) // 8
    allowed = set(jresidue.get_residue_filter(base))
    uniq = [jscalar.get_num_unique_digits(n, base)
            for n in range(start, start + valid)]
    for fused in (True, False):
        keep = [fused is False or (start + i) % (base - 1) in allowed
                for i in range(valid)]
        want = sum(k and min_u <= u <= base for k, u in zip(keep, uniq))
        got = _k4(base, start, valid, fused=fused, batch=lanes,
                  min_uniques=min_u)
        assert got == [want, valid - sum(keep)]
        # Fused keeps a few classes (2 of 97 at b98, 2 of 509 at b510).
        # Unfused, every lane is kept, and across the carry many count; at
        # the range's start the squares lead with zeros and num_uniques sits
        # below 5/8 of the base (b510's first 600 lanes count none).
        assert sum(keep) > 0
        assert want > 0 or fused or where == "range_start"
        assert _k4(base, start, valid, fused=fused, batch=lanes) == \
            [0, valid - sum(keep)]


def test_plain_k4_is_chunk_invariant(monkeypatch):
    start = B98_FIELD + 12345
    whole = _k4(98, start, 5000, fused=False, batch=5000, min_uniques=61)
    monkeypatch.setattr(ve, "DENSE_CHUNK_LANES", 777)
    assert _k4(98, start, 5000, fused=False, batch=5000,
               min_uniques=61) == whole
    assert whole[0] > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = get_plan(98)
    classes = ce.niceonly_classes(plan, True, "cpu")
    st = torch.from_numpy(int_to_limbs(B98_FIELD, 5).astype(np.int64))
    with pytest.raises(ValueError):  # valid_total past the megaloop
        ce.niceonly_dense_megaloop(plan, 64, 2, classes, st, 129)
    with pytest.raises(ValueError):  # u32 carriers are int64 tensors
        ce.niceonly_dense_megaloop(plan, 64, 2, classes.to(torch.int32), st, 9)
    with pytest.raises(ValueError):  # more classes than b - 1
        ce.niceonly_dense_megaloop(plan, 64, 2, torch.arange(98), st, 9)
    with pytest.raises(ValueError):  # start limbs of another base
        ce.niceonly_dense_megaloop(plan, 64, 2, classes, st[:4], 9)
    with pytest.raises(ValueError):
        ce.niceonly_dense_megaloop(plan, 64, 2, classes, st, 9, 99)
    before = ce.LAUNCHES["niceonly_dense"]
    empty = ce.niceonly_classes(get_plan(99), True, "cpu")
    lo99 = get_plan(99).range_start
    got = ce.niceonly_dense_megaloop(
        get_plan(99), 64, 2, empty,
        torch.from_numpy(int_to_limbs(lo99, 5).astype(np.int64)), 100)
    assert got.tolist() == [0, 100]  # b99 keeps no class: all pruned
    assert ce.LAUNCHES["niceonly_dense"] == before  # the CPU launches nothing


# --------------------------------------------------------------------------
# The dense loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_dense_loop_equals_jax_dense_engine(monkeypatch, fused):
    # The contract of tests/test_megaloop.py's single-device niceonly
    # megaloop test: b40, 30,000 numbers, batch 256, segment 3.
    monkeypatch.setenv("NICE_TPU_SHARD", "0")
    monkeypatch.setenv("NICE_TPU_FUSED_FILTER", "1" if fused else "0")
    monkeypatch.setenv("NICE_TPU_MEGALOOP_SEGMENT", "3")
    s, e = B40_MID, B40_MID + 30_000
    want = _numbers(jengine.process_range_niceonly(
        JFieldSize(s, e), 40, backend="jnp", batch_size=256))
    adaptive_floor.reset_for_tests(pinned=4096)
    got = []  # the port's loop runs the fused mode; both count the same
    engine._niceonly_dense(FieldSize(s, e), 40, CPU, got, batch_size=256,
                           segment=3)
    assert [(n.number, n.num_uniques) for n in got] == want == _numbers(
        jscalar.process_range_niceonly(JFieldSize(s, e), 40))
    st = engine.LAST_NICEONLY_STATS
    assert st["runs"] > 1 and st["kept"] > 0 and st["floor"] == 4096
    assert st["lanes"] == st["kept"] + st["pruned"]
    assert st["pruned"] > 0 and st["classes"] == 4
    assert st["launches"] == 0  # plain versions on the CPU


def test_dense_loop_finds_69_through_k4_and_k2(monkeypatch):
    monkeypatch.setenv("NICE_TPU_SHARD", "0")
    monkeypatch.setenv("NICE_TPU_MEGALOOP_SEGMENT", "3")
    want = _numbers(jengine.process_range_niceonly(
        JFieldSize(47, 100), 10, backend="jnp", batch_size=16))
    got = []
    engine._niceonly_dense(FieldSize(47, 100), 10, CPU, got, batch_size=16,
                           segment=3)
    assert [(n.number, n.num_uniques) for n in got] == want == [(69, 10)]
    assert engine.LAST_NICEONLY_STATS["runs"] == 2  # runs of 48 lanes


def test_rare_scan_must_confirm_the_count(monkeypatch):
    real = ce.niceonly_dense_megaloop

    def overcount(*a, **k):
        return real(*a, **k) + torch.tensor([1, 0], dtype=torch.int32)

    monkeypatch.setattr(ce, "niceonly_dense_megaloop", overcount)
    with pytest.raises(RuntimeError, match="rare scan found"):
        engine._niceonly_dense(FieldSize(47, 100), 10, CPU, [])


# --------------------------------------------------------------------------
# b98 and b100 fields through the entry point
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base,start", [(98, B98_FIELD),
                                        (100, B100_RANGE + 250_000)])
def test_engine_equals_scalar_oracle_above_2_128(base, start):
    adaptive_floor.reset_for_tests(pinned=4096)
    field = FieldSize(start, start + 200_000)
    progress = []
    got = engine.process_range_niceonly(
        field, base, device="cpu",
        progress=lambda done, total: progress.append((done, total)))
    assert _numbers(got) == _numbers(jscalar.process_range_niceonly(
        JFieldSize(start, start + 200_000), base))
    assert got.distribution == ()
    st = engine.LAST_NICEONLY_STATS
    assert st["base"] == base and st["ranges"] > 1 and st["kept"] > 0
    assert progress[-1] == (st["lanes"], st["lanes"])


def test_b98_equals_oracle_below_2_128_and_b99_prunes_all():
    # b98's range starts below 2^128 (the host library's filter); b99 keeps
    # no residue class, so K4 prunes every lane and nothing is nice.
    for base in (98, 99):
        lo = get_plan(base).range_start
        got = engine.process_range_niceonly(FieldSize(lo - 50, lo + 20_000),
                                            base, device="cpu")
        assert _numbers(got) == _numbers(jscalar.process_range_niceonly(
            JFieldSize(lo - 50, lo + 20_000), base))
    st = engine.LAST_NICEONLY_STATS
    assert st["base"] == 99 and st["classes"] == 0
    assert st["pruned"] == st["lanes"]


def test_cuda_without_a_card_raises_at_b98():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.process_range_niceonly(FieldSize(B98_FIELD, B98_FIELD + 100), 98)


# --------------------------------------------------------------------------
# Checkpoint and resume at b98
# --------------------------------------------------------------------------

@pytest.fixture
def small_runs(monkeypatch):
    # Runs of 2 x 1024 lanes: a 40,000-number b98 field makes many.
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1024)
    monkeypatch.setattr(engine, "MEGALOOP_SEGMENT_DEFAULT", 2)
    adaptive_floor.reset_for_tests(pinned=4096)


def test_checkpoint_resume_roundtrip_b98(small_runs):
    field = FieldSize(B98_FIELD, B98_FIELD + 40_000)
    states = []
    full = engine.process_range_niceonly(field, 98, device="cpu",
                                         checkpoint_cb=states.append,
                                         checkpoint_batches=1)
    runs = engine.LAST_NICEONLY_STATS["runs"]
    assert len(states) == runs >= 8
    cursors = [st["cursor"] for st in states]
    assert cursors == sorted(cursors) and cursors[-1] == field.end()
    for st in states[:: max(1, len(states) // 4)]:
        assert set(st) == {"cursor", "hist", "nice_numbers", "remaining",
                           "filtered"}
        assert st["hist"] is None and st["filtered"] is True
        got = engine.process_range_niceonly(field, 98, device="cpu", resume=st)
        assert got == full
        # A filtered state is scanned as it is: exactly its remaining lanes.
        assert engine.LAST_NICEONLY_STATS["lanes"] == sum(
            b - a for a, b in st["remaining"])


def test_resume_from_jax_shaped_filtered_state_b98(small_runs, monkeypatch):
    field = FieldSize(B98_FIELD, B98_FIELD + 40_000)
    held = B98_FIELD + 17  # a restored number the resume must keep
    st = {"cursor": B98_FIELD + 5_000, "hist": None,
          "nice_numbers": [[held, 98]],
          "remaining": [[B98_FIELD + 5_000, B98_FIELD + 9_000],
                        [B98_FIELD + 30_000, B98_FIELD + 31_000]],
          "filtered": True}
    filtered = []
    real = msd_filter.get_valid_ranges

    def counted(range_, base, **kw):
        filtered.append((range_.start(), range_.end()))
        return real(range_, base, **kw)

    monkeypatch.setattr(msd_filter, "get_valid_ranges", counted)
    got = engine.process_range_niceonly(field, 98, device="cpu", resume=st)
    assert _numbers(got) == [(held, 98)]
    stats = engine.LAST_NICEONLY_STATS
    assert stats["lanes"] == 5_000 and stats["ranges"] == 2
    assert filtered == []  # a filtered state's gaps are proven empty
    # Without "filtered" the remaining segments are filtered again first.
    st.pop("filtered")
    got = engine.process_range_niceonly(field, 98, device="cpu", resume=st)
    assert _numbers(got) == [(held, 98)]
    assert filtered == [tuple(r) for r in st["remaining"]]


def test_interrupted_run_resumes_to_the_oracle_b98(small_runs):
    field = FieldSize(B98_FIELD - 30, B98_FIELD + 40_000)
    saved = []

    def killed_after_three(state):
        saved.append(state)
        if len(saved) == 3:
            raise KeyboardInterrupt  # the process dies mid-field

    with pytest.raises(KeyboardInterrupt):
        engine.process_range_niceonly(field, 98, device="cpu",
                                      checkpoint_cb=killed_after_three,
                                      checkpoint_batches=1)
    got = engine.process_range_niceonly(field, 98, device="cpu",
                                        resume=saved[-1])
    assert _numbers(got) == _numbers(jscalar.process_range_niceonly(
        JFieldSize(field.start(), field.end()), 98))


def test_dense_loop_resumes_jax_dense_states_b10(monkeypatch):
    # The JAX dense loop's own states ("remaining", "filtered") over b10's
    # range, one per batch, resumed by the port's dense loop: before and
    # after 69.
    monkeypatch.setenv("NICE_TPU_SHARD", "0")
    monkeypatch.setenv("NICE_TPU_MEGALOOP_SEGMENT", "1")
    states = []
    jengine.process_range_niceonly(JFieldSize(47, 100), 10, backend="jnp",
                                   batch_size=16, checkpoint_cb=states.append,
                                   checkpoint_batches=1)
    assert states and all(st["filtered"] for st in states)
    holds = [any(n == 69 for n, _ in st["nice_numbers"]) for st in states]
    assert not holds[0] and holds[-1]
    for st in states:
        got = [NiceNumberSimple(number=int(n), num_uniques=int(u))
               for n, u in st["nice_numbers"]]
        engine._niceonly_dense(FieldSize(47, 100), 10, CPU, got, resume=st,
                               batch_size=16, segment=1)
        assert [(n.number, n.num_uniques) for n in got] == [(69, 10)]
