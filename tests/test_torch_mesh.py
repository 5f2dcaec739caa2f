"""The port's mesh of slices (nice_tpu_torch/parallel/mesh.py and the mesh
half of ops/engine.py) on the CPU, on devices=["cpu"] * k, held against the
JAX package under the conftest's 8 virtual devices (whose engine takes its
sharded path there) and against the scalar oracle where JAX's graph does not
compile in time (b98). Every comparison is exact.

Covered: partition_segments against JAX's; detailed fields on 1, 2, 3 and 8
slices; strided niceonly split over slices; the dense loop at b98 on 2 and 4
slices; the elastic downshift drills (the twins of tests/test_elastic_mesh.py,
with JAX's n_dev_end beside the port's); elastic off and unattributed
failures raising with a resumable state; checkpoints across layouts and
across the two packages; the scheduler's downshift mid-run (the twin of
tests/test_sched.py::test_elastic_downshift_mid_multi_tenant_run); feed
depths; the int32 headroom rule; the mesh.dispatch fault site; slice
identity, liveness and the step cache; and the device lists a mesh refuses.
"""

import functools

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nice_tpu import faults as jfaults
from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import engine as jengine
from nice_tpu.ops import scalar as jscalar
from nice_tpu.parallel import mesh as jmesh
from nice_tpu_torch import obs, sched
from nice_tpu_torch.ckpt import FieldCheckpointer
from nice_tpu_torch.core import base_range
from nice_tpu_torch.core.types import DataToClient, FieldSize, SearchMode
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.ops import adaptive_floor, autotune
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops import engine
from nice_tpu_torch.ops.limbs import get_plan
from nice_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
# tests/test_elastic_mesh.py's b17 field: 25,400 numbers, of which the
# valid range's [5541, 12633) runs on the mesh and the rest on the oracle.
B17 = (5541, 30941)
B17_CORE = (4913, 12633)  # b17's whole valid range
B40_LO = base_range.get_base_range(40)[0]
# The smoke's b98 field that the MSD filter does not prune whole.
B98_FIELD = 413428759798923141071530212209627033363


@pytest.fixture(autouse=True)
def _clean():
    adaptive_floor.reset_for_tests()
    yield
    faults.reset()
    jfaults.reset()
    pmesh.heal_devices()
    jmesh.heal_devices()
    pmesh.clear_step_cache()
    engine._invalidate_mesh_cache()
    adaptive_floor.reset_for_tests()
    obs.reset()


def _cpus(k):
    return ["cpu"] * k


def _pairs(results):
    return ([(d.num_uniques, d.count) for d in results.distribution],
            [(n.number, n.num_uniques) for n in results.nice_numbers])


def _oracle_detailed(lo, hi, base):
    return _pairs(jscalar.process_range_detailed(JFieldSize(lo, hi), base))


def _oracle_niceonly(lo, hi, base):
    return _pairs(jscalar.process_range_niceonly(JFieldSize(lo, hi), base))


@functools.lru_cache(maxsize=None)
def _jax_detailed(lo, hi, base, batch):
    return _pairs(jengine.process_range_detailed(
        JFieldSize(lo, hi), base, backend="jnp", batch_size=batch))


# --------------------------------------------------------------------------
# partition_segments
# --------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5000), st.integers(0, 700)),
                max_size=6),
       st.integers(1, 9), st.sampled_from([1, 7, 64, 128, 256]))
def test_partition_segments_equals_jax(gaps, n, batch):
    segs, pos = [], 0
    for gap, width in gaps:  # ascending and disjoint, some empty
        segs.append((pos + gap, pos + gap + width))
        pos += gap + width
    got = pmesh.partition_segments(segs, n, batch)
    assert got == jmesh.partition_segments(segs, n, batch)
    assert len(got) == n
    assert sum(e - s for q in got for s, e in q) == sum(
        e - s for s, e in segs)


def _covered(queues):
    segs = sorted(s for q in queues for s in q)
    for a, b in zip(segs, segs[1:]):
        assert a[1] <= b[0], f"overlap: {a} {b}"
    return sum(e - s for s, e in segs)


def test_partition_segments_covers_exactly():
    queues = pmesh.partition_segments([(0, 1000), (5000, 5300)], 4, 128)
    assert len(queues) == 4 and _covered(queues) == 1300
    for q in queues[:-1]:
        assert sum(e - s for s, e in q) == 384
    assert queues[2] == [(768, 1000), (5000, 5152)]


def test_partition_segments_fewer_than_slices():
    queues = pmesh.partition_segments([(10, 20)], 8, 256)
    assert len(queues) == 8 and _covered(queues) == 10


def test_partition_segments_empty():
    assert pmesh.partition_segments([], 4, 128) == [[], [], [], []]


def test_partition_segments_single_slice():
    segs = [(0, 999), (2000, 2001)]
    assert pmesh.partition_segments(segs, 1, 128) == [[(0, 999), (2000, 2001)]]


# --------------------------------------------------------------------------
# Detailed fields on k slices against JAX's 8-device engine
# --------------------------------------------------------------------------

# (lo, hi, base, batch): b40 with a ragged tail, b10 [47, 100) with 69, and
# b17's whole valid range (tests/test_engine_sharded.py,
# tests/test_elastic_mesh.py).
DETAILED_FIELDS = [(B40_LO, B40_LO + 3000, 40, 128), (47, 100, 10, 128),
                   (*B17, 17, 256)]


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("field", DETAILED_FIELDS,
                         ids=["b40-ragged", "b10-69", "b17-range"])
def test_detailed_on_k_slices_equals_jax(field, k):
    lo, hi, base, batch = field
    got = engine.process_range_detailed(FieldSize(lo, hi), base, device="cpu",
                                        devices=_cpus(k), batch_size=batch)
    assert _pairs(got) == _jax_detailed(lo, hi, base, batch)
    stats = engine.LAST_FEED_STATS
    assert stats["n_dev_start"] == stats["n_dev_end"] == k
    assert stats["reshards"] == 0
    if base == 10:
        assert (69, 10) in _pairs(got)[1]


def test_detailed_segment_one_equals_megaloop():
    # The reference's segment == 1 steps are the megaloop step at seg=1.
    lo, hi = B17
    runs = [engine.process_range_detailed(
        FieldSize(lo, hi), 17, device="cpu", devices=_cpus(4),
        batch_size=256, segment=seg) for seg in (1, 8)]
    assert _pairs(runs[0]) == _pairs(runs[1]) == _oracle_detailed(lo, hi, 17)


# --------------------------------------------------------------------------
# Niceonly: the strided pipeline split over slices, the dense loop
# --------------------------------------------------------------------------

def _b40_mid():
    lo, hi = base_range.get_base_range(40)
    return (lo + hi) // 2


def _b80_surviving():
    lo, hi = base_range.get_base_range(80)
    return lo + (hi - lo) * 3 // 20


# (base, start, size, pinned MSD floor): fields whose filter leaves several
# descriptors, and b10's range with 69.
STRIDED_FIELDS = [(40, _b40_mid(), 200_000, 4096),
                  (80, _b80_surviving(), 200_000, 16384),
                  (10, 47, 53, 64)]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("field", STRIDED_FIELDS, ids=["b40", "b80", "b10"])
def test_strided_on_k_slices_equals_jax(monkeypatch, field, k):
    """Descriptor groups of 2 a slice: a group spans every slice, so each
    slice's K3 share and the concatenation in slice order are exercised
    (every zero count is audited on the host). JAX's b80 graph takes half
    a minute to compile here, so b80 is held to its scalar oracle."""
    base, lo, size, floor = field
    monkeypatch.setattr(ce, "STRIDED_DESC_MAX", 2)
    monkeypatch.setattr(engine, "STRIDE_AUDIT_EVERY", 1)
    adaptive_floor.reset_for_tests(pinned=floor)
    shares = []
    real = ce.strided_niceonly_batch

    def k3(plan, modulus, residues, periods, desc, n_real, *a):
        shares.append(n_real)
        return real(plan, modulus, residues, periods, desc, n_real, *a)

    monkeypatch.setattr(ce, "strided_niceonly_batch", k3)
    got = engine.process_range_niceonly(FieldSize(lo, lo + size), base,
                                        device="cpu", devices=_cpus(k))
    stats = engine.LAST_NICEONLY_STATS
    n = stats["descriptors"]
    assert stats["n_dev"] == k and n >= 1
    if base == 80:
        want = _oracle_niceonly(lo, lo + size, base)
    else:
        want = _pairs(jengine.process_range_niceonly(
            JFieldSize(lo, lo + size), base, backend="jnp", batch_size=1024))
    assert _pairs(got) == want
    # One K3 call a slice that holds rows of a group, each slice full but
    # a group's last.
    want_shares = []
    for g in range(stats["groups"]):
        rows = min(2 * k, n - 2 * k * g)
        want_shares += [min(2, rows - 2 * d) for d in range(-(-rows // 2))]
    assert shares == want_shares
    if base == 10:
        assert _pairs(got)[1] == [(69, 10)]
    else:
        assert len(shares) >= k  # every slice had a share


@pytest.fixture
def small_runs(monkeypatch):
    # Runs of 2 x 1024 lanes: a 40,000-number b98 field makes many.
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1024)
    monkeypatch.setattr(engine, "MEGALOOP_SEGMENT_DEFAULT", 2)
    adaptive_floor.reset_for_tests(pinned=4096)


B98_RANGE = (B98_FIELD - 30, B98_FIELD + 40_000)


@functools.lru_cache(maxsize=None)
def _b98_oracle():
    return _oracle_niceonly(*B98_RANGE, 98)


@pytest.mark.parametrize("k", [2, 4])
def test_dense_b98_on_k_slices_equals_the_oracle(small_runs, k):
    got = engine.process_range_niceonly(FieldSize(*B98_RANGE), 98,
                                        device="cpu", devices=_cpus(k))
    assert _pairs(got) == _b98_oracle()
    stats = engine.LAST_NICEONLY_STATS
    assert stats["n_dev"] == k and stats["runs"] >= k
    assert engine.LAST_FEED_STATS["n_dev_end"] == k


@pytest.mark.parametrize("k", [2, 5])
def test_dense_loop_on_slices_finds_69(k):
    dev, mesh = engine.resolve_mesh(CPU, _cpus(k))
    got = []
    engine._niceonly_dense(FieldSize(47, 100), 10, dev, got, batch_size=4,
                           segment=1, mesh=mesh)
    assert [(n.number, n.num_uniques) for n in got] == [(69, 10)]
    assert engine.LAST_NICEONLY_STATS["runs"] >= k


# --------------------------------------------------------------------------
# Elastic downshift drills (tests/test_elastic_mesh.py's)
# --------------------------------------------------------------------------

DRILLS = [("mesh.dispatch:dead@3", 7), ("mesh.dispatch:dead:0@3", 7),
          ("mesh.dispatch:dead:1+5+6@2", 5)]


@pytest.mark.parametrize("spec,n_end", DRILLS)
def test_detailed_drill_equals_oracle_and_jax(monkeypatch, spec, n_end):
    lo, hi = B17
    faults.configure(spec)
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        devices=_cpus(8), batch_size=256,
                                        segment=1)
    stats = dict(engine.LAST_FEED_STATS)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)
    assert stats["reshards"] == 1 and stats["reshard_secs"] > 0
    assert (stats["n_dev_start"], stats["n_dev_end"]) == (8, n_end)
    # The reference's drill, per-batch dispatch as its test pins it.
    monkeypatch.setenv("NICE_TPU_MEGALOOP", "0")
    jfaults.configure(spec)
    jengine.process_range_detailed(JFieldSize(lo, hi), 17, backend="jnp",
                                   batch_size=256)
    assert jengine.LAST_FEED_STATS["n_dev_end"] == stats["n_dev_end"]
    assert jengine.LAST_FEED_STATS["reshards"] == stats["reshards"]


@pytest.mark.parametrize("spec,n_end", DRILLS)
def test_dense_drill_equals_oracle(small_runs, spec, n_end):
    faults.configure(spec)
    got = engine.process_range_niceonly(FieldSize(*B98_RANGE), 98,
                                        device="cpu", devices=_cpus(8),
                                        segment=1)
    stats = engine.LAST_FEED_STATS
    assert _pairs(got) == _b98_oracle()
    assert stats["mode"] == "niceonly" and stats["reshards"] == 1
    assert (stats["n_dev_start"], stats["n_dev_end"]) == (8, n_end)


def test_lost_slices_stay_out_of_later_fields():
    faults.configure("mesh.dispatch:dead:2@2")
    lo, hi = B17
    engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                  devices=_cpus(4), batch_size=256, segment=1)
    faults.reset()
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        devices=_cpus(4), batch_size=256)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)
    assert engine.LAST_FEED_STATS["n_dev_start"] == 3
    # Slice identity is the position in the list: slice 2 alone is out.
    slices = pmesh.slices_of(_cpus(4))
    assert [s.id for s in pmesh.live_devices(slices)] == [0, 1, 3]
    _, mesh = engine.resolve_mesh(CPU, _cpus(4))
    assert mesh.ids == (0, 1, 3)
    pmesh.heal_devices()
    assert engine.resolve_mesh(CPU, _cpus(4))[1].ids == (0, 1, 2, 3)
    # Down to one live slice: the one-device path on it.
    pmesh.simulate_device_loss([0, 1, 2])
    assert engine.resolve_mesh(CPU, _cpus(4)) == (CPU, None)
    pmesh.simulate_device_loss([3])
    with pytest.raises(RuntimeError, match="marked lost"):
        engine.resolve_mesh(CPU, _cpus(4))


@pytest.mark.parametrize("mode", ["detailed", "dense"])
def test_elastic_off_raises_with_a_resumable_state(small_runs, mode):
    faults.configure("mesh.dispatch:dead@3")
    if mode == "detailed":
        lo, hi, base = *B17, 17
        run = functools.partial(engine.process_range_detailed, FieldSize(lo, hi),
                                17, device="cpu", batch_size=256, segment=1)
        want = _oracle_detailed(lo, hi, 17)
    else:
        run = functools.partial(engine.process_range_niceonly,
                                FieldSize(*B98_RANGE), 98, device="cpu",
                                segment=1)
        want = _b98_oracle()
    with pytest.raises(engine.DispatchError) as err:
        run(devices=_cpus(8), elastic=False)
    assert isinstance(err.value.cause, pmesh.MeshDeviceLost)
    state = err.value.state
    assert state is not None and state["remaining"]
    assert engine.LAST_FEED_STATS["reshards"] == 0
    faults.reset()
    # Nothing marked lost: the state resumes on the full mesh and on one.
    for devices in (_cpus(8), None):
        assert _pairs(run(devices=devices, resume=state)) == want


def test_unattributed_failure_raises_with_a_state():
    """A failure no probe pins on a slice (mesh.dispatch:raise, an
    engine.dispatch fault) does not downshift: every slice is alive."""
    lo, hi = B17
    for spec in ("mesh.dispatch:raise@4", "engine.dispatch:raise@5"):
        faults.configure(spec)
        with pytest.raises(engine.DispatchError) as err:
            engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                          devices=_cpus(3), batch_size=256,
                                          segment=1)
        faults.reset()
        got = engine.process_range_detailed(
            FieldSize(lo, hi), 17, device="cpu", devices=_cpus(2),
            batch_size=256, resume=err.value.state)
        assert _pairs(got) == _oracle_detailed(lo, hi, 17)


def test_a_launch_failing_mid_item_keeps_the_markers_exact(monkeypatch):
    """A real launch error on slice 2 of an item whose slices 0-1 already
    launched: their markers advance, so the state covers their work once
    and slice 2's not at all."""
    lo, hi = B17_CORE
    real = pmesh.ShardedAccumStep.launch
    calls = [0]

    def launch(self, d, start, valid):
        calls[0] += 1
        if calls[0] >= 10 and d == 2 and calls[0] < 100:
            calls[0] = 100
            raise RuntimeError("a launch failed")
        return real(self, d, start, valid)

    monkeypatch.setattr(pmesh.ShardedAccumStep, "launch", launch)
    with pytest.raises(engine.DispatchError) as err:
        engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                      devices=_cpus(4), batch_size=256,
                                      segment=1)
    monkeypatch.setattr(pmesh.ShardedAccumStep, "launch", real)
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        resume=err.value.state)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)


# --------------------------------------------------------------------------
# Checkpoints across layouts and packages
# --------------------------------------------------------------------------

def _mid_state(states):
    mids = [s for s in states if s.get("remaining") and len(s["remaining"]) > 1]
    assert mids, "no mid-field multi-slice checkpoint fired"
    return mids[len(mids) // 2]


def test_port_state_from_8_slices_resumes_in_jax_and_on_3_and_1():
    lo, hi = B17
    states = []
    full = engine.process_range_detailed(
        FieldSize(lo, hi), 17, device="cpu", devices=_cpus(8), batch_size=256,
        segment=1, checkpoint_cb=states.append, checkpoint_batches=1,
        checkpoint_secs=0)
    want = _oracle_detailed(lo, hi, 17)
    assert _pairs(full) == want
    mid = _mid_state(states)
    prev = lo
    for s, e in mid["remaining"]:  # ascending, disjoint, inside the field
        assert lo <= s < e <= hi and s >= prev
        prev = e
    for devices in (_cpus(3), None):
        got = engine.process_range_detailed(FieldSize(lo, hi), 17,
                                            device="cpu", devices=devices,
                                            batch_size=256, resume=mid)
        assert _pairs(got) == want
    jgot = jengine.process_range_detailed(JFieldSize(lo, hi), 17,
                                          backend="jnp", batch_size=256,
                                          resume=mid)
    assert _pairs(jgot) == want


def test_jax_state_from_8_devices_resumes_on_2_slices(monkeypatch):
    lo, hi = B17
    monkeypatch.setenv("NICE_TPU_MEGALOOP", "0")
    states = []
    jengine.process_range_detailed(JFieldSize(lo, hi), 17, backend="jnp",
                                   batch_size=256,
                                   checkpoint_cb=states.append,
                                   checkpoint_batches=1, checkpoint_secs=0)
    mid = _mid_state(states)
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        devices=_cpus(2), batch_size=256,
                                        resume=mid)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)


def test_dense_states_from_4_slices_resume_on_2(small_runs):
    states = []
    engine.process_range_niceonly(FieldSize(*B98_RANGE), 98, device="cpu",
                                  devices=_cpus(4), segment=1,
                                  checkpoint_cb=states.append,
                                  checkpoint_batches=1)
    assert len(states) >= 4
    for st_ in states[:: max(1, len(states) // 3)]:
        assert st_["filtered"] is True and st_["hist"] is None
        got = engine.process_range_niceonly(FieldSize(*B98_RANGE), 98,
                                            device="cpu", devices=_cpus(2),
                                            resume=st_)
        assert _pairs(got) == _b98_oracle()


def test_manager_remaining_roundtrip(tmp_path):
    lo, hi = B17
    data = DataToClient(claim_id=1, base=17, range_start=lo, range_end=hi,
                        range_size=hi - lo)
    ck = FieldCheckpointer(str(tmp_path), data, SearchMode.NICEONLY, "device",
                           256, device="cpu")
    assert ck.signature["state"] == 3
    state = {"cursor": 6000, "hist": None, "nice_numbers": [(5541, 12)],
             "remaining": [(6000, 7000), (9000, 30941)], "filtered": True}
    ck.save(state)
    got = ck.load()
    assert got["remaining"] == [(6000, 7000), (9000, 30941)]
    assert got["filtered"] is True and got["cursor"] == 6000
    assert got["nice_numbers"] == [(5541, 12)]


# --------------------------------------------------------------------------
# The scheduler: a slice lost under an interleaved two-tenant run
# --------------------------------------------------------------------------

def test_elastic_downshift_mid_multi_tenant_run(monkeypatch, tmp_path):
    monkeypatch.setattr(autotune, "WINNERS_PATH", str(tmp_path / "w.json"))
    autotune.reset_for_tests()
    for mode in ("detailed", "niceonly"):
        autotune.record(mode, 17, "cpu", {"batch_size": 64, "megaloop": 1})
    range_a, range_b = (5541, 9541), (9541, 13541)
    reg = sched.TenantRegistry([
        sched.TenantSpec(name="det", mode="detailed", base=17, priority=2,
                         batch_size=64),
        sched.TenantSpec(name="nice", mode="niceonly", base=17, priority=1)])
    source = sched.StaticSource({"det": [("det/f0", 17, *range_a)],
                                 "nice": [("nice/f0", 17, *range_b)]})
    faults.configure("mesh.dispatch:dead@3")
    scheduler = sched.MultiTenantScheduler(
        reg, source, page_batches=8, quantum_secs=1e-9, device="cpu",
        devices=_cpus(8))
    scheduler.run()
    assert engine.LAST_FEED_STATS["n_dev_start"] == 7  # slice 7 stays out
    assert scheduler.pages_run["det"] >= 4
    faults.reset()
    pmesh.heal_devices()
    try:
        got_det = source.results["det"]["det/f0"]
        got_nice = source.results["nice"]["nice/f0"]
        assert _pairs(got_det) == _pairs(engine.process_range_detailed(
            FieldSize(*range_a), 17, device="cpu"))
        assert _pairs(got_det) == _oracle_detailed(*range_a, 17)
        assert _pairs(got_nice) == _pairs(engine.process_range_niceonly(
            FieldSize(*range_b), 17, device="cpu"))
    finally:
        autotune.reset_for_tests()


# --------------------------------------------------------------------------
# Feed depth, the int32 headroom rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 2, 8])
def test_feed_depth_ab_equivalence(depth):
    lo, hi = B17
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        devices=_cpus(4), batch_size=256,
                                        segment=1, feed_depth=depth)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)
    stats = engine.LAST_FEED_STATS
    assert stats["feed_depth"] == depth and stats["dispatches"] > 0
    assert 0 < stats["gaps"] <= stats["dispatches"]
    assert stats["idle_p95"] >= stats["idle_p50"] >= 0


def test_clamp_segment_is_the_reference_rule():
    for seg in (1, 8, 64, 4096):
        for batch in (1, 128, 1 << 18, 1 << 28):
            for n_dev in (1, 2, 3, 8):
                assert engine.clamp_segment(seg, batch, n_dev) == \
                    jengine._clamp_segment(seg, batch, n_dev)


def test_flush_comes_before_any_bin_can_pass_the_limit(monkeypatch):
    """A small int32 budget: every fold hands over rows whose sum stays
    under half of it, at the mesh's lanes, so the rule holds for the rows
    and for their sum; the field is still exact."""
    monkeypatch.setattr(engine, "ACC_LIMIT", 1 << 12)
    folds = []
    real = pmesh.make_sharded_stats_fold

    def spying(mesh):
        fold = real(mesh)

        def spy(rows):
            stacked = torch.stack(list(rows)).to(torch.int64)
            folds.append((int(stacked.max(1).values.sum()),
                          int(stacked.sum())))
            return fold(rows)

        return spy

    monkeypatch.setattr(pmesh, "make_sharded_stats_fold", spying)
    lo, hi = B17_CORE
    assert engine.clamp_segment(8, 64, 4) == 8  # 2^12 // (2*64*4) = 8
    assert engine.clamp_segment(16, 64, 4) == 8
    got = engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                        devices=_cpus(4), batch_size=64,
                                        segment=16)
    assert _pairs(got) == _oracle_detailed(lo, hi, 17)
    assert len(folds) >= 3
    assert all(peak <= (1 << 12) // 2 for peak, _ in folds)
    assert sum(lanes for _, lanes in folds) >= hi - lo


# --------------------------------------------------------------------------
# The mesh.dispatch fault site
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["mesh.dispatch:dead", "mesh.dispatch:dead@3",
                                  "mesh.dispatch:dead:1+5+6@2",
                                  "mesh.dispatch:dead:0@batch=4",
                                  "mesh.dispatch:raise@0.5"])
def test_configure_takes_the_mesh_dispatch_site(spec):
    faults.configure(spec)
    assert faults.active_sites() == ("mesh.dispatch",)
    jfaults.parse_spec(spec)


@pytest.mark.parametrize("spec", ["mesh.dispatch:teleport",
                                  "mesh.dispatch:dead:",
                                  "mesh.dispatch:dead:x",
                                  "mesh.dispatch:dead:1+",
                                  "mesh.dispatch:truncate"])
def test_configure_refuses_an_unknown_mesh_action(spec):
    with pytest.raises(faults.FaultSpecError):
        faults.configure(spec)
    assert faults.active_sites() == ()


def test_mesh_fault_context_is_the_references(monkeypatch):
    seen = []
    real = faults.fire

    def spy(site, **ctx):
        if site == "mesh.dispatch":
            seen.append(ctx)
        return real(site, **ctx)

    monkeypatch.setattr(faults, "fire", spy)
    faults.configure("mesh.dispatch:dead@99")
    lo, hi = B17
    engine.process_range_detailed(FieldSize(lo, hi), 17, device="cpu",
                                  devices=_cpus(3), batch_size=256, segment=1)
    assert seen and set(seen[0]) == {"batch", "n_dev", "start"}
    assert [c["batch"] for c in seen] == list(range(len(seen)))
    assert {c["n_dev"] for c in seen} == {3}
    assert seen[0]["start"] == lo


# --------------------------------------------------------------------------
# Meshes, slices and the step cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("devices,err", [
    (["cuda"], ValueError),              # a bare cuda names no card
    (["cuda", "cuda"], ValueError),
    (["cpu", "cuda:0"], ValueError),     # a CPU/CUDA mix
    (["cuda:0", "cpu"], ValueError),
    (["tpu:0"], ValueError),
    ([], ValueError),
])
def test_make_mesh_refuses_a_bad_device_list(devices, err):
    with pytest.raises(err):
        pmesh.make_mesh(devices)
    with pytest.raises(ValueError):
        pmesh.device_kind(devices)


def test_a_cuda_list_without_cuda_raises_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.process_range_detailed(FieldSize(47, 100), 10,
                                      devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="kind"):
        engine.process_range_detailed(FieldSize(47, 100), 10, device="cpu",
                                      devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="kind"):
        engine.resolve_mesh(CPU, ["cuda:0", "cuda:1"])


def test_cpu_lists_repeat_and_shard_off_takes_one_device():
    mesh = pmesh.make_mesh(_cpus(3))
    assert mesh.size == 3 and mesh.ids == (0, 1, 2)
    assert mesh.devices == (CPU,) * 3 and mesh.streams == (None,) * 3
    from nice_tpu_torch.obs import series
    assert series.MESH_DEVICES.value() == 3
    assert engine.resolve_mesh(CPU, _cpus(3), shard=False) == (CPU, None)
    assert engine.resolve_mesh(CPU, None) == (CPU, None)
    assert engine.resolve_mesh(CPU, ["cpu"]) == (CPU, None)
    got = engine.process_range_detailed(FieldSize(47, 100), 10, device="cpu",
                                        devices=_cpus(3), shard=False)
    assert engine.LAST_FEED_STATS["n_dev_start"] == 1
    assert _pairs(got) == _oracle_detailed(47, 100, 10)


def test_step_cache_keyed_on_slice_ids():
    pmesh.clear_step_cache()
    plan = get_plan(17)
    m1 = pmesh.make_mesh(_cpus(4))
    m2 = pmesh.make_mesh(_cpus(4))  # another Mesh over the same slices
    s1 = pmesh.make_sharded_megaloop_accum_step(plan, 128, 2, m1)
    assert pmesh.make_sharded_megaloop_accum_step(plan, 128, 2, m2) is s1
    assert pmesh.clear_step_cache([pmesh.mesh_device_ids(m1)[0]]) >= 1
    s3 = pmesh.make_sharded_megaloop_accum_step(plan, 128, 2, m1)
    assert s3 is not s1
    assert pmesh.clear_step_cache([10_000]) == 0
    assert pmesh.make_sharded_megaloop_accum_step(plan, 128, 2, m1) is s3
    # A downshift's survivors keep their ids: a mesh over slices 1-3 shares
    # no entry with the four-slice one's eviction of slice 0.
    survivors = pmesh.make_mesh(m1.slices[1:])
    assert survivors.ids == (1, 2, 3)
    s4 = pmesh.make_sharded_megaloop_accum_step(plan, 128, 2, survivors)
    assert pmesh.clear_step_cache([0]) == 1
    assert pmesh.make_sharded_megaloop_accum_step(plan, 128, 2,
                                                  survivors) is s4


def test_probe_and_diagnosis():
    mesh = pmesh.make_mesh(_cpus(4))
    alive, lost = pmesh.probe_devices(mesh.slices)
    assert len(alive) == 4 and lost == []
    pmesh.simulate_device_loss([1])
    alive, lost = pmesh.probe_devices(mesh.slices)
    assert [s.id for s in lost] == [1]
    # An unattributed failure: the probe names the lost slice.
    survivors, reason = engine._diagnose_survivors(mesh, RuntimeError("x"))
    assert reason == "probe" and [s.id for s in survivors] == [0, 2, 3]
    pmesh.heal_devices()
    assert engine._diagnose_survivors(mesh, RuntimeError("x")) == (None, "")
    # MeshDeviceLost names positions; losing every slice leaves none.
    survivors, reason = engine._diagnose_survivors(
        mesh, pmesh.MeshDeviceLost([3]))
    assert reason == "device_lost" and [s.id for s in survivors] == [0, 1, 2]
    assert engine._diagnose_survivors(
        mesh, pmesh.MeshDeviceLost(range(4))) == (None, "")


def test_warms_take_device_lists_without_torch():
    # A CPU list builds nothing beyond the host library; a bad list raises.
    engine.warm_detailed(17, device="cpu", devices=_cpus(4))
    engine.warm_niceonly(17, 1 << 20, device="cpu", devices=_cpus(4))
    with pytest.raises(ValueError):
        engine.warm_detailed(17, devices=["cuda"])


# --------------------------------------------------------------------------
# The client's flags
# --------------------------------------------------------------------------

QUIET = ("--telemetry-secs", "0", "--pyprof-hz", "0", "--memwatch-secs", "0",
         "--history-secs", "0")


@pytest.mark.parametrize("flags,n_dev", [
    (("--devices", "cpu,cpu,cpu"), 3),
    (("--devices", "cpu,cpu,cpu", "--no-shard"), 1),
    (("--devices", "cpu"), 1),
    ((), 1),
])
def test_client_devices_reach_the_engine(capsys, flags, n_dev):
    from nice_tpu_torch.client import main as client

    assert client.main(["--benchmark", "base-ten", "--device", "cpu",
                        *flags, *QUIET]) == 0
    assert engine.LAST_FEED_STATS["n_dev_start"] == n_dev
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"nice_count": 1' in summary


def test_client_mesh_flags_parse():
    from nice_tpu_torch.client import main as client

    parser = client.build_parser()
    args = parser.parse_args(["--devices", "cuda:0, cuda:0", "--no-elastic"])
    assert args.devices == ["cuda:0", "cuda:0"]
    assert (args.shard, args.elastic) == (True, False)
    assert client._mesh_kwargs(args) == {"devices": ["cuda:0", "cuda:0"],
                                         "shard": True, "elastic": False}
    args = parser.parse_args([])
    assert (args.devices, args.shard, args.elastic) == (None, True, True)
    for bad in ("cuda", "cpu,cuda:0", "cuda:x", ""):
        with pytest.raises(SystemExit):
            parser.parse_args(["--devices", bad])
