"""The port's chaos drill (nice_tpu_torch/scripts/chaos_smoke.py) on the CPU:
the whole drill against a server subprocess (six b22 fields, three
block-lease client runs under dropped submit replies, a server SIGKILL and
restart mid run 2, a dispatch fault in run 3's second member resumed by
reruns), the fault index against the engine's segment plan and the fault
landing after the second member's first snapshot, and the drill's
canonical results against the JAX package's scalar oracle.
"""

import pytest

from nice_tpu.core.types import FieldSize as JFieldSize
from nice_tpu.ops import scalar as jscalar
from nice_tpu_torch.client import api_client
from nice_tpu_torch.core.base_range import get_base_range
from nice_tpu_torch.core.types import FieldSize
from nice_tpu_torch.faults import injector as faults
from nice_tpu_torch.obs import series
from nice_tpu_torch.ops import engine
from nice_tpu_torch.scripts import chaos_smoke

BASE = chaos_smoke.BASE


def _b22_fields():
    """The drill's layout of b22: fields of FIELD_SIZE from the range's
    start, the last one short."""
    lo, hi = get_base_range(BASE)
    return [FieldSize(s, min(s + chaos_smoke.FIELD_SIZE, hi))
            for s in range(lo, hi, chaos_smoke.FIELD_SIZE)]


@pytest.fixture(autouse=True)
def _restore():
    faults.reset()
    yield
    faults.reset()
    api_client.reset()


def test_the_whole_drill_on_the_cpu(tmp_path):
    line = chaos_smoke.run_drill(str(tmp_path), "cpu")
    assert line["ok"], line["failures"]
    assert line["failures"] == []
    assert line["fields"] == 6 and line["submissions"] == 6
    assert line["server_killed"] is True
    assert line["run_rcs"][:2] == [0, 0] and line["run_rcs"][2] != 0
    assert line["rerun_rcs"] and set(line["rerun_rcs"]) == {0}
    assert line["dropped_responses"] >= 1
    assert line["duplicate_replays"] >= 1
    assert line["dispatch_faults"] == 1
    assert line["faulted_claim"] in line["resumed_claims"]
    assert line["resumed_claims"][line["faulted_claim"]] == \
        line["faulted_cursor"]
    assert line["k1_segments"]["cpu"] > 0
    assert min(line["dispatches_by_field"].values()) >= \
        chaos_smoke.MIN_DISPATCHES


@pytest.mark.parametrize("batch", [chaos_smoke.BATCH_SIZE, None])
def test_fault_index_is_the_engines_segment_plan(batch):
    fields = _b22_fields()
    assert len(fields) == 6
    for f in (fields[0], fields[-1]):
        planned = engine.detailed_dispatches(f, BASE, device="cpu",
                                             batch_size=batch)
        before = series.ENGINE_DISPATCHES.value(("detailed",))
        engine.process_range_detailed(f, BASE, device="cpu", batch_size=batch)
        assert series.ENGINE_DISPATCHES.value(("detailed",)) - before == \
            planned
        if batch is None:
            assert planned == 1  # the default shape: one dispatch a field
        else:
            assert planned >= chaos_smoke.MIN_DISPATCHES
            assert chaos_smoke.fault_index(f, "cpu") == planned + 2
    # Outside the base's range the oracle runs: no dispatch.
    assert engine.detailed_dispatches(FieldSize(10, 20), BASE,
                                      device="cpu") == 0


def test_the_fault_lands_after_the_second_members_first_snapshot():
    first, second = _b22_fields()[-2:]
    n = chaos_smoke.fault_index(first, "cpu")
    faults.configure(f"engine.dispatch:raise@{n}", 0)
    states = {1: [], 2: []}
    kw = {"device": "cpu", "batch_size": chaos_smoke.BATCH_SIZE,
          "checkpoint_batches": 1}
    engine.process_range_detailed(first, BASE,
                                  checkpoint_cb=states[1].append, **kw)
    assert states[1][-1]["cursor"] == first.end()  # a finished snapshot
    with pytest.raises(RuntimeError, match="injected engine.dispatch fault"):
        engine.process_range_detailed(second, BASE,
                                      checkpoint_cb=states[2].append, **kw)
    assert len(states[2]) == 1
    assert second.start() < states[2][0]["cursor"] < second.end()
    # The snapshot resumes to the uninterrupted field's results.
    faults.reset()
    resumed = engine.process_range_detailed(second, BASE,
                                            resume=states[2][0],
                                            device="cpu")
    want = engine.process_range_detailed(second, BASE, device="cpu")
    assert resumed == want


def test_canonical_results_equal_the_jax_scalar_oracle():
    f = _b22_fields()[1]
    (dist, nums), = chaos_smoke.canonical([(2, f)]).values()
    ref = jscalar.process_range_detailed(JFieldSize(f.start(), f.end()), BASE)
    assert dist == {d.num_uniques: d.count for d in ref.distribution}
    assert nums == {(n.number, n.num_uniques) for n in ref.nice_numbers}
    assert nums  # the field holds near misses: the comparison is not empty
