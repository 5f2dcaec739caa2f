"""The readers of the program's field records and library loads
(fieldrecords.py and the metrics that read it) on synthetic runs and
records: what each reads, None where nothing is recorded, the warm field's
record left out, and the .b80 twins."""

import sys
from types import ModuleType, SimpleNamespace

import pytest

from benchport import fieldrecords, manifest, traffic
from benchport.run import Field, Run

CONFIG = {"base": 40, "field_size": 10**9, "warm_index": 1705}
READERS = ("client.self_ms_per_field", "engine.ends_ms_per_field",
           "feed.host_ms_per_field", "rare.host_ms_per_field")
TWINS = ("client.self_ms_per_field", "engine.ends_ms_per_field",
         "feed.host_ms_per_field")


def grid_field(k):
    lo, size, _ = traffic.grid(CONFIG)
    return lo + k * size, lo + (k + 1) * size


def run_of(ks):
    run = Run(SimpleNamespace(config=CONFIG, root=manifest.ROOT))
    for i, k in enumerate(ks):
        start, end = grid_field(k)
        run.fields.append(Field(start, end, 0.06, 0.06 * (i + 1), {}, None))
    return run


def record(k, *, scale=1.0, rare=0.0):
    """A field's record: a 60 ms client call around a 58 ms engine call."""
    start, end = grid_field(k)
    spans = {"client.process_field": 0.060, "client.prepare": 0.0005,
             "engine.detailed": 0.058, "client.report": 0.0005,
             "engine.setup": 0.002, "engine.loop": 0.040,
             "engine.drain": 0.013, "engine.finish": 0.003,
             "feed.ring_wait": 0.001, "feed.handoff": 0.004,
             "feed.get": 0.002, "feed.dispatch": 0.030}
    out = {"base": 40, "range_start": start, "range_end": end,
           "spans": {n: [s * scale, 1] for n, s in spans.items()}}
    if rare:
        out["spans"]["rare.scan"] = [rare, 2]
    return out


@pytest.fixture
def program(monkeypatch):
    """Stand-ins for the program's loaded modules; returns their state."""
    state = {"records": [], "loads": {"count": 0, "seconds": 0.0}}
    trace = ModuleType("nice_tpu_torch.obs.trace")
    trace.field_records = lambda: list(state["records"])
    build = ModuleType("nice_tpu_torch.ops.cuda_build")
    build.LOADS = state["loads"]
    monkeypatch.setitem(sys.modules, trace.__name__, trace)
    monkeypatch.setitem(sys.modules, build.__name__, build)
    return state


def read(name, run):
    return manifest.load_reader(name).read(run)


@pytest.mark.parametrize("name", READERS + ("setup.libraries_s",))
def test_nothing_recorded_reads_none(program, name):
    run = run_of([1, 2, 3])
    assert read(name, run) is None  # no record, no load
    program["records"] = [record(7), record(8)]  # not the window's fields
    assert read(name, run) is None


@pytest.mark.parametrize("name", READERS + ("setup.libraries_s",))
def test_a_tree_without_the_records_reads_none(monkeypatch, name):
    """The parent's tree: the modules hold no field_records and no LOADS."""
    monkeypatch.setitem(sys.modules, "nice_tpu_torch.obs.trace",
                        ModuleType("nice_tpu_torch.obs.trace"))
    monkeypatch.setitem(sys.modules, "nice_tpu_torch.ops.cuda_build",
                        ModuleType("nice_tpu_torch.ops.cuda_build"))
    assert read(name, run_of([1, 2])) is None


def test_each_reader_reads_its_spans(program):
    run = run_of([10, 11, 12, 13])
    # The stretch is fields 11 and 12 of the window; 12 scanned near misses.
    program["records"] = [record(11), record(12, rare=0.008)]
    assert read("client.self_ms_per_field", run) == pytest.approx(2.0)
    assert read("engine.ends_ms_per_field", run) == pytest.approx(5.0)
    assert read("feed.host_ms_per_field", run) == pytest.approx(35.0)
    assert read("rare.host_ms_per_field", run) == pytest.approx(4.0)


def test_the_warm_fields_record_is_left_out(program):
    warm = CONFIG["warm_index"]
    run = run_of([5, 6])
    program["records"] = [record(warm, scale=100.0), record(5), record(6)]
    assert read("client.self_ms_per_field", run) == pytest.approx(2.0)
    # A window field on the warm field's range: its own (newer) record is
    # read, the warm one left out.
    run = run_of([5, warm])
    program["records"] = [record(warm, scale=100.0), record(5),
                          record(warm)]
    assert read("engine.ends_ms_per_field", run) == pytest.approx(5.0)
    run = run_of([warm])
    program["records"] = [record(warm, scale=100.0)]
    assert read("engine.ends_ms_per_field", run) is None


def test_library_seconds_read_the_loads(program):
    program["loads"].update(count=3, seconds=12.5)
    assert read("setup.libraries_s", run_of([])) == 12.5


@pytest.mark.parametrize("name", TWINS)
def test_b80_twins_read_as_their_siblings(program, name):
    same, b80 = (manifest.load_reader(n) for n in (name, name + ".b80"))
    assert (b80.LAYER, b80.UNIT, b80.SOURCE) == (same.LAYER, same.UNIT,
                                                 same.SOURCE)
    assert (same.MOVES, b80.MOVES) == ("numbers_per_s", "numbers_per_s.b80")
    run = run_of([3, 4])
    program["records"] = [record(3), record(4, scale=2.0)]
    assert b80.read(run) == same.read(run) is not None


def test_window_records_come_in_the_order_recorded(program):
    run = run_of([4, 2, 9])
    program["records"] = [record(4), record(9), record(2)]
    got = fieldrecords.window_records(run)
    assert [r["range_start"] for r in got] == [grid_field(k)[0]
                                               for k in (4, 9, 2)]
