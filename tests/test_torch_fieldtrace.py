"""The field record of the port's tracing (nice_tpu_torch/obs/trace.py) on a
detailed field through the client's entry, on the CPU path (the plain
versions, through the same feed, window, collector and markers):

* off (no sink, no profiler): no record is kept, no profiler range is
  entered, and LAST_FEED_STATS keeps its keys;
* under a CPU torch.profiler capture: the phase ranges nest as the record
  says, and the engine's four steps, the client's three steps and its
  parts around engine.detailed add up to their spans;
* with a file sink: one `field` event a field and no line an item;
* the rare path: one rare.scan a near-miss segment, none without;
* the libraries' running total: a real load counts, a cached one does not.
"""

import json
import os

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.types import DataToClient
from nice_tpu_torch.obs import trace
from nice_tpu_torch.ops import cuda_build, engine
from nice_tpu_torch.ops import cuda_engine as ce
from nice_tpu_torch.ops.limbs import get_plan

BATCH = 256
SEGMENT_LANES = BATCH * engine.MEGALOOP_SEGMENT_DEFAULT
# A b40 near miss in the middle of the range; 5000 numbers around it hold
# it alone, and 5000 numbers 20000 above it hold none.
B40_NEAR_MISS = 3621949312977
NEAR = (B40_NEAR_MISS - 2_500, B40_NEAR_MISS + 2_500)
CLEAR = (B40_NEAR_MISS + 20_000, B40_NEAR_MISS + 25_000)
FEED_KEYS = {"mode", "feed_depth", "dispatches", "gaps", "idle_p50",
             "idle_p95", "idle_mean", "idle_total", "n_dev_start",
             "n_dev_end", "reshards", "reshard_secs", "ring_waits",
             "block_threads"}
ENGINE_STEPS = ("engine.setup", "engine.loop", "engine.drain",
                "engine.finish")
CLIENT_STEPS = ("client.prepare", "client.engine", "client.report")
CLIENT_PARTS = ("client.prepare", "engine.detailed", "client.report")


@pytest.fixture(autouse=True)
def _fresh_trace():
    trace.reset()
    yield
    trace.reset()


def _field(start, end, claim_id=1):
    args = client.build_parser().parse_args(
        ["detailed", "--no-shard", "--device", "cpu", "--batch-size",
         str(BATCH)])
    data = DataToClient(claim_id=claim_id, base=40, range_start=start,
                        range_end=end, range_size=end - start)
    return client.process_field(data, args)[0]


def _close(parts, whole):
    """Within 0.5 ms or 2 % of the whole."""
    return abs(parts - whole) <= max(0.5e-3, 0.02 * whole)


def test_off_keeps_no_record_and_enters_no_range(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    results = _field(*NEAR)
    assert results.nice_numbers  # the rare path ran
    assert trace.field_records() == []
    assert entered == []
    assert set(engine.LAST_FEED_STATS) == FEED_KEYS
    with trace.field(40, *NEAR) as rec:
        assert rec is trace.OFF
    # The same counter sees the ranges of a profiled field.
    with profile(activities=[ProfilerActivity.CPU]):
        _field(*NEAR)
    assert {"client.process_field", "engine.loop"} <= set(entered)


def _ranges(prof):
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(("client.", "engine.", "rare."))]


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def test_profiled_field_nests_its_ranges_and_adds_up():
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _field(*NEAR)
        _field(*CLEAR, claim_id=2)
    ranges = _ranges(prof)
    by_name: dict = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    assert len(by_name["client.process_field"]) == 2
    for whole in by_name["client.process_field"]:
        parts = [next(r for r in by_name[n] if _inside(r, whole))
                 for n in CLIENT_STEPS]
        detailed = next(r for r in by_name["engine.detailed"]
                        if _inside(r, parts[1]))
        steps = [next(r for r in by_name[n] if _inside(r, detailed))
                 for n in ENGINE_STEPS]
        for seq in (parts, steps):
            for a, b in zip(seq, seq[1:]):
                assert a[3] <= b[2]  # in order, disjoint
    # The collector's items on its own thread, inside the drain or the loop
    # of their field, and the rare path's scan inside an nm item.
    collect = by_name["engine.collect.nm"] + by_name["engine.collect.stats"]
    main_thread = by_name["client.process_field"][0][1]
    assert all(r[1] != main_thread for r in collect)
    assert all(any(_inside(r, d) for d in by_name["engine.detailed"])
               for r in collect)
    (scan,) = by_name["rare.scan"]
    assert any(_inside(scan, r) for r in by_name["engine.collect.nm"])

    records = trace.field_records()
    assert [(r["range_start"], r["range_end"]) for r in records] == [NEAR,
                                                                     CLEAR]
    for rec in records:
        spans = rec["spans"]
        assert rec["base"] == 40
        assert all(spans[n][1] == 1
                   for n in ENGINE_STEPS + CLIENT_STEPS + CLIENT_PARTS)
        assert _close(sum(spans[n][0] for n in ENGINE_STEPS),
                      spans["engine.detailed"][0])
        for parts in (CLIENT_PARTS, CLIENT_STEPS):
            assert _close(sum(spans[n][0] for n in parts),
                          spans["client.process_field"][0])
        loop = spans["engine.loop"][0]
        assert spans["feed.get"][1] == spans["feed.dispatch"][1] == 3
        assert spans["feed.get"][0] + spans["feed.dispatch"][0] <= loop
        assert spans["engine.collect.nm"][1] >= 1
        assert spans["engine.collect.stats"][1] >= 1


def test_file_sink_writes_one_field_event_and_no_item_lines(tmp_path):
    sink = tmp_path / "trace.jsonl"
    trace.configure(str(sink))
    _field(*NEAR)
    trace.configure(None)
    rows = [json.loads(x) for x in sink.read_text().splitlines()]
    fields = [r for r in rows if r["name"] == "field"]
    assert len(fields) == 1
    assert (fields[0]["base"], fields[0]["range_start"],
            fields[0]["range_end"]) == (40, *NEAR)
    assert fields[0]["spans"]["rare.scan"][1] == 1
    # Besides it, the two spans' begin and end lines, as before.
    assert sorted((r["name"], r["event"]) for r in rows
                  if r["name"] != "field") == [
        ("client.process_field", "begin"), ("client.process_field", "end"),
        ("engine.detailed", "begin"), ("engine.detailed", "end")]
    assert trace.field_records() == [
        {k: v for k, v in fields[0].items() if k not in ("ts", "name",
                                                          "event")}]


def test_claim_trace_id_keys_the_record(tmp_path):
    trace.configure(str(tmp_path / "t.jsonl"))
    with trace.trace_context(trace.claim_trace_id(7)):
        _field(*CLEAR, claim_id=7)
    (rec,) = trace.field_records()
    assert rec["trace_id"] == trace.claim_trace_id(7)


@pytest.mark.parametrize("span,near_miss", [(NEAR, True), (CLEAR, False)])
def test_rare_scan_is_recorded_a_near_miss_segment(tmp_path, span,
                                                   near_miss):
    trace.configure(str(tmp_path / "t.jsonl"))
    results = _field(*span)
    segments = {(n.number - span[0]) // SEGMENT_LANES
                for n in results.nice_numbers}
    assert bool(segments) == near_miss
    (rec,) = trace.field_records()
    seconds, scans = rec["spans"].get("rare.scan", [0.0, 0])
    assert scans == len(segments)
    assert (seconds > 0) == near_miss


class _Lib:
    """Stands for a loaded library."""

    def __init__(self, path):
        self.path = path


def test_library_loads_count_real_loads_only(tmp_path, monkeypatch):
    def fake_nvcc_library(lib_path, sources, csrc=None, include=()):
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        with open(lib_path, "w") as f:
            f.write("lib")
        return {"path": lib_path, "seconds": 1.0, "ptxas": ""}

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "nvcc_library", fake_nvcc_library)
    monkeypatch.setattr(cuda_build.ctypes, "PyDLL", _Lib)
    monkeypatch.setattr(cuda_build, "bind", lambda lib: None)
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "LOADS", {"count": 0, "seconds": 0.0})
    sink = tmp_path / "t.jsonl"
    trace.configure(str(sink))
    ce.plan_library.cache_clear()
    try:
        main = cuda_build.load()
        assert cuda_build.load() is main  # cached: not counted
        assert cuda_build.LOADS["count"] == 1
        plan = get_plan(40)
        ce.plan_library(plan)
        ce.plan_library(plan)  # cached
        assert cuda_build.LOADS["count"] == 2
        ce.plan_library.cache_clear()
        ce.plan_library(plan)  # loaded again: the library is on disk
        assert cuda_build.LOADS["count"] == 3
        assert cuda_build.LOADS["seconds"] > 0
    finally:
        ce.plan_library.cache_clear()
        trace.configure(None)
    rows = [json.loads(x) for x in sink.read_text().splitlines()
            if '"build.load"' in x]
    lib = {r["span_id"]: r["lib"] for r in rows if r["event"] == "begin"}
    assert [(lib[r["span_id"]], r["built"]) for r in rows
            if r["event"] == "end"] == [("main", True), ("plan", True),
                                        ("plan", False)]
