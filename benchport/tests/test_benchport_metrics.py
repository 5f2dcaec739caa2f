"""The metric readers' arithmetic on synthetic runs and traces, and the
kernel-name files."""

from types import SimpleNamespace

import pytest

from benchport import devtrace, manifest, peaks
from benchport.run import Field, Run

H100 = {"sms": 132, "capability": (9, 0), "max_sm_mhz": 1980.0,
        "power_limit_w": 700.0}


def synthetic_run(walls, config=None, size=10**9):
    """A run whose fields take `walls` seconds back to back, after a gap of
    0.5 s before the first."""
    cell = SimpleNamespace(config=config or {"base": 40},
                           root=manifest.ROOT)
    run = Run(cell)
    t = 0.5
    for i, w in enumerate(walls):
        t += w
        run.fields.append(Field(i * size, (i + 1) * size, w, t,
                                {"feed_idle_s": w / 10}, None))
    return run


def read(name, run):
    return manifest.load_reader(name).read(run)


@pytest.mark.parametrize("name", ["numbers_per_s", "numbers_per_s.b80"])
def test_rate_is_over_the_whole_window_not_chunks(name):
    walls = [0.05] * 90 + [1.0] * 10  # a stall at the end
    run = synthetic_run(walls)
    total = 0.5 + sum(walls)
    assert read(name, run) == pytest.approx(100 * 10**9 / total)
    # A median of per-chunk rates would hide the stall.
    assert read(name, run) < 10**9 / 0.05 / 2
    assert read(name, synthetic_run([])) is None


@pytest.mark.parametrize("name", ["feed.gap_ms_per_field", "k1_roofline",
                                  "device.idle_pct"])
def test_b80_readers_are_the_same_readers(name):
    same, b80 = (manifest.load_reader(n) for n in (name, name + ".b80"))
    assert b80.read is not None
    assert (b80.LAYER, b80.UNIT, b80.SOURCE) == (same.LAYER, same.UNIT,
                                                 same.SOURCE)
    assert (same.MOVES, b80.MOVES) == ("numbers_per_s", "numbers_per_s.b80")


def test_counter_metrics_per_field():
    run = synthetic_run([0.06] * 40)
    run.launches = {"uniques": 100, "detailed_megaloop": 477 * 40}
    assert read("rare.k2_launches_per_field", run) == pytest.approx(2.5)
    assert read("feed.gap_ms_per_field", run) == pytest.approx(6.0)
    assert read("setup_s", run) == 0.0


def stretch(fields, kernels, launches, busy=1.0, window=1.25):
    return {"fields": fields, "numbers": fields * 10**9,
            "launches": launches,
            "summary": {"window_s": window, "busy_s": busy,
                        "kernels": kernels, "device_ops": [],
                        "idle_gaps": []}}


def test_k1_roofline_from_a_synthetic_profile():
    run = synthetic_run([0.06] * 30)
    run.card = H100
    k1_s = 20 * 0.050  # 20 fields of 50 ms of K1
    run.stretch = stretch(20, {"detailed_megaloop_kernel": [9540, k1_s]},
                          {"detailed_megaloop": 9540})
    peak = 132 * 1980e6 * 64
    least = 20 * 10**9 * 167 / peak
    assert read("k1_roofline", run) == pytest.approx(100 * least / k1_s)
    assert 19 < read("k1_roofline", run) < 21
    # A record the profiler lost is made up from the launches counted.
    run.stretch = stretch(20, {"detailed_megaloop_kernel": [9539, k1_s * 9539 / 9540]},
                          {"detailed_megaloop": 9540})
    assert read("k1_roofline", run) == pytest.approx(100 * least / k1_s)
    # K5 does the same work: its records count.
    run.stretch = stretch(20, {"detailed_megaloop_mma_kernel": [9540, k1_s]},
                          {"detailed_megaloop_mma": 9540})
    assert read("k1_roofline", run) == pytest.approx(100 * least / k1_s)


def test_roofline_reads_nothing_without_records_or_peak():
    run = synthetic_run([0.06] * 3)
    run.card = H100
    run.stretch = stretch(2, {}, {"detailed_megaloop": 954})
    assert read("k1_roofline", run) is None
    run.stretch = stretch(2, {"detailed_megaloop_kernel": [954, 0.1]},
                          {"detailed_megaloop": 954})
    run.card = dict(H100, capability=(8, 0))
    assert read("k1_roofline", run) is None
    run.stretch = None
    assert read("k1_roofline", run) is None


def test_rare_device_ms_and_idle_share():
    run = synthetic_run([0.06] * 30)
    run.stretch = stretch(10, {"uniques_kernel": [50, 0.0005]},
                          {"uniques": 50}, busy=0.5, window=0.6)
    assert read("rare.device_ms_per_field", run) == pytest.approx(0.05)
    assert read("device.idle_pct", run) == pytest.approx(100 / 6)
    run.stretch = stretch(10, {}, {"uniques": 0})
    assert read("rare.device_ms_per_field", run) == 0.0
    run.stretch = stretch(10, {}, {"uniques": 7})
    assert read("rare.device_ms_per_field", run) is None


def test_kernel_name_files():
    k1 = manifest.kernel_names("k1")
    assert {"kernel": "detailed_megaloop_kernel",
            "launches": "detailed_megaloop"} in k1
    assert {"kernel": "detailed_megaloop_mma_kernel",
            "launches": "detailed_megaloop_mma"} in k1
    assert manifest.kernel_names("k2") == [{"kernel": "uniques_kernel",
                                            "launches": "uniques"}]
    from nice_tpu_torch.ops import cuda_engine as ce

    for group in ("k1", "k2"):
        for entry in manifest.kernel_names(group):
            assert entry["launches"] in ce.LAUNCHES


def test_int32_peak_of_an_h100():
    assert peaks.int32_mad_per_s(H100) == pytest.approx(132 * 1.98e9 * 64)
    assert peaks.int32_mad_per_s(dict(H100, max_sm_mhz=None)) is None


class Ev:
    def __init__(self, name, start, end, device=False):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = SimpleNamespace(name="CUDA" if device else "CPU")


def test_summarize_busy_union_gaps_and_annotations():
    events = [
        Ev(devtrace.STRETCH, 0, 1000),
        Ev(devtrace.FIELD, 10, 600),
        Ev(devtrace.FIELD, 20, 590, device=True),  # annotation, not work
        Ev("void nice::detailed_megaloop_kernel<nice::T>(long)", 100, 300, True),
        Ev("void nice::detailed_megaloop_kernel<nice::T>(long)", 250, 400, True),
        Ev("Memcpy DtoH (Device -> Pinned)", 450, 460, True),
        Ev("aten::copy_", 420, 440),
        Ev("void nice::uniques_kernel<nice::P>(long)", 700, 720, True),
        Ev("void k(int)", 1200, 1300, True),  # outside the stretch
    ]
    s = devtrace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((300 + 10 + 20) * 1e-6)
    assert s["kernels"]["detailed_megaloop_kernel"] == [2, pytest.approx(350e-6)]
    assert "field" not in s["kernels"] and devtrace.FIELD not in s["kernels"]
    gaps = dict((round(v * 1e6), k) for k, v in s["idle_gaps"])
    assert gaps[280] == "harness, between fields"   # 720..1000
    assert gaps[240] == "process_field, outside any torch op"  # 460..700
    assert gaps[100] == "process_field, outside any torch op"  # 0..100
    assert gaps[50] == "aten::copy_"  # 400..450
    assert devtrace.summarize([Ev("x", 0, 1)]) is None


def test_symbols_of_demangled_names():
    assert devtrace.symbol("void nice::uniques_kernel<nice::PlanTier>(long "
                           "const*, long, nice::Plan, int*)") == "uniques_kernel"
    assert devtrace.symbol("Memset (Device)") == "Memset (Device)"
