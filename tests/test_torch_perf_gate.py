"""The port's regression gate (nice_tpu_torch/scripts/perf_gate.py) and its
critpath fold (nice_tpu_torch/obs/critpath.py) on the CPU: phase_shares
against the JAX package's on seeded stepprof tables; the bench leg against
a temporary record (no flag against itself, every case of a doubled copy
flagged and exit 1 under --strict, the reference's note and no bench run
without a record, the record written in the shape of BENCH_r*.json); the
critpath-shift and peak-memory diffs on hand-built headlines; the stepprof
leg's zero fences with the profiler off; the feed-idle leg's equal
dispatch counts.
"""

import copy
import json
import subprocess

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nice_tpu.obs import critpath as jcritpath
from nice_tpu_torch.obs import critpath, stepprof
from nice_tpu_torch.ops import engine
from nice_tpu_torch.scripts import perf_gate

PHASES = ("compile", "h2d_feed", "device_compute", "fold", "readback",
          "host_other")

_secs = st.one_of(st.floats(min_value=-1.0, max_value=1e3,
                            allow_nan=False, allow_infinity=False),
                  st.integers(min_value=0, max_value=100), st.none())
_entry = st.fixed_dictionaries(
    {"wall": _secs},
    optional={p: _secs for p in PHASES} | {"fields": st.integers(0, 9)})
_key = st.builds(lambda m, b, d: f"{m}|b{b}|{d}",
                 st.sampled_from(["detailed", "niceonly"]),
                 st.integers(10, 520), st.sampled_from(["cuda", "cpu"]))
_table = st.dictionaries(_key, st.one_of(_entry, st.just("junk")),
                         max_size=6)


@settings(max_examples=200, deadline=None)
@given(_table)
def test_phase_shares_equal_the_references(table):
    assert critpath.phase_shares(table) == jcritpath.phase_shares(table)


def test_segments_and_fold_are_the_references():
    assert critpath.SEGMENTS == jcritpath.SEGMENTS
    assert critpath._PHASE_FOLD == jcritpath._PHASE_FOLD
    table = {"detailed|b40|cuda": {"wall": 2.0, "device_compute": 1.5,
                                   "compile": 0.1, "fold": 0.1,
                                   "host_other": 0.3}}
    assert critpath.phase_shares(table) == {
        "wall_secs": 2.0, "dominant": "device_compute",
        "shares": {"device_compute": 0.8, "readback": 0.05,
                   "unaccounted": 0.15}}
    assert critpath.phase_shares({}) is None


# -- the bench leg ------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_run():
    """One real run of the gate's bench command on the CPU at a small size:
    the CompletedProcess the fake runner hands back."""
    proc = perf_gate.run_bench(perf_gate.bench_cmd("cpu", size=4096), 240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


class _Runner:
    def __init__(self, proc=None):
        self.proc, self.cmds = proc, []

    def __call__(self, cmd, timeout):
        self.cmds.append(cmd)
        assert self.proc is not None, "the bench ran without a record"
        return self.proc


def _report():
    return {"regression": {}, "stepprof": {}}


def _write(path, headline, card):
    path.write_text(json.dumps({"n": 1, "cmd": "x", "rc": 0, "tail": "",
                                "parsed": headline, "card": card}))


def test_bench_command_is_the_references_suite_and_budget(bench_run):
    cmd = perf_gate.bench_cmd("cuda")
    assert cmd[3:] == ["--suite", "default:detailed,msd-ineffective:niceonly",
                       "--budget", "70", "--stepprof", "--device", "cuda"]
    headline = perf_gate.parse_headline(bench_run.stdout)
    assert set(headline["suite"]) == {"detailed/default",
                                      "niceonly/msd-ineffective"}
    assert headline["critpath"] == critpath.phase_shares(
        headline["phase_breakdown"])
    assert headline["peak_mem"]["peak_rss_bytes"] > 0


def test_no_record_writes_the_note_and_skips(tmp_path):
    report, problems, runner = _report(), [], _Runner()
    perf_gate.run_bench_gate(report, problems, device="cpu",
                             records_dir=str(tmp_path), runner=runner)
    gate = report["regression"]["bench"]
    assert gate["baseline"] is None and "cases" not in gate
    assert gate["note"] == ("no committed TORCH_BENCH_r*.json record from "
                            "card 'cpu'; throughput diff skipped")
    assert runner.cmds == [] and problems == []


def test_a_record_of_another_card_is_not_matched(tmp_path, bench_run):
    headline = perf_gate.parse_headline(bench_run.stdout)
    _write(tmp_path / "TORCH_BENCH_r01.json", headline,
           {"device": "NVIDIA H100 80GB HBM3, 700.00 W"})
    (tmp_path / "BENCH_r09.json").write_text(json.dumps(
        {"parsed": headline}))  # the reference's glob, not the port's
    report, problems = _report(), []
    perf_gate.run_bench_gate(report, problems, device="cpu",
                             records_dir=str(tmp_path), runner=_Runner())
    assert report["regression"]["bench"]["baseline"] is None
    assert perf_gate.latest_record(str(tmp_path), "NVIDIA H100 80GB HBM3")[0] \
        == "TORCH_BENCH_r01.json"


def test_record_then_itself_then_a_doubled_copy(tmp_path, bench_run,
                                                monkeypatch):
    runner = _Runner(bench_run)
    rec = tmp_path / "rec"  # not there yet: the record makes it
    path = rec / "TORCH_BENCH_r01.json"
    report, problems = _report(), []
    perf_gate.run_bench_gate(report, problems, device="cpu",
                             records_dir=str(rec), record_path=str(path),
                             runner=runner)
    assert problems == [] and len(runner.cmds) == 1
    written = json.loads(path.read_text())
    assert set(written) == {"n", "cmd", "rc", "note", "tail", "parsed", "card"}
    assert written["n"] == 1 and written["rc"] == 0
    assert written["cmd"].startswith("python -m nice_tpu")
    assert written["card"]["device"] == "cpu"
    assert written["parsed"] == perf_gate.parse_headline(bench_run.stdout)

    # Against itself: every case compared, none flagged.
    report, problems = _report(), []
    perf_gate.run_bench_gate(report, problems, device="cpu",
                             records_dir=str(rec), runner=runner)
    gate = report["regression"]["bench"]
    assert gate["baseline"] == "TORCH_BENCH_r01.json"
    assert set(gate["cases"]) == set(written["parsed"]["suite"])
    assert not any(c["regressed"] for c in gate["cases"].values())
    assert gate["critpath"]["shifted_segments"] == {}
    assert gate["peak_mem"]["growth_frac"] == 0.0 and problems == []

    # A copy with every case's value doubled: each one flagged, and the
    # gate's exit code 1 under --strict (0 without).
    doubled = copy.deepcopy(written)
    for case in doubled["parsed"]["suite"].values():
        case["value"] *= 2
    d = tmp_path / "doubled"
    d.mkdir()
    (d / "TORCH_BENCH_r02.json").write_text(json.dumps(doubled))
    monkeypatch.setattr(perf_gate, "run_bench", runner)
    out = tmp_path / "gate.json"
    argv = ["--device", "cpu", "--records-dir", str(d), "--legs", "bench",
            "--out", str(out)]
    assert perf_gate.main(argv + ["--strict"]) == 1
    report = json.loads(out.read_text())
    cases = report["regression"]["bench"]["cases"]
    assert set(cases) == set(doubled["parsed"]["suite"])
    assert all(c["regressed"] for c in cases.values())
    assert all(abs(c["drop_frac"] - 0.5) < 1e-9 for c in cases.values())
    assert len(report["problems"]) == len(cases) and not report["ok"]
    assert report["card"]["device"] == "cpu" and "torch" in report["card"]
    assert perf_gate.main(argv) == 0


def test_a_failed_bench_run_is_a_leg_error(tmp_path, bench_run):
    headline = perf_gate.parse_headline(bench_run.stdout)
    _write(tmp_path / "TORCH_BENCH_r01.json", headline, {"device": "cpu"})
    failed = subprocess.CompletedProcess([], 1, stdout="oops\n", stderr="")
    report, problems = _report(), []
    perf_gate.run_bench_gate(report, problems, device="cpu",
                             records_dir=str(tmp_path),
                             runner=_Runner(failed))
    assert report["regression"]["bench"]["error"] == "rc=1"
    assert problems and "gate bench run failed" in problems[0]


# -- the diffs on hand-built headlines ---------------------------------------

def _headline(shares, dominant, peak):
    return {"critpath": {"wall_secs": 1.0, "shares": shares,
                         "dominant": dominant},
            "peak_mem": {"peak_rss_bytes": peak, "rss_delta_bytes": 0}}


def test_critpath_shift_and_peak_memory_diffs():
    old = _headline({"device_compute": 0.9, "h2d_feed": 0.05,
                     "unaccounted": 0.05}, "device_compute", 1000)
    new = _headline({"device_compute": 0.5, "h2d_feed": 0.2,
                     "unaccounted": 0.35}, "device_compute", 1300)
    gate, problems = {}, []
    perf_gate.critpath_diff(gate, problems, old, new)
    perf_gate.mem_diff(gate, problems, old, new)
    assert gate["critpath"]["shifted_segments"] == {
        "device_compute": {"baseline": 0.9, "current": 0.5},
        "unaccounted": {"baseline": 0.05, "current": 0.35}}
    assert gate["critpath"]["dominant"] == {
        "baseline": "device_compute", "current": "device_compute",
        "changed": False}
    assert gate["peak_mem"]["regressed"] is True
    assert abs(gate["peak_mem"]["growth_frac"] - 0.3) < 1e-12
    assert len(problems) == 3  # two segments and the memory
    assert "critpath segment device_compute share moved 90% -> 50%" in \
        problems[0]

    # Inside the tolerance: a 0.2 shift and 20 % growth pass.
    within = _headline({"device_compute": 0.7, "h2d_feed": 0.25},
                       "device_compute", 1200)
    gate, problems = {}, []
    perf_gate.critpath_diff(gate, problems, old, within)
    perf_gate.mem_diff(gate, problems, old, within)
    assert gate["critpath"]["shifted_segments"] == {} and problems == []
    assert gate["peak_mem"]["regressed"] is False

    # Missing blocks are notes, not problems.
    gate, problems = {}, []
    perf_gate.critpath_diff(gate, problems, {}, new)
    perf_gate.mem_diff(gate, problems, {}, {})
    assert "baseline round has no critpath block" in gate["critpath"]["note"]
    assert "fresh run carried no peak_mem" in gate["peak_mem"]["note"]
    assert problems == []


# -- the engine legs -----------------------------------------------------------

@pytest.fixture()
def _profiler_off():
    stepprof.reset()
    yield
    stepprof.reset()


def test_stepprof_leg_issues_no_fence_off(_profiler_off):
    report, problems = _report(), []
    perf_gate.run_stepprof(report, problems, device="cpu", reps=2,
                           numbers=1 << 14)
    sp = report["stepprof"]
    assert problems == []
    assert sp["profiler_off"]["fences"] == 0
    assert sp["profiler_off"]["cumulative_keys"] == []
    assert sp["profiler_on"]["fences"] > 0
    assert {k.split("|")[0] for k in sp["profiler_on"]["phase_breakdown"]} \
        == {"detailed", "niceonly"}
    assert set(sp["reconciliation"]) == {"detailed|b30|cpu", "niceonly|b98|cpu"}
    assert all(r["within_10pct"] for r in sp["reconciliation"].values())
    assert "overhead_frac_on_vs_off" in sp
    assert not stepprof.enabled()  # the leg leaves the profiler as it was


def test_feed_idle_leg_dispatches_equal_counts(_profiler_off, monkeypatch):
    report, problems = _report(), []
    monkeypatch.setattr(engine, "DEFAULT_BATCH_SIZE", 1 << 12)
    perf_gate.run_feed_idle_gate(report, problems, device="cpu", pairs=3,
                                 numbers=100_000)
    arms = report["stepprof"]["feed_idle"]
    assert arms["depth_0"]["feed_depth"] == 0
    assert arms["default"]["feed_depth"] == 2
    lanes = (1 << 12) * engine.MEGALOOP_SEGMENT_DEFAULT
    assert arms["depth_0"]["dispatches"] == arms["default"]["dispatches"] == \
        -(-100_000 // lanes)
    assert not [p for p in problems if "dispatched" in p]
    for arm in arms.values():
        assert arm["passes"] == len(arm["idle_fracs"]) == 3
        assert arm["numbers"] == 100_000
        assert 0.0 <= arm["idle_frac"] <= 1.0 and arm["wall_secs"] > 0
    assert not stepprof.enabled()
