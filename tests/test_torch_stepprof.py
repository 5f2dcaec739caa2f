"""The port's device-step profiler (nice_tpu_torch/obs/stepprof.py) on the
CPU, against the JAX package's: the same phase arithmetic and cumulative
table; the fence (a CUDA event on the card; a count alone on the CPU,
nothing when off); compile attribution by thread; and whole fields (a
detailed b40 field of 2^20 numbers, the port's plain kernels against JAX's
jnp backend, and a niceonly one) through both clients' process_field, with
equal counter deltas, the same phase keys, the phases journal event, and no
fence in either package with the profiler off. Every test restores both
packages' process state."""

import threading

import pytest
import torch

from nice_tpu import obs as jobs
from nice_tpu.client import main as jclient
from nice_tpu.core.types import DataToClient as JDataToClient
from nice_tpu.core.types import SearchMode as JSearchMode
from nice_tpu.obs import metrics as jmetrics
from nice_tpu.obs import stepprof as jstepprof
from nice_tpu_torch import obs
from nice_tpu_torch.client import main as client
from nice_tpu_torch.core.base_range import get_base_range
from nice_tpu_torch.core.types import DataToClient
from nice_tpu_torch.obs import series, stepprof
from nice_tpu_torch.ops import cuda_build


def _save_jax_state():
    """A restore() of the JAX state these tests touch: the registry's
    values, stepprof's tables and the journal buffer."""
    values = {}
    for name, m in jobs.REGISTRY.metrics().items():
        with m._lock:
            if isinstance(m, jmetrics.Histogram):
                values[name] = {k: (list(st.counts), st.sum, st.count)
                                for k, st in m._states.items()}
            else:
                values[name] = dict(m._values)
    prof = (jstepprof._fence_count, jstepprof.cumulative(),
            dict(jstepprof.LAST_BREAKDOWN))
    events = list(jobs.journal._client_events)

    def restore():
        for name, m in jobs.REGISTRY.metrics().items():
            saved = values.get(name) or {}
            with m._lock:
                if isinstance(m, jmetrics.Histogram):
                    m._states.clear()
                    for k, (counts, total, count) in saved.items():
                        st = jmetrics._HistState(len(m.buckets))
                        st.counts, st.sum, st.count = list(counts), total, count
                        m._states[k] = st
                else:
                    m._values.clear()
                    m._values.update(saved)
        jstepprof.reset()
        jstepprof._fence_count = prof[0]
        jstepprof._cumulative.update(prof[1])
        jstepprof.LAST_BREAKDOWN.update(prof[2])
        jobs.journal._client_events[:] = events

    return restore


@pytest.fixture(autouse=True)
def _isolated():
    restore = _save_jax_state()
    obs.reset()
    jstepprof.reset()
    yield
    obs.reset()
    restore()


def test_phase_arithmetic_and_tables_match_the_reference():
    adds = [("compile", 0.5), ("h2d_feed", 0.25), ("device_compute", 1.5),
            ("fold", 0.125), ("readback", 0.0625), ("h2d_feed", 0.25)]
    key = ("detailed", "40", "cuda")
    for walls in ((4.0,), (4.0, 2.0)):
        obs.reset()
        jstepprof.reset()
        j0 = jobs.series.STEPPROF_PHASE_SECONDS.label_sums()
        for wall in walls:
            mine = stepprof.StepProfiler("detailed", 40, "cuda", True)
            theirs = jstepprof.StepProfiler("detailed", 40, "cuda", True)
            for phase, secs in adds:
                mine.add(phase, secs)
                theirs.add(phase, secs)
            assert mine.finish(wall) == theirs.finish(wall)
        assert stepprof.cumulative() == jstepprof.cumulative()
        assert stepprof.LAST_BREAKDOWN == jstepprof.LAST_BREAKDOWN
        theirs = {}
        for k, (total, n) in \
                jobs.series.STEPPROF_PHASE_SECONDS.label_sums().items():
            t0, n0 = j0.get(k, (0.0, 0))
            if k[:3] == key and n > n0:
                theirs[k] = (total - t0, n - n0)
        mine = {k: v for k, v in
                series.STEPPROF_PHASE_SECONDS.label_sums().items() if v[1]}
        assert mine == theirs
    assert stepprof.finished() == 2
    assert stepprof.LAST_BREAKDOWN["host_other"] == 0.0  # 2.0 < the rest
    assert set(stepprof.LAST_BREAKDOWN) - {"key", "mode", "base", "backend",
                                           "wall"} == set(stepprof.PHASES)


def test_fence_counts_on_the_cpu_and_never_when_off():
    off = stepprof.StepProfiler("detailed", 10, "cpu")
    assert not off.enabled and stepprof.enabled() is False
    off.fence(torch.zeros(2))
    assert stepprof.fence_count() == 0
    on = stepprof.StepProfiler("detailed", 10, "cpu", True)
    on.fence(None)
    assert stepprof.fence_count() == 0
    on.fence(torch.zeros(2))
    on.fence(torch.zeros(2))
    assert stepprof.fence_count() == 2
    with pytest.raises(AttributeError):
        on.fence(object())  # not a tensor: raises, as nothing is fenced
    stepprof.configure(True)
    assert stepprof.StepProfiler("niceonly", 98, "cpu").enabled
    stepprof.configure(False)


def test_compile_is_the_bound_threads_alone():
    prof = stepprof.StepProfiler("detailed", 40, "cuda", True).start()
    try:
        stepprof.note_compile(2.0)
        t = threading.Thread(target=stepprof.note_compile, args=(5.0,))
        t.start()
        t.join()  # an unbound thread: a prefetch warm, say
        bound = threading.Thread(
            target=lambda: (prof.bind(), stepprof.note_compile(1.0),
                            prof.unbind()))
        bound.start()
        bound.join()  # a collector bound to the field
        assert prof.breakdown()["compile"] == 3.0
    finally:
        prof.stop()
    assert stepprof._current() is None


def test_nvcc_builds_report_their_seconds(monkeypatch, tmp_path):
    """cuda_build.nvcc_library hands its seconds to note_compile."""
    seen = []
    monkeypatch.setattr(cuda_build.stepprof, "note_compile", seen.append)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nfor a; do o=$a; done\n"
                    "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && touch \"$2\"; "
                    "shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(fake))
    info = cuda_build.nvcc_library(str(tmp_path / "lib" / "x.so"), ["a.cu"])
    assert seen == [info["seconds"]]


def _fields():
    lo = get_base_range(40)[0]
    return [("detailed", DataToClient(claim_id=11, base=40, range_start=lo,
                                      range_end=lo + (1 << 20),
                                      range_size=1 << 20)),
            ("niceonly", DataToClient(claim_id=12, base=40, range_start=lo,
                                      range_end=lo + (1 << 20),
                                      range_size=1 << 20))]


def _counts(reg_series):
    return ({m: reg_series.ENGINE_NUMBERS.labels(m).value()
             for m in ("detailed", "niceonly")},
            {m: reg_series.CLIENT_FIELDS.labels(m).value()
             for m in ("detailed", "niceonly")})


@pytest.mark.parametrize("profiled", [False, True])
def test_fields_match_the_reference_with_and_without_the_profiler(
        monkeypatch, profiled):
    # The JAX client reads its knob from the environment; the port's is
    # the --stepprof flag.
    monkeypatch.setenv("NICE_TPU_STEPPROF", "1" if profiled else "0")
    argv = ["--device", "cpu", "--pyprof-hz", "0", "--memwatch-secs", "0",
            "--history-secs", "0"] + (["--stepprof"] if profiled else [])
    args = client.build_parser().parse_args(argv)
    client.configure_obs(args)
    mine0, theirs0 = _counts(series), _counts(jobs.series)
    for mode, data in _fields():
        args.mode = mode
        jmode = JSearchMode.DETAILED if mode == "detailed" else \
            JSearchMode.NICEONLY
        results, _ = client.process_field(data, args)
        jres, _ = jclient.process_field(JDataToClient.from_json(data.to_json()),
                                        jmode, "jnp", None)
        assert [(n.number, n.num_uniques) for n in results.nice_numbers] == \
            [(n.number, n.num_uniques) for n in jres.nice_numbers]
        if mode == "detailed":
            assert [d.count for d in results.distribution] == \
                [d.count for d in jres.distribution]
            if profiled:
                # The detailed loop is profiled in both packages.
                assert set(stepprof.LAST_BREAKDOWN) == \
                    set(jstepprof.LAST_BREAKDOWN)
                b = stepprof.LAST_BREAKDOWN
                assert b["device_compute"] > 0 and b["host_other"] >= 0
                assert sum(b[p] for p in stepprof.PHASES) == \
                    pytest.approx(b["wall"])
    mine = {m: _counts(series)[0][m] - mine0[0][m] for m in mine0[0]}
    theirs = {m: _counts(jobs.series)[0][m] - theirs0[0][m]
              for m in theirs0[0]}
    assert mine == theirs == {"detailed": 1 << 20, "niceonly": 1 << 20}
    mine = {m: _counts(series)[1][m] - mine0[1][m] for m in mine0[1]}
    theirs = {m: _counts(jobs.series)[1][m] - theirs0[1][m]
              for m in theirs0[1]}
    assert mine == theirs == {"detailed": 1, "niceonly": 1}
    events = [e for e in obs.journal.drain_client_events()
              if e["kind"] == "phases"]
    jevents = [e for e in jobs.journal.drain_client_events()
               if e["kind"] == "phases"]
    if profiled:
        assert stepprof.fence_count() > 0 and jstepprof.fence_count() > 0
        # The detailed field's event in both; the JAX client also stamps
        # its niceonly field (its jnp backend runs the profiled dense loop
        # there), where the port's strided pipeline has no profiled loop.
        assert [e["claim_id"] for e in events] == [11]
        assert [e["claim_id"] for e in jevents] == [11, 12]
        assert set(events[0]["detail"]) == set(jevents[0]["detail"])
    else:
        assert stepprof.fence_count() == 0 and jstepprof.fence_count() == 0
        assert events == jevents == []
        assert stepprof.cumulative() == {}


def test_bench_reports_each_cases_phase_breakdown_and_memory(capsys):
    from nice_tpu_torch.scripts import bench

    rc = bench.main(["--only", "extra-large", "--size", "65536", "--batch",
                     "8192", "--reps", "1", "--device", "cpu", "--stepprof"])
    lines = [__import__("json").loads(x)
             for x in capsys.readouterr().out.splitlines() if x]
    assert rc == 0
    detailed = lines[0]
    # Detailed extra-large: the first pass, the warm pass, one timed pass
    # and the feed A/B's two shapes of (warm + 1): 7 profiled fields.
    (key, entry), = detailed["phase_breakdown"].items()
    assert key == "detailed|b40|cpu" and entry["fields"] == 7
    assert set(entry) == {*stepprof.PHASES, "wall", "fields"}
    assert entry["device_compute"] > 0
    # The strided niceonly pipeline has no profiled loop.
    assert "phase_breakdown" not in lines[1]
    for line in lines[:2]:
        mem = line["peak_mem"]
        assert mem["peak_rss_bytes"] > 0 and "rss_delta_bytes" in mem
        assert "device_peak_bytes" not in mem  # no CUDA context here
    assert stepprof.enabled()  # --stepprof turned it on
