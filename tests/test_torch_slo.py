"""The port's SLO engine (nice_tpu_torch/obs/slo.py), occupancy meter
(nice_tpu_torch/parallel/mesh.py) and scheduler series on the CPU, held
against the JAX package's: the same history points fed into both
packages' HistoryStore give equal SloEngine.evaluate results (state,
level, burns, thresholds) through ok -> warn -> page -> ok, for the ratio
kind, for the per-tenant specs and the default specs; the reference's
NICE_TPU_SLO_* knobs equal the port's window_scale and overrides
arguments. Every comparison is exact: both packages compute the same
float expressions in the same order.
"""

import pytest

from nice_tpu.obs import series as jseries
from nice_tpu.obs import slo as jslo
from nice_tpu.obs.history import HistoryStore as JHistoryStore
from nice_tpu.parallel.mesh import OccupancyMeter as JOccupancyMeter
from nice_tpu_torch.obs import series, slo
from nice_tpu_torch.obs.history import HistoryStore
from nice_tpu_torch.parallel.mesh import OccupancyMeter

NOW = 3_000_000.0


def _stores():
    return (HistoryStore(tier1_secs=60.0, tier2_secs=900.0),
            JHistoryStore(tier1_secs=60.0, tier2_secs=900.0))


def _add(stores, series_name, value, ts):
    for store in stores:
        store.add(series_name, value, ts=ts)


def _quantile(mod, **kw):
    base = dict(name="t_claim_p99", kind="quantile", series_prefix="t_lat_p99",
                threshold=0.5, objective=0.10, short_secs=300, long_secs=3600)
    base.update(kw)
    return mod.SloSpec(**base)


def test_transitions_ok_warn_page_ok_equal_jax():
    """tests/test_history_slo.py's quantile walk, in both packages at once:
    no data, all good, a warn-level breach, a saturated page, recovery."""
    stores = _stores()
    eng = slo.SloEngine(stores[0], specs=[_quantile(slo)])
    jeng = jslo.SloEngine(stores[1], specs=[_quantile(jslo)])
    states = []

    def step(now):
        got, want = eng.evaluate(now=now), jeng.evaluate(now=now)
        assert got == want
        states.append(got[0]["state"])
        return got[0]

    assert step(NOW)["no_data"]
    for i in range(10):
        _add(stores, "t_lat_p99", 0.1, NOW - 200 + i * 10)
    step(NOW)
    _add(stores, "t_lat_p99", 0.9, NOW - 95)
    _add(stores, "t_lat_p99", 0.9, NOW - 90)
    assert step(NOW)["burn_short"] >= 1.0
    for i in range(40):
        _add(stores, "t_lat_p99", 2.0, NOW - 80 + i * 2)
    step(NOW)
    later = NOW + 3600 * 2
    for i in range(10):
        _add(stores, "t_lat_p99", 0.1, later - 100 + i * 10)
    step(later)
    assert states == ["ok", "ok", "warn", "page", "ok"]
    assert eng.transitions == jeng.transitions == 3
    assert eng.last() == jeng.last()


def test_ratio_kind_equals_jax():
    stores = _stores()
    for i, (tot, bad) in enumerate(((0, 0), (50, 2), (100, 10))):
        ts = NOW - 200 + i * 60
        _add(stores, 't_req{endpoint="/submit",status="200"}', tot - bad, ts)
        _add(stores, 't_req{endpoint="/submit",status="500"}', bad, ts)
    kw = dict(name="t_submit", kind="ratio", series_prefix="t_req",
              label_filter='endpoint="/submit',
              bad_filter=lambda s: 'status="5' in s, objective=0.01,
              short_secs=300, long_secs=3600)
    got = slo.SloSpec(**kw).evaluate(stores[0], NOW)
    assert got == jslo.SloSpec(**kw).evaluate(stores[1], NOW)
    assert got["burn_long"] == pytest.approx(10.0, rel=0.01)
    assert got["state"] == "page"


@pytest.mark.parametrize("bad,objective,state", [
    (0, None, "ok"), (3, None, "warn"), (10, 0.1, "page")])
def test_tenant_specs_equal_jax(monkeypatch, bad, objective, state):
    """tenant_specs over (name, budget) pairs (a budget of 0 or less gets
    no spec): the same specs, and on page seconds of which `bad` of 10 blow
    the budget the same evaluation. At the tenants' own objective (0.25)
    the burn tops out at 4, under page_burn, so the page case lowers it
    (the port's overrides, the reference's variable)."""
    overrides = {}
    if objective is not None:
        overrides["TENANT_CANON_OBJECTIVE"] = objective
        monkeypatch.setenv("NICE_TPU_SLO_TENANT_CANON_OBJECTIVE",
                           str(objective))
    pairs = [("canon", 0.5), ("mining", 0.0), ("nice", -1.0)]
    specs = slo.tenant_specs(pairs, overrides=overrides)
    jspecs = jslo.tenant_specs(pairs)
    keys = ("name", "kind", "series_prefix", "label_filter", "threshold",
            "objective", "short_secs", "long_secs", "warn_burn", "page_burn",
            "description")
    assert [[getattr(s, k) for k in keys] for s in specs] == \
        [[getattr(s, k) for k in keys] for s in jspecs]
    assert [s.name for s in specs] == ["tenant_canon"]
    stores = _stores()
    for i in range(10):
        _add(stores, 'nice_sched_page_seconds{tenant="canon"}',
             2.0 if i < bad else 0.1, NOW - i)
    got = slo.SloEngine(stores[0], specs).evaluate(now=NOW)
    assert got == jslo.SloEngine(stores[1], jspecs).evaluate(now=NOW)
    assert got[0]["state"] == state


def test_default_specs_equal_jax():
    stores = _stores()
    _add(stores, 'nice_api_request_seconds_p99{endpoint="/claim/detailed"}',
         0.9, NOW - 10)
    got = slo.SloEngine(stores[0]).evaluate(now=NOW)
    assert got == jslo.SloEngine(stores[1]).evaluate(now=NOW)
    assert {r["slo"] for r in got} == {"claim_p99", "submit_success",
                                       "feed_idle_p95", "spot_check_fail"}


def test_knob_arguments_equal_jax_environment(monkeypatch):
    """The port's window_scale and overrides arguments do what the
    reference's NICE_TPU_SLO_WINDOW_SCALE and NICE_TPU_SLO_<NAME>_THRESHOLD
    / _OBJECTIVE variables do."""
    monkeypatch.setenv("NICE_TPU_SLO_WINDOW_SCALE", "0.01")
    monkeypatch.setenv("NICE_TPU_SLO_TENANT_CANON_THRESHOLD", "1.5")
    monkeypatch.setenv("NICE_TPU_SLO_TENANT_CANON_OBJECTIVE", "0.5")
    overrides = {"TENANT_CANON_THRESHOLD": 1.5, "TENANT_CANON_OBJECTIVE": 0.5}
    specs = slo.tenant_specs([("canon", 0.5)], overrides=overrides)
    jspecs = jslo.tenant_specs([("canon", 0.5)])
    assert (specs[0].threshold, specs[0].objective) == \
        (jspecs[0].threshold, jspecs[0].objective) == (1.5, 0.5)
    stores = _stores()
    # The scaled windows (0.6 s, 3 s) hold 1 and 4 of the 10 points, all
    # but one of them bad: burns 2.0 and 1.5, warn; unscaled 0.3 / 0.5, ok.
    for i in range(10):
        _add(stores, 'nice_sched_page_seconds{tenant="canon"}',
             2.0 if i < 3 else 0.1, NOW - i)
    got = slo.SloEngine(stores[0], specs, window_scale=0.01).evaluate(now=NOW)
    assert got == jslo.SloEngine(stores[1], jspecs).evaluate(now=NOW)
    assert got[0]["state"] == "warn"
    assert slo.SloEngine(stores[0], specs).evaluate(now=NOW)[0]["state"] \
        == "ok"


def test_occupancy_meter_equals_jax():
    meters = (OccupancyMeter(), JOccupancyMeter())
    out = []
    for m in meters:
        assert m.occupancy(5.0) == 0.0
        m.start(10.0)
        m.add_busy("a", 2.0)
        m.add_busy("b", 6.0)
        m.add_busy("a", -1.0)  # ignored
        row = [m.busy_secs(), m.busy_secs("a"), m.wall_secs(20.0),
               m.occupancy(20.0), m.shares()]
        m.stop(26.0)
        row += [m.wall_secs(99.0), m.occupancy()]
        out.append(row)
    assert out[0] == out[1]
    assert out[0][3] == 0.8


def test_scheduler_and_slo_series_equal_jax():
    """The series the scheduler and the SLO engine emit carry the
    reference's names, kinds, labels and buckets."""
    for name in ("SCHED_PAGES", "SCHED_PAGE_SECONDS", "SCHED_PREEMPTIONS",
                 "SCHED_OCCUPANCY", "SCHED_MESH_OCCUPANCY", "SCHED_SLO_BURN",
                 "SCHED_STARVED", "SCHED_FIELDS", "SLO_STATE",
                 "SLO_TRANSITIONS"):
        got, want = getattr(series, name), getattr(jseries, name)
        assert (got.name, type(got).__name__, tuple(got.labelnames)) == \
            (want.name, type(want).__name__, tuple(want.labelnames))
        assert getattr(got, "buckets", None) == getattr(want, "buckets", None)
