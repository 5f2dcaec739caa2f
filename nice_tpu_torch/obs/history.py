"""Time-series history: ring-buffer recorder over the metrics registry (the
port's copy of nice_tpu/obs/history.py; its sampling interval, tier widths
and caps are arguments, the sampling interval the client's --history-secs,
default 15).

* ``TieredSeries`` — one metric series' history in three fixed-capacity
  downsampling tiers: ``raw`` (every sample), ``1m`` (60 s buckets) and
  ``15m`` (900 s buckets). Coarse tiers keep (bucket_ts, mean, min, max,
  last, n) and are finalized on bucket rollover; queries also include the
  in-progress bucket so short runs still produce multi-tier data.
* ``HistoryStore`` — {series name -> TieredSeries}, fed by
  ``sample_registries()``: counters/gauges become one series per label
  combination plus an aggregate sum; histograms become ``_sum``/``_count``
  aggregates plus *windowed* p50/p95/p99 series derived from bucket-count
  deltas between consecutive samples.
* ``handle_query()`` — ``GET /history`` on the local metrics port
  (obs/serve.py): JSON bodies, real JSON 404s for unknown series, and a
  directory listing when no ``series`` is given.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as metrics_mod

log = logging.getLogger("nice_tpu_torch.obs")

__all__ = [
    "TieredSeries",
    "HistoryStore",
    "STORE",
    "handle_query",
    "maybe_start_sampler",
    "reset",
]

TIERS = ("raw", "1m", "15m")

# The sampling cadence (the client's --history-secs; 0 = no sampler), the
# coarse tiers' bucket widths and the per-tier point capacities: ~1 h of raw
# at 15 s, ~6 h of 1-min, ~7 d of 15-min (the reference's defaults). All
# three are small fixed rings: a process that runs forever holds a bounded
# history.
DEFAULT_INTERVAL_SECS = 15.0
TIER1_SECS = 60.0
TIER2_SECS = 900.0
RAW_CAP = 240
TIER1_CAP = 360
TIER2_CAP = 672

QUANTILES = ((50, 0.50), (95, 0.95), (99, 0.99))


class _CoarseTier:
    """One downsampling tier: an in-progress aggregate bucket plus a ring of
    finalized (bucket_ts, mean, min, max, last, n) points."""

    __slots__ = ("secs", "points", "cur_ts", "sum", "min", "max", "last", "n")

    def __init__(self, secs: float, cap: int):
        self.secs = secs
        self.points: collections.deque = collections.deque(maxlen=cap)
        self.cur_ts: Optional[float] = None
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        self.last = 0.0
        self.n = 0

    def _bucket(self, ts: float) -> float:
        return ts - (ts % self.secs)

    def add(self, ts: float, value: float) -> None:
        """Fold a sample in, finalizing the bucket on rollover."""
        b = self._bucket(ts)
        if self.cur_ts is not None and b != self.cur_ts:
            self._finalize()
        if self.cur_ts is None:
            self.cur_ts = b
            self.sum = self.min = self.max = self.last = value
            self.n = 1
        else:
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            self.last = value
            self.n += 1

    def _finalize(self) -> None:
        self.points.append((self.cur_ts, self.sum / self.n, self.min,
                            self.max, self.last, self.n))
        self.cur_ts = None
        self.n = 0

    def snapshot(self, since: float) -> List[list]:
        out = [list(p) for p in self.points if p[0] >= since]
        if self.n > 0 and self.cur_ts is not None and self.cur_ts >= since:
            out.append([self.cur_ts, self.sum / self.n, self.min, self.max,
                        self.last, self.n])
        return out


class TieredSeries:
    """One series' raw ring + 1m/15m downsampling tiers. Not thread-safe on
    its own — HistoryStore serializes access."""

    __slots__ = ("raw", "t1", "t2", "last_ts")

    def __init__(self, tier1_secs: float, tier2_secs: float,
                 caps: Tuple[int, int, int] = (RAW_CAP, TIER1_CAP, TIER2_CAP)):
        self.raw: collections.deque = collections.deque(maxlen=caps[0])
        self.t1 = _CoarseTier(tier1_secs, caps[1])
        self.t2 = _CoarseTier(tier2_secs, caps[2])
        self.last_ts = 0.0

    def add(self, ts: float, value: float) -> None:
        """Record one sample in every tier."""
        self.raw.append((ts, value))
        self.last_ts = ts
        self.t1.add(ts, value)
        self.t2.add(ts, value)

    def snapshot(self, since: float, tiers: Sequence[str]) -> Dict[str, list]:
        out: Dict[str, list] = {}
        if "raw" in tiers:
            out["raw"] = [[t, v] for t, v in self.raw if t >= since]
        if "1m" in tiers:
            out["1m"] = self.t1.snapshot(since)
        if "15m" in tiers:
            out["15m"] = self.t2.snapshot(since)
        return out


def _series_key(name: str, labelnames, key) -> str:
    if not key:
        return name
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, key))
    return f"{name}{{{inner}}}"


def _quantile_from_deltas(bounds, deltas, overflow, q):
    """Linear-interpolated quantile from non-cumulative bucket deltas. The
    overflow (+Inf) bucket clamps to the highest finite bound."""
    total = sum(deltas) + overflow
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for b, d in zip(bounds, deltas):
        if d > 0:
            if cum + d >= rank:
                frac = (rank - cum) / d
                return lo + (b - lo) * frac
            cum += d
        lo = b
    return bounds[-1] if bounds else 0.0


class HistoryStore:
    """Bounded in-memory history for every sampled series.

    One instance per process role: the module-global ``STORE`` backs the
    client metrics port; the server builds its own over both the global
    registry and its private API-latency registry.
    """

    def __init__(self, tier1_secs: float = TIER1_SECS,
                 tier2_secs: float = TIER2_SECS, raw_cap: int = RAW_CAP,
                 tier1_cap: int = TIER1_CAP, tier2_cap: int = TIER2_CAP):
        self._t1 = max(float(tier1_secs), 1e-6)
        self._t2 = max(float(tier2_secs), 1e-6)
        self._caps = (int(raw_cap), int(tier1_cap), int(tier2_cap))
        self._lock = threading.Lock()
        self._series: Dict[str, TieredSeries] = {}
        # Previous histogram bucket snapshots, for windowed quantiles.
        self._hist_prev: Dict[str, Tuple[Tuple[int, ...], float, int]] = {}
        self.samples_taken = 0

    # -- recording ---------------------------------------------------------

    def add(self, series: str, value: float, ts: Optional[float] = None):
        ts = time.time() if ts is None else ts
        value = float(value)
        with self._lock:
            s = self._series.get(series)
            if s is None:
                s = self._series[series] = TieredSeries(self._t1, self._t2,
                                                         self._caps)
            s.add(ts, value)

    def sample_registries(self, registries, ts: Optional[float] = None) -> int:
        """Walk every metric in the given registries and record one sample
        per derived series. Returns the number of points recorded."""
        ts = time.time() if ts is None else ts
        n = 0
        for reg in registries:
            for name, m in sorted(reg.metrics().items()):
                if isinstance(m, metrics_mod.Histogram):
                    n += self._sample_histogram(name, m, ts)
                elif isinstance(m, (metrics_mod.Counter, metrics_mod.Gauge)):
                    values = m.values()
                    for key, v in values.items():
                        self.add(_series_key(name, m.labelnames, key), v, ts)
                        n += 1
                    if m.labelnames and len(values) > 1:
                        self.add(name, sum(values.values()), ts)
                        n += 1
        self.samples_taken += 1
        return n

    def _sample_histogram(self, name, m, ts) -> int:
        n = 0
        snap = m.bucket_counts()
        agg_sum = 0.0
        agg_count = 0
        for key, (counts, total, count) in snap.items():
            agg_sum += total
            agg_count += count
            skey = _series_key("", m.labelnames, key)  # "{...}" or ""
            prev = self._hist_prev.get(name + skey)
            self._hist_prev[name + skey] = (counts, total, count)
            if prev is None:
                continue
            pc, _ps, pn = prev
            deltas = [c - p for c, p in zip(counts, pc)]
            overflow = (count - sum(counts)) - (pn - sum(pc))
            if count - pn <= 0:
                continue  # nothing observed this window
            for pname, q in QUANTILES:
                qv = _quantile_from_deltas(m.buckets, deltas, overflow, q)
                if qv is not None:
                    self.add(f"{name}_p{pname}{skey}", qv, ts)
                    n += 1
        self.add(f"{name}_sum", agg_sum, ts)
        self.add(f"{name}_count", agg_count, ts)
        return n + 2

    # -- reading -----------------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, series: str, since: float = 0.0,
              tiers: Sequence[str] = TIERS) -> Optional[Dict[str, list]]:
        with self._lock:
            s = self._series.get(series)
            if s is None:
                return None
            return s.snapshot(since, tiers)



STORE = HistoryStore()

_sampler_lock = threading.Lock()
_sampler_started = False


def maybe_start_sampler(interval: float = DEFAULT_INTERVAL_SECS,
                        registries=None,
                        store: Optional[HistoryStore] = None) -> bool:
    """Start the background sampling thread once per process. Returns True
    when the sampler is running; interval <= 0 creates no thread. The
    sampler reads the registry alone: no torch call, no ctypes call."""
    global _sampler_started
    if not interval or interval <= 0:
        return False
    with _sampler_lock:
        if _sampler_started:
            return True
        _sampler_started = True
    regs = registries if registries is not None else [metrics_mod.REGISTRY]
    st = store if store is not None else STORE

    def _run():
        while True:
            time.sleep(interval)
            try:
                st.sample_registries(regs)
            except Exception:  # noqa: BLE001 — sampling must never crash
                log.exception("history sample failed")

    threading.Thread(target=_run, name="nice-history", daemon=True).start()
    return True


def reset() -> None:
    """A fresh STORE of the default tiers (tests; NOT the started-thread
    guard, whose thread keeps the store it was given)."""
    global STORE
    STORE = HistoryStore()


# -- shared GET /history handler ------------------------------------------


def _split_series_list(raw: str) -> List[str]:
    """Split a comma-separated series list WITHOUT breaking label sets:
    ``a{x="1",y="2"},b`` is two names — commas inside ``{...}`` belong to
    the name itself."""
    out, cur, depth = [], [], 0
    for ch in raw:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [s for s in (x.strip() for x in out) if s]


def handle_query(store: HistoryStore, query_string: str):
    """Shared ``GET /history`` implementation: returns (status, body-dict).

    ``?series=a,b`` selects series (exact names, URL-encoded; commas inside
    ``{...}`` label sets are part of the name); ``?since=TS``
    filters points at-or-after a Unix timestamp; ``?tier=raw|1m|15m`` limits
    tiers. No ``series`` returns the directory of known names. Unknown
    series get a real 404 JSON body naming a sample of known series.
    """
    qs = urllib.parse.parse_qs(query_string or "")
    wanted = []
    for part in qs.get("series", []):
        wanted.extend(_split_series_list(part))
    if not wanted:
        names = store.series_names()
        return 200, {"series": names, "count": len(names)}
    try:
        since = float(qs.get("since", ["0"])[0])
    except ValueError:
        return 400, {"error": "since must be a unix timestamp"}
    tiers: Sequence[str] = TIERS
    if "tier" in qs:
        tiers = tuple(t for t in qs["tier"][0].split(",") if t in TIERS)
        if not tiers:
            return 400, {"error": f"tier must be one of {list(TIERS)}"}
    out: Dict[str, Dict[str, list]] = {}
    missing = []
    for name in wanted:
        snap = store.query(name, since=since, tiers=tiers)
        if snap is None:
            missing.append(name)
        else:
            out[name] = snap
    if missing:
        known = store.series_names()
        return 404, {
            "error": f"unknown series: {', '.join(missing)}",
            "unknown": missing,
            "known_sample": known[:50],
            "known_count": len(known),
        }
    return 200, {"series": out, "since": since, "tiers": list(tiers)}
