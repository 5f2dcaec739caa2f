"""The client side of the critical-path profiler (the port's copy of
SEGMENTS, _PHASE_FOLD and phase_shares from nice_tpu/obs/critpath.py).

phase_shares folds a device-step profiler table (obs/stepprof.py's
cumulative() shape) into the critical-path segments, each segment's share
of the summed wall clock and the dominant one: the bench's per-case and
whole-suite ``critpath`` blocks, which the regression gate diffs between a
fresh run and a committed record (scripts/perf_gate.py).

stepprof's ``compile`` bucket folds into ``device_compute`` (both are
device-side work) and ``fold`` into ``readback`` (both are device->host
transfers); ``host_other`` is by definition unattributed and lands in
``unaccounted``. The rest of the reference module (the per-field waterfall
over the server's journal, the fleet rollup, GET /critpath) stays the JAX
package's, as the server does.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["SEGMENTS", "phase_shares"]

# Segment taxonomy, in causal order (the reference's, so that the two
# packages' summaries compare key for key).
SEGMENTS = (
    "queue_wait",       # generated/queued -> claimed (sat in the pool)
    "claim_rtt",        # client-measured /claim round-trip
    "ckpt_resume",      # checkpoint load + fast-forward replay
    "h2d_feed",         # host->device feed stalls (stepprof h2d_feed)
    "device_compute",   # device execution incl. compile (stepprof)
    "readback",         # device->host folds + readbacks (stepprof)
    "spool_retry",      # offline spool replay delay
    "submit_rtt",       # client-measured /submit round-trip (minus writer wait)
    "writer_wait",      # writer-actor queue wait, claim + submit ops
    "canon_promotion",  # submit_accepted -> canon_promoted (trust path)
    "unaccounted",      # positive residual — visible, never hidden
)

# stepprof phase -> segment fold (see the module docstring).
_PHASE_FOLD = {
    "h2d_feed": "h2d_feed",
    "device_compute": "device_compute",
    "compile": "device_compute",
    "fold": "readback",
    "readback": "readback",
}


def phase_shares(prof: dict) -> Optional[dict]:
    """Critpath summary of a stepprof phase table (the bench's per-case and
    whole-suite breakdowns): fold the profiler's phase buckets into critpath
    segments, compute each segment's share of the summed wall clock, and name
    the dominant one. prof is stepprof.cumulative() shaped —
    {"mode|b<base>|backend": {phase: secs, "wall": secs, ...}}. Returns None
    when the table carries no wall time (profiler off / nothing ran)."""
    wall = 0.0
    totals = {s: 0.0 for s in SEGMENTS}
    for entry in prof.values():
        if not isinstance(entry, dict):
            continue
        try:
            wall += max(0.0, float(entry.get("wall", 0.0) or 0.0))
        except (TypeError, ValueError):
            continue
        for phase, target in _PHASE_FOLD.items():
            try:
                totals[target] += max(0.0, float(entry.get(phase, 0.0) or 0.0))
            except (TypeError, ValueError):
                pass
    if wall <= 0.0:
        return None
    attributed = sum(totals.values())
    totals["unaccounted"] = max(0.0, wall - attributed)
    shares = {
        s: round(totals[s] / wall, 6) for s in SEGMENTS if totals[s] > 0.0
    }
    dominant = max(shares, key=shares.get) if shares else None
    return {
        "wall_secs": round(wall, 6),
        "shares": shares,
        "dominant": dominant,
    }
