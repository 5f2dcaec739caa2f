"""Reading a torch.profiler capture of the traced stretch of a window.

The harness wraps the stretch in a record_function range STRETCH and each
field in FIELD. From the capture's events this takes:

  * the stretch's bounds, from its STRETCH range, in the trace's clock;
  * every device record (kernels, copies, sets) inside them, its time
    summed by kernel symbol, and the busy time: the union of the records'
    intervals, clipped to the stretch (the device-side copies of the
    harness's own ranges, which torch records as annotations, are not
    device work and are left out);
  * the idle gaps, the stretch less the busy union, the longest of them
    named by what the host was doing: the innermost host range (a torch op
    or one of the harness's ranges) around the gap's middle.
"""

from __future__ import annotations

import bisect
import re

STRETCH = "benchport.stretch"
FIELD = "benchport.field"
HOST_LABELS = {STRETCH: "harness, between fields",
               FIELD: "process_field, outside any torch op"}
TOP = 10

_SYMBOL = re.compile(r"([A-Za-z_]\w*)\s*(?:<|\(|$)")


def symbol(name: str) -> str:
    """The function's own name in a demangled kernel name:
    'void nice::k<nice::T>(long const*)' -> 'k'."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)", "anonymous")
    head = name.split("(", 1)[0].split("<", 1)[0]
    head = head.split()[-1] if head.split() else head
    m = _SYMBOL.search(head.rsplit("::", 1)[-1])
    return m.group(1) if m else name


def _is_device(event) -> bool:
    return getattr(event.device_type, "name", str(event.device_type)) == "CUDA"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict | None:
    """{"window_s", "busy_s", "kernels": {symbol: [records, seconds]},
    "device_ops", "idle_gaps"} of a capture, or None where it holds no
    stretch or no device record."""
    events = list(events)
    bounds = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == STRETCH and not _is_device(e)]
    if not bounds:
        return None
    w0, w1 = bounds[0]
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1 or t < s or (_is_device(e)
                                            and e.name in HOST_LABELS):
            continue
        (device if _is_device(e) else host).append((max(s, w0), min(t, w1), e.name))
    if not device:
        return None
    kernels: dict = {}
    for s, t, name in device:
        k = kernels.setdefault(symbol(name), [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e6
    busy = _union((s, t) for s, t, _ in device)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, s, t in gaps[:TOP]:
        mid = (s + t) / 2
        inner = [h for h in host[:bisect.bisect_right(starts, mid)]
                 if h[1] >= mid]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else None
        idle.append([HOST_LABELS.get(name, name or "no host range"),
                     length / 1e6])
    ops = sorted(([k, v[1]] for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "kernels": kernels, "device_ops": ops, "idle_gaps": idle}


def group_seconds(stretch: dict, names: list[dict]) -> float | None:
    """Device seconds of a group of kernels (manifest.kernel_names) in the
    traced stretch: the mean of the records the profiler kept, times the
    launches the program counted there (the profiler now and then loses a
    record). 0.0 where the program launched none of them; None where it
    launched some and the profiler kept no record."""
    summary = stretch.get("summary") or {}
    kernels = summary.get("kernels", {})
    records = secs = 0
    for s in {n["kernel"] for n in names}:
        count, seconds = kernels.get(s, (0, 0.0))
        records += count
        secs += seconds
    launches = sum(stretch["launches"].get(c, 0)
                   for c in {n["launches"] for n in names})
    if launches == 0:
        return 0.0
    if records == 0:
        return None
    return secs / records * launches
