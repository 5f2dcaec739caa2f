"""device.idle_pct: the share of the traced stretch in which no operation
ran on the card (torch.profiler's device records)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "numbers_per_s"


def read(run):
    summary = (run.stretch or {}).get("summary")
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
