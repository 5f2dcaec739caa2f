"""feed.gap_ms_per_field: the engine host loop's gaps between dispatches,
engine.LAST_FEED_STATS["idle_total"] read after every field of the window,
summed, per field."""

LAYER = "engine host loop"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "numbers_per_s"


def read(run):
    if not run.fields:
        return None
    return 1e3 * sum(f.feed_idle_s for f in run.fields) / len(run.fields)
