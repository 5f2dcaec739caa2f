"""engine.ends_ms_per_field: the engine's host work at a field's ends, while
the card has nothing of the field queued: its engine.setup step (tuning,
slivers, rings, threads, to the loop's first get) plus its engine.finish
step (the collector's join to the return), from the program's field
records (fieldrecords.py), mean over the window's recorded fields."""

from benchport import fieldrecords

LAYER = "engine host loop"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "numbers_per_s"
NEEDS = ("engine.setup", "engine.finish")


def read(run):
    return fieldrecords.mean_ms(
        run, lambda r: sum(fieldrecords.seconds(r, n) for n in NEEDS), NEEDS)
