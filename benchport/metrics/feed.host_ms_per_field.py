"""feed.host_ms_per_field: the dispatcher's host time a field, its
engine.loop step less its blocked waits on the card (feed.ring_wait: an
upload waiting for its ring slot's copy; feed.handoff: a hand-off waiting
on a full collector queue), from the program's field records
(fieldrecords.py), mean over the window's recorded fields."""

from benchport import fieldrecords

LAYER = "engine host loop"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "numbers_per_s"
WAITS = ("feed.ring_wait", "feed.handoff")


def read(run):
    return fieldrecords.mean_ms(
        run, lambda r: (fieldrecords.seconds(r, "engine.loop")
                        - sum(fieldrecords.seconds(r, n) for n in WAITS)),
        ("engine.loop",))
