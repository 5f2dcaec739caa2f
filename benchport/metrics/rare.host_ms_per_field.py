"""rare.host_ms_per_field: the rare path's time a field on the collector,
its rare.scan spans (K2's re-scan of a near-miss segment, its copies
waited for) summed over the window's recorded fields and divided by them
(a field without a near miss counts 0), from the program's field records
(fieldrecords.py)."""

from benchport import fieldrecords

LAYER = "rare path"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "numbers_per_s"


def read(run):
    return fieldrecords.mean_ms(
        run, lambda r: fieldrecords.seconds(r, "rare.scan"),
        ("engine.detailed",))
