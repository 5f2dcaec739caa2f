"""client.self_ms_per_field: the client's own time a field, its
client.process_field span less the engine.detailed span inside it (the
program's field records, fieldrecords.py), mean over the window's recorded
fields."""

from benchport import fieldrecords

LAYER = "client"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "numbers_per_s"
NEEDS = ("client.process_field", "engine.detailed")


def read(run):
    return fieldrecords.mean_ms(
        run, lambda r: (fieldrecords.seconds(r, NEEDS[0])
                        - fieldrecords.seconds(r, NEEDS[1])), NEEDS)
