"""rare.k2_launches_per_field: K2 launches (cuda_engine.LAUNCHES["uniques"])
over the window, per field: the rare path's re-scans."""

LAYER = "rare path"
UNIT = "launches"
SOURCE = "program_counter"
MOVES = "numbers_per_s"


def read(run):
    if not run.fields:
        return None
    return run.launches.get("uniques", 0) / len(run.fields)
