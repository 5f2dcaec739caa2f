"""numbers_per_s: every number of the fields completed in the window over
the time from the window's start to the last completion (host clock)."""

UNIT = "numbers/s"
SOURCE = "host_clock"


def read(run):
    if not run.fields:
        return None
    return run.numbers() / run.fields[-1].done_s
