"""setup_s: the process's start to the window's start: torch's import, the
libraries' build or load, the warm field (host clock)."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
