"""setup.libraries_s: the process's wall seconds in building or loading the
kernel libraries (the main library's load and each per-base library's,
nvcc's time included, not a cached return: fieldrecords.library_seconds),
part of setup_s."""

from benchport import fieldrecords

LAYER = "build"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(run):
    return fieldrecords.library_seconds()
