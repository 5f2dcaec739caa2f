"""rare.device_ms_per_field: K2's device time (the kernels named under
benchport/kernels/k2/) in the traced stretch, per field of the stretch."""

from benchport import devtrace, manifest

LAYER = "rare path"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "numbers_per_s"


def read(run):
    st = run.stretch
    if not st or not st["fields"]:
        return None
    secs = devtrace.group_seconds(st, manifest.kernel_names("k2", run.cell.root))
    return None if secs is None else 1e3 * secs / st["fields"]
