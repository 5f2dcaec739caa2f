"""k1_roofline: K1's share of its roofline. The least time the card could
take for K1's work in the traced stretch, over K1's device time there (the
kernels named under benchport/kernels/k1/). The work is every number of the
stretch's fields times the multiplies one needs (opcount.py); the least time
is that over the card's 32-bit multiply-add peak (peaks.py). K1 reads no
input array and writes a histogram, so bytes do not bound it."""

from benchport import devtrace, manifest, opcount, peaks

LAYER = "K1 kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "numbers_per_s"


def read(run):
    st = run.stretch
    peak = peaks.int32_mad_per_s(run.card) if run.card else None
    if not st or not st["numbers"] or not peak:
        return None
    secs = devtrace.group_seconds(st, manifest.kernel_names("k1", run.cell.root))
    if not secs:
        return None
    work = st["numbers"] * opcount.detailed_multiplies(int(run.config["base"]))
    return 100.0 * work / peak / secs
