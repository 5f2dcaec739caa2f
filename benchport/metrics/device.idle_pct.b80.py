"""device.idle_pct.b80: device.idle_pct in the cells whose rate is
numbers_per_s.b80, the end-to-end metric it moves there."""

from benchport import manifest

_SAME = manifest.load_reader("device.idle_pct")
LAYER = _SAME.LAYER
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
MOVES = "numbers_per_s.b80"
read = _SAME.read
