"""engine.ends_ms_per_field.b80: engine.ends_ms_per_field in the cells whose
rate is numbers_per_s.b80, the end-to-end metric it moves there."""

from benchport import manifest

_SAME = manifest.load_reader("engine.ends_ms_per_field")
LAYER = _SAME.LAYER
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
MOVES = "numbers_per_s.b80"
read = _SAME.read
