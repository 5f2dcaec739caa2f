"""k1_roofline.b80: k1_roofline in the cells whose rate is
numbers_per_s.b80, the end-to-end metric it moves there."""

from benchport import manifest

_SAME = manifest.load_reader("k1_roofline")
LAYER = _SAME.LAYER
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
MOVES = "numbers_per_s.b80"
read = _SAME.read
