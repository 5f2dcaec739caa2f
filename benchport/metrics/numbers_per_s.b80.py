"""numbers_per_s.b80: numbers_per_s in the cells whose card paces the whole
field (K1 on its plan tier, about 0.29 ms a launch), where the host's load moves
the rate little, so that it takes a bound of its own."""

from benchport import manifest

_SAME = manifest.load_reader("numbers_per_s")
UNIT = _SAME.UNIT
SOURCE = _SAME.SOURCE
read = _SAME.read
