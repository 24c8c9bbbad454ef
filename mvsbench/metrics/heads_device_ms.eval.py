"""heads_device_ms.eval: device ms, the sum of the card's time between each
span's two events (idle time inside included), a map, in the hypotheses and
heads: the program's `cascade.stage{k}.hypotheses`, `cascade.stage{k}.heads`
and `cascade.confidence` spans; over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "heads", "device_ms")
