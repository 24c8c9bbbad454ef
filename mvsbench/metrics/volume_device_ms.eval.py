"""volume_device_ms.eval: device ms, the sum of the card's time between each
span's two events (idle time inside included), a map, in the cost volumes:
the program's `cascade.stage{k}.volume` spans (warp, correlation, entropy,
visibility, group mean); over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "volume", "device_ms")
