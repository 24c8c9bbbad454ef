"""volume_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the cost volumes: the program's `cascade.stage{k}.volume`
spans (warp, correlation, entropy, visibility, group mean); over the traced
window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "volume", "host_ms")
