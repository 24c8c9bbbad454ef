"""fpn_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the FPN: the program's `encoder` and `decoder` spans (the
decoder's with the ViT features' resize and add); over the traced window's
maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "fpn", "host_ms")
