"""vit_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the ViT: the program's `vit` span (the cubic resize and the
frozen DINOv2); over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "vit", "host_ms")
