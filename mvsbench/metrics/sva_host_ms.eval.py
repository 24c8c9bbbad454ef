"""sva_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the SVA decoder: the program's `decoder_vit` span (the
cross-view ViT decoder); over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "sva", "host_ms")
