"""sva_device_ms.eval: device ms, the sum of the card's time between each
span's two events (idle time inside included), a map, in the SVA decoder:
the program's `decoder_vit` span (the cross-view ViT decoder); over the
traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "sva", "device_ms")
