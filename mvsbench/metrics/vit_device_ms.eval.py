"""vit_device_ms.eval: device ms, the sum of the card's time between each
span's two events (idle time inside included), a map, in the ViT: the
program's `vit` span (the cubic resize and the frozen DINOv2); over the
traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "vit", "device_ms")
