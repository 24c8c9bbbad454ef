"""fpn_device_ms.eval: device ms, the sum of the card's time between each
span's two events (idle time inside included), a map, in the FPN: the
program's `encoder` and `decoder` spans (the decoder's with the ViT
features' resize and add); over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "fpn", "device_ms")
