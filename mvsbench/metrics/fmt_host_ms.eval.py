"""fmt_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the FMT: the program's `fmt` span; over the traced window's
maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "fmt", "host_ms")
