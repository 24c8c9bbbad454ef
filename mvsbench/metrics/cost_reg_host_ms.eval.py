"""cost_reg_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the regularizers: the program's `cascade.stage{k}.cost_reg`
spans; over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "cost_reg", "host_ms")
