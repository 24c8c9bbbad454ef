"""heads_host_ms.eval: host ms, the sum of the spans' durations on the host
clock, a map, in the hypotheses and heads: the program's
`cascade.stage{k}.hypotheses`, `cascade.stage{k}.heads` and
`cascade.confidence` spans; over the traced window's maps (spans.py)."""
from mvsbench.spans import read_part


def read(run):
    return read_part(run, "heads", "host_ms")
