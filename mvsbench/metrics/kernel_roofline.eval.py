"""kernel_roofline.eval: the least time the card needs for one map's calls
of attention, the convolutions and the warp (counts.least_times, from the
reference's calls at the cell's shapes), times the traced window's maps,
over the device time of every traced kernel that kernel_families.json maps
to those functions, hand-written or the library's."""
from mvsbench.counts import family_time, least_times

FUNCTIONS = ("attention", "conv", "warp")


def read(run):
    if run.kind != "eval" or not run.units or run.trace is None or not run.calls \
            or run.peaks is None:
        return None
    need = least_times(run.calls, run.dtype_bytes, run.peaks)
    fns = [f for f in FUNCTIONS if need.get(f)]
    spent = family_time(run.trace["kernels"], run.families, fns)
    if not spent:
        return None
    return 100 * sum(need[f] for f in fns) * run.units / spent
