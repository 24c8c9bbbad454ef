"""map_ms_p90.eval: the 90th percentile of every map's latency in the
window (its arrays handed to the upload -> its depth and confidence on the
host; with one map in flight it spans about two maps), where the window
holds the mix's `p90_min_maps` or more, so that a tenth of them lie beyond
it."""
import statistics


def read(run):
    if run.kind != "eval" or len(run.latencies) < max(run.tail_min, 2):
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=10, method="inclusive")[-1]
