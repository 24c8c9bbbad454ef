"""device_idle_pct.eval: the share of the traced window in which no kernel
or copy ran on the card: 1 - busy / window, busy being the union of the
trace's device intervals."""


def read(run):
    if run.kind != "eval" or run.trace is None or not run.trace["window_s"]:
        return None
    return 100 * (1 - run.trace["busy_s"] / run.trace["window_s"])
