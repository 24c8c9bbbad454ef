"""launches.eval: device kernels launched a map (every kernel of the
traced window, copies and fills by the copy engine aside), over the window's
maps."""


def read(run):
    if run.kind != "eval" or not run.units or run.trace is None:
        return None
    return run.trace["launches"] / run.units
