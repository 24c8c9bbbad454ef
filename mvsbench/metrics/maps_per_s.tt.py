"""maps_per_s.tt: maps completed in the window over its time (its start to
the last map's arrival on the host), as `maps_per_s` is taken in the cells
that bound it; here read in the traced run."""


def read(run):
    if run.kind != "eval" or not run.units or not run.window_s:
        return None
    return run.units / run.window_s
