"""io_ms.eval: ms a map spent moving a map's data: the host-clock span of
its uploads (pageable copies, which the host waits for) and the device time
of its result's copies back to the host, over the traced window's maps."""


def read(run):
    if run.kind != "eval" or not run.units or run.trace is None:
        return None
    d2h = sum(s for name, (s, _) in run.trace["kernels"].items() if name.startswith("Memcpy DtoH"))
    return 1e3 * (run.span_s("upload") + d2h) / run.units
