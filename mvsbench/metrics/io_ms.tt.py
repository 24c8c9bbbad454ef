"""io_ms.tt: `io_ms.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "io_ms.eval.py", "mvsbench_metric_io_ms.eval").read
