"""device_idle_pct.tt: `device_idle_pct.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "device_idle_pct.eval.py", "mvsbench_metric_device_idle_pct.eval").read
