"""cost_reg_device_ms.tt: `cost_reg_device_ms.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "cost_reg_device_ms.eval.py", "mvsbench_metric_cost_reg_device_ms.eval").read
