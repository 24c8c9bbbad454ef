"""kernel_roofline.tt: `kernel_roofline.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "kernel_roofline.eval.py", "mvsbench_metric_kernel_roofline.eval").read
