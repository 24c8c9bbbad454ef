"""mfu_pct.tt: `mfu_pct.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "mfu_pct.eval.py", "mvsbench_metric_mfu_pct.eval").read
