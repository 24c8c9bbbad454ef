"""launches.tt: `launches.eval`'s reading (see that file), in the cells whose
rate is read per layer."""
from mvsbench.harness import HERE, load_module

read = load_module(HERE / "metrics" / "launches.eval.py", "mvsbench_metric_launches.eval").read
