"""Input-pipeline overlap benchmark on the host (counterpart of the repo's
tools/bench_input_pipeline.py): does the port's TrainLoader keep up with
the card's train step?

- generates a synthetic DTU scene set (data/synthetic.make_synthetic_dtu,
  full-size 1200 x 1600 Paeth-filtered PNGs by default, so decoding costs
  what a filtered file costs) in a temporary directory,
- iterates the port's TrainLoader over DTUTrainDataset at the DTU
  multi-scale training protocol,
- reports the producer's throughput (batches/s with no consumer), the
  consumer's stall at a simulated device step time, and the overlap
  efficiency.

    python -m mvsformerplusplus_tpu_torch.tools.bench_input_pipeline --step-ms 900 --steps 40

Prints one JSON line, the keys of the JAX package's tool. Host only: no
card is needed.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.loader import TrainLoader
from ..data.mvs_dataset import DTUTrainDataset
from ..data.synthetic import make_synthetic_dtu

# the DTU multi-scale protocol's crop scales (a representative subset)
SCALES = [(512, 640), (512, 704), (576, 768)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None, help="existing DTU-layout dir (default: synth tmp)")
    ap.add_argument("--h", type=int, default=1200)
    ap.add_argument("--w", type=int, default=1600)
    ap.add_argument("--scans", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--nviews", type=int, default=5)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--step-ms", type=float, default=900.0,
                    help="simulated device step time (the train step's ms per step)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark with the command line `argv`; prints and returns
    its JSON line."""
    args = parser().parse_args(argv)
    tmp = None
    if args.data is None:
        tmp = tempfile.TemporaryDirectory(prefix="ipbench_")
        root = Path(tmp.name) / "dtu"
        t0 = time.time()
        make_synthetic_dtu(root, n_scans=args.scans, n_lights=7, h=args.h, w=args.w)
        gen_s = time.time() - t0
    else:
        root, gen_s = Path(args.data), 0.0
    try:
        ds = DTUTrainDataset(str(root), str(root / "train.txt"), mode="train",
                             nviews=args.nviews, ndepths=192, random_crop=True, augment=True)
        loader = TrainLoader(ds, args.batch_size, SCALES, num_workers=args.num_workers, seed=0)

        def run(consumer_s: float, steps: int):
            """Iterate; returns (per-batch wait times, total wall)."""
            waits, n = [], 0
            t_start = time.time()
            it = loader.epoch(0)
            while n < steps:
                t0 = time.time()
                try:
                    next(it)
                except StopIteration:
                    it = loader.epoch(n)  # a new epoch to reach `steps`
                    continue
                waits.append(time.time() - t0)
                n += 1
                if consumer_s:
                    time.sleep(consumer_s)  # the simulated device step
            return waits, time.time() - t_start

        # the producer alone (the consumer never sleeps)
        _, wall0 = run(0.0, args.steps)
        producer_bps = args.steps / wall0
        # overlapped with the simulated device step
        step_s = args.step_ms / 1e3
        w1, _ = run(step_s, args.steps)
        stall = sum(max(0.0, t) for t in w1[1:])  # the first batch fills the pipeline
        ideal = step_s * (args.steps - 1)
        result = {
            "producer_batches_per_sec": round(producer_bps, 3),
            "producer_ms_per_batch": round(1e3 / producer_bps, 1),
            "consumer_step_ms": args.step_ms,
            "stall_ms_per_step": round(1e3 * stall / max(1, args.steps - 1), 2),
            "overlap_efficiency": round(ideal / (ideal + stall) if ideal else 1.0, 4),
            "keeps_up": bool(1e3 / producer_bps <= args.step_ms),
            "p95_wait_ms": round(1e3 * float(np.percentile(w1[1:] or w1, 95)), 1),
            "protocol": (f"B={args.batch_size} {args.nviews}views {args.h}x{args.w} raw, "
                         f"crops {SCALES}, {args.num_workers} workers"),
            "synth_gen_s": round(gen_s, 1),
        }
    finally:
        if tmp:
            tmp.cleanup()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
