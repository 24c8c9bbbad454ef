"""Readings that a cell's output limits are set from, many seeds in one
process: the program's (a short window of the cell's own loop, its served
answers held to the reference, as a run does) and the control's (the
reference computed in float8 e4m3 in the program's place, the precision
below the configuration's bfloat16, on the same samples).

    python3 -m mvsbench.calibrate --workload <cell> --seeds 1,2,3 --side program|control
        [--seconds 3]

Prints one JSON line a seed with every number the cell compares. The
limits in limits/<workload>.json are set between the program's largest
reading and the control's smallest (PERF.md gives both).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, harness
from .harness import HERE
from .run import ROOT, Context


def control_eval(ctx) -> list:
    """The eval cell's numbers with the reference in float8 in the program's
    place, on the samples a run would check."""
    from .loops.eval import make_pool

    pool = make_pool(ctx.traffic, ctx.seed, ctx.device)
    indices = check.picked(ctx, len(pool))
    ctx.precision = "fp8"
    answers = check.reference_answers(ctx, pool, indices)
    ctx.precision = "fp32"
    return check.eval_answers(ctx, answers, pool, indices)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also append each line to this file")
    args = p.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(bench, cell, seed, args.seconds, False, device=args.device)
        ctx.limits = {}  # every number, not only those the cell compares
        if args.side == "program":
            loop = harness.load_module(HERE / "loops" / f"{ctx.traffic['loop']}.py",
                                       f"mvsbench.loops.{ctx.traffic['loop']}")
            out = loop.run(ctx)
            checks, extra = out["checks"], out["e2e"]
        else:
            checks, extra = control_eval(ctx), {}
        line = json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                           "numbers": {n: v for n, v, *_ in checks}, "e2e": extra,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
