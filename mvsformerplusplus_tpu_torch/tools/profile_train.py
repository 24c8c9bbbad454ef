"""Device time of the bench's train step by kernel and by category, on the
card (counterpart of the trace mode of the repo's tools/profile_train.py,
which traces the JAX package on a TPU).

    python -m mvsformerplusplus_tpu_torch.tools.profile_train [--no-remat] [--granularity stage|cost_reg] [--top N] [--outdir DIR]

Builds the bench's train model, optimizer and batch
(mvsformerplusplus_tpu_torch.bench: B=2, 5 views, 512x640, 192 depths,
bf16, frozen ViT, weights from a seed) with the cascade's remat at
`--granularity` ("stage", as the JAX tool's default; the bench trains at
"cost_reg") or off (`--no-remat`), times a first step and a steady one on
the host clock, then traces one more in a CUDA-only torch.profiler window
and prints what tools/profile_eval.py prints, per step. CUDA only:
without a card it raises.
"""
from __future__ import annotations

import sys

import torch

from .. import bench
from ..train.optim import make_optimizer
from ..train.step import train_step
from .profile_eval import parser, report, trace_file, traced


def profile_train(model, opt, sched, batch, trace_path=None) -> dict:
    """traced() over train steps of `model` (training in place) on `batch`
    (on the card)."""
    prof = traced(lambda: train_step(model, opt, sched, batch), trace_path)
    logs = prof.pop("result")
    prof["finite"] = all(bool(torch.isfinite(v).all()) for k, v in logs.items()
                         if k in ("loss", "grad_norm") or k.startswith("stage"))
    return prof


def main(argv=None) -> int:
    from ..train.trainer import to_device

    ap = parser(__doc__)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--granularity", default="stage", choices=["stage", "cost_reg"])
    args = ap.parse_args(argv)
    device = bench.check_device("cuda")
    model = bench.build(True, device=device, remat_stages=not args.no_remat,
                        remat_granularity=args.granularity)
    opt, sched = make_optimizer(model, **bench.OPT_ARGS)
    batch = to_device(bench.make_train_batch(), device)
    prof = profile_train(model, opt, sched, batch, trace_file(args.outdir, "profile_train"))
    print(f"remat={not args.no_remat}, granularity={args.granularity}")
    report(prof, args.top, "step")
    return 0 if prof["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
