"""The plain reference against the port at tiny widths on the CPU (float32,
the port's plain versions): the same parameter names and shapes, so one
seed draws the same weights into both; the same eval forward; and the
float8 control far from both."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mvsbench import scene, weights
from mvsbench.reference import model as ref_model
from mvsbench.reference import ops as ref_ops
from mvsbench.tests.tiny import TINY_ARGS, tiny_config

from mvsformerplusplus_tpu_torch.config import Config, build_model  # noqa: E402

SEED = 2**31 + 5


def _inputs(views=3, h=64, w=128, seed=SEED, b=1):
    traffic = dict(views=views, height=h, width=w, ndepths=48, depth_min=425.0,
                   depth_interval=10.0, interval_scale=1.06, rig="dtu", texture=64)
    rows = [scene.sample(traffic, torch.Generator().manual_seed(seed + i), "cpu")
            for i in range(b)]
    imgs = torch.stack([r["imgs"] for r in rows])
    cams = {f"stage{k + 1}": torch.stack([r["cams"][k] for r in rows]) for k in range(4)}
    dv = torch.stack([r["depth_values"] for r in rows])
    depth = torch.stack([r["depth"][0] for r in rows])
    return imgs, cams, dv, depth


def _pair(args):
    cfg = tiny_config()["config"]
    cfg["arch"]["args"] = {**cfg["arch"]["args"], **args}
    port = build_model(Config(cfg), dtype=torch.float32, device="cpu")
    ref = ref_model.build(cfg["arch"]["args"]).eval()
    weights.draw_(port, SEED)
    weights.draw_(ref, SEED)
    return port, ref


# the flagship as configured, and with a 3D U-Net at every stage in place of
# the CTA (the stages' other regularizer)
NORMAL_ARGS = dict(cost_reg_type=["Normal"] * 4, use_pe3d=False)


@pytest.mark.parametrize("args", [{}, NORMAL_ARGS], ids=["mvsformerpp", "unet_stages"])
def test_same_parameters(args):
    port, ref = _pair(args)
    want = {n: tuple(p.shape) for n, p in port.state_dict().items()}
    assert {n: tuple(p.shape) for n, p in ref.state_dict().items()} == want
    for (n, p), (m, r) in zip(sorted(port.named_parameters()), sorted(ref.named_parameters())):
        assert n == m and torch.equal(p, r)


@pytest.mark.parametrize("args", [{}, NORMAL_ARGS], ids=["mvsformerpp", "unet_stages"])
def test_eval_forward(args):
    port, ref = _pair(args)
    imgs, cams, dv, _ = _inputs()
    with torch.no_grad():
        a = port(imgs, cams, dv)
        b = ref(imgs, cams, dv)
    itv = float(dv[0, 1] - dv[0, 0])
    assert (a["refined_depth"] - b["refined_depth"]).abs().mean() / itv < 1e-3
    assert (a["photometric_confidence"] - b["photometric_confidence"]).abs().max() < 1e-4
    assert (a["stage4"]["photometric_confidence"]
            - b["stage4"]["photometric_confidence"]).abs().max() < 1e-4


def test_control_reads_far_off():
    """At the same inputs the float8 reference's depth is many times further
    from the float32 reference's than the port's is."""
    port, ref = _pair({})
    imgs, cams, dv, _ = _inputs()
    itv = float(dv[0, 1] - dv[0, 0])
    with torch.no_grad():
        want = ref(imgs, cams, dv)["refined_depth"]
        got = port(imgs, cams, dv)["refined_depth"]
        ref_ops.PRECISION["mode"] = "fp8"
        try:
            low = ref(imgs, cams, dv)["refined_depth"]
        finally:
            ref_ops.PRECISION["mode"] = "fp32"
    port_gap = float((got - want).abs().mean()) / itv
    control_gap = float((low - want).abs().mean()) / itv
    assert control_gap > 100 * port_gap
    assert np.isfinite(control_gap)


def _tiny_ctx(mix: str):
    import json

    from mvsbench.run import Context
    from mvsbench.tests.tiny import HARNESS, TINY_MIX

    ctx = Context.__new__(Context)
    ctx.config = tiny_config()
    ctx.traffic = {**json.loads((HARNESS / "traffic" / f"{mix}.json").read_text()), **TINY_MIX,
                   "pool": 3, "compare": 2}
    ctx.limits = json.loads((HARNESS / "limits" / f"mvsformerpp.{mix}.json").read_text())
    ctx.seed, ctx.seconds, ctx.trace = SEED, 1.0, False
    ctx.device, ctx.precision, ctx.setup_peak = torch.device("cpu"), "fp32", 0
    return ctx


@pytest.mark.parametrize("mix", ["dtu_eval", "tt_eval"])
def test_control_fails_the_limits(mix):
    """The control (the reference in float8 in the program's place) fails a
    number of each cell's limits at tiny widths, as it does on the card at
    the cell's own (PERF.md)."""
    from mvsbench.calibrate import control_eval

    checks = control_eval(_tiny_ctx(mix))
    assert checks and not all(ok for *_, ok in checks), checks
