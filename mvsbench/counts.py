"""The yardstick's counts, from the plain reference at the cell's shapes and
never from the program: products of one map (FlopCounterMode, 2 per multiply-add), and the calls of the functions the
program runs on its hand-written kernels, each with its least time on the
card.

Both are taken on the meta device (shapes only, no arithmetic), so they
cost the host a pass of the reference's Python and nothing on the card.

A call's least time is max(products / the peak of its type, the bytes of
each input read once and each output written once / the HBM bandwidth):
- attention forward: 4·B·H·N·M·Dh products; q, k, v and out;
- a convolution (any: stride-1 'same', strided, 3D, transposed): 2 per
  multiply-add; x, the weights and out;
- warp: a multiply and an add per corner and channel on the float32 units;
  the source, the coordinates and the float32 output.
Activations and weights are in the configuration's compute type, the
warp's coordinates and outputs in float32.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import model as ref_model
from .reference import ops as ref_ops


def reference_pass(arch_args: dict, shapes: dict) -> tuple:
    """(products of one map, the recorded calls) of the reference's forward
    at `shapes` ({"b", "v", "h", "w", "d"}) on the meta device."""
    with torch.device("meta"):
        net = ref_model.build(arch_args)
    net.eval()
    b, v, h, w, d = (shapes[k] for k in ("b", "v", "h", "w", "d"))
    ref_ops.CALLS.clear()
    ref_ops.RECORDING["on"] = True
    try:
        with FlopCounterMode(display=False) as count, torch.no_grad():
            imgs = torch.zeros(b, v, h, w, 3, device="meta")
            cams = {f"stage{i + 1}": torch.zeros(b, v, 2, 4, 4, device="meta")
                    for i in range(4)}
            net(imgs, cams, torch.zeros(b, d, device="meta"))
        return float(count.get_total_flops()), list(ref_ops.CALLS)
    finally:
        ref_ops.RECORDING["on"] = False
        ref_ops.CALLS.clear()


def least_times(calls, dtype_bytes: int, peaks: dict) -> dict:
    """Seconds the card needs at least for each function's calls:
    {function: seconds}."""
    bw, fp32 = peaks["hbm_bytes_s"], peaks["fp32_flops"]
    prod = peaks["bf16_flops"] if dtype_bytes == 2 else peaks["fp32_3xtf32_flops"]
    out = {}

    def add(fn, flops, nbytes, rate):
        out[fn] = out.get(fn, 0.0) + max(flops / rate, nbytes / bw)

    e = dtype_bytes
    for fn, s in calls:
        if fn == "attention":
            b, h, n, m, dh = s["b"], s["h"], s["n"], s["m"], s["dh"]
            qo, kv = b * n * h * dh, b * m * h * dh
            add("attention", 4 * b * h * n * m * dh, (2 * qo + 2 * kv) * e, prod)
        elif fn == "conv":
            flops, nbytes = 2 * s["macs"], (s["x"] + s["w"] + s["y"]) * e
            add("conv", flops, nbytes, prod)
        elif fn == "warp":
            b, hh, ww, c, n = (s[x] for x in ("b", "h", "w", "c", "n"))
            add("warp", 8 * b * n * c, b * hh * ww * c * e + b * n * 2 * 4 + b * n * c * 4, fp32)
    return out


def family_time(kernels: dict, families: dict, functions) -> float:
    """Device seconds of the traced kernels that `families` maps to one of
    `functions`: a kernel whose name holds one of a function's `match`
    substrings and none of its `exclude` ones."""
    total = 0.0
    for name, (sec, _) in kernels.items():
        for fn in functions:
            fam = families.get(fn, {})
            if (any(k in name for k in fam.get("match", ()))
                    and not any(k in name for k in fam.get("exclude", ()))):
                total += sec
                break
    return total
