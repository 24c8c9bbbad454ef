"""The yardstick's counts against shapes worked by hand: the least time of
each function's calls (attention, a convolution, the warp) and the products
the reference's attention and convolution count."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvsbench.counts import family_time, least_times
from mvsbench.reference import ops

PEAKS = {"bf16_flops": 1e15, "fp32_3xtf32_flops": 1e14, "fp32_flops": 1e13,
         "hbm_bytes_s": 1e12}


@pytest.mark.parametrize("n,m", [(4000, 6000), (64, 64)], ids=["products", "bytes"])
def test_attention(n, m):
    b, h, dh = 2, 4, 16
    t = least_times([("attention", dict(b=b, h=h, n=n, m=m, dh=dh))], 2, PEAKS)
    # 4 B H N M Dh products against q, k, v, out in bf16
    assert t == {"attention": pytest.approx(max(4 * b * h * n * m * dh / 1e15,
                                                (2 * b * n * h * dh + 2 * b * m * h * dh) * 2
                                                / 1e12))}


def test_conv():
    x = torch.zeros(1, 16, 64, 80)
    w = torch.zeros(32, 16, 3, 3)
    y = torch.zeros(1, 32, 64, 80)
    ops.CALLS.clear()
    ops.RECORDING["on"] = True
    try:
        ops.record_conv(x, w, y, transposed=False)
    finally:
        ops.RECORDING["on"] = False
    (fn, s), = ops.CALLS
    ops.CALLS.clear()
    macs = 64 * 80 * 32 * 16 * 9
    assert s["macs"] == macs
    t = least_times([(fn, s)], 2, PEAKS)
    want = max(2 * macs / 1e15, (x.numel() + w.numel() + y.numel()) * 2 / 1e12)
    assert t == {"conv": pytest.approx(want)}


def test_transposed_conv_counts_each_input_against_its_taps():
    x, w, y = torch.zeros(1, 8, 4, 6, 6), torch.zeros(8, 4, 3, 3, 3), torch.zeros(1, 4, 8, 12, 12)
    ops.RECORDING["on"] = True
    try:
        ops.record_conv(x, w, y, transposed=True)
    finally:
        ops.RECORDING["on"] = False
    (_, s), = ops.CALLS
    ops.CALLS.clear()
    assert s["macs"] == x.numel() * 4 * 27


def test_warp_bytes_bound():
    call = ("warp", dict(b=1, h=100, w=200, c=8, n=5000))
    t = least_times([call], 2, PEAKS)
    assert t == {"warp": pytest.approx(max(8 * 5000 * 8 / 1e13,
                                           (100 * 200 * 8 * 2 + 5000 * 8 + 5000 * 8 * 4) / 1e12))}


def test_reference_attention_counts_four_products_per_multiply_add():
    q = torch.zeros(1, 300, 2, 16)
    k = torch.zeros(1, 500, 2, 16)
    with FlopCounterMode(display=False) as count:
        ops.softmax_attention(q, k, k, 0.25, chunk=128)
    assert count.get_total_flops() == 4 * 1 * 2 * 300 * 500 * 16


def test_family_time_matches_and_excludes():
    fams = {"conv": {"match": ["fprop", "dgrad"], "exclude": ["wgrad"]},
            "attention": {"match": ["flash_fwd"], "exclude": ["bwd"]}}
    kernels = {"sm90_xmma_fprop_x": [1.0, 3], "sm90_xmma_dgrad_x": [2.0, 1],
               "sm80_xmma_wgrad_dgrad": [4.0, 1], "flash_fwd_mma_kernel<16>": [8.0, 2],
               "flash_bwd_mma_kernel<16>": [16.0, 1]}
    assert family_time(kernels, fams, ["conv"]) == 3.0
    assert family_time(kernels, fams, ["conv", "attention"]) == 11.0


@pytest.mark.parametrize("b", [1, 2])
def test_reference_pass_on_the_meta_device(b):
    """The product count and the recorded calls of a tiny map, shapes only:
    every function is called, and the products grow with the batch."""
    from mvsbench.counts import reference_pass
    from mvsbench.tests.tiny import TINY_ARGS, tiny_config

    args = {**tiny_config()["config"]["arch"]["args"], **TINY_ARGS}
    shapes = {"b": b, "v": 3, "h": 64, "w": 128, "d": 48}
    flops, calls = reference_pass(args, shapes)
    assert flops > 0 and {fn for fn, _ in calls} == {"attention", "conv", "warp"}
    t = least_times(calls, 2, PEAKS)
    assert set(t) == {"attention", "conv", "warp"} and all(v > 0 for v in t.values())
    if b == 2:
        assert flops == pytest.approx(2 * reference_pass(args, {**shapes, "b": 1})[0], rel=0.05)
