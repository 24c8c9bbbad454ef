"""The products a call needs, the hand-written kernels included
(counterpart of the XLA `cost_analysis` count that bench.py's `_flops_of`
reads on a TPU).

    with ProductCount() as count:
        model(imgs, cams, depth_values)
    count.total   # products, 2 per multiply-add

It counts the products the function needs, whatever implements them:
matmuls, convolutions and attention. Every library op is counted by
torch.utils.flop_counter.FlopCounterMode. It cannot see the hand-written
kernels (ctypes calls inside autograd.Functions), so the flash and conv
wrappers count each call by a formula (`kernel_call`):

- flash forward: 4·B·H·N·M·Dh (Q·Kᵀ and P·V);
- flash backward: 8·B·H·N·M·Dh, the autograd of the forward's two
  products (dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q). The fused
  kernel's recompute of S, and the plain version's, is the
  implementation's choice and is not counted;
- conv2d_same and conv2d_same_dx: 2·B·H·W·ky·kx·Ci·Co each (the weight
  gradient, conv2d_same_dk, is torch matmuls that FlopCounterMode counts);
- warp and its backward: 0, so their wrappers count nothing. They are
  gathers and blends, in which FlopCounterMode finds no product in the
  plain versions either.

A wrapper counts its formula on either route, and what FlopCounterMode sees
inside the call (the plain version's matmuls on CPU tensors) is set aside.
So each call counts once, and a count on the card equals the count of the
same call on the CPU. Work that gradient checkpointing replays in a
backward (`replay`, models/layers.remat) is set aside too: the count is the
model's, not the replay's.

Not counted: elementwise work (softmax, exponentials, norms, activations,
the warps' blends). bench.py's XLA count on a TPU included it, so an MFU
from this count is not to be read against a TPU's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

# the counts open in this process. A module-level list, not thread-local:
# the autograd engine runs a CUDA backward on a thread of its own.
_OPEN: List["ProductCount"] = []


class ProductCount:
    """Products counted while the block runs: `library` (FlopCounterMode's,
    less what it saw inside kernel wrappers and replays), `kernels`
    ({wrapper name: products} by the formulas above) and `total`."""

    def __init__(self):
        self._mode = FlopCounterMode(display=False)
        self._set_aside = 0
        self._aside_depth = self._aside_from = 0
        self._replaying = 0
        self.kernels: Dict[str, int] = {}

    def __enter__(self) -> "ProductCount":
        self._mode.__enter__()
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.remove(self)
        return self._mode.__exit__(*exc)

    def _seen(self) -> int:
        return self._mode.get_total_flops()

    @property
    def library(self) -> int:
        return self._seen() - self._set_aside

    @property
    def total(self) -> int:
        return self.library + sum(self.kernels.values())


@contextlib.contextmanager
def _set_aside():
    """What FlopCounterMode sees inside the block is not counted (once, where
    such blocks nest: a kernel call inside a replay); yields the counts that
    were open when it began."""
    counts = list(_OPEN)
    for c in counts:
        if not c._aside_depth:
            c._aside_from = c._seen()
        c._aside_depth += 1
    try:
        yield counts
    finally:
        for c in counts:
            c._aside_depth -= 1
            if not c._aside_depth:
                c._set_aside += c._seen() - c._aside_from


@contextlib.contextmanager
def kernel_call(name: str, products: int):
    """One call of the kernel wrapper `name`: `products` counted in every open
    ProductCount (none during a replay), FlopCounterMode's count of the
    block set aside."""
    with _set_aside() as counts:
        yield
    for c in counts:
        if not c._replaying:
            c.kernels[name] = c.kernels.get(name, 0) + products


@contextlib.contextmanager
def replay():
    """A checkpoint's replay of its forward in the backward: nothing inside
    is counted."""
    with _set_aside() as counts:
        for c in counts:
            c._replaying += 1
        try:
            yield
        finally:
            for c in counts:
                c._replaying -= 1


def flash_fwd_products(q: torch.Tensor, k: torch.Tensor) -> int:
    """4·B·H·N·M·Dh for q [B, N, H, Dh], k [B, M, H, Dh]."""
    b, n, h, dh = q.shape
    return 4 * b * h * n * k.shape[1] * dh


def flash_bwd_products(q: torch.Tensor, k: torch.Tensor) -> int:
    """8·B·H·N·M·Dh: twice the forward's."""
    return 2 * flash_fwd_products(q, k)


def conv_products(x: torch.Tensor, kernel_shape) -> int:
    """2·B·H·W·ky·kx·Ci·Co for x [B, H, W, Ci] and a kernel [ky, kx, Ci, Co]
    (for conv2d_same_dx: g [B, H, W, Co] and the same kernel)."""
    b, h, w, _ = x.shape
    ky, kx, ci, co = kernel_shape
    return 2 * b * h * w * ky * kx * ci * co
