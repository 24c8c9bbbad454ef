"""Stride-1 "same" zero-padded odd-k 2D conv, NHWC (csrc/conv2d.cu), and its
gradients.

Replaces the Pallas kernel mvsformerplusplus_tpu/ops/pallas/conv2d.py
`_conv2d_fwd_impl` (`_kernel`, reached from `conv2d_p`): k in {3, 5, 7}, fp32
accumulation, output in the input dtype, no bias (MMConv adds it outside);
and `_conv2d_bwd`, whose input gradient is the same kernel applied to the
cotangent with the weights flipped in space and ci/co swapped
(`conv2d_same_dx`), and whose weight gradient is a per-tap fp32 reduction
that the JAX package leaves to XLA (here torch matmuls).

Bound on the H100: bytes. Every path case's arithmetic intensity is below
the bf16 tensor cores' ridge (the decoder's 64->8 head at 5x1152x1536 moves
~1.3 GB for 82 GFLOP). Two kernels, chosen by `variant` (dtype, widths,
alignment): the bf16 one ("mma") is an implicit GEMM on the tensor cores
(mma.sync m16n8k16, fp32 accumulators; products of bf16 values are exact in
fp32, so it differs from the plain version only in summation order) over a
double-buffered halo tile fed by cp.async, with the weights packed here into
its B-fragment order (`pack_weights`) and resident in shared memory; the fp32
one ("simt", also any width or alignment the mma kernel does not take) runs
fp32 FMAs. csrc/conv2d.cu's note gives both designs. The TPU kernel's
W-folding and VMEM-driven channel split answer TPU limits and are not
carried over. Each wrapper counts its launches per kernel
(`.launches_mma`, `.launches_simt`) and in all (`.launches`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor

KERNEL_SIZES = (3, 5, 7)


def conv2d_same_plain(x: Tensor, kernel: Tensor) -> Tensor:
    """x [B, H, W, Ci], kernel [ky, kx, Ci, Co] -> [B, H, W, Co] in x's dtype,
    as ky*kx shifted matmuls with fp32 accumulation."""
    ky, kx, ci, co = kernel.shape
    b, h, w, _ = x.shape
    py, px = (ky - 1) // 2, (kx - 1) // 2
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    kf = kernel.float()
    out = torch.zeros(b, h, w, co, dtype=torch.float32, device=x.device)
    for dy in range(ky):
        for dx in range(kx):
            out += xp[:, dy:dy + h, dx:dx + w] @ kf[dy, dx]
    return out.to(x.dtype)


def dx_kernel(kernel: Tensor) -> Tensor:
    """The weights of the input gradient: flipped in space, ci/co swapped."""
    return kernel.flip(0, 1).transpose(2, 3)


def conv2d_same_dx_plain(g: Tensor, kernel: Tensor) -> Tensor:
    """Input gradient of conv2d_same: g [B, H, W, Co] -> [B, H, W, Ci] in g's
    dtype."""
    return conv2d_same_plain(g, dx_kernel(kernel))


def conv2d_same_dk(x: Tensor, g: Tensor, ky: int, kx: int) -> Tensor:
    """Weight gradient [ky, kx, Ci, Co] f32: per tap, the fp32 product of the
    shifted input and the cotangent summed over batch and pixels (the JAX
    package's XLA einsum, here torch matmuls)."""
    b, h, w, ci = x.shape
    co = g.shape[-1]
    py, px = (ky - 1) // 2, (kx - 1) // 2
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    gf = g.float().reshape(-1, co)
    taps = [[xp[:, dy:dy + h, dx:dx + w].reshape(-1, ci).t() @ gf for dx in range(kx)]
            for dy in range(ky)]
    return torch.stack([torch.stack(row) for row in taps])


# the (k, channel pad, Co tile) instantiations of the mma kernel: the
# CONV_MMA_CASE lines of csrc/conv2d.cu (every one whose shared memory fits a
# block; the 7x7 and 5x5 at 64 channels with wide Co tiles do not)
MMA_CASES = frozenset(
    [(3, cp, cot) for cp in (8, 16, 32, 64) for cot in (8, 16, 32, 64)]
    + [(5, cp, cot) for cp in (8, 16, 32, 64) for cot in (8, 16, 32, 64) if (cp, cot) != (64, 64)]
    + [(7, cp, cot) for cp in (8, 16, 32) for cot in (8, 16, 32, 64) if (cp, cot) != (32, 64)]
    + [(7, 64, 8)])


def channel_pad(ci: int) -> int:
    """The input channels the mma kernel stages per pixel: 1-8 zero-padded
    to 8, else Ci itself (it takes 16, 32 and 64)."""
    return 8 if ci <= 8 else ci


def co_tile(co: int) -> int:
    """The mma kernel's Co tile: the widest of 64, 32, 16 and 8 dividing Co
    (0 when none does)."""
    return next((c for c in (64, 32, 16, 8) if co % c == 0), 0)


def variant(x: Tensor, kernel: Tensor) -> str:
    """'mma' where the tensor-core kernel takes the conv of x by kernel
    [k, k, Ci, Co]: x bf16 on a 16-byte boundary, Co a multiple of 8 and
    (k, channel_pad(Ci), co_tile(Co)) instantiated; else 'simt'."""
    k, _, ci, co = kernel.shape
    if x.dtype != torch.bfloat16 or x.data_ptr() % 16:
        return "simt"
    return "mma" if (k, channel_pad(ci), co_tile(co)) in MMA_CASES else "simt"


def _fragment_order(t: Tensor) -> Tensor:
    """t [k, k, Ci, Co] -> [Co / COT, KSTEPS, COT / 8, 32, 4] in the mma
    kernel's B-fragment order (see pack_weights), 0 where the order pads."""
    k, _, ci, co = t.shape
    cp, cot = channel_pad(ci), co_tile(co)
    rows = k * k * cp
    ksteps = -(-rows // 16)
    w2 = F.pad(F.pad(t, (0, 0, 0, cp - ci)).reshape(rows, co), (0, 0, 0, ksteps * 16 - rows))
    # rows (step, half, q, pair), columns (tile, j, g) -> (tile, step, j, g, q, half, pair)
    frag = w2.reshape(ksteps, 2, 4, 2, co // cot, cot // 8, 8).permute(4, 0, 5, 6, 2, 1, 3)
    return frag.reshape(co // cot, ksteps, cot // 8, 32, 4)


@functools.lru_cache(maxsize=None)
def _pack_index(k: int, ci: int, co: int, dx: bool, device: torch.device) -> Tensor:
    """Per packed element of the conv's weights (the stored kernel [k, k, Ci,
    Co], or with dx dx_kernel of it, [k, k, Co, Ci]): its flat index into
    the stored kernel (0, its first weight, where the order pads)."""
    y, x, c, o = torch.meshgrid(*(torch.arange(n) for n in (k, k, ci, co)), indexing="ij")
    flat = ((y * k + x) * ci + c) * co + o
    return _fragment_order(dx_kernel(flat) if dx else flat).to(device)


def pack_weights(kernel: Tensor, dx: bool = False) -> Tensor:
    """The mma kernel's weights, bf16 [Co / COT, KSTEPS, COT / 8, 32, 4], for
    the conv by kernel [k, k, Ci, Co] (with dx: by dx_kernel(kernel)), in
    one gather from kernel as it lies (strided, not flipped). The B-fragment
    order: K is row r = tap * CP + c (tap = dy * k + dx, CP =
    channel_pad(Ci)) in k16 steps; fragment (step s, n8 tile j) gives lane
    (g, q) = (lane / 4, lane % 4) the rows 16 s + 2 q, + 1, + 8, + 9 of
    column COT * tile + 8 j + g (mma.sync m16n8k16's B layout,
    csrc/flash_mma.cuh). The rows of channels past Ci and past k*k*CP, which
    the kernel multiplies by zero A (zero-filled channels, a zero chunk),
    repeat a weight of the kernel instead of a zero, so that the gather is
    the only operation."""
    k, _, ci, co = kernel.shape
    packed = torch.take(kernel, _pack_index(k, ci, co, dx, kernel.device))
    return packed if packed.dtype == torch.bfloat16 else packed.to(torch.bfloat16)


def _check_conv(x: Tensor, kernel: Tensor) -> None:
    ky, kx, ci, _ = kernel.shape
    if ky != kx or ky not in KERNEL_SIZES or x.shape[-1] != ci:
        raise ValueError(f"conv kernel takes square k in {KERNEL_SIZES} with matching Ci, "
                         f"got x {tuple(x.shape)} kernel {tuple(kernel.shape)}")


@functools.lru_cache(maxsize=None)
def _c_fn(name: str, n_ints: int):
    """A C entry point of csrc/conv2d.cu (3 pointers, n_ints ints, stream)."""
    fn = getattr(load("conv2d"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: Tensor, kernel: Tensor, wrapper, dx: bool = False) -> Tensor:
    """The conv of x by kernel (with dx: by dx_kernel(kernel)) through the
    kernel `variant` names, counted on `wrapper`."""
    weights = kernel.transpose(2, 3) if dx else kernel  # the conv's weight shape
    _check_conv(x, weights)
    ky, _, ci, co = weights.shape
    x = x.contiguous()
    b, h, w, _ = x.shape
    out = torch.empty(b, h, w, co, dtype=x.dtype, device=x.device)
    kind = variant(x, weights)
    what = f"{wrapper.__name__} ({kind})"
    if kind == "mma":
        wpack = pack_weights(kernel, dx)
        check(_c_fn("conv2d_same_mma", 6)(ptr(x), ptr(wpack), ptr(out), b, h, w, ci, co, ky,
                                          stream()), what)
    else:
        weights = (dx_kernel(kernel) if dx else kernel).to(x.dtype).contiguous()
        check(_c_fn("conv2d_same_simt", 7)(ptr(x), ptr(weights), ptr(out), b, h, w, ci, co, ky,
                                           dtype_code(x), stream()), what)
    setattr(wrapper, f"launches_{kind}", getattr(wrapper, f"launches_{kind}") + 1)
    wrapper.launches += 1
    return out


def conv2d_same(x: Tensor, kernel: Tensor) -> Tensor:
    """Odd-k stride-1 'same' conv. x [B, H, W, Ci] bf16|f32, kernel
    [k, k, Ci, Co] (cast to x's dtype) -> [B, H, W, Co]. CPU tensors take the
    plain version; CUDA tensors launch the kernel `variant(x, kernel)` names."""
    if not x.is_cuda:
        return conv2d_same_plain(x, kernel)
    return _launch(x, kernel, conv2d_same)


def conv2d_same_dx(g: Tensor, kernel: Tensor) -> Tensor:
    """Input gradient of conv2d_same, g [B, H, W, Co] -> [B, H, W, Ci] in g's
    dtype: the same conv kernel launched with dx_kernel(kernel). CPU tensors
    take the plain version; CUDA tensors launch the kernel
    `variant(g, dx_kernel(kernel))` names."""
    if not g.is_cuda:
        return conv2d_same_plain(g, dx_kernel(kernel))
    return _launch(g, kernel, conv2d_same_dx, dx=True)


conv2d_same.launches = conv2d_same.launches_mma = conv2d_same.launches_simt = 0
conv2d_same_dx.launches = conv2d_same_dx.launches_mma = conv2d_same_dx.launches_simt = 0


class Conv2dSame(torch.autograd.Function):
    """Differentiable conv2d_same. dx (conv2d_same_dx) only when the input
    needs a gradient: the encoder's 7x7 conv on the images and each stage's
    first visibility conv on the detached entropy do not. dK in the kernel's
    dtype, as the JAX package returns it."""

    @staticmethod
    def forward(ctx, x: Tensor, kernel: Tensor) -> Tensor:
        ctx.save_for_backward(x, kernel)
        return conv2d_same(x, kernel)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = conv2d_same_dx(g, kernel) if ctx.needs_input_grad[0] else None
        dk = None
        if ctx.needs_input_grad[1]:
            dk = conv2d_same_dk(x, g, kernel.shape[0], kernel.shape[1]).to(kernel.dtype)
        return dx, dk
