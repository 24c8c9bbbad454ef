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
~1.3 GB for 82 GFLOP). Two kernels, both implicit GEMMs on the tensor
cores over a double-buffered halo tile with the weights packed here and
resident in shared memory, chosen by `variant` (dtype, widths, alignment):
the bf16 one ("mma": mma.sync m16n8k16, fp32 accumulators; products of bf16
values are exact in fp32, so it differs from the plain version only in
summation order; weights in its B-fragment order, `pack_weights`) and the
tf32 one ("tf32": mma.sync m16n8k8, for f32 and for any bf16 width or
alignment the mma kernel does not take; f32 products as 3xTF32, each
operand split into two tf32 parts and each product taken as three, so that
it keeps fp32 accuracy; bf16 in one pass, exact as above; weights packed
already split, `pack_weights_tf32`, in 8-channel chunks of Ci and a Co tile
that `tf32_plan` picks). csrc/conv2d.cu's note gives both designs. The TPU
kernel's W-folding and VMEM-driven channel split answer TPU limits and are
not carried over. Each wrapper counts its launches per kernel
(`.launches_mma`, `.launches_tf32`) and in all (`.launches`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import check, dtype_code, flops, load, ptr, stream

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
    """'mma' where the bf16 tensor-core kernel takes the conv of x by kernel
    [k, k, Ci, Co]: x bf16 on a 16-byte boundary, Co a multiple of 8 and
    (k, channel_pad(Ci), co_tile(Co)) instantiated; else 'tf32' (f32, and
    every other bf16 width or alignment)."""
    k, _, ci, co = kernel.shape
    if x.dtype != torch.bfloat16 or x.data_ptr() % 16:
        return "tf32"
    return "mma" if (k, channel_pad(ci), co_tile(co)) in MMA_CASES else "tf32"


# the (k, Co tile, weights streamed) instantiations of the tf32 kernel: the
# CONV_TF32_CASE lines of csrc/conv2d.cu (tf32_plan picks no other)
TF32_CASES = frozenset([(k, cot, False) for k in (3, 5) for cot in (8, 16, 32)]
                       + [(7, 8, False), (7, 16, False)] + [(k, 8, True) for k in KERNEL_SIZES])
SM_SMEM = 233472  # shared memory of an H100 SM, bytes (1 KB of it reserved per block)
BLOCK_SMEM = 232448  # of one block


def tf32_halo_bytes(k: int, dtype: torch.dtype) -> int:
    """The tf32 kernel's halo in shared memory: stages of one 8-channel
    chunk of an 8 x 32 tile's [8+k-1][32+k-1] pixels in f32, three for f32
    inputs (a two-stage cp.async ring and the small parts), one for bf16."""
    return (3 if dtype == torch.float32 else 1) * (8 + k - 1) * (32 + k - 1) * 8 * 4


def tf32_plan(k: int, ci: int, co: int, dtype: torch.dtype = torch.float32) -> tuple:
    """(Co tile, streamed) of the tf32 kernel for the conv [k, k, Ci, Co] on
    inputs of `dtype`: the widest Co tile of 32, 16 and 8 (no wider than Co
    rounded up to 8) whose resident weights (k*k*ceil(Ci/8)*COT/8 fragments
    of 512 bytes) and halo (tf32_halo_bytes) let two blocks share an SM;
    else 8 with the weights resident if one block fits, else 8 with each
    chunk's weights staged beside its halo (two chunks' at a time)."""
    halo = tf32_halo_bytes(k, dtype)
    frag = k * k * -(-ci // 8) * 512  # the weights of one n8 tile
    for cot in (32, 16, 8):
        if cot <= -(-co // 8) * 8 and 2 * (halo + frag * cot // 8 + 1024) <= SM_SMEM:
            return cot, False
    return (8, False) if halo + frag <= BLOCK_SMEM else (8, True)


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


def _tf32_order(t: Tensor, cot: int) -> Tensor:
    """t [k, k, Ci, Co] -> [ceil(Co / cot), ceil(Ci / 8), k*k, cot / 8, 32, 2]
    in the tf32 kernel's B-fragment order (see pack_weights_tf32), 0 where
    the order pads."""
    k, _, ci, co = t.shape
    nch, ntile = -(-ci // 8), -(-co // cot)
    w2 = F.pad(t.reshape(k * k, ci, co), (0, ntile * cot - co, 0, nch * 8 - ci))
    # rows (chunk, half, t), columns (tile, j, g) -> (tile, chunk, tap, j, g, t, half)
    frag = w2.reshape(k * k, nch, 2, 4, ntile, cot // 8, 8).permute(4, 1, 0, 5, 6, 3, 2)
    return frag.reshape(ntile, nch, k * k, cot // 8, 32, 2)


def tf32(x: Tensor) -> Tensor:
    """f32 x rounded to tf32 as cvt.rna.tf32.f32 (and flash::split_tf32)
    round: to nearest, ties away from zero, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@functools.lru_cache(maxsize=None)
def _tf32_offsets(k: int, ci: int, co: int, cot: int, dx: bool, strides: tuple,
                  device: torch.device) -> Tensor:
    """Per pair of the tf32 kernel's packed weights (see pack_weights_tf32):
    the offsets of its two weights in the stored kernel's memory (its
    `strides`, from its first element; 0 where the order pads)."""
    coords = torch.meshgrid(*(torch.arange(n) for n in (k, k, ci, co)), indexing="ij")
    flat = sum(c * s for c, s in zip(coords, strides))
    return _tf32_order(dx_kernel(flat) if dx else flat, cot).contiguous().to(device)


def pack_weights_tf32(kernel: Tensor, dtype: torch.dtype, cot: int,
                      dx: bool = False) -> Tensor:
    """The tf32 kernel's weights, f32 [ceil(Co / cot), ceil(Ci / 8), k*k,
    cot / 8, 32, 4], for the conv by kernel [k, k, Ci, Co] (with dx: by
    dx_kernel(kernel)) on inputs of `dtype` (the weights are rounded to it
    first, as the plain version's inputs are), in one gather from kernel as
    it lies. The order: per Co tile, per 8-channel chunk of Ci, per tap (dy
    * k + dx), per n8 tile j, lane (g, t) = (lane / 4, lane % 4) holds rows
    t and t + 4 of the chunk (channels 8 chunk + t, + 4) of column cot * tile
    + 8 j + g (mma.sync m16n8k8's B layout), each split for 3xTF32: (big b0,
    big b1, small b0, small b1), big = tf32(w), small = tf32(w - big). Rows
    past Ci and columns past Co repeat a weight of the kernel (the kernel
    zero-fills those input channels and does not store those outputs). A
    CUDA kernel is packed by one launch of csrc/conv2d.cu's
    conv2d_pack_tf32_kernel, the same values bit for bit."""
    k, _, ci, co = kernel.shape
    if kernel.is_cuda:
        idx = _tf32_offsets(k, ci, co, cot, dx, kernel.stride(), kernel.device)
        out = torch.empty(idx.shape[:-1] + (4,), dtype=torch.float32, device=kernel.device)
        round_bf16 = dtype == torch.bfloat16 and kernel.dtype != torch.bfloat16
        check(_pack_fn()(ptr(kernel), ptr(idx), ptr(out), idx.numel() // 2, dtype_code(kernel),
                         int(round_bf16), stream()), "conv2d_pack_tf32")
        return out
    kc = kernel.contiguous()
    w = kc.reshape(-1)[_tf32_offsets(k, ci, co, cot, dx, kc.stride(), kc.device)]
    w = w.to(dtype).float()
    big = tf32(w)
    return torch.cat([big, tf32(w - big)], dim=-1)


@functools.lru_cache(maxsize=None)
def _pack_fn():
    fn = load("conv2d").conv2d_pack_tf32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
        cot, streamed = tf32_plan(ky, ci, co, x.dtype)
        wpack = pack_weights_tf32(kernel, x.dtype, cot, dx)
        check(_c_fn("conv2d_same_tf32", 9)(ptr(x), ptr(wpack), ptr(out), b, h, w, ci, co, ky,
                                           cot, int(streamed), dtype_code(x), stream()), what)
    setattr(wrapper, f"launches_{kind}", getattr(wrapper, f"launches_{kind}") + 1)
    wrapper.launches += 1
    return out


def conv2d_same(x: Tensor, kernel: Tensor) -> Tensor:
    """Odd-k stride-1 'same' conv. x [B, H, W, Ci] bf16|f32, kernel
    [k, k, Ci, Co] (cast to x's dtype) -> [B, H, W, Co]. CPU tensors take the
    plain version; CUDA tensors launch the kernel `variant(x, kernel)` names."""
    with flops.kernel_call("conv2d_same", flops.conv_products(x, kernel.shape)):
        if not x.is_cuda:
            return conv2d_same_plain(x, kernel)
        return _launch(x, kernel, conv2d_same)


def conv2d_same_dx(g: Tensor, kernel: Tensor) -> Tensor:
    """Input gradient of conv2d_same, g [B, H, W, Co] -> [B, H, W, Ci] in g's
    dtype: the same conv kernel launched with dx_kernel(kernel). CPU tensors
    take the plain version; CUDA tensors launch the kernel
    `variant(g, dx_kernel(kernel))` names."""
    with flops.kernel_call("conv2d_same_dx", flops.conv_products(g, kernel.shape)):
        if not g.is_cuda:
            return conv2d_same_plain(g, dx_kernel(kernel))
        return _launch(g, kernel, conv2d_same_dx, dx=True)


conv2d_same.launches = conv2d_same.launches_mma = conv2d_same.launches_tf32 = 0
conv2d_same_dx.launches = conv2d_same_dx.launches_mma = conv2d_same_dx.launches_tf32 = 0


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
