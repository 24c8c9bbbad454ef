"""Plane-sweep warp: bilinear sampling of source features at homography-
projected points (csrc/warp.cu), and its image gradient (csrc/warp_bwd.cu).

Every TPU warp kernel of the JAX package (mvsformerplusplus_tpu/ops/pallas/,
the rows of PERF.md's kernel table) computes a windowed form of one of these
two functions: the forward serves rows 1, 4, 5, 10 and 12, the backward rows
6, 7 and 11 (see each wrapper). The TPU kernels zero samples that escape
their band or patch window; these are exact grid_sample(bilinear, zeros,
align_corners=True) in pixel units and its transpose, so they need no
windows, equal each TPU form wherever no sample escapes it
(tests/test_torch_warp_rows.py) and serve every stage and warp mode.

Bound on the H100: the bytes (the f32 output or cotangent and the
coordinates; stage 4 at DTU eval writes 906 MB for the four source views),
provided each element costs few instructions: work spread one thread per
(sample, channel), with the sample's coordinate work repeated per channel,
is instruction-bound, its time set by the element count. Design: sample-major,
one thread per (sample, 16-byte channel vector), C a template parameter,
16-byte loads of each corner and 16-byte stores or vector atomics (see each
source's note). `variant` picks the vector kernels or the scalar ones (any
C, any alignment, 32-bit indexed within a batch: the forward below 16
channels a thread per sample with C a template parameter, its outputs
staged for 16-byte stores; else, and in the backward, a block's samples'
corners worked out once into shared memory, then the block's [samples x C]
tile swept channel-fastest, so reads coalesce) from the dtype, C and the
pointer's alignment; each wrapper counts
its launches per variant (`.launches_vec`, `.launches_scalar`) and in all
(`.launches`).
"""
from __future__ import annotations

import ctypes

import torch

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor


def bilinear_corners(coords: Tensor, h: int, w: int):
    """Yield (flat pixel index, weight zeroed outside the image) for the four
    bilinear corners of each sample; coords [B, N, 2] f32."""
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            yield idx, torch.where(inside, wy * wx, 0.0)


def warp_bilinear_plain(src: Tensor, coords: Tensor) -> Tensor:
    """src [B, H, W, C], coords [B, ..., 2] (x, y) pixel units -> [B, ..., C] f32.

    Corners outside the image contribute zero with their bilinear weight
    (torch grid_sample zeros padding, align_corners=True)."""
    b, h, w, c = src.shape
    out_shape = coords.shape[:-1] + (c,)
    xy = coords.reshape(b, -1, 2).float()
    flat = src.reshape(b, h * w, c)
    out = torch.zeros(b, xy.shape[1], c, dtype=torch.float32, device=src.device)
    for idx, wt in bilinear_corners(xy, h, w):
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
        out += vals * wt[..., None]
    return out.reshape(out_shape)


def warp_bilinear_bwd_plain(g: Tensor, coords: Tensor, src_shape) -> Tensor:
    """The transpose of warp_bilinear_plain in its image argument: g
    [B, ..., C] cotangent, coords [B, ..., 2] -> dsrc [B, H, W, C] f32, an
    index_add_ of g x bilinear weight at the four corners (zero-padded
    corners get nothing)."""
    b, h, w, c = src_shape
    xy = coords.reshape(b, -1, 2).float()
    gf = g.reshape(b, -1, c).float()
    dsrc = torch.zeros(b * h * w, c, dtype=torch.float32, device=g.device)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None]
    for idx, wt in bilinear_corners(xy, h, w):
        dsrc.index_add_(0, (idx + base).reshape(-1), (gf * wt[..., None]).reshape(-1, c))
    return dsrc.reshape(b, h, w, c)


# the channel counts the vector kernels are built for, per element type: the
# multiples of one 16-byte vector (8 bf16, 4 f32) up to 64 (the WARP_VEC_CASE
# and WARP_BWD_VEC_CASE lines of csrc/warp.cu and csrc/warp_bwd.cu)
VEC_CHANNELS = {torch.bfloat16: (8, 16, 32, 64), torch.float32: (4, 8, 16, 32, 64)}


# samples per block of the scalar kernels (SCALAR_TILE, csrc/warp_corners.cuh)
SCALAR_TILE = 256


def variant(t: Tensor, c: int) -> str:
    """'vec' where the vector kernels take t (the warp's source, or the
    backward's cotangent) at C = c channels: c built for t's dtype and t
    starting on a 16-byte boundary; else 'scalar'."""
    return "vec" if c in VEC_CHANNELS.get(t.dtype, ()) and t.data_ptr() % 16 == 0 else "scalar"


def _check_coords(src: Tensor, coords: Tensor) -> None:
    if coords.dtype != torch.float32 or coords.shape[-1] != 2 or coords.shape[0] != src.shape[0]:
        raise ValueError(f"coords must be f32 [B, ..., 2] matching src batch, got "
                         f"{tuple(coords.shape)} {coords.dtype}")


def _launch_args(t: Tensor, coords: Tensor, h: int, w: int, c: int):
    """coords contiguous on an 8-byte boundary (the vector kernels read each
    sample's (x, y) as one float2) and the samples per batch; raises where a
    32-bit index would overflow."""
    coords = coords.contiguous()
    if coords.data_ptr() % 8:
        coords = coords.clone()
    nsamp = coords.numel() // (2 * t.shape[0])
    if max(nsamp, h * w, SCALAR_TILE) * c >= 2 ** 31:
        raise ValueError(f"warp kernels index in 32 bits: {nsamp} samples or {h} x {w} pixels "
                         f"of {c} channels is too many")
    return coords, nsamp


def _c_fn(lib: str, name: str, n_ints: int):
    """A C entry point (3 pointers, n_ints ints, stream) -> cudaError."""
    fn = getattr(load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _count(wrapper, kind: str) -> None:
    """One launch of the `kind` kernel: its counter and the total."""
    setattr(wrapper, f"launches_{kind}", getattr(wrapper, f"launches_{kind}") + 1)
    wrapper.launches += 1


def warp_bilinear(src: Tensor, coords: Tensor) -> Tensor:
    """Bilinear warp: src [B, H, W, C] bf16|f32, coords [B, D, H', W', 2] f32
    -> [B, D, H', W', C] f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel `variant(src, C)` names (csrc/warp.cu).

    Serves the TPU rows (mvsformerplusplus_tpu/ops/pallas/): 1
    warp_band.py:395 banded_warp_blocked_fused and 4 :195 banded_warp_rows
    (the banded warp mode), 5 :511 banded_warp_blocked (banded with
    banded_fused=False), 10 warp_blend.py:132 _blend_fwd_impl and 12 :153
    blend_ygrouped_dfold (the pallas warp mode, unfolded and depth-folded)."""
    if not src.is_cuda:
        return warp_bilinear_plain(src, coords)
    _check_coords(src, coords)
    src = src.contiguous()
    code = dtype_code(src)
    b, h, w, c = src.shape
    coords, nsamp = _launch_args(src, coords, h, w, c)
    out = torch.empty(coords.shape[:-1] + (c,), dtype=torch.float32, device=src.device)
    kind = variant(src, c)
    fn = _c_fn("warp", f"warp_bilinear_{kind}", 6)
    check(fn(ptr(src), ptr(coords), ptr(out), b, h, w, c, nsamp, code, stream()),
          f"warp_bilinear_{kind}")
    _count(warp_bilinear, kind)
    return out


def warp_bilinear_bwd(g: Tensor, coords: Tensor, src_shape) -> Tensor:
    """Image gradient of warp_bilinear: g [B, D, H', W', C] f32, coords
    [B, D, H', W', 2] f32 -> dsrc [B, H, W, C] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel `variant(g, C)` names
    (csrc/warp_bwd.cu).

    Serves the TPU rows (mvsformerplusplus_tpu/ops/pallas/): 6
    warp_band.py:231 banded_warp_rows_bwd, 7 :478 banded_warp_blocked_bwd
    and 11 warp_blend.py:217 _blend_bwd (the y-grouped blend's VJP). The
    kernel sums with atomics, in an order that varies from run to run, so
    it matches the plain version within fp32 summation noise (the f32
    tolerance of `ops.cuda.tolerance`), not bit for bit."""
    if not g.is_cuda:
        return warp_bilinear_bwd_plain(g, coords, src_shape)
    b, h, w, c = src_shape
    _check_coords(g, coords)
    if g.dtype != torch.float32 or g.shape != coords.shape[:-1] + (c,):
        raise ValueError(f"cotangent must be f32 {tuple(coords.shape[:-1]) + (c,)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    g = g.contiguous()
    coords, nsamp = _launch_args(g, coords, h, w, c)
    dsrc = torch.zeros(b, h, w, c, dtype=torch.float32, device=g.device)
    kind = variant(g, c)
    fn = _c_fn("warp_bwd", f"warp_bilinear_bwd_{kind}", 5)
    check(fn(ptr(g), ptr(coords), ptr(dsrc), b, h, w, c, nsamp, stream()),
          f"warp_bilinear_bwd_{kind}")
    _count(warp_bilinear_bwd, kind)
    return dsrc


warp_bilinear.launches = warp_bilinear.launches_vec = warp_bilinear.launches_scalar = 0
warp_bilinear_bwd.launches = warp_bilinear_bwd.launches_vec = warp_bilinear_bwd.launches_scalar = 0


class WarpBilinear(torch.autograd.Function):
    """Differentiable warp_bilinear: the image gets the transpose of the
    sample (warp_bilinear_bwd); the coordinates get no gradient, as every
    warp of the JAX package stops it (grid_sample.py:813-818)."""

    @staticmethod
    def forward(ctx, src: Tensor, coords: Tensor) -> Tensor:
        ctx.save_for_backward(coords)
        ctx.src_shape, ctx.src_dtype = tuple(src.shape), src.dtype
        return warp_bilinear(src, coords)

    @staticmethod
    def backward(ctx, g: Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (coords,) = ctx.saved_tensors
        dsrc = warp_bilinear_bwd(g.float(), coords.detach(), ctx.src_shape)
        return dsrc.to(ctx.src_dtype), None
