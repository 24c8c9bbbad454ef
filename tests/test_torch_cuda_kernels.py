"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, forward and backward, on the card (marker `cuda`; skipped
without one), with a planted fault per backward kernel that the same check
must reject. Imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention, tolerance, warp
from mvsformerplusplus_tpu_torch.ops.geometry import compose_projection, plane_sweep_coords

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,ci,co,h,w", [(3, 64, 8, 19, 45), (5, 8, 24, 9, 33),
                                         (7, 3, 8, 16, 40), (3, 1, 16, 8, 31),
                                         (3, 16, 64, 10, 70)])
def test_conv_kernel_matches_plain(dev, dtype, k, ci, co, h, w):
    g = torch.Generator(device=dev).manual_seed(k + ci)
    x = torch.randn(2, h, w, ci, generator=g, device=dev).to(dtype)
    kern = (torch.randn(k, k, ci, co, generator=g, device=dev) * 0.1).to(dtype)
    before = conv2d.conv2d_same.launches
    got = conv2d.conv2d_same(x, kern)
    assert conv2d.conv2d_same.launches == before + 1
    _close(got, conv2d.conv2d_same_plain(x, kern))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129), (64, 1729, 1729)])
def test_flash_kernel_matches_plain(dev, dtype, dh, n, m):
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, k, v = (torch.randn(2, s, 3, dh, generator=g, device=dev).to(dtype) for s in (n, m, m))
    before = flash_attention.flash_attention_fwd.launches
    got, lse = flash_attention.flash_attention_fwd(q, k, v, 0.3, return_lse=True)
    assert flash_attention.flash_attention_fwd.launches == before + 1
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, 0.3, return_lse=True)
    _close(got, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def _camera(angle, tx, h, w):
    f = 0.8 * w
    intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    c, s = np.cos(angle), np.sin(angle)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    ext[:3, 3] = [tx, 0.05, 0.02]
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0], cam[1, :3, :3] = ext, intr
    return cam


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 8, 64])
def test_warp_kernel_matches_plain(dev, dtype, c):
    """Geometry where many samples leave the image (partial border blends)."""
    b, h, w, d = 2, 13, 19, 6
    cams = torch.from_numpy(np.stack([_camera(0.0, 0.0, h, w), _camera(0.3, 0.8, h, w)]))
    projs = compose_projection(cams)
    dv = torch.linspace(1.5, 6.0, d)[None].expand(b, d)
    coords, _ = plane_sweep_coords(projs[1:].expand(b, 4, 4), projs[:1].expand(b, 4, 4), dv,
                                   h, w)
    g = torch.Generator(device=dev).manual_seed(c)
    src = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    coords = coords.to(dev)
    before = warp.warp_bilinear.launches
    got = warp.warp_bilinear(src, coords)
    assert warp.warp_bilinear.launches == before + 1
    torch.testing.assert_close(got, warp.warp_bilinear_plain(src, coords), atol=1e-5, rtol=1e-5)


def _fails(got, want):
    rtol, atol = tolerance(want)
    return not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("c", [1, 8, 16, 64])
def test_warp_bwd_kernel_matches_plain(dev, c):
    """Samples straddling every border; f32 atomics, so within the f32
    tolerance, not bit for bit. A corner weight 8% low must fail."""
    b, h, w, d = 3, 21, 37, 5
    g = torch.Generator(device=dev).manual_seed(c)
    xs = torch.rand(b, d, 17, 29, generator=g, device=dev) * (w + 2.2) - 1.6
    ys = torch.rand(b, d, 17, 29, generator=g, device=dev) * (h + 2.2) - 1.6
    coords = torch.stack([xs, ys], -1)
    cot = torch.randn(b, d, 17, 29, c, generator=g, device=dev)
    before = warp.warp_bilinear_bwd.launches
    got = warp.warp_bilinear_bwd(cot, coords, (b, h, w, c))
    assert warp.warp_bilinear_bwd.launches == before + 1
    want = warp.warp_bilinear_bwd_plain(cot, coords, (b, h, w, c))
    _close(got, want)
    idx, wt = next(warp.bilinear_corners(coords.reshape(b, -1, 2), h, w))
    share = torch.zeros(b * h * w, c, device=dev)
    share.index_add_(0, (idx + (torch.arange(b, device=dev) * h * w)[:, None]).reshape(-1),
                     (cot.reshape(b, -1, c) * wt[..., None]).reshape(-1, c))
    assert _fails(got - 0.08 * share.reshape(b, h, w, c), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129), (16, 1000, 700)])
def test_flash_bwd_kernels_match_plain(dev, dtype, dh, n, m):
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, dout = (torch.randn(2, n, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, m, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    out, lse = flash_attention.flash_attention_plain(q, k, v, 0.3, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, 0.3)
    before = (flash_attention.flash_attention_bwd_dkv.launches,
              flash_attention.flash_attention_bwd_dq.launches)
    dk, dv = flash_attention.flash_attention_bwd_dkv(*args)
    dq = flash_attention.flash_attention_bwd_dq(*args)
    assert (flash_attention.flash_attention_bwd_dkv.launches,
            flash_attention.flash_attention_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    want_dk, want_dv = flash_attention.flash_attention_bwd_dkv_plain(*args)
    want_dq = flash_attention.flash_attention_bwd_dq_plain(*args)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want)
    bad = (q, k, v, dout, lse, 0.92 * delta, 0.3)
    assert _fails(flash_attention.flash_attention_bwd_dq(*bad), want_dq)
    assert _fails(flash_attention.flash_attention_bwd_dkv(*bad)[0], want_dk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,ci,co,h,w", [(3, 16, 8, 19, 45), (5, 8, 8, 9, 33), (7, 8, 16, 16, 40)])
def test_conv_dx_kernel_matches_plain(dev, dtype, k, ci, co, h, w):
    g = torch.Generator(device=dev).manual_seed(k + ci)
    cot = torch.randn(2, h, w, co, generator=g, device=dev).to(dtype)
    kern = (torch.randn(k, k, ci, co, generator=g, device=dev) * 0.1).to(dtype)
    before = conv2d.conv2d_same_dx.launches
    got = conv2d.conv2d_same_dx(cot, kern)
    assert conv2d.conv2d_same_dx.launches == before + 1
    want = conv2d.conv2d_same_dx_plain(cot, kern)
    _close(got, want)
    assert _fails(conv2d.conv2d_same_dx(cot, kern.flip(0, 1)), want)


def test_autograd_functions_launch_the_backward_kernels(dev):
    """The differentiable wrappers on CUDA tensors run the kernels both ways
    and give the CPU path's gradients (fp32)."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn(2, 12, 20, 8, generator=g)
    coords = torch.stack([torch.rand(2, 3, 12, 20, generator=g) * 22 - 1,
                          torch.rand(2, 3, 12, 20, generator=g) * 14 - 1], -1)
    q, k, v = (torch.randn(1, 50, 2, 16, generator=g) for _ in range(3))
    x, kern = torch.randn(1, 16, 24, 8, generator=g), torch.randn(3, 3, 8, 8, generator=g) * 0.2
    fns = ((warp.WarpBilinear.apply, (src, coords), (0,)),
           (lambda a, b_, c: flash_attention.FlashAttention.apply(a, b_, c, 0.25), (q, k, v),
            (0, 1, 2)),
           (conv2d.Conv2dSame.apply, (x, kern), (0, 1)))
    counters = (warp.warp_bilinear_bwd, flash_attention.flash_attention_bwd_dkv,
                flash_attention.flash_attention_bwd_dq, conv2d.conv2d_same_dx)
    before = [c.launches for c in counters]
    for fn, inputs, diff in fns:
        grads = []
        for device in ("cpu", dev):
            xs = [a.detach().to(device).requires_grad_(i in diff) for i, a in enumerate(inputs)]
            out = fn(*xs)
            out.backward(torch.ones_like(out))
            grads.append([xs[i].grad.cpu() for i in diff])
        for a, b_ in zip(*grads):
            torch.testing.assert_close(b_, a, rtol=1e-4, atol=1e-4)
    assert all(c.launches > n for c, n in zip(counters, before))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 8, 8, 4, device=dev)
    with pytest.raises(ValueError):
        conv2d.conv2d_same(x, torch.randn(4, 4, 4, 8, device=dev))
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q, 0.2)
    with pytest.raises(TypeError):
        warp.warp_bilinear(x.double(), torch.zeros(1, 2, 8, 8, 2, device=dev))
    with pytest.raises(ValueError):
        warp.warp_bilinear_bwd(torch.zeros(1, 2, 8, 8, 4, device=dev, dtype=torch.bfloat16),
                               torch.zeros(1, 2, 8, 8, 2, device=dev), (1, 8, 8, 4))
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd_dq(q, q, q, q, lse, lse, 0.2)
