"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, forward and backward, on the card (marker `cuda`; skipped
without one), with a planted fault per backward kernel and per flash kernel
that the same check must reject. The bf16 flash kernels (tensor cores) are
held within their rounding budget (flash_attention.budget_tolerance), the
f32 ones within `tolerance`. Imports
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


def _flash_close(got, want, budget):
    """bf16 flash outputs within their rounding budget of the fp32 plain
    version (flash_attention.budget_tolerance), f32 within `tolerance`."""
    if got.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        assert bool((err <= flash_attention.budget_tolerance(want, budget)).all()), err.max()
    else:
        _close(got, want)


def _flash_fails(got, want, budget):
    if got.dtype != torch.bfloat16:
        return _fails(got, want)
    err = (got.float() - want.float()).abs()
    return bool((err > 2 * flash_attention.budget_tolerance(want, budget)).any())


def _flash_fwd_check(q, k, v, scale):
    """One forward launch through the kernel the dtype selects (by its
    counter), against the plain version; the scale 8% low must fail."""
    fa = flash_attention.flash_attention_fwd
    counter = "launches_mma" if q.dtype == torch.bfloat16 else "launches_f32"
    before = (fa.launches_mma, fa.launches_f32)
    got, lse = fa(q, k, v, scale, return_lse=True)
    step = (1, 0) if counter == "launches_mma" else (0, 1)
    assert (fa.launches_mma, fa.launches_f32) == (before[0] + step[0], before[1] + step[1])
    want, want_lse, budget = flash_attention.flash_attention_plain(q, k, v, scale, return_lse=True,
                                                                   with_budget=True)
    _flash_close(got, want, budget)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert _flash_fails(fa(q, k, v, 0.92 * scale), want, budget)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129), (64, 1729, 1729)])
def test_flash_kernel_matches_plain(dev, dtype, dh, n, m):
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, k, v = (torch.randn(2, s, 3, dh, generator=g, device=dev).to(dtype) for s in (n, m, m))
    _flash_fwd_check(q, k, v, 0.3)


def _key_tile(dh, dtype):
    """Keys per K/V tile of the forward kernel the dtype selects."""
    return (128 if dh == 16 else 64) if dtype == torch.bfloat16 else 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("tail", [1, 7, 63])
def test_flash_key_and_query_tails(dev, dtype, dh, tail):
    """Keys 1, 7 and 63 past a whole tile, queries as many past 64 rows."""
    m, n = 2 * _key_tile(dh, dtype) + tail, 64 + tail
    g = torch.Generator(device=dev).manual_seed(dh * tail)
    q, k, v = (torch.randn(2, s, 2, dh, generator=g, device=dev).to(dtype) for s in (n, m, m))
    _flash_fwd_check(q, k, v, dh ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64])
def test_flash_reads_no_key_past_m(dev, dtype, dh):
    """At B=1, k and v are the first m rows of larger tensors whose later
    rows hold NaN: a read past m would show as NaN, in the forward and in
    the backward."""
    n, m = 70, _key_tile(dh, dtype) + 9
    g = torch.Generator(device=dev).manual_seed(dh)
    q, dout = (torch.randn(1, n, 2, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    big = [torch.randn(1, m + 64, 2, dh, generator=g, device=dev).to(dtype) for _ in range(2)]
    for t in big:
        t[:, m:] = float("nan")
    k, v = (t[:, :m] for t in big)
    assert k.is_contiguous() and k.data_ptr() == big[0].data_ptr()
    out = _flash_fwd_check(q, k, v, 0.25)
    assert bool(torch.isfinite(out).all())
    _, lse = flash_attention.flash_attention_plain(q, k, v, 0.25, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    grads = flash_attention.flash_attention_bwd(q, k, v, dout, lse, delta, 0.25)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, dout, lse, delta, 0.25)
    budgets = flash_attention.flash_bwd_budget(q, k, v, dout, lse, delta, 0.25)
    for got, w, b in zip(grads, want, budgets):
        assert bool(torch.isfinite(got).all())
        _flash_close(got, w, b)


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
@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129), (16, 1000, 700),
                                    (64, 300, 129), (16, 5, 64)])
def test_flash_bwd_kernels_match_plain(dev, dtype, dh, n, m):
    """flash_attention_bwd: bf16 through the fused tensor-core kernel within
    the rounding budget, f32 through the dK/dV and dQ SIMT kernels within
    `tolerance` (by their counters); delta 8% low must fail."""
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, dout = (torch.randn(2, n, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, m, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    out, lse = flash_attention.flash_attention_plain(q, k, v, 0.3, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, 0.3)
    counters = (flash_attention.flash_attention_bwd, "launches_mma"), \
        (flash_attention.flash_attention_bwd_dkv, "launches"), \
        (flash_attention.flash_attention_bwd_dq, "launches")
    before = [getattr(f, a) for f, a in counters]
    grads = flash_attention.flash_attention_bwd(*args)
    step = [1, 0, 0] if dtype == torch.bfloat16 else [0, 1, 1]
    assert [getattr(f, a) for f, a in counters] == [b + s for b, s in zip(before, step)]
    want = flash_attention.flash_attention_bwd_plain(*args)
    budgets = flash_attention.flash_bwd_budget(*args)
    for got, w, b in zip(grads, want, budgets):
        assert got.dtype == dtype and got.shape == w.shape
        _flash_close(got, w, b)
    bad = flash_attention.flash_attention_bwd(q, k, v, dout, lse, 0.92 * delta, 0.3)
    assert _flash_fails(bad[0], want[0], budgets[0])
    assert _flash_fails(bad[1], want[1], budgets[1])


def test_flash_autograd_in_bf16_runs_the_mma_kernels(dev):
    """FlashAttention on bf16 CUDA tensors: one mma forward and one fused
    mma backward, no SIMT launch; gradients only where asked."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 90, 2, 16, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    fa, fb = flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd
    f32 = (fa.launches_f32, flash_attention.flash_attention_bwd_dkv.launches,
           flash_attention.flash_attention_bwd_dq.launches)
    before = (fa.launches_mma, fb.launches_mma)
    qr, kr = q.requires_grad_(True), k.requires_grad_(True)
    flash_attention.FlashAttention.apply(qr, kr, v, 0.25).float().sum().backward()
    assert (fa.launches_mma, fb.launches_mma) == (before[0] + 1, before[1] + 1)
    assert (fa.launches_f32, flash_attention.flash_attention_bwd_dkv.launches,
            flash_attention.flash_attention_bwd_dq.launches) == f32
    assert qr.grad is not None and kr.grad is not None and v.grad is None


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
    qb = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bwd_dkv(qb, qb, qb, qb, lse, lse, 0.2)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd(qb.half(), qb.half(), qb.half(), 0.2)
