"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, forward and backward, on the card (marker `cuda`; skipped
without one), with a planted fault per backward kernel and per flash kernel
that the same check must reject. The bf16 flash kernels (tensor cores) are
held within their rounding budget (flash_attention.budget_tolerance), the
f32 ones within `tolerance`. The last cases take the shapes a rank of
parallel.dist meets on the train crop (one sample per rank, or half the
source views). Imports no JAX, so it also runs on a machine without it:

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


# conv cases (k, Ci, Co, B, H, W): every Ci the paths give the forward (1, 3,
# 8, 16, 32, 64) with every Co (8, 16, 32, 64) at k 3, 5 and 7, at batches of
# 1-3 and sizes that are no multiple of the 8 x 32 pixel tile; and Co 24 and
# 128 (several Co tiles)
CONV_GRID = [(k, ci, co, 1 + (i % 3), 9 + (i % 5), 33 + 2 * (i % 7))
             for i, (k, ci, co) in enumerate((k, ci, co) for k in (3, 5, 7)
                                             for ci in (1, 3, 8, 16, 32, 64)
                                             for co in (8, 16, 32, 64))]
CONV_EXTRA = [(5, 8, 24, 2, 9, 33), (3, 16, 128, 2, 10, 70), (3, 64, 8, 3, 19, 45),
              (3, 12, 20, 2, 11, 35), (5, 7, 5, 1, 13, 30), (3, 36, 40, 1, 9, 40)]
# the (k, Ci, Co) of the grid whose mma tiles would not fit a block's shared
# memory: they run the tf32 kernel in bf16 too
NOT_BUILT = ((5, 64, 64), (7, 32, 64), (7, 64, 16), (7, 64, 32), (7, 64, 64))


def _conv_check(fn, plain, fault, x, kern):
    """One launch of fn through the kernel `conv2d.variant` names (by its
    counters), against the plain version; the planted fault must fail."""
    got, kind = _launched(fn, lambda: fn(x, kern), ("mma", "tf32"))
    want = plain(x, kern)
    _close(got, want)
    assert _fails(fault(x, kern), want)
    return kind


def _conv_fault(x, kern):
    """The top row of taps weighted 8% low."""
    bad = kern.clone()
    bad[0] *= 0.92
    return conv2d.conv2d_same(x, bad)


def _conv_dx_fault(g, kern):
    """The weights not flipped in space."""
    return conv2d.conv2d_same_dx(g, kern.flip(0, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,ci,co,b,h,w", CONV_GRID + CONV_EXTRA)
def test_conv_kernel_matches_plain(dev, dtype, k, ci, co, b, h, w):
    g = torch.Generator(device=dev).manual_seed(k + ci + co)
    x = torch.randn(b, h, w, ci, generator=g, device=dev).to(dtype)
    kern = (torch.randn(k, k, ci, co, generator=g, device=dev) * (k * k * ci) ** -0.5).to(dtype)
    kind = _conv_check(conv2d.conv2d_same, conv2d.conv2d_same_plain, _conv_fault, x, kern)
    assert kind == conv2d.variant(x, kern)
    assert kind == ("mma" if dtype == torch.bfloat16 and (k, ci, co) not in NOT_BUILT
                    and co % 8 == 0 and ci in (1, 3, 7, 8, 16, 32, 64) else "tf32")


@pytest.mark.parametrize("ci", [8, 64])
def test_conv_misaligned_input_takes_the_simt_kernel(dev, ci):
    """A bf16 input view off a 16-byte boundary runs the tf32 kernel (the
    SIMT one's successor), with the same result; aligned, the same input
    runs the mma kernel."""
    g = torch.Generator(device=dev).manual_seed(300 + ci)
    x = torch.randn(2, 11, 37, ci, generator=g, device=dev).to(torch.bfloat16)
    kern = (torch.randn(3, 3, ci, 16, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    fwd = (conv2d.conv2d_same, conv2d.conv2d_same_plain, _conv_fault)
    assert _conv_check(*fwd, _misaligned(x), kern) == "tf32"
    assert _conv_check(*fwd, x, kern) == "mma"
    dx = (conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, _conv_dx_fault)
    gk = (torch.randn(3, 3, 16, ci, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    assert _conv_check(*dx, _misaligned(x), gk) == "tf32"
    assert _conv_check(*dx, x, gk) == "mma"


@pytest.mark.parametrize("ci", [4, 8, 64])
def test_conv_f32_misaligned_input_takes_4_byte_copies(dev, ci):
    """An f32 input off a 16-byte boundary is staged by 4-byte cp.async, not
    16-byte, with the same result, forward and dx."""
    g = torch.Generator(device=dev).manual_seed(310 + ci)
    x = torch.randn(2, 11, 37, ci, generator=g, device=dev)
    kern = torch.randn(3, 3, ci, 16, generator=g, device=dev) * 0.1
    fwd = (conv2d.conv2d_same, conv2d.conv2d_same_plain, _conv_fault)
    assert _conv_check(*fwd, _misaligned(x), kern) == "tf32"
    dx = (conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, _conv_dx_fault)
    gk = torch.randn(3, 3, 16, ci, generator=g, device=dev) * 0.1
    assert _conv_check(*dx, _misaligned(x), gk) == "tf32"


@pytest.mark.parametrize("kdtype,dtype,dx", [(torch.float32, torch.float32, False),
                                             (torch.float32, torch.float32, True),
                                             (torch.float32, torch.bfloat16, False),
                                             (torch.bfloat16, torch.bfloat16, True)])
def test_conv_tf32_packing_on_the_card_is_the_cpu_packing(dev, kdtype, dtype, dx):
    """conv2d_pack_tf32_kernel gathers and splits the weights as the torch
    version on the CPU does, bit for bit, from a strided (permuted) kernel,
    rounding f32 weights to bf16 first for bf16 inputs."""
    g = torch.Generator().manual_seed(11)
    param = torch.randn(12, 20, 5, 5, generator=g).to(kdtype)  # [Co, Ci, k, k]
    kern = param.permute(2, 3, 1, 0)
    for cot in (8, 16):
        cpu = conv2d.pack_weights_tf32(kern, dtype, cot, dx)
        card = conv2d.pack_weights_tf32(param.to(dev).permute(2, 3, 1, 0), dtype, cot, dx)
        assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))


def test_conv_tf32_streams_the_weights_where_they_do_not_fit(dev):
    """The 7x7 at Ci 64 in f32 (its resident weights and three halo stages
    exceed a block's shared memory) stages each chunk's weights beside its
    halo; bf16 (one halo stage) keeps them resident, one block an SM."""
    assert conv2d.tf32_plan(7, 64, 12) == (8, True)
    assert conv2d.tf32_plan(7, 64, 12, torch.bfloat16) == (8, False)
    g = torch.Generator(device=dev).manual_seed(320)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, 10, 40, 64, generator=g, device=dev).to(dtype)
        kern = (torch.randn(7, 7, 64, 12, generator=g, device=dev) * 0.02).to(dtype)
        fwd = (conv2d.conv2d_same, conv2d.conv2d_same_plain, _conv_fault)
        assert _conv_check(*fwd, x, kern) == "tf32"


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
    """Keys per K/V tile of the forward kernel the dtype selects (FwdTile,
    F32Tile in csrc/flash_attention.cu)."""
    if dtype == torch.bfloat16:
        return 128 if dh == 16 else 64
    return {16: 128, 32: 64, 64: 64, 128: 32}[dh]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("tail", [1, 7, 63])
def test_flash_key_and_query_tails(dev, dtype, dh, tail):
    """Keys 1, 7 and 63 past a whole tile, queries as many past 64 rows."""
    m, n = 2 * _key_tile(dh, dtype) + tail, 64 + tail
    g = torch.Generator(device=dev).manual_seed(dh * tail)
    q, k, v = (torch.randn(2, s, 2, dh, generator=g, device=dev).to(dtype) for s in (n, m, m))
    _flash_fwd_check(q, k, v, dh ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
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


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_f32_any_scale(dev, scale):
    """The f32 kernel takes any scale: a negative one
    (q's sign flipped) and zero (uniform weights, keys past a whole tile
    still masked)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, s, 2, 64, generator=g, device=dev) for s in (70, 135, 135))
    got, lse = flash_attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
    want, want_lse = flash_attention.flash_attention_plain(q, k, v, scale, return_lse=True)
    _close(got, want)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_bwd_f32_any_scale(dev, scale):
    """The f32 backward takes any scale: a negative one and zero (uniform
    weights), with keys past a whole 64-key block."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, dout = (torch.randn(2, 70, 2, 64, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(2, 135, 2, 64, generator=g, device=dev) for _ in range(2))
    out, lse = flash_attention.flash_attention_plain(q, k, v, scale, return_lse=True)
    args = (q, k, v, dout, lse, flash_attention.attention_delta(out, dout), scale)
    for got, want in zip(flash_attention.flash_attention_bwd(*args),
                         flash_attention.flash_attention_bwd_plain(*args)):
        _close(got, want)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("n,m", [(1, 9), (17, 65), (100, 63), (129, 200)])
def test_flash_bwd_f32_every_head_dim_and_tail(dev, dh, n, m):
    """The fused 3xTF32 backward at its four head dims with queries and keys
    past whole tiles (16 or 32 queries, 64 keys), q and k at std 1.5."""
    g = torch.Generator(device=dev).manual_seed(dh + n + m)
    q, k = (1.5 * torch.randn(2, s, 3, dh, generator=g, device=dev) for s in (n, m))
    v, dout = (torch.randn(2, s, 3, dh, generator=g, device=dev) for s in (m, n))
    out, lse = flash_attention.flash_attention_plain(q, k, v, dh ** -0.5, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, dh ** -0.5)
    fb = flash_attention.flash_attention_bwd
    before = (fb.launches_mma, fb.launches_f32)
    grads = fb(*args)
    assert (fb.launches_mma, fb.launches_f32) == (before[0], before[1] + 1)
    for got, want in zip(grads, flash_attention.flash_attention_bwd_plain(*args)):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)
    bad = fb(q, k, v, dout, lse, 0.92 * delta, dh ** -0.5)
    want = flash_attention.flash_attention_bwd_plain(*args)
    assert _fails(bad[0], want[0]) and _fails(bad[1], want[1])


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


def _launched(fn, call, kinds=("vec", "scalar")):
    """Run call(); return the variant of `kinds` whose counter moved on fn
    (exactly one, by one, and the total with it)."""
    before = {k: getattr(fn, f"launches_{k}") for k in kinds}
    total = fn.launches
    out = call()
    moved = [k for k, n in before.items() if getattr(fn, f"launches_{k}") != n]
    assert len(moved) == 1 and getattr(fn, f"launches_{moved[0]}") == before[moved[0]] + 1
    assert fn.launches == total + 1
    return out, moved[0]


def _misaligned(t):
    """t's values in a contiguous view one element off a 16-byte boundary."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _check_warp(src, coords):
    """One launch, through the variant `warp.variant` names (by its
    counter), against the plain version; coords off by 1/256 px must fail."""
    b, h, w, c = src.shape
    got, kind = _launched(warp.warp_bilinear, lambda: warp.warp_bilinear(src, coords))
    assert kind == warp.variant(src, c)
    want = warp.warp_bilinear_plain(src, coords)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert _fails(warp.warp_bilinear(src, coords + 1 / 256), want)
    return kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 8, 16, 32, 64])
def test_warp_kernel_matches_plain(dev, dtype, c):
    """Geometry where many samples leave the image (partial border blends);
    2 x 6 x 13 x 19 samples, no multiple of the 256-thread block. C 1 and 3
    run the scalar kernel, the rest the vector one (f32 and bf16)."""
    b, h, w, d = 2, 13, 19, 6
    cams = torch.from_numpy(np.stack([_camera(0.0, 0.0, h, w), _camera(0.3, 0.8, h, w)]))
    projs = compose_projection(cams)
    dv = torch.linspace(1.5, 6.0, d)[None].expand(b, d)
    coords, _ = plane_sweep_coords(projs[1:].expand(b, 4, 4), projs[:1].expand(b, 4, 4), dv,
                                   h, w)
    g = torch.Generator(device=dev).manual_seed(c)
    src = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    kind = _check_warp(src, coords.to(dev))
    assert kind == ("scalar" if c in (1, 3) else "vec")


def _border_coords(g, b, d, hh, ww, h, w):
    """Sample positions past every border and far outside the image: uniform
    over [-1.6, W + 0.6] x [-1.6, H + 0.6], with some rows and columns moved
    to +-1e6 px, exactly on -1 and W or H, and to 1e30."""
    xs = torch.rand(b, d, hh, ww, generator=g, device=g.device) * (w + 2.2) - 1.6
    ys = torch.rand(b, d, hh, ww, generator=g, device=g.device) * (h + 2.2) - 1.6
    xs[:, :, 0], ys[:, :, 1] = 1e6, -1e6
    xs[:, :, :, 0], ys[:, :, :, 1] = -1.0, float(h)
    xs[:, :, 2, 2], ys[:, :, 3, 3] = float(w), 1e30
    return torch.stack([xs, ys], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 8, 64])
def test_warp_kernel_at_every_border_and_far_outside(dev, dtype, c):
    b, h, w = 3, 21, 37
    g = torch.Generator(device=dev).manual_seed(100 + c)
    coords = _border_coords(g, b, 5, 17, 29, h, w)
    src = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    _check_warp(src, coords)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 64])
def test_warp_misaligned_source_takes_the_scalar_kernel(dev, dtype, c):
    """A source view off a 16-byte boundary at a vector width runs the
    scalar kernel, with the same result."""
    b, h, w = 2, 11, 23
    g = torch.Generator(device=dev).manual_seed(200 + c)
    coords = _border_coords(g, b, 3, 9, 14, h, w)
    src = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    assert _check_warp(_misaligned(src), coords) == "scalar"
    assert _check_warp(src, coords) == "vec"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 5, 6, 12, 15, 17, 24, 48])
def test_warp_scalar_widths_match_plain(dev, dtype, c):
    """Channel counts outside VEC_CHANNELS run the scalar variant (below 16
    channels its thread-per-sample kernel, from 17 on its channel-fastest
    one): samples past every border, 3 x 5 x 17 x 29 of them (no multiple of
    its 256-sample tile), aligned and off a 16-byte boundary."""
    b, h, w = 3, 21, 37
    g = torch.Generator(device=dev).manual_seed(400 + c)
    coords = _border_coords(g, b, 5, 17, 29, h, w)
    src = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
    assert _check_warp(src, coords) == "scalar"
    assert _check_warp(_misaligned(src), coords) == "scalar"


def _fails(got, want):
    rtol, atol = tolerance(want)
    return not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)


def _check_warp_bwd(cot, coords, src_shape):
    """One launch, through the variant `warp.variant` names (by its
    counter), against the plain version within the f32 tolerance (atomics:
    not bit for bit); the top-left corner's weight 8% low must fail."""
    b, h, w, c = src_shape
    got, kind = _launched(warp.warp_bilinear_bwd,
                          lambda: warp.warp_bilinear_bwd(cot, coords, src_shape))
    assert kind == warp.variant(cot, c)
    want = warp.warp_bilinear_bwd_plain(cot, coords, src_shape)
    _close(got, want)
    idx, wt = next(warp.bilinear_corners(coords.reshape(b, -1, 2), h, w))
    share = torch.zeros(b * h * w, c, device=cot.device)
    share.index_add_(0, (idx + (torch.arange(b, device=cot.device) * h * w)[:, None]).reshape(-1),
                     (cot.reshape(b, -1, c) * wt[..., None]).reshape(-1, c))
    assert _fails(got - 0.08 * share.reshape(b, h, w, c), want)
    return kind


@pytest.mark.parametrize("c", [1, 3, 8, 16, 32, 64])
def test_warp_bwd_kernel_matches_plain(dev, c):
    """Samples past every border and far outside the image; C 1 and 3 run
    the scalar kernel, the rest the vector one."""
    b, h, w, d = 3, 21, 37, 5
    g = torch.Generator(device=dev).manual_seed(c)
    coords = _border_coords(g, b, d, 17, 29, h, w)
    cot = torch.randn(b, d, 17, 29, c, generator=g, device=dev)
    cot[:, :, 5] = 0.0  # whole zero vectors skip the atomics
    kind = _check_warp_bwd(cot, coords, (b, h, w, c))
    assert kind == ("scalar" if c in (1, 3) else "vec")


@pytest.mark.parametrize("c", [2, 5, 6, 12, 24, 48])
def test_warp_bwd_scalar_widths_match_plain(dev, c):
    """The backward's scalar kernel at channel counts outside VEC_CHANNELS
    (float4 reductions where 4 divides C, float2 where 2 does, else
    scalar), aligned and off a 16-byte boundary, zero vectors included."""
    b, h, w, d = 3, 21, 37, 5
    g = torch.Generator(device=dev).manual_seed(500 + c)
    coords = _border_coords(g, b, d, 17, 29, h, w)
    cot = torch.randn(b, d, 17, 29, c, generator=g, device=dev)
    cot[:, :, 5] = 0.0
    assert _check_warp_bwd(cot, coords, (b, h, w, c)) == "scalar"
    assert _check_warp_bwd(_misaligned(cot), coords, (b, h, w, c)) == "scalar"


@pytest.mark.parametrize("c", [8, 64])
def test_warp_bwd_misaligned_cotangent_takes_the_scalar_kernel(dev, c):
    b, h, w = 2, 15, 26
    g = torch.Generator(device=dev).manual_seed(300 + c)
    coords = _border_coords(g, b, 3, 11, 13, h, w)
    cot = torch.randn(b, 3, 11, 13, c, generator=g, device=dev)
    assert _check_warp_bwd(_misaligned(cot), coords, (b, h, w, c)) == "scalar"
    assert _check_warp_bwd(cot, coords, (b, h, w, c)) == "vec"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129), (16, 1000, 700),
                                    (64, 300, 129), (16, 5, 64)])
def test_flash_bwd_kernels_match_plain(dev, dtype, dh, n, m):
    """flash_attention_bwd: bf16 through the fused tensor-core kernel within
    the rounding budget, f32 through the fused 3xTF32 kernel within
    `tolerance` (by their counters); delta 8% low must fail."""
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, dout = (torch.randn(2, n, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, m, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    out, lse = flash_attention.flash_attention_plain(q, k, v, 0.3, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, 0.3)
    counters = (flash_attention.flash_attention_bwd, "launches_mma"), \
        (flash_attention.flash_attention_bwd, "launches_f32")
    before = [getattr(f, a) for f, a in counters]
    grads = flash_attention.flash_attention_bwd(*args)
    step = [1, 0] if dtype == torch.bfloat16 else [0, 1]
    assert [getattr(f, a) for f, a in counters] == [b + s for b, s in zip(before, step)]
    want = flash_attention.flash_attention_bwd_plain(*args)
    budgets = flash_attention.flash_bwd_budget(*args)
    for got, w, b in zip(grads, want, budgets):
        assert got.dtype == dtype and got.shape == w.shape
        _flash_close(got, w, b)
    bad = flash_attention.flash_attention_bwd(q, k, v, dout, lse, 0.92 * delta, 0.3)
    assert _flash_fails(bad[0], want[0], budgets[0])
    assert _flash_fails(bad[1], want[1], budgets[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,n,m", [(24, 200, 333), (32, 77, 129), (24, 1000, 700),
                                    (32, 65, 64), (8, 70, 90), (48, 130, 67), (128, 150, 140)])
def test_flash_padded_head_dims_match_plain(dev, dtype, dh, n, m):
    """Head dims between the kernels' widths (16, 32, 64, 128): the wrappers
    zero-pad to the next width and slice back. Forward and backward against
    the plain versions at the true head dim, through the kernel the dtype
    selects (the forward's counters), with their planted faults."""
    g = torch.Generator(device=dev).manual_seed(dh + n)
    q, dout = (torch.randn(2, n, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, m, 3, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    out = _flash_fwd_check(q, k, v, dh ** -0.5)
    assert out.shape == q.shape and out.is_contiguous()
    _, lse = flash_attention.flash_attention_plain(q, k, v, dh ** -0.5, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, dh ** -0.5)
    grads = flash_attention.flash_attention_bwd(*args)
    want = flash_attention.flash_attention_bwd_plain(*args)
    budgets = flash_attention.flash_bwd_budget(*args)
    for got, w, b in zip(grads, want, budgets):
        assert got.dtype == dtype and got.shape == w.shape and got.is_contiguous()
        _flash_close(got, w, b)
    bad = flash_attention.flash_attention_bwd(q, k, v, dout, lse, 0.92 * delta, dh ** -0.5)
    assert _flash_fails(bad[0], want[0], budgets[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_above_128_raises(dev, dtype):
    q = torch.zeros(1, 8, 1, 129, device=dev, dtype=dtype)
    fa = flash_attention.flash_attention_fwd
    before = (fa.launches_mma, fa.launches_f32)
    with pytest.raises(ValueError, match="up to 128"):
        fa(q, q, q, 0.1)
    lse = torch.zeros(1, 1, 8, device=dev)
    with pytest.raises(ValueError, match="up to 128"):
        flash_attention.flash_attention_bwd(q, q, q, q, lse, lse, 0.1)
    assert (fa.launches_mma, fa.launches_f32) == before


def test_flash_autograd_in_bf16_runs_the_mma_kernels(dev):
    """FlashAttention on bf16 CUDA tensors: one mma forward and one fused
    mma backward, no f32 launch; gradients only where asked."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 90, 2, 16, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    fa, fb = flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd
    f32 = (fa.launches_f32, fb.launches_f32)
    before = (fa.launches_mma, fb.launches_mma)
    qr, kr = q.requires_grad_(True), k.requires_grad_(True)
    flash_attention.FlashAttention.apply(qr, kr, v, 0.25).float().sum().backward()
    assert (fa.launches_mma, fb.launches_mma) == (before[0] + 1, before[1] + 1)
    assert (fa.launches_f32, fb.launches_f32) == f32
    assert qr.grad is not None and kr.grad is not None and v.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,ci,co,b,h,w", [c for c in CONV_GRID if c[1] >= 8]
                         + [(3, 16, 8, 1, 19, 45), (5, 8, 8, 2, 9, 33), (7, 8, 16, 2, 16, 40)])
def test_conv_dx_kernel_matches_plain(dev, dtype, k, ci, co, b, h, w):
    """dx of the forward conv [k, k, Ci, Co]: the kernel on the cotangent
    [B, H, W, Co] with Ci outputs."""
    g = torch.Generator(device=dev).manual_seed(k + ci + co)
    cot = torch.randn(b, h, w, co, generator=g, device=dev).to(dtype)
    kern = (torch.randn(k, k, ci, co, generator=g, device=dev) * (k * k * co) ** -0.5).to(dtype)
    kind = _conv_check(conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, _conv_dx_fault, cot,
                       kern)
    assert kind == conv2d.variant(cot, conv2d.dx_kernel(kern))
    assert kind == ("mma" if dtype == torch.bfloat16 and (k, co, ci) not in NOT_BUILT else "tf32")


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
    counters = ((warp.warp_bilinear_bwd, "launches"),
                (flash_attention.flash_attention_bwd, "launches_f32"),
                (conv2d.conv2d_same_dx, "launches_tf32"))
    before = [getattr(c, a) for c, a in counters]
    for fn, inputs, diff in fns:
        grads = []
        for device in ("cpu", dev):
            xs = [a.detach().to(device).requires_grad_(i in diff) for i, a in enumerate(inputs)]
            out = fn(*xs)
            out.backward(torch.ones_like(out))
            grads.append([xs[i].grad.cpu() for i in diff])
        for a, b_ in zip(*grads):
            torch.testing.assert_close(b_, a, rtol=1e-4, atol=1e-4)
    assert all(getattr(c, a) > n for (c, a), n in zip(counters, before))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 8, 8, 4, device=dev)
    with pytest.raises(ValueError):
        conv2d.conv2d_same(x, torch.randn(4, 4, 4, 8, device=dev))
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q[..., :16], q[..., :16], 0.2)
    with pytest.raises(TypeError):
        warp.warp_bilinear(x.double(), torch.zeros(1, 2, 8, 8, 2, device=dev))
    with pytest.raises(ValueError):
        warp.warp_bilinear_bwd(torch.zeros(1, 2, 8, 8, 4, device=dev, dtype=torch.bfloat16),
                               torch.zeros(1, 2, 8, 8, 2, device=dev), (1, 8, 8, 4))
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, q, lse[..., :4], lse, 0.2)
    qb = torch.randn(1, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bwd(qb.half(), qb.half(), qb.half(), qb.half(), lse,
                                            lse, 0.2)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_fwd(qb.half(), qb.half(), qb.half(), 0.2)


# the train crop (512 x 640) as the ranks of parallel.dist see it: per stage
# (D, C, H/8..H, W/8..W); a rank at --mesh 2,1 holds one sample and warps its
# 4 source views, a rank at --mesh 1,2 holds two samples and warps 2 of
# their 4 (shard_views): 4 folded views either way, each rank its own
RANK_STAGES = [(32, 64, 64, 80), (16, 32, 128, 160), (8, 16, 256, 320), (4, 8, 512, 640)]


def _rank_warp_coords(views, b, d, hh, ww, dev):
    """Plane-sweep coordinates of `views` source views of `b` samples folded
    view-major, as StageNet.build_volume folds them."""
    cams = torch.from_numpy(np.stack([_camera(0.0, 0.0, hh, ww)]
                                     + [_camera(0.05 * i, 0.3 * i, hh, ww)
                                        for i in range(1, views + 1)]))
    projs = compose_projection(cams)
    src = projs[1:].repeat_interleave(b, 0)
    ref = projs[:1].expand(views * b, 4, 4)
    dv = torch.linspace(2.0, 6.0, d)[None].expand(views * b, d)
    return plane_sweep_coords(src, ref, dv, hh, ww)[0].to(dev)


@pytest.mark.parametrize("views,b", [(4, 1), (2, 2)], ids=["mesh2x1", "mesh1x2"])
@pytest.mark.parametrize("d,c,hh,ww", RANK_STAGES)
def test_warp_at_the_ranks_shapes(dev, views, b, d, c, hh, ww):
    """The warp and its image gradient at a rank's shapes, each through the
    vector kernel, against the plain version, with the planted faults."""
    g = torch.Generator(device=dev).manual_seed(d + c + views)
    coords = _rank_warp_coords(views, b, d, hh, ww, dev)
    src = torch.randn(views * b, hh, ww, c, generator=g, device=dev).to(torch.bfloat16)
    assert _check_warp(src, coords) == "vec"
    cot = torch.randn(views * b, d, hh, ww, c, generator=g, device=dev)
    assert _check_warp_bwd(cot, coords, (views * b, hh, ww, c)) == "vec"


@pytest.mark.parametrize("part,b,n,heads,dh", [("vit", 5, 321, 12, 64), ("cta", 1, 5120, 4, 16)])
def test_flash_at_one_sample_per_rank(dev, part, b, n, heads, dh):
    """Flash at a --mesh 2,1 rank's train shapes (one sample, 512 x 640):
    the ViT's 5 views of 321 tokens and the CTA's 5120 tokens, forward
    through the mma kernel; the CTA's backward too (q, k at std 1.5, as
    chip_smoke.py draws them), each with its planted fault."""
    g = torch.Generator(device=dev).manual_seed(n)
    q, k = (1.5 * torch.randn(b, n, heads, dh, generator=g, device=dev) for _ in range(2))
    v, dout = (torch.randn(b, n, heads, dh, generator=g, device=dev) for _ in range(2))
    q, k, v, dout = (x.to(torch.bfloat16) for x in (q, k, v, dout))
    scale = dh ** -0.5
    out = _flash_fwd_check(q, k, v, scale)
    if part == "vit":
        return
    _, lse = flash_attention.flash_attention_plain(q, k, v, scale, return_lse=True)
    delta = flash_attention.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, scale)
    before = flash_attention.flash_attention_bwd.launches_mma
    grads = flash_attention.flash_attention_bwd(*args)
    assert flash_attention.flash_attention_bwd.launches_mma == before + 1
    want = flash_attention.flash_attention_bwd_plain(*args)
    budgets = flash_attention.flash_bwd_budget(*args)
    for got, w, bud in zip(grads, want, budgets):
        _flash_close(got, w, bud)
    bad = flash_attention.flash_attention_bwd(q, k, v, dout, lse, 0.92 * delta, scale)
    assert _flash_fails(bad[0], want[0], budgets[0])


# a rank's convs at 512 x 640 (B, H, W, Ci, Co, k): the encoder's on one
# sample's 5 views, the decoder heads, a visibility net on 4 folded views
# (either layout), the FMT smoothing on one view
RANK_CONVS = [(5, 512, 640, 3, 8, 7), (5, 512, 640, 8, 8, 5), (5, 256, 320, 16, 16, 3),
              (5, 128, 160, 32, 32, 3), (5, 64, 80, 64, 64, 3), (5, 128, 160, 64, 32, 3),
              (5, 256, 320, 64, 16, 3), (5, 512, 640, 64, 8, 3), (4, 64, 80, 1, 16, 3),
              (4, 512, 640, 16, 16, 3), (4, 512, 640, 16, 8, 3), (1, 64, 80, 32, 32, 3),
              (1, 512, 640, 8, 8, 3)]


@pytest.mark.parametrize("b,h,w,ci,co,k", RANK_CONVS)
def test_conv_at_one_sample_per_rank(dev, b, h, w, ci, co, k):
    """The conv through the mma kernel at a rank's shapes, and its dx where
    the train path needs it (not on the images, not on the entropy), each
    with its planted fault."""
    g = torch.Generator(device=dev).manual_seed(h + ci + co)
    x = torch.randn(b, h, w, ci, generator=g, device=dev).to(torch.bfloat16)
    kern = (torch.randn(k, k, ci, co, generator=g, device=dev) * (k * k * ci) ** -0.5).to(
        torch.bfloat16)
    assert _conv_check(conv2d.conv2d_same, conv2d.conv2d_same_plain, _conv_fault, x, kern) == "mma"
    if ci in (1, 3):
        return
    cot = torch.randn(b, h, w, co, generator=g, device=dev).to(torch.bfloat16)
    assert _conv_check(conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, _conv_dx_fault, cot,
                       kern) == "mma"
