"""Each hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, on the card (marker `cuda`; skipped without one). Imports
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


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 8, 8, 4, device=dev)
    with pytest.raises(ValueError):
        conv2d.conv2d_same(x, torch.randn(4, 4, 4, 8, device=dev))
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, q, q, 0.2)
    with pytest.raises(TypeError):
        warp.warp_bilinear(x.double(), torch.zeros(1, 2, 8, 8, 2, device=dev))
