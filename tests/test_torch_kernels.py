"""Each hand-written kernel's plain PyTorch version against the JAX function
it replaces (Pallas kernels in interpret mode on CPU), at small odd sizes
with ragged tails. The kernels themselves are held to these plain versions
on the card by tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mvsformerplusplus_tpu.ops.grid_sample import homography_warp, homography_warp_banded
from mvsformerplusplus_tpu.ops.pallas.conv2d import conv2d_p, conv2d_viable
from mvsformerplusplus_tpu.ops.pallas.flash_attention import _flash_fwd, flash_attention
from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention as tflash, warp
from mvsformerplusplus_tpu_torch.ops.geometry import plane_sweep_coords
from mvsformerplusplus_tpu_torch.ops.grid_sample import homography_warp as t_homography_warp
from tests.test_grid_sample import compose, rand_camera
from tests.torch_parity import assert_close, t


@pytest.mark.parametrize("k,ci,co,h,w", [(3, 8, 16, 16, 40), (5, 16, 8, 8, 72),
                                         (7, 3, 8, 16, 40), (3, 1, 16, 24, 40)])
def test_conv_plain_matches_pallas(k, ci, co, h, w):
    assert conv2d_viable(h, w, ci, co, k, k)
    rng = np.random.RandomState(k * ci + co)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    kern = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    want = jax.jit(conv2d_p)(jnp.asarray(x), jnp.asarray(kern))
    assert_close(conv2d.conv2d_same(t(x), t(kern)), want)


@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129)])
def test_flash_plain_matches_pallas(dh, n, m):
    rng = np.random.RandomState(dh + n)
    q, k, v = (rng.randn(2, s, 3, dh).astype(np.float32) for s in (n, m, m))
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.21)
    got = tflash.flash_attention_fwd(t(q), t(k), t(v), 0.21)
    assert_close(got, want)


def test_flash_plain_lse_matches_pallas():
    rng = np.random.RandomState(1)
    b, n, m, h, dh = 1, 70, 90, 2, 16
    q, k, v = (rng.randn(b, s, h, dh).astype(np.float32) for s in (n, m, m))
    fold = lambda x: jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(b * h, x.shape[1], dh)  # noqa
    _, lse = _flash_fwd(fold(q) * 0.5, fold(k), fold(v), 128, 128, need_lse=True)
    _, got = tflash.flash_attention_fwd(t(q), t(k), t(v), 0.5, return_lse=True)
    assert_close(got.reshape(b * h, n), np.asarray(lse)[:, :n, 0])


def _warp_setup(seed, b, h, w, c, d, angle, tx, lo, hi):
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    ref_intr, ref_ext = rand_camera(rng, h, w, angle=0.0, tx=0.0)
    src_intr, src_ext = rand_camera(rng, h, w, angle=angle, tx=tx)
    ref_proj = np.broadcast_to(compose(ref_intr, ref_ext)[None], (b, 4, 4)).copy()
    src_proj = np.broadcast_to(compose(src_intr, src_ext)[None], (b, 4, 4)).copy()
    dv = np.broadcast_to(np.linspace(lo, hi, d, dtype=np.float32)[None], (b, d)).copy()
    return feat, src_proj, ref_proj, dv


@pytest.mark.parametrize("per_pixel", [False, True])
def test_warp_plain_matches_exact_warp(per_pixel):
    """Against the JAX exact (bilinear_sample) warp, on geometry where many
    samples leave the image (partial blending at the border)."""
    feat, src_proj, ref_proj, dv = _warp_setup(3, 2, 13, 19, 5, 6, 0.3, 0.8, 1.5, 6.0)
    if per_pixel:
        dv = np.random.RandomState(4).uniform(1.5, 6, (2, 6, 13, 19)).astype(np.float32)
    want, want_inv = homography_warp(feat, src_proj, ref_proj, dv)
    got, got_inv = t_homography_warp(t(feat), t(src_proj), t(ref_proj), t(dv))
    assert_close(got, want)
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))


def test_warp_plain_matches_banded_fused():
    """Against the TPU eval warp (banded_warp_blocked_fused, interpret mode)
    on an escape-free geometry, where the two compute the same function."""
    b, h, w, c, d = 2, 32, 384, 8, 4
    feat, src_proj, ref_proj, dv = _warp_setup(41, b, h, w, c, d, 0.05, 0.2, 3.0, 5.0)
    want, _ = homography_warp_banded(feat, src_proj, ref_proj, jnp.asarray(dv), ky=16,
                                     fused=True)
    want = np.asarray(want).reshape(c, b, d, h, w).transpose(1, 2, 3, 4, 0)
    coords, _ = plane_sweep_coords(t(src_proj), t(ref_proj), t(dv), h, w)
    assert_close(warp.warp_bilinear(t(feat), coords), want)
