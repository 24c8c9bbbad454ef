"""The backward of each differentiable kernel wrapper of the port
(WarpBilinear, FlashAttention, Conv2dSame) against the JAX package on CPU,
where each runs its plain forward and plain backward: the warp against
jax.linear_transpose of bilinear_sample, flash attention against jax.vjp of
the Pallas flash_attention and conv against jax.grad of the Pallas conv2d_p
(both in interpret mode). The CUDA kernels are held to these plain versions
on the card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformerplusplus_tpu.ops.grid_sample import bilinear_sample
from mvsformerplusplus_tpu.ops.pallas.conv2d import conv2d_p, conv2d_viable
from mvsformerplusplus_tpu.ops.pallas.flash_attention import flash_attention
from mvsformerplusplus_tpu_torch.ops.cuda.conv2d import Conv2dSame
from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (
    FlashAttention, attention_delta, flash_attention_bwd_plain, flash_attention_plain)
from mvsformerplusplus_tpu_torch.ops.cuda.warp import WarpBilinear
from tests.torch_parity import assert_close, t


def _vjp(fn, inputs, g):
    """Gradients of sum(fn(*inputs) * g) with respect to each input."""
    xs = [x.clone().requires_grad_(True) for x in inputs]
    (fn(*xs) * g).sum().backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("c", [1, 8, 16])
def test_warp_image_grad_matches_linear_transpose(c):
    """Samples on a grid from -1.6 to W+0.6 straddle every border, so some
    corners fall outside the image (zero padding gets no gradient)."""
    rng = np.random.RandomState(c)
    b, h, w, d = 2, 9, 13, 3
    src = rng.randn(b, h, w, c).astype(np.float32)
    xs = rng.uniform(-1.6, w + 0.6, (b, d, 7, 11))
    ys = rng.uniform(-1.6, h + 0.6, (b, d, 7, 11))
    coords = np.stack([xs, ys], -1).astype(np.float32)
    g = rng.randn(b, d, 7, 11, c).astype(np.float32)
    (want,) = jax.linear_transpose(lambda im: bilinear_sample(im, coords),
                                   jax.ShapeDtypeStruct(src.shape, jnp.float32))(g)
    src_t = t(src).requires_grad_(True)
    coords_t = t(coords).requires_grad_(True)
    (WarpBilinear.apply(src_t, coords_t) * t(g)).sum().backward()
    assert coords_t.grad is None
    assert_close(src_t.grad, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dh,n,m", [(16, 200, 333), (64, 77, 129)])
def test_flash_grad_matches_pallas_vjp(dh, n, m):
    """Ragged N != M; dq with respect to the unscaled q."""
    rng = np.random.RandomState(dh + n)
    q, k, v = (rng.randn(2, s, 3, dh).astype(np.float32) * 0.5 for s in (n, m, m))
    g = rng.randn(2, n, 3, dh).astype(np.float32)
    scale = 0.37
    _, vjp = jax.vjp(lambda a, b_, c: flash_attention(a, b_, c, scale), q, k, v)
    want = vjp(jnp.asarray(g))
    got = _vjp(lambda a, b_, c: FlashAttention.apply(a, b_, c, scale), (t(q), t(k), t(v)), t(g))
    for a, b_ in zip(got, want):
        assert_close(a, b_, atol=2e-5, rtol=2e-4)


def test_flash_bwd_plain_is_the_autograd_of_its_forward():
    """flash_attention_bwd_plain from the saved lse and delta (from out)
    equals autograd through flash_attention_plain, in f32 at 1e-5."""
    rng = np.random.RandomState(5)
    q, k, v = (t(rng.randn(1, s, 2, 16).astype(np.float32)) for s in (50, 70, 70))
    g = t(rng.randn(1, 50, 2, 16).astype(np.float32))
    out, lse = flash_attention_plain(q, k, v, 0.3, return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, g, lse, attention_delta(out, g), 0.3)
    want = _vjp(lambda a, b_, c: flash_attention_plain(a, b_, c, 0.3), (q, k, v), g)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)


def test_flash_forward_keeps_no_lse_without_grad():
    q = torch.randn(1, 5, 1, 16)
    out = FlashAttention.apply(q, q, q, 0.2)
    assert out.grad_fn is None
    torch.testing.assert_close(out, flash_attention_plain(q, q, q, 0.2))


@pytest.mark.parametrize("k,ci,co,h,w", [(3, 8, 16, 16, 40), (5, 16, 8, 8, 72),
                                         (7, 3, 8, 16, 40)])
def test_conv_grads_match_pallas_grad(k, ci, co, h, w):
    assert conv2d_viable(h, w, ci, co, k, k)
    rng = np.random.RandomState(k * ci + co)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    kern = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    g = rng.randn(2, h, w, co).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b_: jnp.sum(conv2d_p(a, b_) * g), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(kern))
    got = _vjp(Conv2dSame.apply, (t(x), t(kern)), t(g))
    for a, b_ in zip(got, want):
        assert_close(a, b_, atol=1e-4, rtol=1e-4)


def test_conv_skips_dx_when_the_input_needs_none():
    x = torch.randn(1, 8, 8, 3)
    kern = torch.randn(3, 3, 3, 4, requires_grad=True)
    Conv2dSame.apply(x, kern).sum().backward()
    assert x.grad is None and kern.grad is not None
