"""Flash attention at head dims between the kernels' widths, on the CPU.

The CUDA kernels are built at head dims 16, 32, 64 and 128; the wrappers
zero-pad q, k, v (and dout) to the next of these and slice the outputs and
gradients back (ops/cuda/flash_attention.py padded_head_dim, pad_head_dim).
Here that rule runs through the plain versions at Dh 8, 24, 32, 48 and 128:
the padded forward and backward, sliced, equal the unpadded ones and JAX's
softmax_attention_xla (with its VJP), the padded columns come out zero, lse
and the rounding budgets are unchanged, and a head dim above 128 is refused
by name. The kernels themselves at these head dims are
tests/test_torch_cuda_kernels.py's (marker cuda)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.ops.attention import softmax_attention_xla
from mvsformerplusplus_tpu_torch.ops.cuda import flash_attention as fa

HEAD_DIMS = [8, 24, 32, 48, 128]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dh, n=37, m=29, heads=3):
    rng = np.random.RandomState(dh)
    q, dout = (rng.randn(2, n, heads, dh).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, m, heads, dh).astype(np.float32) for _ in range(2))
    return q, k, v, dout


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_padded_width(dh):
    width = fa.padded_head_dim(dh)
    assert width in fa.HEAD_DIMS and width >= dh
    assert all(w < dh for w in fa.HEAD_DIMS if w < width)


def test_head_dim_above_128_raises():
    with pytest.raises(ValueError, match="up to 128"):
        fa.padded_head_dim(129)
    x = torch.zeros(1, 4, 1, 129)
    with pytest.raises(ValueError, match="up to 128"):
        fa._check_qkv(x, x, x)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_pad_and_slice_forward(dh):
    q, k, v, _ = _inputs(dh)
    scale = dh ** -0.5
    width = fa.padded_head_dim(dh)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    padded = [fa.pad_head_dim(x, width) for x in (qt, kt, vt)]
    assert all(p.shape[-1] == width and torch.equal(p[..., :dh], x)
               for p, x in zip(padded, (qt, kt, vt)))
    out_p, lse_p, budget_p = fa.flash_attention_plain(*padded, scale, return_lse=True,
                                                      with_budget=True)
    out, lse, budget = fa.flash_attention_plain(qt, kt, vt, scale, return_lse=True,
                                                with_budget=True)
    assert torch.equal(out_p[..., dh:], torch.zeros_like(out_p[..., dh:]))
    assert torch.equal(budget_p[..., dh:], torch.zeros_like(budget_p[..., dh:]))
    torch.testing.assert_close(out_p[..., :dh], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(budget_p[..., :dh], budget, rtol=1e-6, atol=1e-9)
    want = np.asarray(jax.jit(softmax_attention_xla, static_argnums=3)(q, k, v, scale))
    np.testing.assert_allclose(out_p[..., :dh].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_pad_and_slice_backward(dh):
    q, k, v, dout = _inputs(dh)
    scale = dh ** -0.5
    width = fa.padded_head_dim(dh)
    qt, kt, vt, dt = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(qt, kt, vt, scale, return_lse=True)
    delta = fa.attention_delta(out, dt)
    padded = [fa.pad_head_dim(x, width) for x in (qt, kt, vt, dt)]
    torch.testing.assert_close(fa.attention_delta(fa.pad_head_dim(out, width), padded[3]), delta,
                               rtol=1e-6, atol=1e-6)
    grads_p = fa.flash_attention_bwd_plain(*padded, lse, delta, scale)
    grads = fa.flash_attention_bwd_plain(qt, kt, vt, dt, lse, delta, scale)
    budgets_p = fa.flash_bwd_budget(*padded, lse, delta, scale)
    budgets = fa.flash_bwd_budget(qt, kt, vt, dt, lse, delta, scale)
    _, vjp = jax.vjp(lambda a, b, c: softmax_attention_xla(a, b, c, scale), q, k, v)
    jax_grads = vjp(dout)
    for g_p, g, b_p, b, w in zip(grads_p, grads, budgets_p, budgets, jax_grads):
        assert torch.equal(g_p[..., dh:], torch.zeros_like(g_p[..., dh:]))
        assert torch.equal(b_p[..., dh:], torch.zeros_like(b_p[..., dh:]))
        torch.testing.assert_close(g_p[..., :dh], g, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b_p[..., :dh], b, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(g_p[..., :dh].numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dh", [24, 48])
def test_autograd_on_cpu_at_odd_head_dims(dh):
    """FlashAttention (the model's entry) on CPU tensors at a head dim no
    kernel is built for: the plain versions, with gradients, as JAX's."""
    q, k, v, dout = _inputs(dh)
    scale = dh ** -0.5
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.FlashAttention.apply(qt, kt, vt, scale)
    out.backward(torch.from_numpy(dout))
    want, vjp = jax.vjp(lambda a, b, c: softmax_attention_xla(a, b, c, scale), q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip((qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
