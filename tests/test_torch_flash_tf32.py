"""The arithmetic of the f32 flash forward kernel (csrc/flash_attention.cu
`flash_fwd_3xtf32_kernel`) modelled on the CPU, no card needed.

The kernel takes its products on the tf32 tensor cores. Each fp32 operand
is split into big = tf32(x) and small = tf32(x - big), rounded as
`cvt.rna.tf32.f32` rounds (to nearest, ties away from zero), and each
product is summed as small·big + big·small + big·big (CUTLASS's
OpMultiplyAddFastF32 order), for S = Q·Kᵀ and for O = P·V with P split too.
The softmax runs in base 2 with scale·log2(e) applied to the fp32 logits.
The model below does the same in plain torch: products of tf32 values are
exact in fp32, so fp32 matmuls of the parts stand for the mma's sums. It
must lie within `ops.cuda.tolerance` of `flash_attention_plain` at the
matcher's shape (1611 tokens, head dim 64) and at head dims 16, 32 and 128,
with q and k at std 1 and 3, and within it of the JAX package's Pallas
kernel (interpret mode). The same model with one tf32 pass must lie 10x or
more outside the tolerance, so these checks can tell the two apart. The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.ops.pallas.flash_attention import flash_attention
from mvsformerplusplus_tpu_torch.ops.cuda import tolerance
from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

# (head dim, tokens, heads): the matcher's ViT-B, then the other kernel widths
SHAPES = [(64, 1611, 2), (16, 1000, 2), (32, 777, 2), (128, 500, 2)]
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to tf32 as cvt.rna.tf32.f32: half an ulp of the 10-bit
    mantissa added to the magnitude's bits, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on tf32 parts: 3 passes = small·big + big·small + big·big, 1 =
    big·big alone."""
    (ab, as_), (bb, bs) = split(a), split(b)
    if passes == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def kernel_model(q, k, v, scale, passes=3):
    """q [B, N, H, Dh], k/v [B, M, H, Dh] f32 -> (out, lse [B, H, N]) with the
    kernel's arithmetic: the products on tf32 parts, fp32 logits, the
    softmax in base 2, out = (P·V) / rowsum(P), lse = (max + log2 l)·ln 2."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = matmul(qt, kt.transpose(-1, -2), passes)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    mx = s.amax(-1, keepdim=True) * c
    p = torch.exp2(s * c - mx)
    l = p.sum(-1, keepdim=True)
    out = matmul(p, vt, passes) / l
    lse = (mx + torch.log2(l))[..., 0] * math.log(2)
    return out.transpose(1, 2), lse


def _inputs(dh, n, heads, std, seed):
    rng = np.random.RandomState(seed)
    q, k = (std * rng.randn(1, n, heads, dh) for _ in range(2))
    v = rng.randn(1, n, heads, dh)
    return [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v)]


def err_over_tol(got, want) -> float:
    """max |got - want| / (atol + rtol |want|), ops.cuda.tolerance's."""
    rtol, atol = tolerance(want)
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("std", [1.0, 3.0])
@pytest.mark.parametrize("dh,n,heads", SHAPES)
def test_3xtf32_within_the_f32_tolerance(dh, n, heads, std):
    q, k, v = _inputs(dh, n, heads, std, dh + int(std))
    scale = dh ** -0.5
    want, want_lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    got, lse = kernel_model(q, k, v, scale)
    assert err_over_tol(got, want) <= 1
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("std", [1.0, 3.0])
@pytest.mark.parametrize("dh,n,heads", SHAPES)
def test_one_tf32_pass_is_far_outside(dh, n, heads, std):
    """What the split buys: one tf32 pass lies 10x or more outside the
    tolerance that 3xTF32 meets on the same inputs."""
    q, k, v = _inputs(dh, n, heads, std, dh + int(std))
    scale = dh ** -0.5
    want = flash_attention_plain(q, k, v, scale)
    assert err_over_tol(kernel_model(q, k, v, scale, passes=1)[0], want) >= 10


@pytest.mark.parametrize("std", [1.0, 3.0])
def test_3xtf32_within_the_f32_tolerance_of_pallas(std):
    """The same inputs through the JAX package's Pallas flash attention
    (f32, interpret mode) and the model."""
    q, k, v = _inputs(64, 300, 2, std, 7)
    scale = 0.125
    want = torch.from_numpy(np.asarray(flash_attention(*(jnp.asarray(x.numpy())
                                                          for x in (q, k, v)), scale)))
    assert err_over_tol(kernel_model(q, k, v, scale)[0], want) <= 1


def test_tf32_rounds_to_nearest_ties_away():
    """Ties (half of the 10-bit mantissa's ulp) round away from zero, below
    them towards it, and big + small gives x back to 2^-22 relative."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    assert not (tf32(x).view(torch.int32) & 0x1FFF).any()
    r = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32) * 100)
    big, small = split(r)
    assert ((big + small - r).abs() <= 2.0 ** -22 * r.abs()).all()
    assert ((big - r).abs() > 2.0 ** -16 * r.abs()).any()
