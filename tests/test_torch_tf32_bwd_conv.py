"""The arithmetic of the f32 flash backward (csrc/flash_attention_bwd.cu
`flash_bwd_3xtf32_kernel`) and of the tf32 conv (csrc/conv2d.cu
`conv2d_tf32_kernel`) modelled on the CPU, no card needed.

Both kernels take their products on the tf32 tensor cores as 3xTF32: each
fp32 operand split into big = tf32(x) and small = tf32(x - big)
(`cvt.rna.tf32.f32`'s rounding) and each product summed as small·big +
big·small + big·big. Products of tf32 values are exact in fp32, so fp32
matmuls of the parts stand for the mma's sums (test_torch_flash_tf32.py's
model, reused here). The models follow the kernels' tiling:

- the backward: S^T = K·Q^T and dP^T = V·dO^T split, one exponential per
  logit in base 2 (P = 2^(S scale log2e - lse log2e)), dS = P (dP - delta);
  dV and dK summed per tile of 32 queries (16 above head dim 16), each
  tile's product on P and dS split (never one tf32 pass), dQ per block of
  64 keys;
- the conv: the weights packed by `conv2d.pack_weights_tf32` (pre-split, in
  the kernel's B-fragment order) read back in the kernel's K order (8-channel
  chunks of Ci, the k*k taps within a chunk, a row of taps summed apart),
  the input zero-padded to whole chunks and split.

Each model must lie within `ops.cuda.tolerance` of the port's plain version
and of the JAX package (the Pallas flash attention's VJP and `conv2d_p` with
its VJP, in interpret mode; XLA's exact conv where the Pallas conv's
folding does not take the shape), and the same model with one tf32 pass
must lie 10x or more outside it. bf16 inputs are exact in tf32: one pass
gives what three give, bit for bit. The kernels themselves are held to the
plain versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsformerplusplus_tpu.ops.pallas.conv2d import conv2d_p, conv2d_viable
from mvsformerplusplus_tpu.ops.pallas.flash_attention import flash_attention
from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale
from mvsformerplusplus_tpu_torch.ops.cuda import conv2d
from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (attention_delta,
                                                                  flash_attention_bwd_plain,
                                                                  flash_attention_plain)
from test_torch_flash_tf32 import LOG2E, err_over_tol, matmul, split

BKV = 64  # key rows per block of the backward kernel


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def query_tile(dh: int) -> int:
    """Query rows per tile of the backward kernel (BwdF32::BQ)."""
    return 32 if dh == 16 else 16


def bwd_model(q, k, v, dout, lse, delta, scale, passes=3):
    """q/dout [B, N, H, Dh], k/v [B, M, H, Dh], lse/delta [B, H, N] f32 ->
    (dq, dk, dv) with the kernel's arithmetic."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))  # [B, H, ., Dh]
    n, m, dh = qt.shape[2], kt.shape[2], qt.shape[3]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    l2 = (lse * torch.tensor(LOG2E, dtype=torch.float32))[:, :, None, :]
    p = torch.exp2(matmul(kt, qt.transpose(-1, -2), passes) * c - l2)  # P^T [B, H, M, N]
    ds = p * (matmul(vt, dot.transpose(-1, -2), passes) - delta[:, :, None, :])
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    bq = query_tile(dh)
    for t0 in range(0, n, bq):
        sl = slice(t0, t0 + bq)
        dv = dv + matmul(p[..., sl], dot[:, :, sl], passes)
        dk = dk + matmul(ds[..., sl], qt[:, :, sl], passes)
    dq = torch.zeros_like(qt)
    for k0 in range(0, m, BKV):
        dq = dq + matmul(ds[:, :, k0:k0 + BKV].transpose(-1, -2), kt[:, :, k0:k0 + BKV],
                         passes) * scale
    return dq.transpose(1, 2), (dk * scale).transpose(1, 2), dv.transpose(1, 2)


def _flash_inputs(b, n, m, h, dh, std, seed):
    rng = np.random.RandomState(seed)
    q, k = (std * rng.randn(b, s, h, dh) for s in (n, m))
    v, dout = (rng.randn(b, s, h, dh) for s in (m, n))
    return [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, dout)]


def _bwd_case(dh, n, m, std, scale, seed):
    q, k, v, dout = _flash_inputs(2, n, m, 2, dh, std, seed)
    out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    return q, k, v, dout, lse, attention_delta(out, dout), scale


# (head dim, queries, keys, std of q and k, scale): the CTA's head dim at
# its std-1.5 draw and entropy scale, then the other kernel widths
BWD_CASES = [(16, 700, 900, 1.5, entropy_inv_scale(16, 900, 12185)),
             (32, 333, 200, 1.0, 32 ** -0.5), (64, 300, 250, 1.0, 0.125),
             (128, 150, 170, 1.0, 128 ** -0.5)]


@pytest.mark.parametrize("dh,n,m,std,scale", BWD_CASES)
def test_bwd_model_within_the_f32_tolerance(dh, n, m, std, scale):
    args = _bwd_case(dh, n, m, std, scale, dh + n)
    for got, want in zip(bwd_model(*args), flash_attention_bwd_plain(*args)):
        assert err_over_tol(got, want) <= 1


@pytest.mark.parametrize("dh,n,m,std,scale", BWD_CASES)
def test_bwd_one_tf32_pass_is_far_outside(dh, n, m, std, scale):
    """One tf32 pass (and P and dS rounded to tf32 alone) lies 10x or more
    outside the tolerance that 3xTF32 meets on the same inputs."""
    args = _bwd_case(dh, n, m, std, scale, dh + n)
    ratios = [err_over_tol(g, w) for g, w in zip(bwd_model(*args, passes=1),
                                                 flash_attention_bwd_plain(*args))]
    assert min(ratios) >= 10


@pytest.mark.parametrize("dh,std,scale", [(16, 1.5, 0.25), (32, 1.0, 0.125), (64, 1.0, 0.125),
                                          (128, 1.0, 0.0625)])
def test_bwd_model_within_the_f32_tolerance_of_pallas(dh, std, scale):
    """jax.vjp of the Pallas flash attention (f32, interpret mode) against the
    model fed the same delta (from the Pallas output) and the plain lse;
    power-of-two scales keep the JAX side's q * scale exact."""
    q, k, v, dout = _flash_inputs(2, 130, 150, 2, dh, std, dh)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, scale),
                       *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    _, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    delta = attention_delta(torch.from_numpy(np.asarray(out).copy()), dout)
    for got, w in zip(bwd_model(q, k, v, dout, lse, delta, scale), want):
        assert err_over_tol(got, torch.from_numpy(np.asarray(w).copy())) <= 1


def conv_model(x, packed, k, ci, co, passes=3):
    """The conv x [B, H, W, Ci] -> [B, H, W, Co] (f32) the tf32 kernel
    computes from `packed` ([Co tiles, chunks, k*k, COT / 8, 32, 4]: lane
    (g, t) holds rows t and t + 4 of its chunk, column g of its n8 tile, big
    then small): per 8-channel chunk, per row of taps a partial sum of the
    taps' split products, folded into the output."""
    ntile, nch, kk, nt = packed.shape[:4]
    frag = packed.reshape(ntile, nch, kk, nt, 8, 4, 4)  # (tile, chunk, tap, j, g, t, value)

    def rows(f):  # (tile, chunk, tap, j, g, t, half) -> [tap, chunk * 8 + 4 half + t, column]
        return f.permute(2, 1, 6, 5, 0, 3, 4).reshape(kk, nch * 8, ntile * nt * 8)

    bb, bs = rows(frag[..., :2]), rows(frag[..., 2:])
    n, h, w, _ = x.shape
    p = (k - 1) // 2
    ab, as_ = split(F.pad(x.float(), (0, nch * 8 - ci, p, p, p, p)))
    out = torch.zeros(n, h, w, ntile * nt * 8)
    for ch in range(nch):
        cs = slice(ch * 8, ch * 8 + 8)
        for dy in range(k):
            part = torch.zeros_like(out)
            for dx in range(k):
                a_b, a_s = (a[:, dy:dy + h, dx:dx + w, cs] for a in (ab, as_))
                b_b, b_s = bb[dy * k + dx, cs], bs[dy * k + dx, cs]
                part = part + (a_b @ b_b if passes == 1 else (a_s @ b_b + a_b @ b_s) + a_b @ b_b)
            out = out + part
    return out[..., :co]


def _tf32_conv(x, kern, dx=False, passes=3):
    """The model of the kernel's conv of x by kern [k, k, Ci, Co] (with dx:
    by dx_kernel(kern)), packed as the wrapper packs it."""
    k, _, ci, co = kern.shape
    cin, cout = (co, ci) if dx else (ci, co)
    cot, _ = conv2d.tf32_plan(k, cin, cout, x.dtype)
    return conv_model(x, conv2d.pack_weights_tf32(kern, x.dtype, cot, dx), k, cin, cout, passes)


def _jax_conv(x, kern, g):
    """The JAX package's conv of x by kern and its input gradient at g:
    conv2d_p with its VJP (Pallas, interpret mode) where conv2d_viable
    takes the shape, else XLA's conv (exact f32 at the tests' precision)."""
    k, _, ci, co = kern.shape
    if conv2d_viable(x.shape[1], x.shape[2], ci, co, k, k):
        fn = conv2d_p
    else:
        def fn(a, b):
            return jax.lax.conv_general_dilated(a, b, (1, 1), "SAME",
                                                dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out, vjp = jax.vjp(fn, jnp.asarray(x.numpy()), jnp.asarray(kern.numpy()))
    return (torch.from_numpy(np.asarray(out).copy()),
            torch.from_numpy(np.asarray(vjp(jnp.asarray(g.numpy()))[0]).copy()))


def _conv_case(k, ci, co, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, 8, 24, ci).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(2, 8, 24, co).astype(np.float32)).to(dtype)
    kern = torch.from_numpy((rng.randn(k, k, ci, co) * (k * k * ci) ** -0.5).astype(np.float32))
    return x, g, kern.to(dtype)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("ci", [1, 3, 8, 16, 64])
def test_conv_model_within_the_f32_tolerance_of_plain_and_jax(k, ci):
    """Forward and dx at Co 12 (no multiple of 8: a padded n8 tile) against
    the plain versions and the JAX package's."""
    x, g, kern = _conv_case(k, ci, 12, 10 * k + ci)
    fwd, dx = _tf32_conv(x, kern), _tf32_conv(g, kern, dx=True)
    assert err_over_tol(fwd, conv2d.conv2d_same_plain(x, kern)) <= 1
    assert err_over_tol(dx, conv2d.conv2d_same_dx_plain(g, kern)) <= 1
    jfwd, jdx = _jax_conv(x, kern, g)
    assert err_over_tol(fwd, jfwd) <= 1
    assert err_over_tol(dx, jdx) <= 1


@pytest.mark.parametrize("k,ci,co", [(3, 1, 12), (7, 3, 8), (5, 8, 12), (3, 16, 16), (3, 64, 8),
                                     (3, 64, 37)])
def test_conv_one_tf32_pass_is_far_outside(k, ci, co):
    x, g, kern = _conv_case(k, ci, co, 3 * k + ci + co)
    assert err_over_tol(_tf32_conv(x, kern, passes=1), conv2d.conv2d_same_plain(x, kern)) >= 10
    assert err_over_tol(_tf32_conv(g, kern, dx=True, passes=1),
                        conv2d.conv2d_same_dx_plain(g, kern)) >= 10


@pytest.mark.parametrize("k,ci,co", [(3, 3, 12), (5, 8, 8), (7, 64, 16), (3, 24, 5)])
def test_conv_bf16_is_exact_in_one_pass(k, ci, co):
    """bf16 values are exact in tf32 (their packed small parts are 0): one
    pass gives what three give, bit for bit, and that is the exact conv in
    f32 up to summation order (the kernel rounds it to bf16 once)."""
    x, g, kern = _conv_case(k, ci, co, k + ci + co, torch.bfloat16)
    for inp, dx in ((x, False), (g, True)):
        cot = conv2d.tf32_plan(k, *((co, ci) if dx else (ci, co)), torch.bfloat16)[0]
        packed = conv2d.pack_weights_tf32(kern, torch.bfloat16, cot, dx)
        assert not packed[..., 2:].any()
        one = _tf32_conv(inp, kern, dx, passes=1)
        assert torch.equal(one, _tf32_conv(inp, kern, dx))
        kf = kern.float()
        want = (conv2d.conv2d_same_dx_plain(inp.float(), kf) if dx
                else conv2d.conv2d_same_plain(inp.float(), kf))
        assert err_over_tol(one, want) <= 1
