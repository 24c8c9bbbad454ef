"""`conv2d.variant`, the rule by which the conv wrappers choose the bf16
tensor-core (mma) or the tf32 tensor-core CUDA kernel (csrc/conv2d.cu);
`conv2d.pack_weights`, the mma kernel's B-fragment order; and
`conv2d.tf32_plan` and `conv2d.pack_weights_tf32`, the tf32 kernel's Co tile
and its pre-split B-fragment order. All are plain Python, so they are held
here on the CPU: the packed weights, read back in each kernel's K order (tap
* CP + channel in k16 steps, the A rows each lane points ldmatrix at; for
tf32, 8-channel chunks of Ci, then the taps), must give the conv the plain
version and the Pallas kernel give. The kernels themselves are held on the
card (tests/test_torch_cuda_kernels.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from mvsformerplusplus_tpu.ops.pallas.conv2d import conv2d_p, conv2d_viable
from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, tolerance

CSRC = Path(conv2d.__file__).resolve().parents[2] / "csrc"
BF16, F32 = torch.bfloat16, torch.float32

torch.set_num_threads(1)

# (k, Ci, Co) of every conv and conv dx the model paths run (chip_smoke.py's
# CONV_SHAPES, and their dx with Ci and Co swapped)
PATH_CONVS = [(7, 3, 8), (5, 8, 8), (3, 16, 16), (3, 32, 32), (3, 64, 64), (3, 64, 32),
              (3, 64, 16), (3, 64, 8), (3, 1, 16), (3, 16, 8), (3, 8, 8)]
PATH_DX = [(5, 8, 8), (3, 16, 16), (3, 32, 32), (3, 64, 64), (3, 32, 64), (3, 16, 64),
           (3, 8, 64), (3, 8, 16), (3, 8, 8)]


def _kernel(k, ci, co, dtype=BF16):
    return torch.zeros(k, k, ci, co, dtype=dtype)


@pytest.mark.parametrize("k,ci,co", sorted(set(PATH_CONVS + PATH_DX)))
def test_every_path_conv_takes_the_mma_kernel_in_bf16(k, ci, co):
    x = torch.zeros(2, 5, 7, ci, dtype=BF16)
    assert x.data_ptr() % 16 == 0
    assert conv2d.variant(x, _kernel(k, ci, co)) == "mma"


@pytest.mark.parametrize("k,ci,co", [(3, 64, 8), (7, 3, 8), (3, 16, 64)])
def test_f32_takes_the_simt_kernel(k, ci, co):
    """f32 takes the tf32 kernel, which took the SIMT kernel's place."""
    x = torch.zeros(2, 5, 7, ci, dtype=F32)
    assert conv2d.variant(x, _kernel(k, ci, co, F32)) == "tf32"


@pytest.mark.parametrize("k,ci,co", [(3, 8, 4), (3, 8, 12), (3, 12, 8), (3, 24, 8), (3, 128, 8),
                                     (5, 64, 64), (7, 64, 16), (7, 32, 64)])
def test_other_widths_take_the_simt_kernel(k, ci, co):
    """Co no multiple of 8, Ci that is neither 1-8 nor 16, 32 or 64, and the
    wide 5x5 / 7x7 tiles whose shared memory does not fit a block: the tf32
    kernel, in one pass (bf16 is exact in tf32)."""
    x = torch.zeros(2, 5, 7, ci, dtype=BF16)
    assert conv2d.variant(x, _kernel(k, ci, co)) == "tf32"


@pytest.mark.parametrize("ci", [8, 64])
def test_a_view_off_a_16_byte_boundary_takes_the_simt_kernel(ci):
    """A contiguous view whose storage offset breaks 16-byte alignment is
    tf32; one whose offset is a whole 16 bytes stays mma."""
    n = 2 * 5 * 7 * ci
    base = torch.zeros(n + 8, dtype=BF16)
    assert base.data_ptr() % 16 == 0
    off = base[1:1 + n].view(2, 5, 7, ci)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert conv2d.variant(off, _kernel(3, ci, 8)) == "tf32"
    assert conv2d.variant(base[8:].view(2, 5, 7, ci), _kernel(3, ci, 8)) == "mma"


def test_mma_cases_are_the_instantiations_of_the_kernel():
    """MMA_CASES lists exactly the (k, channel pad, Co tile) triples the
    CONV_MMA_CASE lines of csrc/conv2d.cu instantiate."""
    text = (CSRC / "conv2d.cu").read_text()
    built = {tuple(int(a) for a in args.split(","))
             for args in re.findall(r"^\s*CONV_MMA_CASE\(([^)]*)\)\s*$", text, flags=re.M)}
    assert built == set(conv2d.MMA_CASES)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 9, 8, generator=g).to(dtype)
    kern = (torch.randn(3, 3, 8, 16, generator=g) * 0.2).to(dtype)
    cot = torch.randn(2, 6, 9, 16, generator=g).to(dtype)
    counters = [(fn, a) for fn in (conv2d.conv2d_same, conv2d.conv2d_same_dx)
                for a in ("launches", "launches_mma", "launches_tf32")]
    before = [getattr(fn, a) for fn, a in counters]
    assert torch.equal(conv2d.conv2d_same(x, kern), conv2d.conv2d_same_plain(x, kern))
    assert torch.equal(conv2d.conv2d_same_dx(cot, kern), conv2d.conv2d_same_dx_plain(cot, kern))
    assert [getattr(fn, a) for fn, a in counters] == before


def kernel_order_conv(x, packed, k, ci, co):
    """The conv the mma kernel computes from `packed`, in f32: in k16 step s,
    the lanes of k half h point ldmatrix at channels r % CP .. + 7 of tap
    r // CP (r = 16 s + 8 h; a zero chunk past the k*k taps), and those 8 A
    columns meet B rows r .. r + 7, read out of the fragments as mma.sync
    m16n8k16 lays them out (lane (g, q) holds rows 2q, 2q+1 and 2q+8, 2q+9 of
    column g of each n8 tile)."""
    cp, cot = conv2d.channel_pad(ci), conv2d.co_tile(co)
    ntile, ksteps, nt = packed.shape[:3]
    assert (ntile * cot, nt * 8, packed.shape[3:]) == (co, cot, (32, 4))
    frag = packed.float().reshape(ntile, ksteps, nt, 8, 4, 2, 2)  # (tile, s, j, g, q, half, pair)
    b = frag.permute(1, 5, 4, 6, 0, 2, 3).reshape(ksteps * 16, co)
    n, h, w, _ = x.shape
    p = (k - 1) // 2
    xp = F.pad(x.float(), (0, cp - ci, p, p, p, p))
    out = torch.zeros(n, h, w, co)
    for r in range(0, ksteps * 16, 8):
        tap, c = divmod(r, cp)
        if tap < k * k:
            dy, dx = divmod(tap, k)
            out += xp[:, dy:dy + h, dx:dx + w, c:c + 8] @ b[r:r + 8]
    return out


@pytest.mark.parametrize("k,ci,co", [(3, 1, 16), (3, 3, 8), (7, 3, 8), (5, 8, 8), (3, 8, 24),
                                     (5, 16, 64), (3, 32, 48), (3, 64, 8), (7, 64, 8),
                                     (3, 16, 128)])
def test_packed_weights_in_kernel_order_give_the_plain_conv(k, ci, co):
    """Odd H and W; Co 24, 48 and 128 take several Co tiles."""
    g = torch.Generator().manual_seed(k * ci + co)
    x = torch.randn(2, 5, 11, ci, generator=g).to(BF16)
    kern = (torch.randn(k, k, ci, co, generator=g) * (k * k * ci) ** -0.5).to(BF16)
    want = conv2d.conv2d_same_plain(x, kern)
    got = kernel_order_conv(x, conv2d.pack_weights(kern), k, ci, co).to(BF16)
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,ci,co", [(5, 8, 8), (3, 16, 64), (3, 64, 8), (3, 8, 16), (7, 16, 24)])
def test_dx_packing_gives_the_plain_input_gradient(k, ci, co):
    """pack_weights(kernel, dx=True) packs dx_kernel(kernel) ([k, k, Co,
    Ci]) straight from the stored kernel."""
    g = torch.Generator().manual_seed(k * ci + co + 1)
    cot = torch.randn(2, 6, 13, co, generator=g).to(BF16)
    kern = (torch.randn(k, k, ci, co, generator=g) * (k * k * co) ** -0.5).to(BF16)
    packed = conv2d.pack_weights(kern, dx=True)
    want = conv2d.conv2d_same_dx_plain(cot, kern)
    got = kernel_order_conv(cot, packed, k, co, ci).to(BF16)
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_packing_reads_a_strided_f32_kernel():
    """The port's convs pass their [Co, Ci, k, k] parameter permuted to
    [k, k, Ci, Co], a non-contiguous view; f32 weights round to bf16."""
    g = torch.Generator().manual_seed(5)
    param = torch.randn(16, 8, 3, 3, generator=g)
    kern = param.permute(2, 3, 1, 0)
    assert not kern.is_contiguous()
    assert torch.equal(conv2d.pack_weights(kern), conv2d.pack_weights(kern.contiguous().to(BF16)))


def test_packing_lays_out_each_tap_in_8_channel_rows():
    """A 7x7 at Ci 3: tap t's weights are B rows 8 t .. 8 t + 2 (channel_pad
    3 = 8), its 49 taps fill 24.5 k16 steps of 25."""
    kern = torch.arange(1, 7 * 7 * 3 * 8 + 1, dtype=F32).reshape(7, 7, 3, 8)
    packed = conv2d.pack_weights(kern)
    assert packed.dtype == BF16 and packed.shape == (1, 25, 1, 32, 4)
    b = packed.float().reshape(1, 25, 1, 8, 4, 2, 2).permute(1, 5, 4, 6, 0, 2, 3).reshape(400, 8)
    for tap in (0, 17, 48):
        want = kern.reshape(49, 3, 8)[tap].to(BF16).float()
        assert torch.equal(b[8 * tap:8 * tap + 3], want)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("ci", [1, 3, 8, 16])
def test_packed_weights_in_kernel_order_match_pallas(k, ci):
    """Against the Pallas kernel (interpret mode) in f32, on bf16-representable
    values, so both sides sum the same exact products."""
    co, h, w = 8, 8, 24
    assert conv2d_viable(h, w, ci, co, k, k)
    rng = np.random.RandomState(10 * k + ci)
    x = torch.from_numpy(rng.randn(2, h, w, ci).astype(np.float32)).to(BF16)
    kern = torch.from_numpy((rng.randn(k, k, ci, co) * 0.2).astype(np.float32)).to(BF16)
    want = np.asarray(jax.jit(conv2d_p)(jnp.asarray(x.float().numpy()),
                                        jnp.asarray(kern.float().numpy())))
    got = kernel_order_conv(x, conv2d.pack_weights(kern), k, ci, co)
    want = torch.from_numpy(want.copy())
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_tf32_cases_are_the_instantiations_of_the_kernel():
    """TF32_CASES lists exactly the (k, Co tile, streamed) triples the
    CONV_TF32_CASE lines of csrc/conv2d.cu instantiate."""
    text = (CSRC / "conv2d.cu").read_text()
    built = {(k, cot, bool(st)) for k, cot, st in (
        tuple(int(a) for a in args.split(","))
        for args in re.findall(r"^\s*CONV_TF32_CASE\(([^)]*)\)\s*$", text, flags=re.M))}
    assert built == set(conv2d.TF32_CASES)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("ci", [1, 3, 8, 12, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("co", [4, 8, 12, 16, 32, 64])
def test_tf32_plan_is_instantiated_and_fits(dtype, k, ci, co):
    """Every (k, Ci, Co) gets a Co tile the kernel is built at, no wider
    than Co needs, whose shared memory fits a block: the halo's stages (a
    two-stage ring and the small parts for f32; one for bf16) and the
    weights (resident: every chunk's; streamed: two chunks')."""
    cot, streamed = conv2d.tf32_plan(k, ci, co, dtype)
    assert (k, cot, streamed) in conv2d.TF32_CASES
    assert cot == 8 or cot <= -(-co // 8) * 8
    halo = (3 if dtype == F32 else 1) * (8 + k - 1) * (32 + k - 1) * 8 * 4
    assert halo == conv2d.tf32_halo_bytes(k, dtype)
    chunks = 2 if streamed else -(-ci // 8)
    assert halo + chunks * k * k * cot // 8 * 512 <= conv2d.BLOCK_SMEM


def test_tf32_plan_of_the_path_convs():
    """The f32 path's convs and dx: resident weights, two blocks an SM."""
    for k, ci, co in PATH_CONVS + PATH_DX:
        cot, streamed = conv2d.tf32_plan(k, ci, co)
        assert not streamed and cot <= max(8, co)
    assert conv2d.tf32_plan(3, 64, 64) == (16, False)
    assert conv2d.tf32_plan(3, 32, 32) == (32, False)
    assert conv2d.tf32_plan(3, 8, 64) == (32, False)
    assert conv2d.tf32_plan(7, 64, 64) == (8, True)


def tf32_kernel_order_conv(x, packed, k, ci, co):
    """The conv the tf32 kernel computes from `packed` ([Co tiles, chunks,
    k*k, COT / 8, 32, 4]), in f32: for chunk c and tap t, the A columns are
    channels 8 c .. 8 c + 7 of the tap's shifted input (zero past Ci) and
    meet B rows read out of the fragments as mma.sync m16n8k8 lays them out
    (lane (g, q) holds rows q and q + 4 of column g of its n8 tile), big +
    small (3xTF32's two parts; their sum is the weight to 2^-22)."""
    ntile, nch, kk, nt = packed.shape[:4]
    assert (packed.shape[4:], packed.dtype) == ((32, 4), F32) and ntile * nt * 8 >= co
    frag = packed.reshape(ntile, nch, kk, nt, 8, 4, 4)
    parts = frag[..., :2] + frag[..., 2:]  # (tile, chunk, tap, j, g, q, half)
    b = parts.permute(2, 1, 6, 5, 0, 3, 4).reshape(kk, nch * 8, ntile * nt * 8)
    n, h, w, _ = x.shape
    p = (k - 1) // 2
    xp = F.pad(x.float(), (0, nch * 8 - ci, p, p, p, p))
    out = torch.zeros(n, h, w, b.shape[-1])
    for c in range(nch):
        for tap in range(kk):
            dy, dx = divmod(tap, k)
            out += xp[:, dy:dy + h, dx:dx + w, 8 * c:8 * c + 8] @ b[tap, 8 * c:8 * c + 8]
    return out[..., :co]


@pytest.mark.parametrize("k,ci,co", [(3, 1, 4), (3, 3, 12), (7, 3, 4), (5, 8, 12), (3, 16, 4),
                                     (3, 12, 12), (3, 64, 12), (5, 20, 4), (3, 8, 64)])
def test_tf32_packed_weights_in_kernel_order_give_the_plain_conv(k, ci, co):
    """f32 weights packed pre-split for the tf32 kernel at the Co tile its
    plan picks; Co 4 and 12 pad an n8 tile, Ci 3, 12 and 20 a chunk."""
    g = torch.Generator().manual_seed(k * ci + co + 7)
    x = torch.randn(2, 5, 11, ci, generator=g)
    kern = torch.randn(k, k, ci, co, generator=g) * (k * k * ci) ** -0.5
    cot, _ = conv2d.tf32_plan(k, ci, co, F32)
    packed = conv2d.pack_weights_tf32(kern, F32, cot)
    big, small = packed[..., :2], packed[..., 2:]
    assert torch.equal(conv2d.tf32(big), big) and torch.equal(conv2d.tf32(small), small)
    want = conv2d.conv2d_same_plain(x, kern)
    got = tf32_kernel_order_conv(x, packed, k, ci, co)
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,ci,co", [(3, 16, 4), (5, 8, 12), (3, 64, 8), (3, 4, 12), (7, 16, 4)])
def test_tf32_dx_packing_gives_the_plain_input_gradient(k, ci, co):
    """pack_weights_tf32(kernel, dx=True) packs dx_kernel(kernel) ([k, k, Co,
    Ci]) straight from the stored kernel; dx outputs Ci 4 and 12 channels."""
    g = torch.Generator().manual_seed(k * ci + co + 8)
    cot_in = torch.randn(2, 6, 13, co, generator=g)
    kern = torch.randn(k, k, ci, co, generator=g) * (k * k * co) ** -0.5
    cot, _ = conv2d.tf32_plan(k, co, ci)
    packed = conv2d.pack_weights_tf32(kern, F32, cot, dx=True)
    want = conv2d.conv2d_same_dx_plain(cot_in, kern)
    got = tf32_kernel_order_conv(cot_in, packed, k, co, ci)
    rtol, atol = tolerance(want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_tf32_packing_rounds_bf16_weights_exactly():
    """For bf16 inputs the weights round to bf16 first: exact in tf32, so
    every small part is 0 and the kernel takes one pass."""
    g = torch.Generator().manual_seed(9)
    kern = torch.randn(3, 3, 8, 12, generator=g)
    packed = conv2d.pack_weights_tf32(kern, BF16, 16)
    assert not packed[..., 2:].any()
    assert torch.equal(packed[..., :2], packed[..., :2].to(BF16).float())
