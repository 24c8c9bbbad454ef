"""`warp.variant`, the rule by which the warp wrappers choose the vector or
the scalar CUDA kernels (csrc/warp.cu, csrc/warp_bwd.cu). It reads only the
dtype, C and the tensor's alignment, so it is held here on the CPU; the
kernels themselves are held on the card (tests/test_torch_cuda_kernels.py).
"""
import re
from pathlib import Path

import pytest
import torch

from mvsformerplusplus_tpu_torch.ops.cuda import warp

CSRC = Path(warp.__file__).resolve().parents[2] / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,c", [(BF16, 8), (BF16, 16), (BF16, 32), (BF16, 64),
                                     (F32, 4), (F32, 8), (F32, 64)])
def test_vector_widths_take_the_vector_kernels(dtype, c):
    t = torch.zeros(2, 5, 7, c, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    assert warp.variant(t, c) == "vec"


@pytest.mark.parametrize("dtype,c", [(d, c) for d in (BF16, F32) for c in (1, 3, 6)]
                         + [(BF16, 4)])
def test_other_widths_take_the_scalar_kernels(dtype, c):
    """C 1, 3, 6, and half a bf16 vector."""
    assert warp.variant(torch.zeros(2, 5, 7, c, dtype=dtype), c) == "scalar"


@pytest.mark.parametrize("dtype,c", [(BF16, 3), (BF16, 12), (BF16, 24), (BF16, 48),
                                     (F32, 2), (F32, 6), (F32, 12), (F32, 24), (F32, 48)])
def test_widths_between_the_vector_widths_take_the_scalar_kernels(dtype, c):
    """A user config's feature widths that no vector case builds (12, 24, 48;
    f32 2 and 6; bf16 3) take the scalar kernels, aligned or not."""
    t = torch.zeros(2, 5, 7, c, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    assert warp.variant(t, c) == "scalar"


@pytest.mark.parametrize("dtype,c", [(BF16, 8), (BF16, 64), (F32, 4), (F32, 64)])
def test_a_view_off_a_16_byte_boundary_takes_the_scalar_kernels(dtype, c):
    """A contiguous view whose storage offset breaks 16-byte alignment is
    scalar; one whose offset is a whole 16 bytes stays vector."""
    per_16 = 16 // torch.tensor([], dtype=dtype).element_size()
    base = torch.zeros(2 * 5 * 7 * c + per_16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    off = base[1:1 + 2 * 5 * 7 * c].view(2, 5, 7, c)
    assert off.is_contiguous() and off.contiguous().data_ptr() % 16 != 0
    assert warp.variant(off.contiguous(), c) == "scalar"
    whole = base[per_16:].view(2, 5, 7, c)
    assert warp.variant(whole, c) == "vec"


def _built_widths(source: str, macro: str) -> dict:
    """{type: channel counts} of the vector cases a kernel source builds."""
    text = (CSRC / source).read_text()
    found = {}
    for args in re.findall(rf"^\s*{macro}\(([^)]*)\)\s*$", text, flags=re.M):
        *ty, c = [a.strip() for a in args.split(",")]
        found.setdefault(ty[0] if ty else "float", []).append(int(c))
    return found


def test_vec_channels_are_the_widths_the_kernels_build():
    """VEC_CHANNELS lists exactly the channel counts csrc/warp.cu and
    csrc/warp_bwd.cu instantiate (the backward takes only f32)."""
    fwd = _built_widths("warp.cu", "WARP_VEC_CASE")
    assert fwd == {"__nv_bfloat16": list(warp.VEC_CHANNELS[BF16]),
                   "float": list(warp.VEC_CHANNELS[F32])}
    assert _built_widths("warp_bwd.cu", "WARP_BWD_VEC_CASE") == {
        "float": list(warp.VEC_CHANNELS[F32])}


def test_the_narrow_kernel_is_built_for_every_width_below_narrow_c():
    """The scalar forward's thread-per-sample kernel takes C as a template
    parameter: csrc/warp.cu instantiates it once for each C below NARROW_C,
    so every narrow width reaches it and none falls to the channel-fastest
    kernel."""
    text = (CSRC / "warp.cu").read_text()
    narrow = int(re.search(r"constexpr int NARROW_C = (\d+);", text).group(1))
    built = [int(c) for c in re.findall(r"^\s*WARP_NARROW_CASE\((\d+)\)\s*$", text, flags=re.M)]
    assert built == list(range(1, narrow))


@pytest.mark.parametrize("aligned", [True, False])
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(aligned):
    """On CPU tensors both wrappers return their plain version's result,
    aligned or not, and no launch counter moves."""
    g = torch.Generator().manual_seed(3)
    b, h, w, c = 2, 6, 9, 8
    base = torch.randn(b * h * w * c + 1, generator=g).to(BF16)
    src = (base[:-1] if aligned else base[1:]).view(b, h, w, c)
    coords = torch.stack([torch.rand(b, 3, 4, 5, generator=g) * (w + 2) - 1,
                          torch.rand(b, 3, 4, 5, generator=g) * (h + 2) - 1], -1)
    cot = torch.randn(b, 3, 4, 5, c, generator=g)
    counters = [(fn, a) for fn in (warp.warp_bilinear, warp.warp_bilinear_bwd)
                for a in ("launches", "launches_vec", "launches_scalar")]
    before = [getattr(fn, a) for fn, a in counters]
    assert torch.equal(warp.warp_bilinear(src, coords), warp.warp_bilinear_plain(src, coords))
    assert torch.equal(warp.warp_bilinear_bwd(cot, coords, (b, h, w, c)),
                       warp.warp_bilinear_bwd_plain(cot, coords, (b, h, w, c)))
    assert [getattr(fn, a) for fn, a in counters] == before


def test_scalar_tile_is_the_kernels_tile():
    """SCALAR_TILE, which bounds the 32-bit element index of a tile in the
    wrapper's check, is the scalar kernels' samples per block
    (csrc/warp_corners.cuh)."""
    text = (CSRC / "warp_corners.cuh").read_text()
    assert re.search(r"constexpr int SCALAR_TILE = (\d+);", text).group(1) == str(
        warp.SCALAR_TILE)


def test_the_32_bit_check_covers_a_whole_tile():
    """A channel count so wide that one tile's elements overflow 32 bits
    raises before any launch, whatever the sample count."""
    src = torch.zeros(1, 1, 1, 1)
    with pytest.raises(ValueError, match="32 bits"):
        warp._launch_args(src, torch.zeros(1, 1, 2), 1, 1, 2 ** 31 // warp.SCALAR_TILE)
