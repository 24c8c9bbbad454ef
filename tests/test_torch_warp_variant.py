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
