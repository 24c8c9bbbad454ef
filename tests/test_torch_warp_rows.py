"""TPU kernel rows 5, 10, 11 and 12 (PERF.md's kernel table) against the
port's exact warp, on the CPU: the same numpy-seeded features, cameras and
hypotheses go through the JAX formulation (its Pallas kernels in interpret
mode, as tests/test_grid_sample.py runs them) and through the port's
warp. Each windowed formulation equals exact sampling wherever no sample
escapes its window, so each case first asserts zero escapes with the JAX
package's own diagnostic, then agreement within f32 atol 1e-5 of the
port's warp_bilinear (warp_bilinear_bwd for row 11), the functions the
CUDA kernels compute, on the JAX coordinates. The port's homography_warp,
which projects its own coordinates in f32 (a few ulps from JAX's, up to
~1e-5 px at x ~ 100), agrees within atol 1e-4. Features are
bf16-representable, so a bf16 operand inside a TPU formulation loses
nothing.

- row 5, warp_band.py:511 banded_warp_blocked: homography_warp_banded with
  fused=False at a blocked shape (W % 128 == 0, W >= 384);
- row 10, warp_blend.py:132 _blend_fwd_impl: homography_warp_ygrouped;
- row 12, warp_blend.py:153 blend_ygrouped_dfold: homography_warp_ygrouped
  with fold_depth=True on re-centered per-pixel hypotheses (D=8);
- row 11, warp_blend.py:217 _blend_bwd: jax.vjp of _ygrouped_impl with
  respect to the image against warp_bilinear_bwd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvsformerplusplus_tpu.ops.geometry import plane_sweep_coords
from mvsformerplusplus_tpu.ops.grid_sample import (_ygrouped_impl, banded_escape_fraction,
                                                    fold_escape_fraction, homography_warp_banded,
                                                    homography_warp_ygrouped)
from mvsformerplusplus_tpu_torch.ops.cuda.warp import warp_bilinear, warp_bilinear_bwd
from mvsformerplusplus_tpu_torch.ops.grid_sample import homography_warp
from tests.test_grid_sample import compose

ATOL = 1e-5


def _scene(seed, b, h, w, c, angle=0.03, tx=-0.3, ty=-0.02):
    """bf16-representable f32 features [B, H, W, C] and a (src, ref)
    projection pair [B, 4, 4]: the source camera turned by `angle` about y
    and moved by (tx, ty), which shifts the samples left and up by a part of
    a pixel (so none lands in the last row or column, which the windowed
    formulations' diagnostic counts as an escape though exact there)."""
    rng = np.random.RandomState(seed)
    feat = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(seed))
    feat = feat.to(torch.bfloat16).float().numpy()
    f = 0.8 * w
    intr = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
    ext[:3, 3] = [tx, ty, 0]
    src = np.broadcast_to(compose(intr, ext)[None], (b, 4, 4)).copy()
    ref = np.broadcast_to(compose(intr, np.eye(4, dtype=np.float32))[None], (b, 4, 4)).copy()
    return feat, src, ref, rng


def _coords(src, ref, dv, h, w):
    return np.asarray(plane_sweep_coords(src, ref, jnp.asarray(dv), h, w)[0])


def _check_forward(want, feat, src, ref, dv):
    """want [B, D, H, W, C] against warp_bilinear on the JAX coordinates
    (atol 1e-5) and homography_warp from the projections (atol 1e-4)."""
    coords = _coords(src, ref, dv, feat.shape[1], feat.shape[2])
    got = warp_bilinear(torch.from_numpy(feat), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    end, _ = homography_warp(*(torch.from_numpy(np.asarray(a)) for a in (feat, src, ref, dv)))
    np.testing.assert_allclose(end.numpy(), want, rtol=0, atol=1e-4)


def test_row5_banded_warp_blocked():
    b, h, w, c, d = 1, 16, 384, 8, 2
    feat, src, ref, _ = _scene(51, b, h, w, c)
    dv = np.linspace(3.6, 4.4, d, dtype=np.float32)[None]
    assert banded_escape_fraction(_coords(src, ref, dv, h, w), h, w, gy=8, ky=16,
                                  block_w=128) == 0.0
    want, _ = homography_warp_banded(feat, src, ref, jnp.asarray(dv), ky=16, fused=False)
    want = np.asarray(want).reshape(c, b, d, h, w).transpose(1, 2, 3, 4, 0)
    _check_forward(want, feat, src, ref, dv)


def test_row10_ygrouped_blend():
    b, h, w, c, d = 1, 16, 128, 8, 4
    feat, src, ref, _ = _scene(52, b, h, w, c)
    dv = np.linspace(3.0, 5.0, d, dtype=np.float32)[None]
    assert fold_escape_fraction(_coords(src, ref, dv, h, w), h, w, gy=8, ky=16, wx=6,
                                fold=False) == 0.0
    want, _ = homography_warp_ygrouped(feat, src, ref, dv, gy=8, ky=16, wx=6)
    want = np.asarray(want).reshape(b, d, c, h, w).transpose(0, 1, 3, 4, 2)
    _check_forward(want, feat, src, ref, dv)


def test_row12_ygrouped_blend_depth_folded():
    b, h, w, c, d = 1, 32, 128, 16, 8
    feat, src, ref, rng = _scene(53, b, h, w, c)
    # a narrow re-centered band per pixel, as the fine stages schedule it
    base = np.linspace(3.9, 4.35, d, dtype=np.float32)
    dv = np.broadcast_to(base[None, :, None, None], (b, d, h, w)).copy()
    dv = dv * rng.uniform(0.97, 1.03, size=(b, 1, h, w)).astype(np.float32)
    assert fold_escape_fraction(_coords(src, ref, dv, h, w), h, w, gy=16, ky=24, wx=12,
                                fold=True) == 0.0
    want, _ = homography_warp_ygrouped(feat, src, ref, dv, gy=16, ky=24, wx=12, fold_depth=True)
    want = np.asarray(want).reshape(b, d, c, h, w).transpose(0, 1, 3, 4, 2)
    _check_forward(want, feat, src, ref, dv)


def test_row11_ygrouped_blend_vjp():
    b, h, w, c, d = 1, 16, 128, 8, 4
    feat, src, ref, rng = _scene(54, b, h, w, c)
    dv = np.linspace(3.0, 5.0, d, dtype=np.float32)[None]
    coords = _coords(src, ref, dv, h, w)
    assert fold_escape_fraction(coords, h, w, gy=8, ky=16, wx=6, fold=False) == 0.0
    g = rng.randn(b, d, c, h * w).astype(np.float32)
    _, vjp = jax.vjp(lambda x: _ygrouped_impl(x, jnp.asarray(coords), gy=8, ky=16, wx=6),
                     jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    g_port = torch.from_numpy(g.reshape(b, d, c, h, w).transpose(0, 1, 3, 4, 2).copy())
    got = warp_bilinear_bwd(g_port, torch.from_numpy(coords), (b, h, w, c))
    assert np.abs(np.asarray(want)).max() > 1.0  # the gradient is not trivially zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
