"""The PyTorch port's pure ops against the JAX package's, fp32 on CPU, at
atol/rtol 2e-4: geometry, sampling, resize, position encodings, attention."""
import numpy as np
import pytest

import jax.numpy as jnp

from mvsformerplusplus_tpu.ops import attention as jattn
from mvsformerplusplus_tpu.ops import geometry as jgeo
from mvsformerplusplus_tpu.ops import pe as jpe
from mvsformerplusplus_tpu.ops import resize as jresize
from mvsformerplusplus_tpu.ops import sampling as jsamp
from mvsformerplusplus_tpu_torch.ops import attention as tattn
from mvsformerplusplus_tpu_torch.ops import geometry as tgeo
from mvsformerplusplus_tpu_torch.ops import pe as tpe
from mvsformerplusplus_tpu_torch.ops import resize as tresize
from mvsformerplusplus_tpu_torch.ops import sampling as tsamp
from tests.test_casmvs import make_inputs
from tests.torch_parity import assert_close, t


def _cams(seed=0, v=3):
    _, cams, dv = make_inputs(np.random.RandomState(seed), v=v, h=32, w=48, dfull=24)
    return np.asarray(cams["stage3"]), np.asarray(dv)


def test_compose_projection():
    cams, _ = _cams()
    assert_close(tgeo.compose_projection(t(cams)), jgeo.compose_projection(cams))


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_coords(per_pixel):
    cams, dv = _cams()
    projs = np.asarray(jgeo.compose_projection(cams))
    h, w, d = 16, 24, 5
    if per_pixel:
        dv = np.random.RandomState(1).uniform(3, 7, (1, d, h, w)).astype(np.float32)
    else:
        dv = dv[:, :d]
    want_c, want_i = jgeo.plane_sweep_coords(projs[:, 1], projs[:, 0], dv, h, w)
    got_c, got_i = tgeo.plane_sweep_coords(t(projs[:, 1]), t(projs[:, 0]), t(dv), h, w)
    assert_close(got_c, want_c)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_get_position_3d_with_and_without_bounds():
    cams, dv = _cams()
    intr = cams[:, 0, 1, :3, :3]
    hypo = np.asarray(jsamp.init_inverse_range(dv, 6, 8, 12))
    want, wb = jgeo.get_position_3d(intr, hypo, 8, 12, dv.min(), dv.max())
    got, gb = tgeo.get_position_3d(t(intr), t(hypo), 8, 12, t(dv).min(), t(dv).max())
    assert_close(got, want)
    hypo2 = hypo * 1.1
    want2, _ = jgeo.get_position_3d(intr, hypo2, 8, 12, dv.min(), dv.max(), bounds=wb)
    got2, _ = tgeo.get_position_3d(t(intr), t(hypo2), 8, 12, t(dv).min(), t(dv).max(), bounds=gb)
    assert_close(got2, want2)


@pytest.mark.parametrize("fn", ["init_range", "init_inverse_range"])
def test_init_ranges(fn):
    _, dv = _cams()
    assert_close(getattr(tsamp, fn)(t(dv), 8, 6, 10), getattr(jsamp, fn)(dv, 8, 6, 10))


def test_schedule_inverse_range():
    rng = np.random.RandomState(2)
    depth = rng.uniform(3, 7, (1, 6, 10)).astype(np.float32)
    hypo = np.sort(rng.uniform(2, 8, (1, 8, 6, 10)), axis=1)[:, ::-1].astype(np.float32).copy()
    want = jsamp.schedule_inverse_range(depth, hypo, 4, 2.67, 12, 20)
    assert_close(tsamp.schedule_inverse_range(t(depth), t(hypo), 4, 2.67, 12, 20), want)


def test_schedule_range():
    rng = np.random.RandomState(3)
    depth = rng.uniform(3, 7, (2, 6, 10)).astype(np.float32)
    itv = rng.uniform(0.05, 0.2, (2,)).astype(np.float32)
    want = jsamp.schedule_range(depth, 8, itv, 12, 20)
    assert_close(tsamp.schedule_range(t(depth), 8, t(itv), 12, 20), want)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_depth_regression(per_pixel):
    rng = np.random.RandomState(4)
    prob = rng.dirichlet(np.ones(8), size=(2, 5, 6)).transpose(0, 3, 1, 2).astype(np.float32)
    dv = rng.uniform(2, 8, (2, 8, 5, 6) if per_pixel else (2, 8)).astype(np.float32)
    assert_close(tsamp.depth_regression(t(prob), t(dv)), jsamp.depth_regression(prob, dv))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_conf_regression(n):
    rng = np.random.RandomState(5 + n)
    prob = rng.dirichlet(np.ones(16) * 0.3, size=(2, 5, 6)).transpose(0, 3, 1, 2)
    prob = prob.astype(np.float32)
    assert_close(tsamp.conf_regression(t(prob), n), jsamp.conf_regression(prob, n))


@pytest.mark.parametrize("method,align_corners,out_hw", [
    ("linear", True, (13, 22)), ("linear", False, (13, 22)), ("linear", False, (4, 5)),
    ("cubic", False, (13, 22)), ("cubic", True, (7, 9)), ("nearest", False, (14, 20)),
])
def test_resize2d(method, align_corners, out_hw):
    x = np.random.RandomState(6).randn(2, 7, 10, 3).astype(np.float32)
    want = jresize.resize2d(x, *out_hw, method=method, align_corners=align_corners)
    got = tresize.resize2d(t(x), *out_hw, method=method, align_corners=align_corners)
    assert_close(got, want)


def test_resize2d_pos_embed_scale_override():
    """DINOv2's pos-embed resize: bicubic with scale (g0 + 0.1) / g."""
    g, h0, w0 = 37, 36, 48
    x = np.random.RandomState(7).randn(1, g, g, 8).astype(np.float32)
    kw = dict(method="cubic", align_corners=False, scale_h=(h0 + 0.1) / g,
              scale_w=(w0 + 0.1) / g)
    assert_close(tresize.resize2d(t(x), h0, w0, **kw), jresize.resize2d(x, h0, w0, **kw))


def test_resize_hw_axes():
    x = np.random.RandomState(8).randn(2, 4, 5, 7).astype(np.float32)
    want = jresize.resize_hw_axes(x, 10, 14, h_axis=-2, w_axis=-1, method="linear",
                                  align_corners=True)
    got = tresize.resize_hw_axes(t(x), 10, 14, h_axis=-2, w_axis=-1, method="linear",
                                 align_corners=True)
    assert_close(got, want)


@pytest.mark.parametrize("d_model,h,w", [(32, 6, 10), (64, 18, 24)])
def test_sine_pe_2d(d_model, h, w):
    assert_close(tpe.sine_pe_2d(d_model, h, w), jpe.sine_pe_2d(d_model, h, w))


@pytest.mark.parametrize("fn", ["position_encoding_3d", "position_encoding_3d_parts"])
def test_position_encoding_3d(fn):
    pos = np.random.RandomState(9).rand(2, 3, 4, 5, 6).astype(np.float32)
    assert_close(getattr(tpe, fn)(t(pos), 8), getattr(jpe, fn)(pos, 8))


@pytest.mark.parametrize("seq,avg", [(1729, None), (27648, 12185), (1, 762)])
def test_entropy_inv_scale(seq, avg):
    assert tattn.entropy_inv_scale(16, seq, avg) == pytest.approx(
        jattn.entropy_inv_scale(16, seq, avg), rel=1e-12)


def _qkv(seed, n, m, h=2, dh=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, n, h, dh).astype(np.float32), rng.randn(2, m, h, dh).astype(np.float32),
            rng.randn(2, m, h, dh).astype(np.float32))


def test_linear_attention():
    q, k, v = _qkv(10, 37, 29)
    assert_close(tattn.linear_attention(t(q), t(k), t(v)), jattn.linear_attention(q, k, v))


@pytest.mark.parametrize("n,m", [(37, 29), (64, 64)])
def test_softmax_attention(n, m):
    q, k, v = _qkv(11, n, m)
    want = jattn.softmax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3)
    assert_close(tattn.softmax_attention(t(q), t(k), t(v), 0.3), want)
