"""The port's fusion (mvsformerplusplus_tpu_torch/fusion/) against the JAX
package's on the CPU, on the same depth maps: the three fuse functions and
the reprojection helpers. Masks must agree exactly and points within rtol
1e-5 (fp32 products in another order).

The inputs make every decision robust, so that exact masks are a fair
demand: a fronto-parallel plane seen by cameras translated so that ref
pixel centres land a quarter pixel off the source grid, some ref pixels
and one source region moved far off the plane, confidences of 0.3 or 0.9.
The test asserts it: the JAX function's masks do not change when every
threshold moves by 1e-4 either way, nor when the source cameras' principal
points do (which moves every projected coordinate, floor and range test
by 1e-4 px)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mvsformerplusplus_tpu.fusion import fusion as jf
from mvsformerplusplus_tpu.fusion.ply import read_ply as jax_read_ply
from mvsformerplusplus_tpu_torch.fusion import fusion as tf
from mvsformerplusplus_tpu_torch.fusion.ply import read_ply, write_ply


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W, F = 24, 32, 80.0
# source cameras: (x, y) disparity in pixels of the plane at depth 5
SHIFTS = [(1.25, 0.25), (-2.25, 1.25), (0.25, -1.25), (3.25, -0.25)]
EPS = 1e-4


def _cam(dx, dy, principal=(0.0, 0.0)):
    c = np.zeros((2, 4, 4), np.float32)
    c[0] = np.eye(4)
    c[0, 0, 3], c[0, 1, 3] = dx * 5.0 / F, dy * 5.0 / F
    c[1, :3, :3] = [[F, 0, W / 2 + principal[0]], [0, F, H / 2 + principal[1]], [0, 0, 1]]
    c[1, 3, 3] = 1.0
    return c


def _scene(principal=(0.0, 0.0)):
    rng = np.random.RandomState(0)
    ref_depth = np.where(rng.rand(H, W) < 0.15, 5.5, 5.0).astype(np.float32)
    src_depths = np.full((4, H, W), 5.0, np.float32)
    src_depths[2, :, : W // 2] = 4.2
    ref_conf = np.where(rng.rand(H, W) < 0.2, 0.3, 0.9).astype(np.float32)
    src_confs = np.where(rng.rand(4, H, W) < 0.2, 0.3, 0.9).astype(np.float32)
    src_cams = np.stack([_cam(dx, dy, principal) for dx, dy in SHIFTS])
    return dict(ref_depth=ref_depth, ref_conf=ref_conf, src_depths=src_depths,
                src_confs=src_confs, ref_cam=_cam(0, 0), src_cams=src_cams)


def _rel_base(base, sign):
    """A base b' whose thresholds k / b' move by at least EPS from k / b
    (k >= 2)."""
    return 2.0 / (2.0 / base + sign * EPS)


FUSE = {
    "dpcd": (("ref_depth", "ref_conf", "src_depths", "ref_cam", "src_cams"),
             dict(conf_thresh=0.5, dist_base=4.0, rel_diff_base=1300.0),
             lambda kw, s: [dict(kw, conf_thresh=0.5 + s * EPS),
                            dict(kw, dist_base=_rel_base(4.0, s)),
                            dict(kw, rel_diff_base=_rel_base(1300.0, s))]),
    "pcd": (("ref_depth", "ref_conf", "src_depths", "src_confs", "ref_cam", "src_cams"),
            dict(conf_thresh=0.5, img_dist_thresh=1.0, depth_thresh=0.01, vthresh=3.0),
            lambda kw, s: [dict(kw, conf_thresh=0.5 + s * EPS),
                           dict(kw, img_dist_thresh=1.0 + s * EPS),
                           dict(kw, depth_thresh=0.01 + s * EPS / 4.0)]),
    "gipuma": (("ref_depth", "ref_conf", "src_depths", "src_confs", "ref_cam", "src_cams"),
               dict(prob_threshold=0.5, disp_threshold=0.1, num_consistent=2),
               lambda kw, s: [dict(kw, prob_threshold=0.5 + s * EPS),
                              dict(kw, disp_threshold=0.1 + s * EPS)]),
}


def _jax(name, scene, kw):
    names, _, _ = FUSE[name]
    out = getattr(jf, f"{name}_fuse")(*(jnp.asarray(scene[n]) for n in names), **kw)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", list(FUSE))
def test_inputs_decide_every_pixel_by_more_than_eps(name):
    names, kw, moved = FUSE[name]
    base = _jax(name, _scene(), kw)
    variants = [(_scene(), k) for s in (1, -1) for k in moved(kw, s)]
    variants += [(_scene((s * EPS, t * EPS)), kw) for s in (1, -1) for t in (1, -1)]
    for scene, k in variants:
        for a, b in zip(base[1:], _jax(name, scene, k)[1:]):  # the masks (gipuma: and px)
            np.testing.assert_array_equal(a, b)
    assert 0.1 < base[1].mean() < 0.9  # both kept and dropped pixels


@pytest.mark.parametrize("name", list(FUSE))
def test_fuse_matches_jax(name):
    names, kw, _ = FUSE[name]
    scene = _scene()
    want = _jax(name, scene, kw)
    got = [o.numpy() for o in getattr(tf, f"{name}_fuse")(
        *(torch.from_numpy(scene[n]) for n in names), **kw)]
    mask = want[1]
    np.testing.assert_array_equal(got[1], mask)
    np.testing.assert_allclose(got[0][mask], want[0][mask], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[2:], want[2:]):  # gipuma's consistent and src_px
        np.testing.assert_array_equal(a, b)


def test_reprojection_helpers_match_jax():
    s = _scene()
    j = {k: jnp.asarray(v) for k, v in s.items()}
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    args = ("ref_depth", "src_depths", "ref_cam", "src_cams")
    rd_j = jf.reproject_dynamic(*(j[a] for a in args))
    rd_t = tf.reproject_dynamic(*(t[a] for a in args))
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(tf.vis_filter_dynamic(t["ref_depth"], rd_t),
                    jf.vis_filter_dynamic(j["ref_depth"], rd_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rs_j, in_j = jf.reproject_static(*(j[a] for a in args))
    rs_t, in_t = tf.reproject_static(*(t[a] for a in args))
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    for a, b in zip(tf.vis_filter_static(t["ref_depth"], rs_t, in_t, 1.0, 0.01, 3.0),
                    jf.vis_filter_static(j["ref_depth"], rs_j, in_j, 1.0, 0.01, 3.0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    grid = tf._pixel_grid_center(5, 7).numpy()
    np.testing.assert_array_equal(grid, np.asarray(jf._pixel_grid_center(5, 7)))


@pytest.mark.parametrize("colors", [True, False])
def test_ply_round_trip_reads_in_jax(tmp_path, colors):
    rng = np.random.RandomState(1)
    pts = rng.randn(50, 3).astype(np.float32)
    cols = rng.randint(0, 256, (50, 3)).astype(np.uint8) if colors else None
    write_ply(tmp_path / "x.ply", pts, cols)
    for reader in (read_ply, jax_read_ply):
        p, c = reader(tmp_path / "x.ply")
        np.testing.assert_array_equal(p, pts)
        assert (c is None) if cols is None else np.array_equal(c, cols)
