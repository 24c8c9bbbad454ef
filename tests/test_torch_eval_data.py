"""The port's eval data path against the JAX package's: resize_linear
against cv2.resize(INTER_LINEAR) on float32 images (exact at every eval
ratio tested), and the port's EvalDataset against the JAX EvalDataset on
scans the port's synthetic writer makes (JPEG images), sample by sample:
images, cameras, depth values, ref_img and ground truth, exactly. Covers
dtu, tt (the 4-row pad and cy shift), eth3d (the depth-max range line),
cams with their own hypothesis count, the cams_1 and images_post
fallbacks and fix_res; and EvalLoader's order and rank/world striding."""
import shutil

import cv2
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.data.eval_dataset import EvalDataset as JaxEvalDataset
from mvsformerplusplus_tpu.data.loader import EvalLoader as JaxEvalLoader
from mvsformerplusplus_tpu_torch.data.eval_dataset import EvalDataset
from mvsformerplusplus_tpu_torch.data.image import resize_linear
from mvsformerplusplus_tpu_torch.data.io import read_cam_file, save_cam_file
from mvsformerplusplus_tpu_torch.data.loader import EvalLoader
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_eval_scan


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", [((1200, 1600), (1152, 1536)), ((1088, 1920), (832, 1536)),
                                     ((96, 128), (96, 128)), ((37, 53), (100, 131)),
                                     ((60, 80), (30, 40)), ((13, 17), (40, 9))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_resize_linear_matches_cv2(src, dst, channels):
    """Exact: the same taps and the same float32 rounding as OpenCV's
    vector loops (a fused multiply-add per tap pair)."""
    rng = np.random.RandomState(channels)
    shape = src + ((channels,) if channels else ())
    img = rng.rand(*shape).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, *dst)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """One 3-view geometric scan at 100 x 150 (no multiple of 64), and
    copies with each layout variant."""
    root = tmp_path_factory.mktemp("eval")
    make_geometric_eval_scan(root, "scan1", n_views=3, h=100, w=150, ndepth=48,
                             scene=GeometricScene(seed=3, tex_res=128))
    src = root / "scan1"
    shutil.copytree(src, root / "cams1")
    shutil.move(root / "cams1" / "cams", root / "cams1" / "cams_1")
    shutil.copytree(src, root / "post")
    shutil.move(root / "post" / "images", root / "post" / "images_post")
    shutil.copytree(src, root / "dnum")
    for cam in (root / "dnum" / "cams").iterdir():
        K, E, dmin, dint, _ = read_cam_file(cam)
        save_cam_file(cam, K, E, dmin, dint, depth_num=128, depth_max=dmin + 128 * dint)
    for name in ("cams1", "post", "dnum"):
        shutil.copytree(root / "gt_depths" / "scan1", root / "gt_depths" / name)
    return root


CASES = {"dtu": ("scan1", dict(dataset_name="dtu", max_h=96, max_w=128)),
         "upscale": ("scan1", dict(dataset_name="dtu", max_h=192, max_w=320)),
         "tt": ("scan1", dict(dataset_name="tt", max_h=64, max_w=128)),
         "eth3d": ("scan1", dict(dataset_name="eth3d", max_h=96, max_w=128)),
         "depth_num": ("dnum", dict(dataset_name="dtu", max_h=96, max_w=128)),
         "cams_1": ("cams1", dict(dataset_name="dtu", max_h=64, max_w=128)),
         "images_post": ("post", dict(dataset_name="dtu", max_h=64, max_w=128)),
         "fix_res": ("scan1", dict(dataset_name="dtu", max_h=64, max_w=128, fix_res=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_dataset_matches_jax(scans, case):
    scan, kw = CASES[case]
    common = dict(nviews=3, ndepths=48, interval_scale={scan: 1.06},
                  gt_depth_path=str(scans / "gt_depths"), **kw)
    port = EvalDataset(str(scans), [scan], **common)
    ref = JaxEvalDataset(str(scans), [scan], **common)
    assert len(port) == len(ref) == 3
    for i in range(3):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() and "gt_depth" in a
        for k in ("imgs", "depth_values", "ref_img", "gt_depth"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for s in b["cams"]:
            np.testing.assert_array_equal(a["cams"][s], b["cams"][s])
        assert (a["scan"], a["ref_view"], a["filename"]) == (b["scan"], b["ref_view"],
                                                              b["filename"])
    # each of the scan's views decoded once over its three samples
    assert port.views.decodes == 3


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
def test_eval_loader_order_and_striding_match_jax(scans, rank, world):
    common = dict(nviews=2, ndepths=48, max_h=64, max_w=128)
    port = [s["ref_view"] for s in EvalLoader(EvalDataset(str(scans), ["scan1", "dnum"], **common),
                                              rank=rank, world=world)]
    ref = [s["ref_view"] for s in JaxEvalLoader(JaxEvalDataset(str(scans), ["scan1", "dnum"],
                                                               **common), rank=rank, world=world)]
    assert port == ref and len(port) == len(range(6)[rank::world])
