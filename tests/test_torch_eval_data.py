"""The port's eval data path against the JAX package's: resize_linear
against cv2.resize(INTER_LINEAR) on float32 images (exact at every eval
ratio tested), and the port's EvalDataset against the JAX EvalDataset on
scans the port's synthetic writer makes (JPEG images), sample by sample:
images, cameras, depth values, ref_img and ground truth, exactly. Covers
dtu, tt (the 4-row pad and cy shift), eth3d (the depth-max range line),
cams with their own hypothesis count, the cams_1 and images_post
fallbacks, fix_res and a scan whose samples read more views than
CACHED_VIEWS (each view decoded once); EvalLoader's order and rank/world
striding; and each view decoded once in a loader's sweep of a scan several
times longer than a sample, its pair file listing the nearest sources
first."""
import shutil

import cv2
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.data.eval_dataset import EvalDataset as JaxEvalDataset
from mvsformerplusplus_tpu.data.loader import EvalLoader as JaxEvalLoader
from mvsformerplusplus_tpu_torch.data.eval_dataset import CACHED_VIEWS, EvalDataset
from mvsformerplusplus_tpu_torch.data.image import resize_linear
from mvsformerplusplus_tpu_torch.data.io import read_cam_file, save_cam_file, save_pair_file
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


# a scan whose samples each read more views than CACHED_VIEWS, every view a
# source of every other
WIDE_VIEWS = CACHED_VIEWS + 2
# scans of LONG_VIEWS views on a line, each view's sources its nearest along
# it, nearest first (as the converters write pair.txt from a camera path),
# {scan: sources a view}: the converters' 10, and more than CACHED_VIEWS
LONG_VIEWS = 60
LONG_SOURCES = {"long10": 10, "long17": CACHED_VIEWS + 1}


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """One 3-view geometric scan at 100 x 150 (no multiple of 64), and
    copies with each layout variant; a WIDE_VIEWS-view scan at 40 x 60; and
    the LONG_SOURCES scans at 24 x 32."""
    root = tmp_path_factory.mktemp("eval")
    scene = GeometricScene(seed=3, tex_res=128)
    make_geometric_eval_scan(root, "scan1", n_views=3, h=100, w=150, ndepth=48, scene=scene)
    make_geometric_eval_scan(root, "wide", n_views=WIDE_VIEWS, h=40, w=60, ndepth=48,
                             scene=scene)
    for i, (name, n) in enumerate(LONG_SOURCES.items()):
        if i == 0:
            make_geometric_eval_scan(root, name, n_views=LONG_VIEWS, h=24, w=32, ndepth=48,
                                     scene=scene)
        else:
            shutil.copytree(root / next(iter(LONG_SOURCES)), root / name)
        save_pair_file(root / name / "pair.txt", [
            (r, [(v, 100.0 - abs(v - r)) for v in sorted(range(LONG_VIEWS),
                                                          key=lambda v: abs(v - r))[1:n + 1]])
            for r in range(LONG_VIEWS)])
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
         "fix_res": ("scan1", dict(dataset_name="dtu", max_h=64, max_w=128, fix_res=True)),
         "many_views": ("wide", dict(dataset_name="dtu", max_h=64, max_w=128,
                                     nviews=WIDE_VIEWS - 1))}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_dataset_matches_jax(scans, case):
    scan, kw = CASES[case]
    common = {"nviews": 3, "ndepths": 48, "interval_scale": {scan: 1.06},
              "gt_depth_path": str(scans / "gt_depths"), **kw}
    views = WIDE_VIEWS if scan == "wide" else 3
    port = EvalDataset(str(scans), [scan], **common)
    ref = JaxEvalDataset(str(scans), [scan], **common)
    assert len(port) == len(ref) == views
    for i in range(views):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() and "gt_depth" in a
        for k in ("imgs", "depth_values", "ref_img", "gt_depth"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for s in b["cams"]:
            np.testing.assert_array_equal(a["cams"][s], b["cams"][s])
        assert (a["scan"], a["ref_view"], a["filename"]) == (b["scan"], b["ref_view"],
                                                              b["filename"])
    # each of the scan's views decoded once over its samples
    assert port.views.decodes == views


def test_eval_loader_decodes_each_view_once_when_a_sample_reads_more_than_the_cache(scans):
    """A sweep of the WIDE_VIEWS-view scan with samples of WIDE_VIEWS - 1
    views (more than CACHED_VIEWS), through the eval CLI's two loader
    threads: each view decoded once, every sample the dataset's own."""
    ds = EvalDataset(str(scans), ["wide"], nviews=WIDE_VIEWS - 1, ndepths=48, max_h=64,
                     max_w=128)
    assert WIDE_VIEWS - 1 > CACHED_VIEWS
    got = list(EvalLoader(ds, num_workers=2))
    assert [s["ref_view"] for s in got] == list(range(WIDE_VIEWS))
    assert ds.views.decodes == WIDE_VIEWS
    want = EvalDataset(str(scans), ["wide"], nviews=WIDE_VIEWS - 1, ndepths=48, max_h=64,
                       max_w=128)
    for i in (0, WIDE_VIEWS - 1):
        np.testing.assert_array_equal(got[i]["imgs"], want[i]["imgs"])


@pytest.mark.parametrize("scan,nviews", [("long10", 20), ("long17", 20), ("long17", 8)])
def test_eval_loader_decodes_each_view_once_on_a_long_scan(scans, scan, nviews):
    """A sweep through the eval CLI's two loader threads of a LONG_VIEWS-view
    scan, several times a sample's views, whose samples read their nearest
    views: the run scripts' --num_view 20 on a converter's pair file (11
    views a sample, as Tanks and Temples'), on 17 sources (18 views a sample,
    more than CACHED_VIEWS) and at 8 views a sample. Each view decoded once
    although the cache holds fewer views than the scan, every sample the
    dataset's own."""
    kw = dict(nviews=nviews, ndepths=48, max_h=64, max_w=64, dataset_name="tt")
    ds = EvalDataset(str(scans), [scan], **kw)
    assert ds.views.size < LONG_VIEWS
    got = list(EvalLoader(ds, num_workers=2))
    assert [s["ref_view"] for s in got] == list(range(LONG_VIEWS))
    assert [len(s["imgs"]) for s in got] == [min(nviews, LONG_SOURCES[scan] + 1)] * LONG_VIEWS
    assert ds.views.decodes == LONG_VIEWS
    want = EvalDataset(str(scans), [scan], **kw)
    for i in (0, LONG_VIEWS // 2, LONG_VIEWS - 1):
        np.testing.assert_array_equal(got[i]["imgs"], want[i]["imgs"])


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
def test_eval_loader_order_and_striding_match_jax(scans, rank, world):
    common = dict(nviews=2, ndepths=48, max_h=64, max_w=128)
    port = [s["ref_view"] for s in EvalLoader(EvalDataset(str(scans), ["scan1", "dnum"], **common),
                                              rank=rank, world=world)]
    ref = [s["ref_view"] for s in JaxEvalLoader(JaxEvalDataset(str(scans), ["scan1", "dnum"],
                                                               **common), rank=rank, world=world)]
    assert port == ref and len(port) == len(range(6)[rank::world])
