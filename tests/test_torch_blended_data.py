"""The port's BlendedTrainDataset against the JAX package's on scans that
data/synthetic.make_blended_scan writes (the BlendedMVS layout, JPEG
through the port's encoder): flat and nested {scan}/{scan}/{scan}, cam
files with and without the depth_num and depth_max fields. The decoded
views bit for bit, the samples bit for bit (both sides normalise the
crops in the same C pass, the port's copy of the JAX package's fastio;
cameras, depth values, depth pyramids and masks), the metas, the top-7
source shuffle and the per-dataset cache of decoded views."""
import random

import numpy as np
import pytest

from mvsformerplusplus_tpu.data.mvs_dataset import BlendedTrainDataset as JaxBlended
from mvsformerplusplus_tpu_torch.data.mvs_dataset import BlendedTrainDataset
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_blended_scan

AUG = dict(brightness=0.2, contrast=0.1, saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1)
KW = dict(nviews=4, ndepths=48, interval_scale=1.0, random_crop=True, augment=True,
          aug_args=AUG, resize_range=(1.0, 1.2))


@pytest.fixture(scope="module", params=[(False, True), (True, True), (False, False)],
            ids=["flat", "nested", "flat_no_depth_num"])
def scans(request, tmp_path_factory):
    """Two 9-view scans at 96 x 128 (9 views: the pair's top 7 is a strict
    subset of each view's 8 sources)."""
    nested, depth_num = request.param
    root = tmp_path_factory.mktemp("blended")
    for i, scan in enumerate(("5a3ca9cb", "5b08286b")):
        make_blended_scan(root, scan, n_views=9, h=96, w=128, ndepth=48, depth_num=depth_num,
                          nested=nested, scene=GeometricScene(seed=i, tex_res=128))
    return root, request.param


def _pair(root, mode="train", **kw):
    args = (str(root), str(root / "train.txt"))
    return BlendedTrainDataset(*args, mode=mode, **kw), JaxBlended(*args, mode=mode, **kw)


def test_metas_and_views_match_jax(scans):
    root, (_, depth_num) = scans
    port, jax_ds = _pair(root, **KW)
    assert port.metas == jax_ds.metas and len(port) == 18
    for meta in (port.metas[0], port.metas[-1]):
        for vid in (meta[2], meta[3][-1]):
            got, want = port.load_view(meta, vid, True), jax_ds.load_view(meta, vid, True)
            np.testing.assert_array_equal(got[0], want[0])  # decoded pixels
            assert got[0].dtype == want[0].dtype == np.float32 and got[0].flags.writeable
            for g, w in zip(got[1:5], want[1:5]):
                np.testing.assert_array_equal(g, w)
            assert got[5:] == want[5:]
    dmin, dint = port.load_view(port.metas[0], 0, False)[5:]
    with open(port._scan_dir(port.metas[0][0]) + "/cams/00000000_cam.txt") as f:
        fields = f.read().split()[-4:]
    if depth_num:  # re-derived from depth_max over ndepths
        assert dint == pytest.approx((float(fields[3]) - dmin) / 48)
    else:
        assert dint == float(fields[-1])


@pytest.mark.parametrize("idx,crop,epoch", [(0, (64, 96), 0), (5, (64, 64), 1),
                                            (13, (80, 112), 2)])
def test_train_sample_matches_jax(scans, idx, crop, epoch):
    root, _ = scans
    port, jax_ds = _pair(root, **KW)
    got, want = port.get_sample(idx, crop, epoch), jax_ds.get_sample(idx, crop, epoch)
    assert got["filename"] == want["filename"]
    assert got["imgs"].shape == want["imgs"].shape == (4, *crop, 3)
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    for k in want["cams"]:
        np.testing.assert_array_equal(got["cams"][k], want["cams"][k])
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    for k in ("depth_gt", "mask"):
        for s in want[k]:
            np.testing.assert_array_equal(got[k][s], want[k][s])
    assert set(np.unique(got["mask"]["stage4"])) <= {0.0, 1.0}


def test_val_sample_matches_jax(scans):
    """mode val: centre crop, no augmentation; the full 96 x 128 view."""
    root, _ = scans
    port, jax_ds = _pair(root, mode="val", nviews=5, ndepths=48, interval_scale=1.0)
    got, want = port.get_sample(3, (96, 128)), jax_ds.get_sample(3, (96, 128))
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    np.testing.assert_array_equal(got["mask"]["stage4"], want["mask"]["stage4"])


def test_sources_come_from_the_top_7(scans):
    """Each sample's sources are 3 of its pair's first 7, never the 8th."""
    root, _ = scans
    port, _ = _pair(root, **KW)
    for idx in range(len(port)):
        srcs = port.metas[idx][3]
        picked = port.shuffle_src_views(srcs, random.Random(idx))
        assert sorted(picked) == sorted(srcs[:7]) and srcs[7] not in picked


def test_decoded_views_are_cached_read_only(scans):
    root, _ = scans
    port, _ = _pair(root, **KW)
    for epoch in range(2):
        for idx in range(9):
            port.get_sample(idx, (64, 96), epoch)
    assert port.views.decodes == 9  # scan 1's nine views, each decoded once
    pixels = port.views.get(next(iter(port.views._images)))
    assert not pixels.flags.writeable


def test_refs_without_sources_are_skipped(tmp_path):
    make_blended_scan(tmp_path, "s", n_views=3, h=32, w=48, ndepth=16,
                      scene=GeometricScene(seed=0, tex_res=32))
    pair = tmp_path / "s" / "cams" / "pair.txt"
    lines = pair.read_text().splitlines()
    lines[2] = "0"  # view 0 lists no source
    pair.write_text("\n".join(lines) + "\n")
    port, jax_ds = _pair(tmp_path, **KW)
    assert [m[2] for m in port.metas] == [m[2] for m in jax_ds.metas] == [1, 2]
