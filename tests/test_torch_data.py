"""The port's training data pipeline (mvsformerplusplus_tpu_torch/data/)
against the JAX package's (PIL and OpenCV there, numpy here) on the same
files and seeds:
- io: PFM, cam and pair files read the same values; the port's writers
  write what the JAX writers write;
- transforms: the same jitter draws, jitter and crop-normalize within 2e-5;
- the DTU dataset: get_sample(idx, crop, epoch) with augmentation on, on a
  geometric scan the JAX writer made (PIL's PNGs): images within 2e-5
  after normalization, cameras within 1e-6 relative, depth, mask, depth
  values and view order exactly equal;
- the synthetic writers: the same files (images bit-equal, cams and PFMs
  equal)."""
import numpy as np
import pytest

from mvsformerplusplus_tpu.data import io as jio
from mvsformerplusplus_tpu.data import synthetic as jsyn
from mvsformerplusplus_tpu.data import transforms as jtr
from mvsformerplusplus_tpu.data.mvs_dataset import DTUTrainDataset as JaxDTU
from mvsformerplusplus_tpu_torch.data import io as tio
from mvsformerplusplus_tpu_torch.data import synthetic as tsyn
from mvsformerplusplus_tpu_torch.data import transforms as ttr
from mvsformerplusplus_tpu_torch.data.mvs_dataset import DTUTrainDataset

AUG = dict(brightness=0.2, contrast=0.1, saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1)


@pytest.fixture(scope="module")
def geometric_scan(tmp_path_factory):
    """A 5-view geometric DTU scan at 160 x 240 written by the JAX package."""
    root = tmp_path_factory.mktemp("dtu")
    jsyn.make_geometric_dtu(root, n_views=5, n_lights=7, h=160, w=240, ndepth=48,
                            scene=jsyn.GeometricScene(seed=3, tex_res=256))
    return root


def test_io_matches_the_jax_readers_and_writers(tmp_path):
    rng = np.random.RandomState(0)
    depth = rng.uniform(1, 9, (13, 17)).astype(np.float32)
    color = rng.rand(5, 7, 3).astype(np.float32)
    intr = np.array([[401.5, 0, 120.25], [0, 399.0, 80.5], [0, 0, 1]], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[:3] = rng.randn(3, 4)
    for name, img in (("d", depth), ("c", color)):
        tio.save_pfm(tmp_path / f"{name}_t.pfm", img)
        jio.save_pfm(tmp_path / f"{name}_j.pfm", img)
        ours, theirs = tmp_path / f"{name}_t.pfm", tmp_path / f"{name}_j.pfm"
        assert ours.read_bytes() == theirs.read_bytes()
        got, want = tio.read_pfm(theirs), jio.read_pfm(theirs)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.float32 and got[1] == want[1]
    for extra in ({}, {"depth_num": 192, "depth_max": 935.5}):
        tio.save_cam_file(tmp_path / "t.txt", intr, ext, 425.0, 2.5, **extra)
        jio.save_cam_file(tmp_path / "j.txt", intr, ext, 425.0, 2.5, **extra)
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
        got = tio.read_cam_file(tmp_path / "j.txt", 1.06)
        want = jio.read_cam_file(tmp_path / "j.txt", 1.06)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g) if not isinstance(g, dict) else 0,
                                          np.asarray(w) if not isinstance(w, dict) else 0)
        assert got[4] == want[4]
    pairs = [(0, [(1, 0.5), (2, 0.25)]), (1, [(0, 0.5)])]
    tio.save_pair_file(tmp_path / "tp.txt", pairs)
    jio.save_pair_file(tmp_path / "jp.txt", pairs)
    assert (tmp_path / "tp.txt").read_text() == (tmp_path / "jp.txt").read_text()
    assert tio.read_pair_file(tmp_path / "jp.txt") == jio.read_pair_file(tmp_path / "jp.txt")
    np.testing.assert_array_equal(tio.build_camera_stack(intr, ext),
                                  jio.build_camera_stack(intr, ext))
    np.testing.assert_array_equal(tio.scale_intrinsics(intr, 0.25),
                                  jio.scale_intrinsics(intr, 0.25))


def test_transforms_match_jax():
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 56, 3) * 255).astype(np.uint8).astype(np.float32) / 255
    for seed in range(6):
        pt = ttr.sample_jitter_params(np.random.RandomState(seed), **AUG)
        pj = jtr.sample_jitter_params(np.random.RandomState(seed), **AUG)
        assert pt.keys() == pj.keys()
        for k in pt:
            np.testing.assert_array_equal(pt[k], pj[k])
        for gamma in (True, False):
            np.testing.assert_allclose(ttr.apply_color_jitter(img, pt, include_gamma=gamma),
                                       jtr.apply_color_jitter(img, pj, include_gamma=gamma),
                                       rtol=0, atol=2e-5)
    np.testing.assert_array_equal(ttr.normalize_imagenet(img), jtr.normalize_imagenet(img))
    mask = (rng.rand(64, 96) > 0.5).astype(np.float32)
    got, want = ttr.stage_pyramid(mask), jtr.stage_pyramid(mask)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("idx,crop,epoch", [(0, (128, 192), 0), (9, (128, 192), 1),
                                            (23, (96, 128), 0), (34, (128, 160), 2)])
def test_dtu_sample_matches_jax(geometric_scan, idx, crop, epoch):
    kw = dict(nviews=5, ndepths=48, interval_scale=1.06, random_crop=True, augment=True,
              aug_args=AUG, resize_range=(1.0, 1.2))
    listfile = geometric_scan / "train.txt"
    got = DTUTrainDataset(str(geometric_scan), str(listfile), **kw).get_sample(idx, crop, epoch)
    want = JaxDTU(str(geometric_scan), str(listfile), **kw).get_sample(idx, crop, epoch)
    assert got["filename"] == want["filename"]  # reference view (and scan)
    assert got["imgs"].shape == want["imgs"].shape == (5, *crop, 3)
    np.testing.assert_allclose(got["imgs"], want["imgs"], rtol=0, atol=2e-5)
    for k in want["cams"]:
        np.testing.assert_allclose(got["cams"][k], want["cams"][k], rtol=1e-6, atol=0)
        # the view order: each view's extrinsic is its own camera's
        np.testing.assert_array_equal(got["cams"][k][:, 0], want["cams"][k][:, 0])
    np.testing.assert_array_equal(got["depth_values"], want["depth_values"])
    for k in ("depth_gt", "mask"):
        for s in want[k]:
            np.testing.assert_array_equal(got[k][s], want[k][s])


def test_synthetic_writers_match_jax(tmp_path):
    jsyn.make_synthetic_dtu(tmp_path / "j", n_views=3, n_lights=2, h=24, w=32, seed=4)
    tsyn.make_synthetic_dtu(tmp_path / "t", n_views=3, n_lights=2, h=24, w=32, seed=4)
    jsyn.make_geometric_dtu(tmp_path / "gj", n_views=3, n_lights=2, h=40, w=56, ndepth=16,
                            scene=jsyn.GeometricScene(seed=1, tex_res=64))
    tsyn.make_geometric_dtu(tmp_path / "gt", n_views=3, n_lights=2, h=40, w=56, ndepth=16,
                            scene=tsyn.GeometricScene(seed=1, tex_res=64))
    for j, t in (("j", "t"), ("gj", "gt")):
        files = sorted(p.relative_to(tmp_path / j) for p in (tmp_path / j).rglob("*")
                       if p.is_file())
        assert files == sorted(p.relative_to(tmp_path / t)
                               for p in (tmp_path / t).rglob("*") if p.is_file())
        assert any(f.suffix == ".png" for f in files) and any(f.suffix == ".pfm" for f in files)
        for f in files:
            a, b = tmp_path / j / f, tmp_path / t / f
            if f.suffix == ".png":
                from PIL import Image

                np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
            else:
                assert a.read_bytes() == b.read_bytes(), f
