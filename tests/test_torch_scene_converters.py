"""The port's scene converters (mvsformerplusplus_tpu_torch/tools/
colmap2mvsnet.py and nerf2mvsnet.py) against the repo's JAX-side tools
(tools/, OpenCV inside) on the same small scenes of the analytic scene
(data/synthetic.make_colmap_scene, make_nerf_scene: 6 views at 240 x 320).

- colmap2mvsnet: binary and text models, four camera models, max_d 256 and
  0 (the inverse-depth depth count), a view whose features match no 3D
  point, the byte copy and --convert_format from PNG, BMP, LZW TIFF, JPEG
  and a JPEG with EXIF orientation 6;
- nerf2mvsnet with ORB: camera_angle_x and fl_x/fl_y intrinsics, RGBA
  frames, a frame path without its extension;
- cams/*.txt and pair.txt byte-equal, images pixel-equal once decoded;
  every view's depth range holds its median true depth;
- nerf2mvsnet with the DINOv2 matcher on the CPU, both tools given the same
  flax ViT-B parameters (`params=`): match points within 1e-3 px, the depth
  ranges within 1e-5 relative (what 1e-3 px moves a triangulated depth here
  by), the view pairs the same;
- both CLIs (main(argv)) run the same conversion as convert.
"""
import filecmp
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu_torch.data import io, native, synthetic
from mvsformerplusplus_tpu_torch.tools import colmap2mvsnet, nerf2mvsnet

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import colmap2mvsnet as jax_colmap  # noqa: E402
from tools import nerf2mvsnet as jax_nerf  # noqa: E402

FORMATS = ("png", "bmp", "tif", "jpg6", "jpg")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return synthetic.GeometricScene(0, tex_res=256)


def _same_scan(a: Path, b: Path, n_views: int):
    cams = sorted(p.name for p in (a / "cams").iterdir())
    assert cams == [f"{i:0>8}_cam.txt" for i in range(n_views)]
    assert cams == sorted(p.name for p in (b / "cams").iterdir())
    for name in cams:
        assert filecmp.cmp(a / "cams" / name, b / "cams" / name, shallow=False), name
    assert filecmp.cmp(a / "pair.txt", b / "pair.txt", shallow=False)
    for i in range(n_views):
        name = f"{i:0>8}.jpg"
        np.testing.assert_array_equal(io.read_image_u8(a / "images" / name),
                                      io.read_image_u8(b / "images" / name))


def _ranges_hold_medians(scan: Path, depths):
    for i, depth in enumerate(depths):
        _, _, dmin, _, extra = io.read_cam_file(scan / "cams" / f"{i:0>8}_cam.txt")
        median = float(np.median(depth[depth > 0]))
        assert dmin <= median <= extra["depth_max"], (i, dmin, median, extra["depth_max"])


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
@pytest.mark.parametrize("model,max_d,convert_format",
                         [("PINHOLE", 256, True), ("SIMPLE_PINHOLE", 0, False),
                          ("SIMPLE_RADIAL", 128, True), ("OPENCV", 0, True)])
def test_colmap_equals_the_jax_tool(tmp_path, scene, binary, model, max_d, convert_format):
    _, depths = synthetic.make_colmap_scene(tmp_path / "port", n_points=1500, model=model,
                                            binary=binary, formats=FORMATS, empty_view=2,
                                            scene=scene)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    before = dict(native.plain_calls)
    got = colmap2mvsnet.convert(tmp_path / "port", max_d=max_d, convert_format=convert_format)
    assert native.plain_calls == before
    want = jax_colmap.convert(tmp_path / "jax", max_d=max_d, convert_format=convert_format)
    assert got[1] == want[1]
    assert {k: tuple(map(float, v)) for k, v in got[0].items()} == \
        {k: tuple(map(float, v)) for k, v in want[0].items()}
    if convert_format:
        _same_scan(tmp_path / "port", tmp_path / "jax", 6)
    else:  # the byte copy keeps each source file under a .jpg name
        for i in range(6):
            assert filecmp.cmp(tmp_path / "port" / "images" / f"{i:0>8}.jpg",
                               tmp_path / "jax" / "images" / f"{i:0>8}.jpg", shallow=False)
        for name in ["pair.txt"] + [f"cams/{i:0>8}_cam.txt" for i in range(6)]:
            assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)
    _ranges_hold_medians(tmp_path / "port", depths)


@pytest.mark.parametrize("intrinsics", ["angle", "focal"])
def test_nerf_orb_equals_the_jax_tool(tmp_path, scene, intrinsics):
    _, depths = synthetic.make_nerf_scene(tmp_path / "port", rgba=(1, 4), bare=(2,),
                                          intrinsics=intrinsics, scene=scene)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    before = dict(native.plain_calls)
    got_depths, got_covis = nerf2mvsnet.convert(tmp_path / "port")
    assert native.plain_calls == before
    want_depths, want_covis = jax_nerf.convert(tmp_path / "jax")
    assert got_depths == want_depths
    np.testing.assert_array_equal(got_covis, want_covis)
    assert (got_covis > 0).sum() >= 12
    _same_scan(tmp_path / "port", tmp_path / "jax", 6)
    _ranges_hold_medians(tmp_path / "port", depths)


def test_nerf_out_dir_and_the_cli(tmp_path, scene):
    synthetic.make_nerf_scene(tmp_path / "s", n_frames=4, scene=scene)
    nerf2mvsnet.main(["--scene_dir", str(tmp_path / "s"), "--out_dir", str(tmp_path / "a"),
                      "--max_d", "128"])
    nerf2mvsnet.convert(tmp_path / "s", tmp_path / "b", max_d=128)
    _same_scan(tmp_path / "a", tmp_path / "b", 4)
    with pytest.raises(SystemExit):
        nerf2mvsnet.main(["--scene_dir", str(tmp_path / "s"), "--matcher", "dino"])


def test_colmap_cli(tmp_path, scene):
    synthetic.make_colmap_scene(tmp_path / "a", n_points=800, formats=("png", "bmp"),
                                scene=scene)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    colmap2mvsnet.main(["--dense_folder", str(tmp_path / "a"), "--max_d", "0",
                        "--interval_scale", "1.06", "--convert_format"])
    colmap2mvsnet.convert(tmp_path / "b", max_d=0, interval_scale=1.06, convert_format=True)
    _same_scan(tmp_path / "a", tmp_path / "b", 6)


def test_colmap_readers_equal_the_jax_tools(tmp_path, scene):
    for binary in (False, True):
        synthetic.make_colmap_scene(tmp_path / str(binary), n_points=500, binary=binary,
                                    model="OPENCV", scene=scene)
        got = colmap2mvsnet.read_model(tmp_path / str(binary) / "sparse")
        want = jax_colmap.read_model(tmp_path / str(binary) / "sparse")
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                for a, b in zip(g[k], w[k]):
                    np.testing.assert_array_equal(a, b)
        for cam in got[0].values():
            np.testing.assert_array_equal(colmap2mvsnet.intrinsics_of(cam),
                                          jax_colmap.intrinsics_of(cam))
    q = np.array([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(colmap2mvsnet.qvec2rotmat(q), jax_colmap.qvec2rotmat(q))
    np.testing.assert_allclose(colmap2mvsnet.qvec2rotmat(synthetic._rotmat_to_qvec(
        colmap2mvsnet.qvec2rotmat(q))), colmap2mvsnet.qvec2rotmat(q), atol=1e-12)


# ------------------------------------------------------------------- dino

def test_nerf_dino_matches_the_jax_tool(tmp_path, scene):
    """The DINOv2 matcher: both tools given flax's initialisation of ViT-B
    (the JAX tool's own `--matcher dino` cannot load a file, see
    tests/test_torch_dino_match.py), the working size 154 x 210."""
    import jax
    import jax.numpy as jnp

    from mvsformerplusplus_tpu.models.dino import DinoVisionTransformer as JaxViT
    from tools.dino_match import make_dino_matcher as jax_make_dino_matcher

    params = jax.jit(JaxViT().init)(jax.random.PRNGKey(0), jnp.zeros((1, 154, 210, 3)))["params"]
    port_fn = nerf2mvsnet.make_matcher("dino", params=params, device="cpu", long_side=210)
    jax_fn = jax_make_dino_matcher(long_side=210, params=params)
    synthetic.make_nerf_scene(tmp_path / "port", n_frames=3, scene=scene)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    a, b = (io.imread_rgb(tmp_path / "port" / "train" / f"r_{i}.png") for i in (0, 1))
    got, want = port_fn(a, b), jax_fn(a, b)
    assert len(got[0]) == len(want[0]) >= 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    got_depths, got_covis = nerf2mvsnet.convert(tmp_path / "port", pairs_per_view=2,
                                                match_fn=port_fn, device="cpu")
    want_depths, want_covis = jax_nerf.convert(tmp_path / "jax", pairs_per_view=2,
                                               match_fn=jax_fn)
    assert [d is None for d, _ in got_depths] == [d is None for d, _ in want_depths]
    np.testing.assert_allclose(np.array(got_depths, float), np.array(want_depths, float),
                               rtol=1e-5)
    np.testing.assert_array_equal(got_covis > 0, want_covis > 0)
    for i in range(3):
        g = io.read_cam_file(tmp_path / "port" / "cams" / f"{i:0>8}_cam.txt")
        w = io.read_cam_file(tmp_path / "jax" / "cams" / f"{i:0>8}_cam.txt")
        np.testing.assert_allclose([g[2], g[4]["depth_max"]], [w[2], w[4]["depth_max"]],
                                   rtol=1e-5)
    assert io.read_pair_file(tmp_path / "port" / "pair.txt") == \
        io.read_pair_file(tmp_path / "jax" / "pair.txt")
