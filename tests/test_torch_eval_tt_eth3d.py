"""The port's eval command line against the repo's test.py at the Tanks and
Temples and ETH3D settings of the run scripts
(mvsformerplusplus_tpu_torch/scripts/test_tt_*.sh, test_eth3d.sh), on the
CPU, on tiny scans of those layouts and the same seeded flax weights (the
port from their --ckpt_npz, test.py from the same variables saved by the
JAX CheckpointManager, --ckpt: its --ckpt_npz would compile the flax init
first):

- T&T: a 6-view scan at the raw 56 x 128 (the dataset's 4-row edge pad to
  64 x 128 and its cy shift), cams with the four-field range line
  (depth_min, interval, depth_num, depth_max), run with --dataset tt
  --num_view 5 --interval_scale 1.0 --conf_choose stage4 --filter_method
  dpcd --conf 0.3 --fusion_view 3;
- ETH3D: a 5-view scan at the raw 192 x 288 (ETH3D's 2:3), resized to
  64 x 128 as 4032 x 6048 becomes 1024 x 1600 (the smaller of the two
  ratios, rounded down to multiples of 64), cams whose second range field
  is the depth max, run with --dataset eth3d --schedule queue
  --interval_scale 1.0 --filter_method dpcd --conf 0.5.

The range lines span 0.85-1.15 of the scene's median depth (not all of it):
with random weights the inverse-depth cascade's later stages reach past a
wider range's far end, where a hypothesis 1 / inv amplifies rounding by
orders of magnitude (testing.well_conditioned); inside this one every
pixel is well-conditioned. Both command lines build their model in fp32 here (their own build is bf16,
whose rounding differs between the two frameworks by more than a parity
tolerance), so the depth maps are held to the flagship forward's
tolerances (test_torch_flagship.py: rtol 1e-3 on depth, atol 1e-3 on
confidence, which the uint8 map holds within one step); each cam file and
reference image is the JAX run's. Fusion: the port's fuse_scan and test.py's
on the port's depth maps, and on the scan's ground-truth depths (rendered
at the eval size with the cams the dataset gives) written in their place,
a non-empty cloud; each reference view's dpcd masks and points held to the
JAX ones as chip_smoke.py's gt_fusion_check holds the card to the CPU (a
threshold decision may flip on at most 1e-4 of the pixels, points within
1e-4 of the cloud's extent), and where no decision flips the two clouds
equal point for point and colour for colour. Each view is decoded once.
--window_check off: test.py's pre-flight checks the TPU warp's sampling
windows (the port's warp needs none).
"""
import functools
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mvsformerplusplus_tpu.config as jax_config
import mvsformerplusplus_tpu.utils.cache as jax_cache
from mvsformerplusplus_tpu.fusion import fusion as jax_fusion
from mvsformerplusplus_tpu.train.checkpoints import CheckpointManager as JaxCheckpoints
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState
from mvsformerplusplus_tpu_torch import config as port_config
from mvsformerplusplus_tpu_torch.data.io import (build_camera_stack, read_cam_file,
                                                 read_pair_file, read_pfm, save_cam_file,
                                                 save_pfm)
from mvsformerplusplus_tpu_torch.data.synthetic import (GeometricScene, make_geometric_eval_scan,
                                                        tnt_cameras)
from mvsformerplusplus_tpu_torch.eval import cli
from mvsformerplusplus_tpu_torch.fusion import fusion as port_fusion
from mvsformerplusplus_tpu_torch.fusion.ply import read_ply
from tests.test_casmvs import make_inputs
from tests.test_torch_flagship import TINY_ARCH_ARGS
from tests.torch_parity import init_flax
from tools.convert_reference import save_npz

REPO = Path(__file__).resolve().parents[1]
DEPTHS = 48

# name -> (views, raw H x W, the run's flags beyond the common ones)
SETTINGS = {
    "tt": (6, (56, 128), ["--dataset", "tt", "--num_view", "5", "--max_h", "64",
                          "--max_w", "128", "--conf_choose", "stage4", "--filter_method", "dpcd",
                          "--conf", "0.3", "--fusion_view", "3"]),
    "eth3d": (5, (192, 288), ["--dataset", "eth3d", "--num_view", "5", "--max_h", "128",
                              "--max_w", "160", "--schedule", "queue", "--filter_method", "dpcd",
                              "--conf", "0.5"]),
}
EVAL_HW = (64, 128)  # what both settings' images become


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_test_cli():
    """The repo's test.py as a module (a plain `import test` would find the
    standard library's test package)."""
    spec = importlib.util.spec_from_file_location("jax_eval_cli_tt_eth3d", REPO / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _eval_k(K, raw_hw):
    """The intrinsics the dataset gives a view of `raw_hw` at EVAL_HW (T&T:
    cy shifted by the pad, scale 1)."""
    K = K.copy()
    if raw_hw[0] + 8 == EVAL_HW[0]:
        K[1, 2] += 4.0
        return K
    K[0] *= EVAL_HW[1] / raw_hw[1]
    K[1] *= EVAL_HW[0] / raw_hw[0]
    return K


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Both scans (their views on the T&T rig), their ground-truth depths
    at EVAL_HW, the tiny flagship's config and its seeded flax weights."""
    root = tmp_path_factory.mktemp("tt_eth3d")
    scene = GeometricScene(seed=5, tex_res=128)
    for name, (views, (h, w), _) in SETTINGS.items():
        cams = tnt_cameras(views, h, w)
        make_geometric_eval_scan(root, name, n_views=views, h=h, w=w, ndepth=DEPTHS,
                                 scene=scene, cameras=cams)
        gt = root / "gt_eval" / name
        gt.mkdir(parents=True)
        depth = read_pfm(root / "gt_depths" / name / "depth_map_0000.pfm")[0]
        median = float(np.median(depth[depth > 0]))
        dmin, dmax = 0.85 * median, 1.15 * median
        for vid, (K, E) in enumerate(cams):
            path = root / name / "cams" / f"{vid:0>8}_cam.txt"
            if name == "tt":  # T&T's four fields: a hypothesis count, and the depth max
                save_cam_file(path, K, E, dmin, (dmax - dmin) / 192, depth_num=192,
                              depth_max=dmax)
            else:  # ETH3D's: the second field is the depth max
                save_cam_file(path, K, E, dmin, dmax)
            save_pfm(gt / f"{vid:0>8}.pfm",
                     scene.render(_eval_k(K, (h, w)), E, *EVAL_HW)[1])
        (root / f"{name}.txt").write_text(f"{name}\n")
    cfg = {"arch": {"args": {**TINY_ARCH_ARGS, "vit_depth": 3,
                             "vit_path": str(root / "none.npz")}}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    jm = jax_config.build_model(jax_config.Config(cfg), dtype=jnp.float32)
    variables = init_flax(jm, *make_inputs(np.random.RandomState(0), v=3, h=64, w=128),
                          train=False)
    save_npz(variables["params"], variables["batch_stats"], root / "ckpt.npz")
    JaxCheckpoints(root / "jax_ckpt").save(
        0, TrainState.create(variables, jax_make_optimizer(freeze_vit=True)))
    return root


def _argv(root, name, out, weights=None):
    weights = weights or ["--ckpt_npz", str(root / "ckpt.npz")]
    return ["--config", str(root / "cfg.json"), "--testpath", str(root), "--testlist",
            str(root / f"{name}.txt"), "--outdir", str(out), "--numdepth", str(DEPTHS),
            "--interval_scale", "1.0", "--window_check", "off", *weights, *SETTINGS[name][2]]


@pytest.fixture(scope="module")
def runs(root):
    """Both command lines on both scans, their models built in fp32: name ->
    (the port's outdir, its stats, the JAX run's outdir)."""
    mp = pytest.MonkeyPatch()
    port_build, jax_build = port_config.build_model, jax_config.build_model
    mp.setattr(cli, "build_model",
               lambda cfg, dtype, device: port_build(cfg, dtype=torch.float32, device=device))
    mp.setattr(jax_config, "build_model",
               lambda cfg, dtype=None, **kw: jax_build(cfg, dtype=jnp.float32, **kw))
    # test.py's persistent compile cache would write outside the test's directories
    mp.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    test_cli = _jax_test_cli()
    out = {}
    try:
        for name in SETTINGS:
            port_out, jax_out = root / f"port_{name}", root / f"jax_{name}"
            stats = cli.main(_argv(root, name, port_out) + ["--device", "cpu"])
            mp.setattr(sys, "argv", ["test.py", *_argv(root, name, jax_out,
                                                       ["--ckpt", str(root / "jax_ckpt")])])
            test_cli.main()
            out[name] = (port_out, stats, jax_out)
    finally:
        mp.undo()
    return out


def _views(name):
    return range(SETTINGS[name][0])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_depth_maps_match_jax(runs, name):
    port_out, stats, jax_out = runs[name]
    assert stats["maps"] == SETTINGS[name][0]
    for v in _views(name):
        got = read_pfm(port_out / name / "depth_est" / f"{v:0>8}.pfm")[0]
        want = read_pfm(jax_out / name / "depth_est" / f"{v:0>8}.pfm")[0]
        assert got.shape == want.shape == EVAL_HW and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0, err_msg=str(v))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_stage4_or_mean_confidence_matches_jax(runs, name):
    """uint8 maps of clip(conf, 0, 1) * 255, truncated: a confidence within
    1e-3 of the JAX one lies within one step."""
    port_out, _, jax_out = runs[name]
    for v in _views(name):
        got = np.load(port_out / name / "confidence" / f"{v:0>8}.npy")
        want = np.load(jax_out / name / "confidence" / f"{v:0>8}.npy")
        assert got.dtype == want.dtype == np.uint8 and got.shape == EVAL_HW
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, v


@pytest.mark.parametrize("name", list(SETTINGS))
def test_cams_and_reference_images_match_jax(runs, name):
    """The cams the dataset gave (T&T's shifted cy, ETH3D's range from its
    depth max) and the reference images as decoded."""
    port_out, _, jax_out = runs[name]
    for v in _views(name):
        got = read_cam_file(port_out / name / "cams" / f"{v:0>8}_cam.txt")
        want = read_cam_file(jax_out / name / "cams" / f"{v:0>8}_cam.txt")
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        images = [np.asarray(Image.open(o / name / "images" / f"{v:0>8}.jpg"))
                  for o in (port_out, jax_out)]
        assert images[0].shape == EVAL_HW + (3,)
        np.testing.assert_array_equal(*images)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_each_view_is_decoded_once(runs, name):
    _, stats, _ = runs[name]
    assert stats["decodes"] == SETTINGS[name][0]
    assert stats["fusion_decodes"] == SETTINGS[name][0]


def _fuse_both(root, name, outdir):
    """The port's fuse_scan and test.py's on the maps under `outdir` with
    the setting's flags: (port cloud, JAX cloud, port point count)."""
    args = cli.parser().parse_args(_argv(root, name, outdir) + ["--device", "cpu"])
    n = cli.fuse_scan(args, name, torch.device("cpu"))
    got = read_ply(outdir / f"{name}.ply")
    _jax_test_cli().fuse_scan(args, name)
    return got, read_ply(outdir / f"{name}.ply"), n


@functools.lru_cache(maxsize=None)
def _jax_dpcd(conf):
    """The JAX dpcd filter and its per-source decisions (the strictest
    level's consistency, which the kept point is averaged over)."""
    def fuse(ref_depth, ref_conf, src_depths, ref_cam, src_cams):
        pts, mask = jax_fusion.dpcd_fuse(ref_depth, ref_conf, src_depths, ref_cam, src_cams,
                                         conf_thresh=conf)
        reproj = jax_fusion.reproject_dynamic(ref_depth, src_depths, ref_cam, src_cams)
        return pts, mask, jax_fusion.vis_filter_dynamic(ref_depth, reproj)[1]

    return jax.jit(fuse)


def _port_dpcd(conf, ref_depth, ref_conf, src_depths, ref_cam, src_cams):
    pts, mask = port_fusion.dpcd_fuse(ref_depth, ref_conf, src_depths, ref_cam, src_cams,
                                      conf_thresh=conf)
    reproj = port_fusion.reproject_dynamic(ref_depth, src_depths, ref_cam, src_cams)
    return pts, mask, port_fusion.vis_filter_dynamic(ref_depth, reproj)[1]


def _views_agree(root, name, outdir):
    """Each reference view fused by the port's dpcd_fuse and the JAX one on
    the maps, cams and sources (the first --fusion_view of pair.txt) that
    fuse_scan reads, at the setting's --conf: the share of pixels whose
    mask or any per-source decision differs, the largest point distance
    over the kept cloud's extent where both keep the pixel and every
    decision agrees, and each side's kept count. fp32 products in another
    order can flip a decision that sits on its threshold (a few per scan of
    true depths), which moves the kept point by up to a source's share of
    its average, so the two are held as chip_smoke.py's gt_fusion_check
    holds the card to the CPU: decisions differing on at most 1e-4 of the
    pixels, points within 1e-4 of the extent where they agree."""
    args = cli.parser().parse_args(_argv(root, name, outdir))
    d = outdir / name

    def view(v):
        conf = np.load(d / "confidence" / f"{v:0>8}.npy").astype(np.float32) / 255.0
        K, E = read_cam_file(d / "cams" / f"{v:0>8}_cam.txt")[:2]
        return (read_pfm(d / "depth_est" / f"{v:0>8}.pfm")[0].astype(np.float32), conf,
                build_camera_stack(K, E))

    flips = pixels = 0
    kept, dist, pts = [0, 0], [], []
    for ref, srcs in read_pair_file(root / name / "pair.txt"):
        srcs = srcs[:args.fusion_view]
        depth, conf, cam = view(ref)
        src = [view(s_) for s_ in srcs]
        arrays = (depth, conf, np.stack([v[0] for v in src]), cam, np.stack([v[2] for v in src]))
        p_port, m_port, d_port = (t.numpy() for t in _port_dpcd(
            args.conf, *(torch.from_numpy(a) for a in arrays)))
        p_jax, m_jax, d_jax = (np.asarray(t) for t in _jax_dpcd(args.conf)(*arrays))
        agree = (m_port == m_jax) & (d_port == d_jax).all(axis=0)
        flips += int((~agree).sum())
        pixels += m_port.size
        kept[0] += int(m_port.sum())
        kept[1] += int(m_jax.sum())
        both = m_port & m_jax & agree
        dist.append(np.abs(p_port - p_jax).max(axis=-1)[both])
        pts.append(p_jax[m_jax])
    pts = np.concatenate(pts)
    extent = float(np.ptp(pts, axis=0).max()) if len(pts) else 0.0
    dist = np.concatenate(dist)
    return flips / pixels, (float(dist.max()) / extent if len(dist) else 0.0), kept


def _assert_clouds_agree(root, name, outdir, got, want, n):
    """The per-view rule of _views_agree; each command line's cloud the
    pixels its own fusion keeps; where no mask differs, the two clouds
    point for point (within 1e-4 of the extent) and colour for colour."""
    flip_share, dist, kept = _views_agree(root, name, outdir)
    assert flip_share <= 1e-4 and dist <= 1e-4, (flip_share, dist)
    assert (n, len(want[0])) == tuple(kept)
    if kept[0] == kept[1] and flip_share == 0:
        extent = float(np.ptp(want[0], axis=0).max()) if n else 0.0
        assert np.abs(got[0] - want[0]).max(initial=0.0) <= 1e-4 * extent
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_fused_cloud_matches_jax(root, runs, name):
    port_out, stats, _ = runs[name]
    got, want, n = _fuse_both(root, name, port_out)
    assert n == stats["points"][name]
    _assert_clouds_agree(root, name, port_out, got, want, n)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_ground_truth_cloud_matches_jax(root, runs, name, tmp_path):
    """The scan's true depths at EVAL_HW (confidence 1) in place of the
    estimates, with the port's cams and images: a non-empty cloud, test.py's."""
    port_out = runs[name][0]
    out = tmp_path / "gt"
    shutil.copytree(port_out / name, out / name)
    for v in _views(name):
        save_pfm(out / name / "depth_est" / f"{v:0>8}.pfm",
                 read_pfm(root / "gt_eval" / name / f"{v:0>8}.pfm")[0])
        np.save(out / name / "confidence" / f"{v:0>8}.npy", np.full(EVAL_HW, 255, np.uint8))
    got, want, n = _fuse_both(root, name, out)
    assert n > 0
    _assert_clouds_agree(root, name, out, got, want, n)
