"""The port's end-to-end accuracy protocol (tools/e2e_protocol.py in the
port, the counterpart of the repo's tools/e2e_protocol.py) on the CPU.

- GeometricScene.point_to_surface_distance and tnt_cameras against the
  JAX package's (the same scene from the same seed; distances rtol 1e-6,
  cameras exact), and make_geometric_eval_scan's `cameras=`.
- The torch nearest-neighbour completeness against scipy's cKDTree on a
  fixed cloud hundreds of mm from the origin (within 1e-5 mm), where
  float32 matrix-product distances would be off by far more.
- The renderer against the port's own warp at the ground-truth depth: a
  source view warped into the reference frustum reproduces the reference
  image (the JAX test_renderer_matches_framework_warp's gates).
- One CasMVSNet epoch of the tool at 128 x 192 (a train set cut to one
  reference view's 7 samples): the config the JAX tool writes, the results
  file's keys, the checkpoints, every filter's cloud scored; then the
  render record: a run at another resolution renders again.
- slow: the JAX test_e2e_protocol at its own scale and gates, through the
  port's command lines (the arch dicts are the port tool's)."""
import json

import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.data import synthetic as jsyn
from mvsformerplusplus_tpu_torch.data import synthetic as syn
from mvsformerplusplus_tpu_torch.data.io import read_cam_file, read_pfm
from mvsformerplusplus_tpu_torch.fusion.ply import read_ply
from mvsformerplusplus_tpu_torch.ops.geometry import compose_projection
from mvsformerplusplus_tpu_torch.ops.grid_sample import homography_warp
from mvsformerplusplus_tpu_torch.tools import e2e_protocol as e2e
from tools.e2e_protocol import CASMVS_ARCH as JAX_CASMVS_ARCH
from tools.e2e_protocol import FLAGSHIP_ARCH as JAX_FLAGSHIP_ARCH



def shrink(monkeypatch, h, w):
    """The tool's protocol cut to an h x w scene, 48 hypotheses and one
    crop of the whole view."""
    for name, value in (("H", h), ("W", w), ("DEPTHS", 48), ("CROPS", ((h, w),)),
                        ("MICRO", {str(h): 2})):
        monkeypatch.setattr(e2e, name, value)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arch_dicts_are_the_jax_tools():
    assert e2e.CASMVS_ARCH == JAX_CASMVS_ARCH
    assert e2e.FLAGSHIP_ARCH == JAX_FLAGSHIP_ARCH


def test_point_to_surface_distance_matches_jax():
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-900, 900, (2000, 3)) + [0, 0, 650],
                          rng.uniform(-300, 300, (2000, 3)) + [0, 0, 600]]).astype(np.float32)
    got = syn.GeometricScene(0, tex_res=16).point_to_surface_distance(pts)
    want = jsyn.GeometricScene(0, tex_res=16).point_to_surface_distance(pts)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # points on a quad lie on the surface
    p0, e1, e2, _ = syn.GeometricScene(0, tex_res=16).quads[2]
    on = p0 + rng.rand(50, 1) * e1 + rng.rand(50, 1) * e2
    assert syn.GeometricScene(0, tex_res=16).point_to_surface_distance(on).max() < 1e-3


@pytest.mark.parametrize("n,h,w", [(5, 128, 192), (11, 1088, 1920)])
def test_tnt_cameras_match_jax(n, h, w):
    for (k, e), (jk, je) in zip(syn.tnt_cameras(n, h, w), jsyn.tnt_cameras(n, h, w)):
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(e, je)


def test_eval_scan_takes_explicit_cameras(tmp_path):
    cams = syn.tnt_cameras(3, 64, 96)
    scene = syn.GeometricScene(1, tex_res=64)
    syn.make_geometric_eval_scan(tmp_path, n_views=3, h=64, w=96, ndepth=16, scene=scene,
                                 cameras=cams)
    for vid, (k, e) in enumerate(cams):
        got_k, got_e, *_ = read_cam_file(tmp_path / "scan1" / "cams" / f"{vid:0>8}_cam.txt")
        np.testing.assert_allclose(got_k, k, rtol=1e-6)
        np.testing.assert_allclose(got_e, e, rtol=1e-6, atol=1e-5)
        depth, _ = read_pfm(tmp_path / "gt_depths" / "scan1" / f"depth_map_{vid:0>4}.pfm")
        np.testing.assert_array_equal(depth, scene.render(k, e, 64, 96)[1])


def test_nearest_distance_matches_ckdtree():
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(1)
    cloud = (rng.uniform(-200, 200, (20000, 3)) + [30, -20, 650]).astype(np.float32)
    query = cloud[rng.randint(0, len(cloud), 3000)].astype(np.float64)
    query += rng.normal(0, 0.1, query.shape)  # 0.1 mm off the cloud, as fused points lie
    query = np.concatenate([query, rng.uniform(-250, 250, (500, 3)) + [0, 0, 650]])
    want = cKDTree(cloud).query(query, k=1)[0]
    got = e2e.nearest_distance(query, cloud, "cpu", q_chunk=700, p_chunk=5000)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a reach below most distances: every query searched again, the same answer
    np.testing.assert_allclose(e2e.nearest_distance(query, cloud, "cpu", q_chunk=300,
                                                    reach=0.01, p_chunk=3000),
                               want, atol=1e-5, rtol=0)
    # the float32 matrix-product form is what the protocol must not use
    mm = torch.cdist(torch.from_numpy(query[:3000]).float(), torch.from_numpy(cloud),
                     compute_mode="use_mm_for_euclid_dist").min(1).values.numpy()
    assert np.abs(mm - want[:3000]).max() > 1e-3


def test_renderer_matches_port_warp():
    h, w = 256, 320
    sc = syn.GeometricScene(0, tex_res=512)
    (k0, e0), (k1, e1) = syn.geometric_cameras(2, h, w)
    img0, d0 = sc.render(k0, e0, h, w)
    img1, _ = sc.render(k1, e1, h, w)

    def proj(k, e):
        cam = np.zeros((1, 2, 4, 4), np.float32)
        cam[0, 0], cam[0, 1, :3, :3] = e, k
        return compose_projection(torch.from_numpy(cam)[:, None])[:, 0]

    warped, invalid = homography_warp(torch.from_numpy(img1[None]), proj(k1, e1), proj(k0, e0),
                                      torch.from_numpy(d0[None, None]))
    ok = ~invalid.numpy()[0, 0]
    err = np.abs(warped.numpy()[0, 0] - img0)[ok]
    assert ok.mean() > 0.9
    assert err.mean() < 0.03, err.mean()


def test_one_casmvs_epoch_writes_every_result(tmp_path, monkeypatch):
    shrink(monkeypatch, 128, 192)
    scene = syn.GeometricScene(0, tex_res=256)
    _, tr, ev = e2e.build_data(tmp_path, scene)
    pairs = (tr / "Cameras" / "pair.txt").read_text().splitlines()
    (tr / "Cameras" / "pair.txt").write_text("\n".join(["1"] + pairs[1:3]) + "\n")
    res = e2e.run(tmp_path, models=("casmvs",), epochs=1, device="cpu", scene=scene,
                  tensorboard=True)
    cfg = json.loads((tmp_path / "casmvs" / "cfg.json").read_text())
    assert cfg["arch"]["args"] == e2e.CASMVS_ARCH
    assert cfg["trainer"]["remat_map"] == {"1024": "stage"} and cfg["trainer"]["epochs"] == 1
    assert (tmp_path / "casmvs" / "saved" / "checkpoints").is_dir()
    assert list((tmp_path / "casmvs" / "saved" / "tb").glob("events.out.tfevents.*"))
    on_disk = json.loads((tmp_path / "e2e_protocol_metrics.json").read_text())
    assert on_disk["casmvs"] == json.loads(json.dumps(res["casmvs"]))
    assert on_disk["render"]["h"] == 128 and "flagship" not in on_disk
    for fname, _ in e2e.FILTERS:
        entry = res["casmvs"][fname]
        for k in ("n_views", "abs_depth_error", "thres20mm_error", "thres8mm_error",
                  "mean_error", "n_points", "eval_seconds"):
            assert k in entry, (fname, k)
        assert np.isfinite(entry["abs_depth_error"])
        if entry["n_points"]:
            assert all(np.isfinite(entry[k]) for k in ("accuracy_mean_mm",
                                                       "completeness_median_mm"))
    # the cloud left is the last filter's own (each filter deleted the one before)
    ply = tmp_path / "casmvs" / "out" / "scan1.ply"
    n_last = len(read_ply(ply)[0]) if ply.exists() else 0
    assert res["casmvs"]["gipuma"]["n_points"] == n_last

    stamp = (tr / "train.txt").stat().st_mtime_ns
    e2e.build_data(tmp_path, scene)  # same resolution: nothing rendered
    assert (tr / "train.txt").stat().st_mtime_ns == stamp
    shrink(monkeypatch, 64, 128)
    e2e.build_data(tmp_path, scene)
    assert read_pfm(ev / "gt_depths" / "scan1" / "depth_map_0000.pfm")[0].shape == (64, 128)
    assert json.loads((tmp_path / "render.json").read_text())["h"] == 64


@pytest.mark.slow
@pytest.mark.parametrize("model_name", ["casmvs", "flagship"])
def test_e2e_protocol_at_the_jax_tests_scale(tmp_path, model_name):
    """tests/test_e2e_protocol.py's run and gates through the port: 256 x 320
    scenes, 3-view training at 128 x 192 for 12 epochs (fp32), then the
    eval CLI with pcd at 48 hypotheses."""
    from scipy.spatial import cKDTree

    from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
    from mvsformerplusplus_tpu_torch.train import cli as train_cli

    h, w = 256, 320
    scene = syn.GeometricScene(0, tex_res=1024)
    tr, ev = tmp_path / "train_data", tmp_path / "eval_data"
    syn.make_geometric_dtu(tr, n_views=5, n_lights=7, h=h, w=w, ndepth=32, scene=scene)
    syn.make_geometric_eval_scan(ev, n_views=5, h=h, w=w, ndepth=48, scene=scene)
    (tr / "val.txt").write_text("scan1\n")
    arch = {"casmvs": e2e.CASMVS_ARCH, "flagship": e2e.FLAGSHIP_ARCH}[model_name]
    # fp32 on the CPU, as every CPU test of the port trains (bf16 is the card's)
    cfg = {"arch": {"bf16": False, "args": arch}, "data_loader": [{"type": "DTULoader", "args": {
        "datapath": str(tr), "train_data_list": str(tr / "train.txt"), "mode": "train",
        "nviews": 3, "num_depths": 32, "interval_scale": 1.06, "batch_size": 2,
        "val_data_list": str(tr / "val.txt"), "height": 128, "width": 192,
        "random_crop": True, "augment": False, "num_workers": 2,
        "multi_scale_args": {"scales": [[128, 192]], "resize_range": [1.0, 1.0],
                             "scale_batch_map": {"128": 2}}}}],
        "optimizer": {"args": {"lr": 3e-3, "vit_lr": 3e-3, "warmup_steps": 10,
                               "min_lr": 0.05, "weight_decay": 0.01}},
        "trainer": {"epochs": 12, "save_dir": str(tmp_path / "saved"), "logging_every": 20,
                    "monitor": "min mean_error", "early_stop": 100}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    train_cli.main(["-c", str(tmp_path / "cfg.json"), "--save_dir", str(tmp_path / "saved"),
                    "--device", "cpu"])
    (tmp_path / "list.txt").write_text("scan1\n")
    out = tmp_path / "out"
    eval_cli.main(["--config", str(tmp_path / "cfg.json"),
                   "--ckpt", str(tmp_path / "saved" / "checkpoints"), "--testpath", str(ev),
                   "--testlist", str(tmp_path / "list.txt"), "--outdir", str(out),
                   "--gt_depth_path", str(ev / "gt_depths"), "--num_view", "5",
                   "--numdepth", "48", "--max_h", str(h), "--max_w", str(w),
                   "--filter_method", "pcd", "--conf", "0.3", "--fusion_view", "5",
                   "--device", "cpu"])
    metrics = e2e._depth_metrics(out / "depth_metric.txt")
    gates = {"casmvs": dict(abs=40.0, t20=0.40, t8=0.55, acc_mean=6.0, acc_med=4.0,
                            comp_med=6.0),
             "flagship": dict(abs=45.0, t20=0.45, t8=0.60, acc_mean=7.0, acc_med=5.0,
                              comp_med=8.0)}[model_name]
    assert metrics["abs_depth_error"] < gates["abs"], metrics
    assert metrics["thres20mm_error"] < gates["t20"], metrics
    assert metrics["thres8mm_error"] < gates["t8"], metrics
    pts, _ = read_ply(out / "scan1.ply")
    assert len(pts) > 10_000, len(pts)
    acc = scene.point_to_surface_distance(np.asarray(pts, np.float32))
    assert float(np.mean(acc)) < gates["acc_mean"]
    assert float(np.median(acc)) < gates["acc_med"]
    world = e2e.gt_surface_points(ev, step=7)
    comp = cKDTree(pts).query(world, k=1)[0]
    assert float(np.median(comp)) < gates["comp_med"]
