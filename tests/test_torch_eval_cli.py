"""The port's eval command line end to end on the CPU (--device cpu), its
fuse_scan against the JAX test.py's, its workers, and convert.load_npz.

- The tiny flagship on a 3-view 128 x 192 geometric scan (JPEG images, GT
  depths): the MVSNet output layout, each file's type and shape, the cams
  the dataset gave, the reference JPEG decoding as cv2.imwrite's would,
  depth_metric.txt with the JAX metric set; then --skip_depth with pcd and
  gipuma.
- fuse_scan against JAX's test.fuse_scan on the same written depth maps
  (the robust plane scene of test_torch_fusion.py): the ply files hold the
  same points (rtol 1e-5) and colours (exact), for each method.
- Workers on three copies of the scan: --world 2 strides the scans, two
  --schedule queue processes claim each once, --reclaim_stale takes over a
  planted stale claim; each gives the one-process run's depth maps and the
  per-worker depth metric files merged into depth_metric.txt.
- load_npz round-trips tools/convert_reference.save_npz of random flax
  variables into the state from_jax_variables gives, strictly.
- configs/casmvs.json's CasMVSNet at a tiny width: seeded weights with an
  existing vit_path (nothing loaded, one log line), and --ckpt of a
  checkpoints directory, whose depth maps are the loaded model's own
  forward on the dataset's samples."""
import importlib.util
import io
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.train.metrics import depth_metrics as jax_depth_metrics
from mvsformerplusplus_tpu_torch.config import Config, build_model
from mvsformerplusplus_tpu_torch.convert import load_npz
from mvsformerplusplus_tpu_torch.data.eval_dataset import EvalDataset
from mvsformerplusplus_tpu_torch.data.io import read_cam_file, read_pfm, save_cam_file, save_pfm
from mvsformerplusplus_tpu_torch.data.io import save_pair_file
from mvsformerplusplus_tpu_torch.data.jpeg import write_jpeg
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_eval_scan
from mvsformerplusplus_tpu_torch.eval import cli
from mvsformerplusplus_tpu_torch.fusion.ply import read_ply
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.testing import inverse_depth_bounds
from mvsformerplusplus_tpu_torch.train.checkpoints import CheckpointManager
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from tests.test_casmvs import make_inputs
from tests.test_torch_flagship import TINY, TINY_ARCH_ARGS
from tests.test_torch_fusion import _scene
from tests.torch_parity import init_flax, load_port
from tools.convert_reference import save_npz

REPO = Path(__file__).resolve().parents[1]
H, W = 128, 192


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    make_geometric_eval_scan(root, "scan1", n_views=3, h=H, w=W, ndepth=48,
                             scene=GeometricScene(seed=2, tex_res=128))
    (root / "list.txt").write_text("scan1\n")
    cfg = {"arch": {"args": {**TINY_ARCH_ARGS, "vit_depth": 3,
                             "vit_path": str(root / "none.npz")}}}
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


def _argv(root, out, *extra):
    return ["--config", str(root / "cfg.json"), "--testpath", str(root),
            "--testlist", str(root / "list.txt"), "--outdir", str(out), "--num_view", "3",
            "--numdepth", "48", "--max_h", str(H), "--max_w", str(W), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def run(scan, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    stats = cli.main(_argv(scan, out, "--gt_depth_path", str(scan / "gt_depths")))
    return out, stats


def test_eval_cli_writes_the_mvsnet_layout(scan, run):
    out, stats = run
    assert stats["maps"] == 3 and stats["decodes"] == 3 and stats["forward_ms"] == []
    ds = EvalDataset(str(scan), ["scan1"], nviews=3, ndepths=48, max_h=H, max_w=W)
    for i in range(3):
        sample = ds[i]
        ref = f"{sample['ref_view']:0>8}"
        depth = read_pfm(out / "scan1" / "depth_est" / f"{ref}.pfm")[0]
        dv = sample["depth_values"]
        assert depth.shape == (H, W) and np.isfinite(depth).all()
        lo, hi = inverse_depth_bounds(dv[0], dv[-1], TINY["ndepths"])
        assert (depth >= lo * (1 - 1e-5)).all() and (depth <= hi * (1 + 1e-5)).all()
        conf = np.load(out / "scan1" / "confidence" / f"{ref}.npy")
        assert conf.dtype == np.uint8 and conf.shape == (H, W)
        K, E, dmin, dint, _ = read_cam_file(out / "scan1" / "cams" / f"{ref}_cam.txt")
        cam = sample["cams"]["stage4"][0]
        np.testing.assert_allclose(K, cam[1, :3, :3], rtol=1e-6)
        np.testing.assert_allclose(E, cam[0], rtol=1e-6)
        assert np.isclose(dmin, dv[0]) and np.isclose(dint, dv[1] - dv[0])
        ok, ref_jpg = cv2.imencode(".jpg", sample["ref_img"][..., ::-1])
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / "scan1" / "images" / f"{ref}.jpg")),
            np.asarray(Image.open(io.BytesIO(ref_jpg.tobytes()))))
    lines = dict(ln.split(": ") for ln in (out / "depth_metric.txt").read_text().splitlines())
    z = np.zeros((1, 4, 4), np.float32)
    assert set(lines) == {"n_views"} | set(jax_depth_metrics(z, z, z > -1))
    assert lines["n_views"] == "3" and all(np.isfinite(float(v)) for v in lines.values())
    assert (out / "scan1.ply").exists() and stats["points"]["scan1"] >= 0


@pytest.mark.parametrize("method", ["pcd", "gipuma"])
def test_skip_depth_fuses_the_written_maps(scan, run, method):
    out, _ = run
    (out / "scan1.ply").unlink(missing_ok=True)
    stats = cli.main(_argv(scan, out, "--skip_depth", "--filter_method", method))
    assert "maps" not in stats and (out / "scan1.ply").exists()
    assert len(read_ply(out / "scan1.ply")[0]) == stats["points"]["scan1"]


def _jax_test_cli():
    """The repo's test.py as a module (a plain `import test` would find the
    standard library's test package)."""
    spec = importlib.util.spec_from_file_location("jax_eval_cli", REPO / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The robust plane scene written as an eval CLI's output: ref view 0
    twice in pair.txt (the second pass meets gipuma's used mask), sources
    1-4; confidence as uint8; colours from a JPEG per view."""
    root = tmp_path_factory.mktemp("fuse")
    s = _scene()
    depths = [s["ref_depth"], *s["src_depths"]]
    confs = [s["ref_conf"], *s["src_confs"]]
    cams = [s["ref_cam"], *s["src_cams"]]
    d = root / "out" / "scan1"
    for sub in ("depth_est", "confidence", "cams", "images"):
        (d / sub).mkdir(parents=True)
    rng = np.random.RandomState(4)
    for v in range(5):
        save_pfm(d / "depth_est" / f"{v:0>8}.pfm", depths[v])
        np.save(d / "confidence" / f"{v:0>8}.npy", np.round(confs[v] * 255).astype(np.uint8))
        save_cam_file(d / "cams" / f"{v:0>8}_cam.txt", cams[v][1, :3, :3], cams[v][0], 4.0, 0.1)
        write_jpeg(d / "images" / f"{v:0>8}.jpg",
                   (rng.rand(*depths[v].shape, 3) * 255).astype(np.uint8))
    (root / "scan1").mkdir()
    save_pair_file(root / "scan1" / "pair.txt", [(0, [(s_, 1.0) for s_ in (1, 2, 3, 4)]),
                                                 (0, [(s_, 1.0) for s_ in (4, 3, 2, 1)])])
    return root


@pytest.mark.parametrize("method", ["dpcd", "pcd", "gipuma"])
def test_fuse_scan_ply_matches_jax(written, method):
    args = cli.parser().parse_args(
        ["--config", "unused", "--testpath", str(written), "--testlist", "unused",
         "--outdir", str(written / "out"), "--filter_method", method, "--thres_view", "3",
         "--device", "cpu"])
    n = cli.fuse_scan(args, "scan1", torch.device("cpu"))
    got = read_ply(written / "out" / "scan1.ply")
    _jax_test_cli().fuse_scan(args, "scan1")
    want = read_ply(written / "out" / "scan1.ply")
    assert n == len(want[0]) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def scans(scan):
    """scan1 (with its ground truth) copied as scan2 and scan3, and the
    one-process run over the three (no fusion)."""
    for name in ("scan2", "scan3"):
        for d in (scan, scan / "gt_depths"):
            if not (d / name).exists():
                shutil.copytree(d / "scan1", d / name)
    (scan / "list3.txt").write_text("scan1\nscan2\nscan3\n")
    out = scan / "one_process"
    cli.main(_argv(scan, out, "--filter_method", "none") + ["--testlist", str(scan / "list3.txt")])
    return scan, out


def _depths(out, scan):
    return {p.name: read_pfm(p)[0] for p in sorted((out / scan / "depth_est").glob("*.pfm"))}


def _assert_same_depths(out, want_out, names):
    for name in names:
        got, want = _depths(out, name), _depths(want_out, name)
        assert len(want) == 3 and got.keys() == want.keys(), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")


def test_world_2_strides_the_scans(scans, tmp_path):
    """--world 2: rank 0 takes scan1 and scan3, rank 1 scan2 (test.py's
    all_scans[rank::world]), each writes depth_metric.rank{r}.txt and
    leaves depth_metric.txt merged over both, fuses its own scans, and the
    depth maps are the one-process run's."""
    root, want_out = scans
    gt = ["--gt_depth_path", str(root / "gt_depths"), "--testlist", str(root / "list3.txt")]
    done = {}
    for rank in (0, 1):
        stats = cli.main(_argv(root, tmp_path, "--world", "2", "--rank", str(rank), *gt))
        done[rank] = sorted(stats["points"])
        lines = dict(ln.split(": ") for ln in
                     (tmp_path / f"depth_metric.rank{rank}.txt").read_text().splitlines())
        assert lines["n_views"] == str(3 * len(done[rank]))
    assert done == {0: ["scan1", "scan3"], 1: ["scan2"]}
    assert sorted(p.name for p in tmp_path.glob("*.ply")) == ["scan1.ply", "scan2.ply",
                                                               "scan3.ply"]
    merged = dict(ln.split(": ") for ln in (tmp_path / "depth_metric.txt").read_text().splitlines())
    assert merged["n_views"] == "9"
    _assert_same_depths(tmp_path, want_out, ["scan1", "scan2", "scan3"])


def test_queue_workers_cover_every_scan_once(scans, tmp_path):
    """Two --schedule queue processes on the three scans: each scan claimed
    once (one g0 claim file, no later generation) and done, every depth map
    the one-process run's, one depth_metric.pid{pid}.txt per worker that did
    a scan, merged into depth_metric.txt."""
    root, want_out = scans
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    argv = [sys.executable, "-m", "mvsformerplusplus_tpu_torch.eval"] + _argv(
        root, tmp_path, "--schedule", "queue", "--filter_method", "none", "--gt_depth_path",
        str(root / "gt_depths"), "--testlist", str(root / "list3.txt"))
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    claims = sorted(p.name for p in (tmp_path / ".claims").iterdir())
    assert claims == sorted(f"scan{i}.{x}" for i in (1, 2, 3) for x in ("claim.g0", "done"))
    owners = {(tmp_path / ".claims" / f"scan{i}.claim.g0").read_text() for i in (1, 2, 3)}
    parts = sorted(p.name for p in tmp_path.glob("depth_metric.pid*.txt"))
    assert parts == sorted(f"depth_metric.{o}.txt" for o in owners)
    merged = dict(ln.split(": ") for ln in (tmp_path / "depth_metric.txt").read_text().splitlines())
    assert merged["n_views"] == "9"
    _assert_same_depths(tmp_path, want_out, ["scan1", "scan2", "scan3"])


def test_reclaim_stale_takes_a_planted_claim(scans, tmp_path):
    """A g0 claim on scan1 whose owner went silent an hour ago and never
    marked it done: --reclaim_stale 60 takes it as g1 and finishes the
    scan; without --reclaim_stale a worker leaves it alone."""
    root, want_out = scans
    (root / "list1.txt").write_text("scan1\n")
    claims = tmp_path / ".claims"
    claims.mkdir()
    planted = claims / "scan1.claim.g0"
    planted.write_text("pid1")
    os.utime(planted, (planted.stat().st_atime - 3600, planted.stat().st_mtime - 3600))
    argv = _argv(root, tmp_path, "--schedule", "queue", "--filter_method", "none",
                 "--testlist", str(root / "list1.txt"))
    assert cli.main(argv)["maps"] == 0 and not (claims / "scan1.done").exists()
    stats = cli.main(argv + ["--reclaim_stale", "60"])
    assert stats["maps"] == 3
    assert (claims / "scan1.claim.g1").read_text() == f"pid{os.getpid()}"
    assert (claims / "scan1.done").exists() and planted.read_text() == "pid1"
    _assert_same_depths(tmp_path, want_out, ["scan1"])


def test_window_check_logs_one_line(scan, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="mvsformerplusplus_tpu_torch"):
        cli.main(_argv(scan, tmp_path, "--filter_method", "none"))
    assert sum("--window_check" in r.getMessage() for r in caplog.records) == 1
    assert not (tmp_path / "scan1.ply").exists()


def test_eval_cli_needs_the_card_unless_told_cpu(scan, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(scan, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


@pytest.fixture(scope="module")
def flax_npz(tmp_path_factory):
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    variables = init_flax(JaxFlagship(**TINY, remat_stages=False), imgs, cams, dv, train=False)
    path = tmp_path_factory.mktemp("npz") / "ckpt.npz"
    save_npz(variables["params"], variables["batch_stats"], path)
    return variables, path


def test_load_npz_matches_from_jax_variables(flax_npz):
    variables, path = flax_npz
    want = load_port(DINOv2MVSNet(**TINY), variables).state_dict()
    model = DINOv2MVSNet(**TINY)
    assert load_npz(path, model) == len(want)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_load_npz_is_strict(flax_npz, tmp_path):
    _, path = flax_npz
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    key = "params:encoder/ConvBlock_0/Conv_0/kernel"
    assert key in flat
    np.savez(tmp_path / "extra.npz", **flat, **{"params:nowhere/kernel": np.zeros((3, 3))})
    with pytest.raises(KeyError, match="nowhere"):
        load_npz(tmp_path / "extra.npz", DINOv2MVSNet(**TINY))
    np.savez(tmp_path / "shape.npz", **{**flat, key: flat[key][..., :1]})
    with pytest.raises(ValueError, match="shape"):
        load_npz(tmp_path / "shape.npz", DINOv2MVSNet(**TINY))
    partial = {k: v for k, v in flat.items() if k != key}
    np.savez(tmp_path / "partial.npz", **partial)
    model = DINOv2MVSNet(**TINY)
    before = model.state_dict()["encoder.ConvBlock_0.Conv_0.weight"].clone()
    assert load_npz(tmp_path / "partial.npz", model) == len(partial) + sum(
        k.startswith("batch_stats:") and k.endswith("/mean") for k in partial)
    torch.testing.assert_close(model.state_dict()["encoder.ConvBlock_0.Conv_0.weight"], before)


@pytest.fixture(scope="module")
def casmvs(tmp_path_factory):
    """configs/casmvs.json at a tiny width, its vit_path an existing file
    that is no ViT, and a checkpoints directory of the model (as the
    training command line writes it)."""
    root = tmp_path_factory.mktemp("casmvs")
    cfg = json.loads((REPO / "configs" / "casmvs.json").read_text())
    cfg["arch"]["args"].update(feat_chs=[4, 8, 16, 32], ndepths=[8, 4, 4, 4],
                               base_ch=[4, 4, 4, 4], vit_path=str(root / "vit.npz"))
    (root / "vit.npz").write_bytes(b"not a ViT")
    (root / "cfg.json").write_text(json.dumps(cfg))
    model = build_model(Config(cfg), dtype=torch.float32, device="cpu", seed=3, train=True)
    opt, sched = make_optimizer(model)
    CheckpointManager(root / "checkpoints").save(0, model, opt, sched, 0, config=cfg,
                                                 monitor_value=1.0)
    return root, cfg


def _casmvs_argv(scan, root, out, *extra):
    argv = _argv(scan, out, *extra)
    argv[argv.index("--config") + 1] = str(root / "cfg.json")
    return argv


def test_casmvs_eval_cli_loads_no_vit(scan, casmvs, tmp_path, caplog):
    root, _ = casmvs
    with caplog.at_level(logging.INFO, logger="mvsformerplusplus_tpu_torch"):
        stats = cli.main(_casmvs_argv(scan, root, tmp_path))
    assert sum("CasMVSNet has no ViT: nothing loaded" in r.getMessage()
               for r in caplog.records) == 1
    assert stats["maps"] == 3 and stats["points"]["scan1"] >= 0
    assert (tmp_path / "scan1.ply").exists()
    for v in range(3):
        depth = read_pfm(tmp_path / "scan1" / "depth_est" / f"{v:0>8}.pfm")[0]
        assert depth.shape == (H, W) and np.isfinite(depth).all()


def test_casmvs_eval_cli_depth_is_the_checkpoint_forward(scan, casmvs, tmp_path):
    """--ckpt: each written depth map is the checkpoint's model (bf16, as
    the CLI builds it) on the dataset's sample, exactly."""
    root, cfg = casmvs
    stats = cli.main(_casmvs_argv(scan, root, tmp_path, "--ckpt", str(root / "checkpoints"),
                                  "--filter_method", "none"))
    assert stats["maps"] == 3
    model = build_model(Config(cfg), dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(CheckpointManager(root / "checkpoints").load(0)["state_dict"])
    ds = EvalDataset(str(scan), ["scan1"], nviews=3, ndepths=48, max_h=H, max_w=W)
    with torch.inference_mode():
        for i in range(3):
            sample = ds[i]
            out = model(torch.from_numpy(sample["imgs"])[None],
                        {k: torch.from_numpy(c)[None] for k, c in sample["cams"].items()},
                        torch.from_numpy(sample["depth_values"])[None])
            got = read_pfm(tmp_path / "scan1" / "depth_est" / f"{sample['ref_view']:0>8}.pfm")[0]
            np.testing.assert_array_equal(got, out["refined_depth"][0].float().numpy())
