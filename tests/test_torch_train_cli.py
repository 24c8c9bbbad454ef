"""The port's training command line end to end on the CPU (--device cpu):
the tiny flagship on an 80 x 120 geometric DTU scan (one reference view,
7 lights), 64 x 96 and 64 x 64 crops, two epochs with validation, then -r
to a third epoch and --finetune from the run's checkpoints with the
schedule continued. Asserts the checkpoint files, a bit-equal restore of
model_last.pth, the resumed epoch, step and learning rate, finite losses
and metrics, and scalars.jsonl and the panels; --debug's per-module
gradient norms; a BlendedLoader config (BlendedTrainDataset, the
"blended" interval scale, validation with the Blended class); a tiny
CasMVSNet through configs/casmvs.json's settings (no ViT to load); and
the JAX CLI's distribution flags: --mesh 2,1 and --mesh 1,2 on CPU ranks
and two --distributed processes train to the one-rank run's checkpoint,
and a layout that cannot split the batch or the source views exits with
its message."""
import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mvsformerplusplus_tpu_torch.config import Config, build_model
from mvsformerplusplus_tpu_torch.data.io import read_png
from mvsformerplusplus_tpu_torch.data.mvs_dataset import BlendedTrainDataset
from mvsformerplusplus_tpu_torch.data.synthetic import (GeometricScene, make_blended_scan,
                                                        make_geometric_dtu)
from mvsformerplusplus_tpu_torch.models.casmvs import CasMVSNet
from mvsformerplusplus_tpu_torch.parallel.dist import free_port
from mvsformerplusplus_tpu_torch.train import cli
from mvsformerplusplus_tpu_torch.train.optim import warmup_cosine
from tests.test_torch_flagship import TINY_ARCH_ARGS

WARMUP, MIN_LR, LR = 3, 0.01, 1e-3
REPO = Path(__file__).resolve().parents[1]


def _config(tmp_path, data):
    cfg = {
        "arch": {"bf16": False, "loss": {"clip_func": "dynamic"},
                 "args": {**TINY_ARCH_ARGS, "vit_depth": 3,
                          "vit_path": str(tmp_path / "none.npz")}},
        "data_loader": [{"type": "DTULoader", "args": {
            "datapath": str(data), "train_data_list": str(data / "train.txt"),
            "val_data_list": str(data / "train.txt"), "nviews": 3, "num_depths": 48,
            "batch_size": 2, "num_workers": 2, "height": 64, "width": 96,
            "aug_args": {"brightness": 0.2, "contrast": 0.1, "saturation": 0.1, "hue": 0.05},
            "multi_scale_args": {"scales": [[64, 96], [64, 64]], "resize_range": [1.0, 1.2],
                                 "scale_batch_map": {"64": 1}}}}],
        "optimizer": {"args": {"lr": LR, "warmup_steps": WARMUP, "min_lr": MIN_LR}},
        "trainer": {"epochs": 2, "logging_every": 1, "monitor": "min mean_error",
                    "early_stop": 10, "remat_map": {"64": "stage"}},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return cfg, path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the CLI runs many small CPU ops, and with several
    test workers on the machine more threads only oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    make_geometric_dtu(root, n_views=3, n_lights=7, h=80, w=120, ndepth=48,
                       scene=GeometricScene(seed=2, tex_res=128))
    # one reference view (view 0 and its two sources): 7 samples, one per light
    pairs = (root / "Cameras" / "pair.txt").read_text().splitlines()
    (root / "Cameras" / "pair.txt").write_text("\n".join(["1"] + pairs[1:3]) + "\n")
    return root


def _scalars(save):
    return [json.loads(ln) for ln in (save / "scalars.jsonl").read_text().splitlines()]


def _finite(entries):
    return all(math.isfinite(e[k]) for e in entries for k in e
               if k in ("loss", "grad_norm") or k.startswith("stage"))


def test_train_resume_finetune(tmp_path, scan):
    cfg, path = _config(tmp_path, scan)
    save = tmp_path / "saved"
    base = ["-c", str(path), "--device", "cpu", "--save_dir", str(save)]
    t1 = cli.main(base)
    spe = t1.train_loader.steps_per_epoch()
    assert spe == 7 // 2 and t1.global_step == 2 * spe
    assert [e["step"] for e in t1.logged] == list(range(1, 2 * spe + 1))
    assert _finite(t1.logged) and all(e["micro"] == 2 for e in t1.logged)
    assert [s["epoch"] for s in t1.epoch_stats] == [0, 1]
    # remat_map {"64": "stage"}: every crop here is 64 high
    assert t1.model.cascade.remat_whole_stage and not t1.model.cascade.stage1.remat_cost_reg
    assert sum(b["steps"] for s in t1.epoch_stats for b in s["buckets"].values()) == 2 * spe
    assert [v["maps"] for v in t1.val_stats] == [7, 7]
    assert all(math.isfinite(x) for v in t1.val_stats for x in v["metrics"].values())
    assert {"mean_error", "thres2mm_error", "abs_depth_error"} <= set(t1.val_stats[0]["metrics"])
    ck = save / "checkpoints"
    names = {p.name for p in ck.iterdir()}
    assert {"checkpoint-epoch0.pth", "checkpoint-epoch1.pth", "model_last.pth", "model_best.pth",
            "meta.json", "config.json"} <= names, names
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["last_epoch"] == 1 and meta["mode"] == "min" and not meta["interrupted"]
    assert meta["monitor_best"] == min(v["metrics"]["mean_error"] for v in t1.val_stats)
    payload = torch.load(ck / "model_last.pth", weights_only=True)
    assert {"arch", "epoch", "step", "state_dict", "optimizer", "scheduler", "monitor_best",
            "config"} <= set(payload) and (payload["epoch"], payload["step"]) == (1, 2 * spe)
    fresh = build_model(Config(cfg), dtype=torch.float32, device="cpu", train=True)
    fresh.load_state_dict(payload["state_dict"])
    for k, v in t1.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    # -r with a third epoch: starts at epoch 2, step 2 * spe, on the 3-epoch schedule
    t2 = cli.main(base + ["-r", "--epochs", "3"])
    assert [s["epoch"] for s in t2.epoch_stats] == [2]
    assert t2.logged[0]["step"] == 2 * spe + 1 and t2.global_step == 3 * spe
    want_lr = LR * warmup_cosine(2 * spe, WARMUP, 3 * spe, MIN_LR)
    assert t2.logged[0]["lr"] == pytest.approx(want_lr, rel=1e-12)
    assert _finite(t2.logged)
    assert json.loads((ck / "meta.json").read_text())["last_epoch"] == 2

    # --finetune from the run (reset_sche false): the best epoch's weights
    # and its schedule step, on the new run's one-epoch schedule
    cfg["arch"].update(reset_sche=False, dtu_model_path=str(ck))
    (tmp_path / "ft.json").write_text(json.dumps(cfg))
    best = json.loads((ck / "meta.json").read_text())["best_epoch"]
    best_step = (best + 1) * spe
    t3 = cli.main(["-c", str(tmp_path / "ft.json"), "--device", "cpu", "--finetune",
                   "--save_dir", str(tmp_path / "ft"), "--epochs", "1"])
    assert t3.logged[0]["step"] == 1 and t3.scheduler.last_epoch == best_step + spe
    assert t3.logged[0]["lr"] == pytest.approx(LR * warmup_cosine(best_step, WARMUP, spe, MIN_LR),
                                               rel=1e-12)
    assert (tmp_path / "ft" / "checkpoints" / "model_last.pth").exists()

    # scalars.jsonl across the first two runs: every logged step, then each
    # validation at the epoch's last step; the panels at each of those steps
    recs = _scalars(save)
    assert [(r["mode"], r["step"]) for r in recs] == [
        ("train", s) for s in range(1, spe + 1)] + [("val", spe)] + [
        ("train", s) for s in range(spe + 1, 2 * spe + 1)] + [("val", 2 * spe)] + [
        ("train", s) for s in range(2 * spe + 1, 3 * spe + 1)] + [("val", 3 * spe)]
    first = t1.logged[0]
    assert recs[0] == {"time": recs[0]["time"], "mode": "train", "step": 1,
                       **{k: v for k, v in first.items()
                          if k in ("loss", "grad_norm") or k.startswith("stage")}}
    assert recs[spe]["mean_error"] == t1.val_stats[0]["metrics"]["mean_error"]
    names = sorted(p.name for p in (save / "images").iterdir())
    assert names == sorted([f"train_step{s:08d}.png" for s in range(1, 3 * spe + 1)]
                           + [f"val_step{s:08d}.png" for s in (spe, 2 * spe, 3 * spe)])
    # two micro-batches a step: gt, depth and error of the last one's sample
    # 0, no confidence (as the JAX accumulated step); validation adds it
    for name in names[:-3]:
        assert read_png(save / "images" / name).shape in ((64, 3 * 64, 3), (64, 3 * 96, 3))
    assert read_png(save / "images" / f"val_step{spe:08d}.png").shape == (64, 4 * 96, 3)


def test_debug_logs_per_module_gradient_norms(tmp_path, scan, caplog):
    """--debug: each logged step's per-module gradient norms, finite, in
    the log and in scalars.jsonl ("debug", with the step's "train" record),
    the frozen ViT's 0; one log line says the port has no warp-window
    check; no non-finite warning."""
    _, path = _config(tmp_path, scan)
    save = tmp_path / "saved"
    with caplog.at_level(logging.INFO, logger="mvsformerplusplus_tpu_torch"):
        t = cli.main(["-c", str(path), "--device", "cpu", "--save_dir", str(save), "--epochs",
                      "1", "--debug"])
    assert t.debug and sum("no warp-window check" in r.message for r in caplog.records) == 1
    assert not any("NON-FINITE" in r.message for r in caplog.records)
    recs = _scalars(save)
    debug = [r for r in recs if r["mode"] == "debug"]
    assert [r["step"] for r in debug] == [r["step"] for r in recs if r["mode"] == "train"] \
        == [e["step"] for e in t.logged] and len(debug) == t.global_step
    for r in debug:
        assert set(r) == {"time", "mode", "step", "encoder", "decoder", "vit", "decoder_vit",
                          "fmt", "cascade"}
        assert r["vit"] == 0 and all(math.isfinite(r[k]) and r[k] > 0 for k in
                                     ("encoder", "decoder", "decoder_vit", "fmt", "cascade"))
    for e, r in zip(t.logged, debug):  # the returned entries hold the counts too
        assert {k: e[f"gnorm/{k}"] for k in r if k not in ("time", "mode", "step")} == \
            {k: v for k, v in r.items() if k not in ("time", "mode", "step")}
        assert [e[f"nonfinite/{k}"] for k in ("encoder", "decoder", "vit", "decoder_vit", "fmt",
                                              "cascade")] == [0] * 6


def test_log_var_config_logs_the_uncertainty_terms(tmp_path, scan):
    """A config with the log_var head and reg depth at its log_var stages
    (3-4) trains through the command line unchanged: the
    stage3_uncertainty and stage4_uncertainty terms, finite, in every
    logged step and in scalars.jsonl's train records, under the JAX
    Trainer's names."""
    cfg, _ = _config(tmp_path, scan)
    cfg["arch"]["args"].update(log_var=True, depth_type=["ce", "ce", "reg", "reg"])
    path = tmp_path / "log_var.json"
    path.write_text(json.dumps(cfg))
    save = tmp_path / "saved"
    t = cli.main(["-c", str(path), "--device", "cpu", "--save_dir", str(save), "--epochs", "1"])
    assert [s.log_var for s in (t.model.cascade.stage3, t.model.cascade.stage4)] == [True, True]
    want = {"stage3_uncertainty", "stage4_uncertainty"}
    assert t.logged and all(want <= set(e) for e in t.logged) and _finite(t.logged)
    train = [r for r in _scalars(save) if r["mode"] == "train"]
    assert len(train) == len(t.logged) and all(want <= set(r) for r in train)


def _one_epoch(tmp_path, scan, name, *flags):
    """One epoch of the tiny config at batch 2 without micro-batches (a
    micro-batch of 1 clamps up to one sample per data rank, so --mesh 2,1
    would step on the whole batch where one rank steps twice)."""
    _, path = _config(tmp_path, scan)
    save = tmp_path / name
    out = cli.main(["-c", str(path), "--device", "cpu", "--save_dir", str(save), "--epochs", "1",
                    "-o", "data_loader;0;args;multi_scale_args;scale_batch_map={}", *flags])
    return out, save


def _checkpoint(save):
    return torch.load(save / "checkpoints" / "model_last.pth", weights_only=True)


def _assert_same_state(got, want, steps):
    """Parameters within what AdamW makes of rounding-level gradient
    differences: an entry whose gradient is near 0 (a bias before a
    BatchNorm) may move up to 2 lr a step the other way. Running statistics
    within 2e-3 of each tensor's largest entry: after the first step they
    are taken through weights that moved apart so."""
    for k, w in want.items():
        g = got[k]
        if not w.dtype.is_floating_point:
            assert torch.equal(g, w), k
        elif "running" in k:
            assert (g - w).abs().max() <= 2e-3 * w.abs().max() + 1e-5, k
        else:
            assert (g - w).abs().max() <= 2 * LR * steps + 1e-5, k


def _assert_same_training(save, want_save, steps):
    """The same checkpoint as the one-rank run's (_assert_same_state), the
    first step's losses at rtol 1e-4 and the later steps' (on weights that
    moved apart as _assert_same_state allows) at 1e-3, and scalars.jsonl
    written once."""
    got, want = _checkpoint(save), _checkpoint(want_save)
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"]) == (0, steps)
    _assert_same_state(got["state_dict"], want["state_dict"], steps)
    recs, want_recs = _scalars(save), _scalars(want_save)
    assert [(r["mode"], r["step"]) for r in recs] == [(r["mode"], r["step"]) for r in want_recs]
    for r, w in zip(recs, want_recs):
        if r["mode"] == "train":
            for k in w:
                if k == "loss" or k.startswith("stage"):
                    rel = 1e-4 if r["step"] == 1 else 1e-3
                    assert r[k] == pytest.approx(w[k], rel=rel), (r["step"], k)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory, scan):
    return _one_epoch(tmp_path_factory.mktemp("mesh11"), scan, "saved", "--mesh", "1,1")


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_mesh_trains_to_the_one_rank_checkpoint(tmp_path, scan, one_rank, mesh):
    """--mesh 2,1 (a sample per rank) and --mesh 1,2 (a source view per
    rank) train the tiny config to the checkpoint of --mesh 1,1, with one
    scalars.jsonl; the ranks return their summaries: the same logged
    losses, and the same validation metrics on both ranks (7 batches split
    4 + 3 over the data ranks under 2,1), near the one-rank run's (rtol
    1e-2: the bucketed error metrics of weights that moved apart by up to
    2 lr a step where a gradient is near 0)."""
    t, want_save = one_rank
    ranks, save = _one_epoch(tmp_path, scan, "saved", "--mesh", mesh)
    assert [r["rank"] for r in ranks] == [0, 1] and all(r["global_step"] == 3 for r in ranks)
    _assert_same_training(save, want_save, 3)
    assert ranks[0]["logged"] == ranks[1]["logged"]
    maps = [r["val_stats"][0]["maps"] for r in ranks]
    assert maps == ([4, 3] if mesh == "2,1" else [7, 7])
    assert ranks[0]["val_stats"][0]["metrics"] == ranks[1]["val_stats"][0]["metrics"]
    for k, v in t.val_stats[0]["metrics"].items():
        assert ranks[0]["val_stats"][0]["metrics"][k] == pytest.approx(v, rel=1e-2), k
    assert not (save / "images").exists() or len(list((save / "images").iterdir())) == len(
        list((want_save / "images").iterdir()))


def test_distributed_processes_train_as_one(tmp_path, scan):
    """Two --distributed processes (one rank each, rendezvous at
    --coordinator) train the tiny config at 2 samples per process to the
    checkpoint of one process with --mesh 2,1 and a batch of 4."""
    _, want_save = _one_epoch(tmp_path, scan, "one", "--mesh", "2,1", "--batch_size", "4")
    _, path = _config(tmp_path, scan)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mvsformerplusplus_tpu_torch.train", "-c", str(path), "--device",
         "cpu", "--save_dir", str(tmp_path / "two"), "--epochs", "1", "-o",
         "data_loader;0;args;multi_scale_args;scale_batch_map={}", "-o",
         "data_loader;0;args;val_data_list=none", "--distributed", "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "process 1 of 2: 1 cpu rank(s) over gloo" in outs[1]
    got, want = _checkpoint(tmp_path / "two"), _checkpoint(want_save)
    assert got["step"] == want["step"] == 1
    _assert_same_state(got["state_dict"], want["state_dict"], 1)


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "3,1"], "the batch of 2 per process does not split over 3 data ranks"),
    (["--mesh", "1,3"], "2 source views do not split over 3 cv ranks"),
    (["--mesh", "2"], "give the two sizes n_data,n_cv"),
    (["--distributed"], "--distributed needs --coordinator, --num_processes and --process_id"),
    (["--distributed", "--coordinator", "h:1", "--num_processes", "2", "--process_id", "0",
      "--mesh", "1,1"], "1 ranks cannot split over 2 processes")])
def test_layout_that_cannot_split_exits(tmp_path, scan, capsys, flags, message):
    _, path = _config(tmp_path, scan)
    with pytest.raises(SystemExit):
        cli.main(["-c", str(path), "--device", "cpu"] + flags)
    assert message in capsys.readouterr().err


def test_blended_loader_trains_and_validates(tmp_path):
    """A BlendedLoader config (the fine-tune's interval_scale 1.0, its
    96 x 128 views validated whole): BlendedTrainDataset for training and
    validation, metrics on the "blended" interval scale, --debug, the
    scalars' train, val and debug records and both panels."""
    data = tmp_path / "blended"
    make_blended_scan(data, "5a3ca9cb", n_views=5, h=96, w=128, ndepth=48,
                      scene=GeometricScene(seed=3, tex_res=128))
    cfg, _ = _config(tmp_path, data)
    a = cfg["data_loader"][0]["args"]
    cfg["data_loader"][0]["type"] = "BlendedLoader"
    a.update(interval_scale=1.0, height=96, width=128, batch_size=2,
             multi_scale_args={"scales": [[64, 96]], "resize_range": [1.0, 1.2],
                               "scale_batch_map": {"64": 2}})
    (tmp_path / "b.json").write_text(json.dumps(cfg))
    save = tmp_path / "saved"
    t = cli.main(["-c", str(tmp_path / "b.json"), "--device", "cpu", "--save_dir", str(save),
                  "--epochs", "1", "--debug"])
    assert t.interval_norm == "blended"
    assert isinstance(t.train_loader.dataset, BlendedTrainDataset)
    assert isinstance(t.val_loader.dataset, BlendedTrainDataset)
    assert t.global_step == 2 and [v["maps"] for v in t.val_stats] == [5]
    assert _finite(t.logged) and all(math.isfinite(x) for x in t.val_stats[0]["metrics"].values())
    assert sorted({r["mode"] for r in _scalars(save)}) == ["debug", "train", "val"]
    assert {p.name for p in (save / "images").iterdir()} == {
        "train_step00000001.png", "train_step00000002.png", "val_step00000002.png"}
    assert read_png(save / "images" / "val_step00000002.png").shape == (96, 4 * 128, 3)


def test_casmvs_trains_without_a_vit(tmp_path, scan, caplog):
    """configs/casmvs.json's arch.args at a tiny width: CasMVSNet, one
    optimizer group, nothing loaded from an existing vit_path (one log line
    says the model has none), checkpoints that restore into a fresh
    build_model."""
    cfg, _ = _config(tmp_path, scan)
    (tmp_path / "vit.npz").write_bytes(b"not a ViT")
    cfg["arch"]["args"] = {**json.loads((REPO / "configs" / "casmvs.json").read_text())["arch"][
        "args"], "feat_chs": [4, 8, 16, 32], "ndepths": [8, 4, 4, 4], "base_ch": [4, 4, 4, 4],
        "vit_path": str(tmp_path / "vit.npz")}
    # a 3D U-Net at stage 1 halves H/8 and W/8 three times: crops of 64s
    a = cfg["data_loader"][0]["args"]
    a.update(width=64, multi_scale_args={**a["multi_scale_args"], "scales": [[64, 64]]})
    path = tmp_path / "cas.json"
    path.write_text(json.dumps(cfg))
    save = tmp_path / "saved"
    with caplog.at_level(logging.INFO, logger="mvsformerplusplus_tpu_torch"):
        t = cli.main(["-c", str(path), "--device", "cpu", "--save_dir", str(save),
                      "--epochs", "1"])
    assert isinstance(t.model, CasMVSNet) and len(t.optimizer.param_groups) == 1
    assert sum("CasMVSNet has no ViT: nothing loaded" in r.message for r in caplog.records) == 1
    assert _finite(t.logged) and t.global_step == 3 and [v["maps"] for v in t.val_stats] == [7]
    payload = torch.load(save / "checkpoints" / "model_last.pth", weights_only=True)
    fresh = build_model(Config(cfg), dtype=torch.float32, device="cpu", train=True)
    fresh.load_state_dict(payload["state_dict"])
