"""The port's training command line end to end on the CPU (--device cpu):
the tiny flagship on an 80 x 120 geometric DTU scan (one reference view,
7 lights), 64 x 96 and 64 x 64 crops, two epochs with validation, then -r
to a third epoch and --finetune from the run's checkpoints with the
schedule continued. Asserts the checkpoint files, a bit-equal restore of
model_last.pth, the resumed epoch, step and learning rate, and finite
losses and metrics; and that each flag of the JAX CLI that the port does
not have exits with an error naming its ROADMAP item."""
import json
import math

import pytest
import torch

from mvsformerplusplus_tpu_torch.config import Config, build_model
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_dtu
from mvsformerplusplus_tpu_torch.train import cli
from mvsformerplusplus_tpu_torch.train.optim import warmup_cosine
from tests.test_torch_flagship import TINY_ARCH_ARGS

WARMUP, MIN_LR, LR = 3, 0.01, 1e-3


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


@pytest.mark.parametrize("flags,item", [(["--mesh", "1,2"], "item 9"),
                                        (["--mesh", "2,1"], "item 9"),
                                        (["--distributed"], "item 9"),
                                        (["--coordinator", "h:1"], "item 9"),
                                        (["--num_processes", "2"], "item 9"),
                                        (["--process_id", "0"], "item 9"),
                                        (["--debug"], "item 8")])
def test_unported_flags_exit_naming_the_roadmap(tmp_path, capsys, flags, item):
    with pytest.raises(SystemExit):
        cli.main(["-c", str(tmp_path / "cfg.json"), "--device", "cpu"] + flags)
    assert f"ROADMAP.md §1 {item}" in capsys.readouterr().err


def test_blended_loader_exits_naming_the_roadmap(tmp_path, scan):
    cfg, _ = _config(tmp_path, scan)
    cfg["data_loader"][0]["type"] = "BlendedLoader"
    (tmp_path / "b.json").write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="ROADMAP.md §1 item 8"):
        cli.main(["-c", str(tmp_path / "b.json"), "--device", "cpu"])
