"""convert.load_vit_pth: the original DINOv2 torch checkpoint (reference key
names, 'blocks.N.attn.qkv.weight', 'ls1.gamma', 'mlp.fc1.weight', ...) as
arch.args.vit_path.

- A seeded .pth of the tiny flagship's ViT loads through the JAX tool's
  convert_state_dict + unflatten + merge_vit_params and through
  load_vit_pth: the interval taps agree (fp32, 2e-4, as
  test_torch_vit_load.py), and no other weight of the port model moves.
- The {'model': ...} wrapper loads the same tensors.
- The .pth and the .npz convert_state_dict writes from it load bit-equal
  tensors; the block count is the model's, not the converter's fixed 12.
- Both command lines take a .pth vit_path: the eval CLI's seeded-weights
  loader (which handed every file to load_vit_npz and raised ValueError on a
  .pth) and the training CLI (which exited for anything but .npz), each
  bit-equal to the .npz load."""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.models import dino as jdino
from mvsformerplusplus_tpu_torch.config import Config, init_weights
from mvsformerplusplus_tpu_torch.convert import load_vit, load_vit_npz, load_vit_pth
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_dtu
from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.train import cli as train_cli
from tests.test_torch_flagship import TINY, TINY_ARCH_ARGS
from tests.torch_parity import assert_close, init_flax, t
from tools.convert_dinov2 import convert_state_dict, merge_vit_params, unflatten

X = np.random.RandomState(3).rand(2, 28, 42, 3).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vit():
    return jdino.DinoVisionTransformer(embed_dim=TINY["vit_ch"], depth=TINY["vit_depth"],
                                       num_heads=TINY["vit_num_heads"])


def _reference_state_dict(params) -> dict:
    """The flax ViT tree written back under the reference DINOv2 key names
    and layouts (the inverse of convert_state_dict), as torch tensors."""
    def a(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {"patch_embed.proj.weight": a(np.asarray(params["patch_embed"]["kernel"])
                                       .transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": a(params["patch_embed"]["bias"]),
          "cls_token": a(params["cls_token"]), "pos_embed": a(params["pos_embed"]),
          "norm.weight": a(params["norm"]["scale"]), "norm.bias": a(params["norm"]["bias"])}
    for i in range(TINY["vit_depth"]):
        b, p = params[f"blocks_{i}"], f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[f"{p}{norm}.weight"] = a(b[norm]["scale"])
            sd[f"{p}{norm}.bias"] = a(b[norm]["bias"])
        for dense, src in (("attn.qkv", b["attn"]["qkv"]), ("attn.proj", b["attn"]["proj"]),
                           ("mlp.fc1", b["mlp_fc1"]), ("mlp.fc2", b["mlp_fc2"])):
            sd[f"{p}{dense}.weight"] = a(np.asarray(src["kernel"]).T)
            sd[f"{p}{dense}.bias"] = a(src["bias"])
        sd[f"{p}ls1.gamma"] = a(b["ls1_gamma"])
        sd[f"{p}ls2.gamma"] = a(b["ls2_gamma"])
    return sd


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """A seeded .pth with the reference key names, the .npz the JAX tool
    converts from it, and the JAX ViT's interval taps on its weights."""
    root = tmp_path_factory.mktemp("vit")
    jm = _jax_vit()
    variables = init_flax(jm, X, seed=7)
    sd = _reference_state_dict(variables["params"])
    torch.save(sd, root / "vit.pth")
    torch.save({"model": sd}, root / "wrapped.pth")
    flat = convert_state_dict(sd, depth=TINY["vit_depth"])
    np.savez(root / "vit.npz", **flat)
    merged = merge_vit_params({"params": {"vit": variables["params"]}},
                              unflatten(flat))["params"]["vit"]
    want = jax.jit(lambda p: jm.apply({"params": p}, X))(merged)
    return root, len(flat), want


def _model():
    model = DINOv2MVSNet(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _vit_state(model):
    return {k: v for k, v in model.state_dict().items() if k.startswith("vit.")}


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_load_vit_pth_matches_the_jax_vit(pth):
    root, n_flat, want = pth
    model = _model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_vit_pth(root / "vit.pth", model) == n_flat
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(k.startswith("vit.") for k in moved)
    with torch.inference_mode():
        got = model.vit(t(X))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_wrapped_pth_and_npz_load_bit_equal_tensors(pth):
    root, _, _ = pth
    models = [_model() for _ in range(4)]
    load_vit_pth(root / "vit.pth", models[0])
    load_vit_pth(root / "wrapped.pth", models[1])
    load_vit_npz(root / "vit.npz", models[2])
    load_vit(root / "vit.pth", models[3])  # chosen by suffix
    for m in models[1:]:
        _assert_bit_equal(_vit_state(models[0]), _vit_state(m))


def test_pth_with_missing_block_raises(pth, tmp_path):
    """The block count comes from the model: a checkpoint with fewer blocks
    than the model's ViT is refused by name."""
    root, _, _ = pth
    sd = torch.load(root / "vit.pth", weights_only=False)
    torch.save({k: v for k, v in sd.items() if not k.startswith("blocks.2.")},
               tmp_path / "short.pth")
    with pytest.raises(KeyError, match="blocks.2"):
        load_vit_pth(tmp_path / "short.pth", _model())


def test_eval_cli_loads_a_pth_vit_path(pth):
    """The eval CLI's seeded-weights loader with a .pth arch.args.vit_path
    (it used to hand the file to load_vit_npz, which raised ValueError)."""
    root, _, _ = pth
    want = _model()
    load_vit_npz(root / "vit.npz", want)
    model = _model()
    cfg = Config({"arch": {"args": {"vit_path": str(root / "vit.pth")}}})
    eval_cli._load_weights(model, cfg, argparse.Namespace(ckpt_npz=None, ckpt=None))
    _assert_bit_equal(_vit_state(model), _vit_state(want))


def test_train_cli_loads_a_pth_vit_path(pth, tmp_path):
    """One step of the training CLI on a 3-view 64 x 96 scan (one reference
    view, its 7 lights) with a .pth vit_path (it used to exit for anything
    but .npz): the frozen ViT holds the .npz load's tensors bit for bit."""
    root, _, _ = pth
    data = tmp_path / "dtu"
    make_geometric_dtu(data, n_views=3, n_lights=7, h=64, w=96, ndepth=48,
                       scene=GeometricScene(seed=2, tex_res=64))
    pairs = (data / "Cameras" / "pair.txt").read_text().splitlines()
    (data / "Cameras" / "pair.txt").write_text("\n".join(["1"] + pairs[1:3]) + "\n")
    cfg = {"arch": {"bf16": False, "args": {**TINY_ARCH_ARGS, "vit_depth": 3,
                                            "vit_path": str(root / "vit.pth")}},
           "data_loader": [{"type": "DTULoader", "args": {
               "datapath": str(data), "train_data_list": str(data / "train.txt"),
               "nviews": 3, "num_depths": 48, "batch_size": 7, "num_workers": 1,
               "height": 64, "width": 64,
               "multi_scale_args": {"scales": [[64, 64]], "resize_range": [1.0, 1.0],
                                    "scale_batch_map": {"64": 1}}}}],
           "optimizer": {"args": {"lr": 1e-3, "warmup_steps": 1}},
           "trainer": {"epochs": 1, "logging_every": 1, "log_images": False}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    trainer = train_cli.main(["-c", str(tmp_path / "cfg.json"), "--device", "cpu",
                              "--save_dir", str(tmp_path / "saved")])
    assert trainer.global_step == 1
    want = _model()
    load_vit_npz(root / "vit.npz", want)
    _assert_bit_equal(_vit_state(trainer.model), _vit_state(want))
