"""convert.load_vit_npz: a flattened flax .npz of random ViT parameters, in
the layout tools/convert_dinov2.py writes ('blocks_0/attn/qkv/kernel', ...),
loads into the port flagship's ViT; the ViT's interval taps then match the
JAX ViT's on the same weights (fp32, atol/rtol 2e-4), and no other weight
of the model moves. A key the model lacks, or a shape it does not have,
raises."""
import jax
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.models import dino as jdino
from mvsformerplusplus_tpu_torch.config import init_weights
from mvsformerplusplus_tpu_torch.convert import load_vit_npz
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from tests.test_torch_flagship import TINY
from tests.torch_parity import assert_close, init_flax, t
from tools.convert_dinov2 import load_dino_params


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_load_vit_npz_matches_the_jax_vit(tmp_path):
    x = np.random.RandomState(3).rand(2, 28, 42, 3).astype(np.float32)
    kw = dict(embed_dim=TINY["vit_ch"], depth=TINY["vit_depth"], num_heads=TINY["vit_num_heads"])
    jm = jdino.DinoVisionTransformer(**kw)
    params = init_flax(jm, x, seed=7)["params"]
    np.savez(tmp_path / "vit.npz", **dict(_flat(params)))

    model = DINOv2MVSNet(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_vit_npz(tmp_path / "vit.npz", model)
    assert n == len(dict(_flat(params)))
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(k.startswith("vit.") for k in moved)

    want = jax.jit(lambda p: jm.apply({"params": p}, x))(load_dino_params(tmp_path / "vit.npz"))
    with torch.inference_mode():
        got = model.vit(t(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_load_vit_npz_rejects_foreign_keys_and_shapes(tmp_path):
    model = DINOv2MVSNet(**TINY)
    np.savez(tmp_path / "a.npz", **{"blocks_0/attn/qkv/nope": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="not a parameter"):
        load_vit_npz(tmp_path / "a.npz", model)
    np.savez(tmp_path / "b.npz", **{"norm/scale": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_vit_npz(tmp_path / "b.npz", model)
