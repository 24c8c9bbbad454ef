"""The port's run outputs against the JAX package's: scalars.jsonl records
(utils/logging.ScalarWriter, equal but for the wall-clock time), the PNG
depth panels (utils/logging.ImageWriter, decoded with PIL to the same
pixels as the JAX writer's, which PIL encodes), and --debug's per-module
gradient norms and non-finite counts (train/step.debug_logs against the
JAX _debug_logs on the same gradients, converted)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.train.step import _debug_logs
from mvsformerplusplus_tpu.utils import logging as jlog
from mvsformerplusplus_tpu_torch.convert import from_jax_variables
from mvsformerplusplus_tpu_torch.data.io import read_png
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.train.step import debug_logs
from mvsformerplusplus_tpu_torch.utils import logging as tlog
from tests.test_casmvs import make_inputs
from tests.test_torch_flagship import TINY


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "time"}
            for line in path.read_text().splitlines()]


def test_scalar_records_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    writes = [("train", {"loss": np.float32(rng.rand()), "grad_norm": torch.tensor(2.5),
                         "stage1": 0.25}, 1),
              ("val", {"mean_error": rng.rand(), "thres2mm_error": np.float64(0.125)}, 7),
              ("debug", {"encoder": 1e-7, "cascade": 3}, np.int64(7)),
              ("train", {}, 100)]
    jw, tw = jlog.ScalarWriter(tmp_path / "j"), tlog.ScalarWriter(tmp_path / "t")
    for mode, scalars, step in writes:
        jw.write(mode, {k: np.asarray(v) for k, v in scalars.items()}, step)
        tw.write(mode, scalars, step)
    jw.close()
    got = _records(tmp_path / "t" / "scalars.jsonl")
    want = _records(tmp_path / "j" / "scalars.jsonl")
    assert got == want and len(got) == len(writes)
    times = [json.loads(line)["time"] for line in
             (tmp_path / "t" / "scalars.jsonl").read_text().splitlines()]
    assert all(isinstance(x, float) for x in times) and times == sorted(times)


def _panel_inputs(case, rng):
    h, w = 24, 40
    depth = rng.uniform(400, 900, (h, w)).astype(np.float32)
    gt = rng.uniform(400, 900, (h, w)).astype(np.float32)
    conf = rng.rand(h, w).astype(np.float32)
    mask = (rng.rand(h, w) > 0.3).astype(np.float32)
    if case == "full":
        return depth, gt, conf, mask
    if case == "no_gt":
        return depth, None, conf, None
    if case == "no_conf_gt_only":
        gt[rng.rand(h, w) > 0.5] = 0
        return depth, gt, None, None
    if case == "non_finite":
        depth[0, :5] = np.nan
        depth[1, :3] = np.inf
        return depth, gt, conf, mask
    if case == "empty_mask":
        return depth, gt, conf, np.zeros_like(mask)
    if case == "constant":
        return np.full((h, w), 500, np.float32), None, None, None
    raise ValueError(case)


@pytest.mark.parametrize("case", ["full", "no_gt", "no_conf_gt_only", "non_finite",
                                  "empty_mask", "constant"])
def test_panels_decode_to_the_jax_pixels(tmp_path, case):
    args = _panel_inputs(case, np.random.RandomState(1))
    jlog.ImageWriter(tmp_path / "j").write("train", 42, *args)
    tlog.ImageWriter(tmp_path / "t").write("train", 42, *args)
    path = tmp_path / "t" / "images" / "train_step00000042.png"
    want = np.asarray(Image.open(tmp_path / "j" / "images" / "train_step00000042.png"))
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(path), want)
    panels = (3 if args[1] is not None else 1) + (args[2] is not None)
    assert got.shape == (24, 40 * panels, 3) and got.dtype == np.uint8


@pytest.fixture(scope="module")
def grads_pair():
    """Random gradients shaped like the tiny flagship's parameters, the
    ViT's zero (stopped in JAX; no gradient in the port), with inf and
    NaN entries planted in two modules."""
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    jm = JaxFlagship(**TINY, remat_stages=False)
    shapes = jax.eval_shape(lambda r: jm.init(r, imgs, cams, dv, train=False),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(2)
    grads = jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape) * rng.rand(), np.float32),
                         shapes)
    grads["vit"] = jax.tree.map(np.zeros_like, grads["vit"])
    grads["fmt"] = jax.tree.map(lambda g: g.copy(), grads["fmt"])
    jax.tree.leaves(grads["fmt"])[0].flat[:3] = [np.nan, np.inf, -np.inf]
    jax.tree.leaves(grads["cascade"])[-1].flat[0] = np.nan
    model = DINOv2MVSNet(**TINY)
    converted = from_jax_variables({"params": grads})
    for name, p in model.named_parameters():
        p.grad = None if name.startswith("vit.") else converted[name]
    return grads, model


def test_debug_logs_match_jax(grads_pair):
    grads, model = grads_pair
    want = {k: float(v) for k, v in _debug_logs(jax.tree.map(jnp.asarray, grads)).items()}
    got = debug_logs(model)
    assert set(got) == set(want) == {f"{kind}/{m}" for kind in ("gnorm", "nonfinite")
                                     for m in ("encoder", "decoder", "vit", "decoder_vit",
                                               "fmt", "cascade")}
    largest = max(v for k, v in want.items() if k.startswith("gnorm/") and np.isfinite(v))
    for k, v in want.items():
        if k.startswith("nonfinite/"):
            assert int(got[k]) == v, k
        elif np.isfinite(v):
            assert abs(float(got[k]) - v) <= 1e-5 * largest, (k, float(got[k]), v)
        else:
            assert not np.isfinite(float(got[k])), k
    assert (want["nonfinite/fmt"], want["nonfinite/cascade"], want["gnorm/vit"]) == (3, 1, 0)


def test_debug_logs_stay_on_the_device_of_the_model(grads_pair):
    """Every entry is a 0-dim tensor (no host value is read unless the
    caller reads it)."""
    _, model = grads_pair
    for k, v in debug_logs(model).items():
        assert isinstance(v, torch.Tensor) and v.ndim == 0, k
