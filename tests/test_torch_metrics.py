"""The port's validation metrics (train/metrics.py) against the JAX
package's on the same depth maps, with a scalar and a per-sample scale,
within 1e-6; and eval_step's interval scaling ('dtu': di / 2.65,
'blended': di) on a stub model."""
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.train import metrics as jm
from mvsformerplusplus_tpu_torch.train import metrics as tm
from mvsformerplusplus_tpu_torch.train.step import eval_step


def _maps(seed=0, b=3, h=24, w=32):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(400, 900, (b, h, w)).astype(np.float32)
    est = gt + rng.standard_t(2, (b, h, w)).astype(np.float32) * 6
    mask = rng.rand(b, h, w) > 0.3
    mask[1] = False  # an image with no valid pixel counts as 0
    return est, gt, mask


@pytest.mark.parametrize("scale", [1.0, np.array([1.0, 0.5, 2.0], np.float32)],
                         ids=["scalar", "per_sample"])
def test_depth_metrics_match_jax(scale):
    est, gt, mask = _maps()
    want = jm.depth_metrics(est, gt, mask, scale=scale)
    got = tm.depth_metrics(torch.from_numpy(est), torch.from_numpy(gt), torch.from_numpy(mask),
                           scale=torch.as_tensor(scale))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)


class _Stub(torch.nn.Module):
    """Returns a fixed depth map; records the mode and temperatures it ran with."""

    def __init__(self, depth):
        super().__init__()
        self.depth, self.calls = depth, []
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, imgs, cams, depth_values, tmp):
        self.calls.append((self.training, tmp))
        return {"refined_depth": self.depth, "photometric_confidence": torch.ones_like(self.depth)}


@pytest.mark.parametrize("norm", ["dtu", "blended"])
def test_eval_step_scales_thresholds_by_the_interval(norm):
    est, gt, mask = _maps(1)
    dv = np.stack([425 + np.arange(8) * 2.65 * k for k in (1.0, 2.0, 0.5)]).astype(np.float32)
    batch = {"imgs": torch.zeros(3, 2, 8, 8, 3), "cams": {},
             "depth_values": torch.from_numpy(dv),
             "depth_gt": {"stage4": torch.from_numpy(gt)},
             "mask": {"stage4": torch.from_numpy(mask.astype(np.float32))}}
    model = _Stub(torch.from_numpy(est)).train()
    got = eval_step(model, batch, interval_norm=norm)
    assert model.calls == [(False, (5.0, 5.0, 5.0, 1.0))] and model.training
    di = dv[:, 1] - dv[:, 0]
    want = jm.depth_metrics(est, gt, mask, scale=di if norm == "blended" else di / 2.65)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)
