"""The port's TrainLoader against the JAX package's (rank 0 of 1) on a
geometric DTU scan: the same batches, in the same order and crop buckets,
for two epochs (images within 2e-5, everything else equal); and the
balanced multi-dataset schedule and concatenation against the JAX ones.
The scan is written by the port's synthetic writer and read by both."""
import numpy as np

from mvsformerplusplus_tpu.data import loader as jld
from mvsformerplusplus_tpu.data.mvs_dataset import DTUTrainDataset as JaxDTU
from mvsformerplusplus_tpu_torch.data import loader as tld
from mvsformerplusplus_tpu_torch.data import synthetic as tsyn
from mvsformerplusplus_tpu_torch.data.mvs_dataset import DTUTrainDataset

SCALES = [(64, 96), (96, 128), (64, 128)]


def _datasets(root):
    kw = dict(nviews=3, ndepths=16, augment=True, resize_range=(1.0, 1.2))
    args = (str(root), str(root / "train.txt"))
    return DTUTrainDataset(*args, **kw), JaxDTU(*args, **kw)


def test_train_loader_matches_jax(tmp_path):
    # written by the port (unfiltered PNG rows), read by both
    tsyn.make_geometric_dtu(tmp_path, n_views=3, n_lights=7, h=120, w=160, ndepth=16,
                            scene=tsyn.GeometricScene(seed=5, tex_res=128))
    tds, jds = _datasets(tmp_path)
    got_loader = tld.TrainLoader(tds, batch_size=4, scales=SCALES, seed=2, num_workers=2)
    want_loader = jld.TrainLoader(jds, batch_size=4, scales=SCALES, seed=2, num_workers=2,
                                  rank=0, world=1)
    assert got_loader.steps_per_epoch() == want_loader.steps_per_epoch() == len(tds) // 4
    for epoch in (0, 1):
        got, want = list(got_loader.epoch(epoch)), list(want_loader.epoch(epoch))
        assert [hw for _, hw in got] == [hw for _, hw in want]
        assert len(got) == got_loader.steps_per_epoch()
        assert [hw for _, hw in got] == [tuple(hw) for _, hw in got_loader.batches(epoch)]
        for (g, _), (w, _) in zip(got, want):
            assert g.keys() == w.keys() and g["filename"] == w["filename"]
            np.testing.assert_allclose(g["imgs"], w["imgs"], rtol=0, atol=2e-5)
            np.testing.assert_array_equal(g["depth_values"], w["depth_values"])
            for k in ("cams", "depth_gt", "mask"):
                for s in w[k]:
                    np.testing.assert_allclose(g[k][s], w[k][s], rtol=1e-6, atol=0)


def test_balanced_schedule_and_concat_match_jax():
    lengths = [7, 12, 5]
    for epoch in range(3):
        np.testing.assert_array_equal(tld.BalancedSchedule(lengths, seed=1).epoch(epoch),
                                      jld.BalancedSchedule(lengths, seed=1).epoch(epoch))

    class Child:
        def __init__(self, n, tag):
            self.n, self.tag = n, tag

        def __len__(self):
            return self.n

        def get_sample(self, idx, crop_hw, epoch=0):
            return (self.tag, idx, crop_hw, epoch)

    kids = [Child(n, i) for i, n in enumerate(lengths)]
    got, want = tld.ConcatDataset(kids), jld.ConcatDataset(kids)
    assert len(got) == len(want) == sum(lengths)
    assert all(got.get_sample(i, (64, 64), 1) == want.get_sample(i, (64, 64), 1)
               for i in range(sum(lengths)))
    order = tld.BalancedSchedule(lengths).epoch
    got_loader = tld.TrainLoader(got, batch_size=3, scales=SCALES, order_fn=order)
    want_loader = jld.TrainLoader(want, batch_size=3, scales=SCALES, order_fn=order)
    assert got_loader.steps_per_epoch() == want_loader.steps_per_epoch() == 5
    for epoch in (0, 1):
        g, w = got_loader.batches(epoch), want_loader.schedule.epoch(epoch, order=order(epoch))
        assert [(list(i), hw) for i, hw in g] == [(list(i), hw) for i, hw in w]
