"""Host-side input pipeline (counterpart of mvsformerplusplus_tpu/data/loader.py,
for one process): threaded prefetch, batching, and balanced multi-dataset
sampling.

TrainLoader walks a ShapeBucketSchedule (one crop scale per batch,
reproducible from (seed, epoch)); its worker threads load the next two
batches while the current one trains (the reading, decoding and resizing
is numpy and zlib work that releases the interpreter lock for much of its
time).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .mvs_dataset import MVSTrainDataset, ShapeBucketSchedule


def collate(samples: List[dict]) -> dict:
    """Stack a list of samples into batched numpy arrays; other values
    (file names) become lists."""
    out = {}
    for k, v in samples[0].items():
        if isinstance(v, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples]) for kk in v}
        elif isinstance(v, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class TrainLoader:
    """Multi-scale bucketed training loader: `epoch(e)` yields (batch dict,
    crop_hw) per step."""

    def __init__(self, dataset: MVSTrainDataset, batch_size: int,
                 scales: Sequence[Tuple[int, int]], seed: int = 0, num_workers: int = 4,
                 order_fn=None):
        """order_fn(epoch) -> index array replaces the schedule's permutation
        (BalancedSchedule for balanced multi-dataset training)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.schedule = ShapeBucketSchedule(len(dataset), scales, batch_size, seed)
        self.num_workers = num_workers
        self.order_fn = order_fn

    def steps_per_epoch(self) -> int:
        n = len(self.order_fn(0)) if self.order_fn else len(self.dataset)
        return n // self.batch_size

    def batches(self, epoch: int):
        """The epoch's [(sample indices, crop_hw), ...], as `epoch` loads them."""
        order = self.order_fn(epoch) if self.order_fn is not None else None
        return self.schedule.epoch(epoch, order=order)

    def _load(self, idxs, crop_hw, epoch):
        return collate([self.dataset.get_sample(int(i), crop_hw, epoch) for i in idxs]), crop_hw

    def epoch(self, epoch: int) -> Iterator[Tuple[dict, Tuple[int, int]]]:
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            todo = iter(self.batches(epoch))
            pending = []
            for _ in range(2):  # batches prefetched ahead
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt[0], nxt[1], epoch))
            while pending:
                fut = pending.pop(0)
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt[0], nxt[1], epoch))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


class BalancedSchedule:
    """Balanced multi-dataset sampling: each epoch draws min(len(d)) samples
    from each child (RandomState(seed * 9973 + epoch)), concatenated and
    shuffled; indices into the concatenated datasets."""

    def __init__(self, lengths: Sequence[int], seed: int = 0):
        self.lengths = list(lengths)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]])
        self.seed = seed

    def epoch(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 9973 + epoch)
        n = min(self.lengths)
        picks = [rng.permutation(ln)[:n] + off for off, ln in zip(self.offsets, self.lengths)]
        allidx = np.concatenate(picks)
        rng.shuffle(allidx)
        return allidx


class ConcatDataset(MVSTrainDataset):
    """Concatenated train datasets behind one get_sample."""

    def __init__(self, children: Sequence[MVSTrainDataset]):
        self.children = list(children)
        self.lengths = [len(c) for c in self.children]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]])

    def __len__(self):
        return int(sum(self.lengths))

    def get_sample(self, idx, crop_hw, epoch=0):
        child = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.children[child].get_sample(int(idx - self.offsets[child]), crop_hw, epoch)
