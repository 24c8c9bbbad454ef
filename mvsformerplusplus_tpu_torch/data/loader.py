"""Host-side input pipeline (counterpart of mvsformerplusplus_tpu/data/loader.py):
threaded prefetch, batching, balanced multi-dataset sampling, the sample
stream split over processes and ranks, and the evaluation loader.

TrainLoader walks a ShapeBucketSchedule (one crop scale per batch,
reproducible from (seed, epoch)); its worker threads load the next two
batches while the current one trains (the reading, decoding and resizing
is numpy and zlib work that releases the interpreter lock for much of its
time).

Across processes it is the JAX TrainLoader: `rank` and `world` count
processes (hosts), the schedule draws global batches of batch_size * world
and process `rank` takes idxs[rank::world][:batch_size], its host batch.
One process of the JAX package shards that host batch over its local
devices; here each rank loads only its part of it (`shard`), the samples
the JAX package's device of the same data index gets, micro-batches
included (`micro_count`); the cv ranks of one data index load the same
part. `stride` hands a rank every n-th host batch instead (validation:
one batch per data index in turn).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


def micro_count(scale_batch_map: Dict[str, int], crop_hw, batch_size: int,
                ld: int = 1) -> int:
    """Micro-batches of a host batch of `batch_size` at crop `crop_hw`
    (the JAX Trainer's _micro_count): batch_size // micro for the largest
    micro <= scale_batch_map[crop height] that divides the batch and is a
    multiple of the `ld` data shards of the host (a micro below ld clamps
    up to ld), or 1."""
    micro = (scale_batch_map or {}).get(str(crop_hw[0]))
    if not micro or micro >= batch_size:
        return 1
    micro = max(micro, ld)
    while micro >= ld and (batch_size % micro != 0 or micro % ld != 0):
        micro -= 1
    if micro < ld or micro >= batch_size:
        return 1
    return batch_size // micro


class TrainLoader:
    """Multi-scale bucketed training loader: `epoch(e)` yields (batch dict,
    crop_hw) per step."""

    def __init__(self, dataset: MVSTrainDataset, batch_size: int,
                 scales: Sequence[Tuple[int, int]],
                 scale_batch_map: Optional[Dict[str, int]] = None, rank: int = 0,
                 world: int = 1, seed: int = 0, num_workers: int = 4, order_fn=None,
                 shard: Tuple[int, int] = (0, 1), stride: Tuple[int, int] = (0, 1)):
        """order_fn(epoch) -> index array replaces the schedule's permutation
        (BalancedSchedule for balanced multi-dataset training). `rank` and
        `world` are the process's, `batch_size` the host batch; shard=(j, n)
        loads part j of n of each host batch, stride=(j, n) host batches j,
        j + n, ..."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.schedule = ShapeBucketSchedule(len(dataset), scales, batch_size * world, seed)
        self.scale_batch_map = scale_batch_map or {}
        self.rank, self.world = rank, world
        self.num_workers = num_workers
        self.order_fn = order_fn
        self.shard, self.stride = shard, stride
        if batch_size % shard[1]:
            raise ValueError(f"a host batch of {batch_size} does not split over {shard[1]} "
                             "data ranks")

    def steps_per_epoch(self) -> int:
        n = len(self.order_fn(0)) if self.order_fn else len(self.dataset)
        return n // (self.batch_size * self.world)

    def host_batches(self, epoch: int):
        """The epoch's [(sample indices, crop_hw), ...] of this process (the
        JAX TrainLoader's)."""
        order = self.order_fn(epoch) if self.order_fn is not None else None
        return [(idxs[self.rank::self.world][:self.batch_size], hw)
                for idxs, hw in self.schedule.epoch(epoch, order=order)]

    def batches(self, epoch: int):
        """The epoch's [(sample indices, crop_hw), ...], as `epoch` loads them:
        this rank's stride of the host batches and its shard of each. The
        shard of a batch split into micro-batches is micro-batch by
        micro-batch: part j of each."""
        j, n = self.shard
        out = []
        for idxs, hw in self.host_batches(epoch)[self.stride[0]::self.stride[1]]:
            if n > 1:
                n_micro = micro_count(self.scale_batch_map, hw, len(idxs), n)
                idxs = np.asarray(idxs).reshape(n_micro, n, -1)[:, j].reshape(-1)
            out.append((idxs, hw))
        return out

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


class EvalLoader:
    """Sequential prefetching loader of an evaluation dataset: worker
    threads load the next two samples while the current one runs; `rank`
    and `world` stride the sample indices across processes."""

    def __init__(self, dataset, rank: int = 0, world: int = 1, num_workers: int = 2):
        self.dataset = dataset
        self.indices = list(range(len(dataset)))[rank::world]
        self.num_workers = num_workers

    def __len__(self):
        return len(self.indices)

    def __iter__(self):
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            todo = iter(self.indices)
            pending = [pool.submit(self.dataset.__getitem__, i) for _, i in zip(range(2), todo)]
            while pending:
                fut = pending.pop(0)
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(pool.submit(self.dataset.__getitem__, nxt))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
