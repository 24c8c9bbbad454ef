"""The (data, cv) layout as process groups (counterpart of
mvsformerplusplus_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D mesh (data, cv): `data`
shards the batch (sharded jit then takes BatchNorm moments, the loss and
the gradient over the global batch), `cv` shards the source views of the
cost volume. Here each device is one process (a rank) of
`world = n_data * n_cv`; rank r has data index r // n_cv and cv index
r % n_cv, and joins two groups:

- its *data group*: the ranks with its cv index (one per data index), over
  which batch reductions run (BatchNorm moments of layers whose input is
  the same on every cv rank, the loss's valid-pixel count, metrics);
- its *cv group*: the ranks with its data index, over which the
  view-sharded cost volume is summed (or, depth-sharded, the entropy's
  softmax over D is taken and the volume's slices are gathered).

The whole world reduces what is split over both: the visibility net's
rows under view sharding, and the gradients (a sum over data and a mean
over cv: one all-reduce over the world, divided by n_cv).

Every collective is an `all_reduce`, a `broadcast` or a `barrier`, the
three that gloo runs on CUDA tensors: several ranks on one card (the only
multi-rank layout one card gives) talk over gloo, ranks with a card each
over NCCL (`backend_for`). Without a process group every group has one
member and reduces nothing.

`launch` starts the ranks of one process (a host) with
torch.multiprocessing (spawn): one process per host drives all its ranks,
as one JAX process drives all its local devices.
"""
from __future__ import annotations

import logging
import socket
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger("mvsformerplusplus_tpu_torch")


class Group:
    """The ranks a reduction runs over. `index` is this rank's position in
    `ranks`; `pg` is None without a process group (then nothing is
    reduced)."""

    def __init__(self, pg=None, ranks: Sequence[int] = (0,), index: int = 0):
        self.pg, self.ranks, self.index = pg, tuple(ranks), index
        self.size = len(self.ranks)

    @property
    def active(self) -> bool:
        return self.pg is not None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the group; differentiable (the backward sums
        the gradient over the group)."""
        if not self.active:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllReduceSum.apply(x, self.pg)
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=self.pg)
        return y

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of `x` over the group (no gradient)."""
        if not self.active:
            return x
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.pg)
        return y

    def sum_(self, tensors: Sequence[torch.Tensor], scale: float = 1.0) -> None:
        """Replace each tensor by `scale` times its sum over the group, with
        one all-reduce per dtype of a flat buffer (no gradient)."""
        if not self.active:
            if scale != 1.0:
                for t in tensors:
                    t.mul_(scale)
            return
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.pg)
            if scale != 1.0:
                flat.mul_(scale)
            _unflatten(flat, group)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with the group's first member's, one
        broadcast per dtype."""
        if not self.active:
            return
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, self.ranks[0], group=self.pg)
            _unflatten(flat, group)

    def barrier(self) -> None:
        if self.active:
            dist.barrier(group=self.pg)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the gradient over it."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def _by_dtype(tensors):
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _unflatten(flat, tensors) -> None:
    i = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


@dataclass
class Layout:
    """This rank's place in the (data, cv) layout. `data_per_process` is the
    data extent of one process (the JAX mesh's data_extent_per_process): the
    host batch splits over it."""
    n_data: int = 1
    n_cv: int = 1
    rank: int = 0
    data_per_process: int = 1
    data: Group = field(default_factory=Group)
    cv: Group = field(default_factory=Group)
    world: Group = field(default_factory=Group)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_cv

    @property
    def local_data_index(self) -> int:
        """The data index within this process: which part of the host batch
        this rank loads."""
        return self.data_index % self.data_per_process

    def reduce_grads(self, params) -> None:
        """Each gradient becomes its sum over the data axis and its mean over
        the cv axis: one all-reduce over the world divided by n_cv. The
        loss of each rank is its share of the global loss (the masked means
        divide by the global count), so the data sum is the global gradient;
        under view or depth sharding every cv rank computes the whole loss,
        and the cv mean is its gradient (see the StageNet module)."""
        grads = [p.grad for p in params if p.grad is not None]
        self.world.sum_(grads, 1.0 / self.n_cv)

    def attach(self, model: torch.nn.Module) -> torch.nn.Module:
        """Give the model's train-mode BatchNorms their moment groups (the
        data group, the world for a VisibilityNet whose StageNet shards its
        views; under shard_depth every cv rank's visibility net sees the same
        entropy, and keeps the data group) and each StageNet its cv group."""
        from ..models.stagenet import StageNet

        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.sync = self.data
        for m in model.modules():
            if isinstance(m, StageNet):
                m.cv = self.cv
                if m.shard_views:
                    for bn in m.vis.modules():
                        if isinstance(bn, torch.nn.BatchNorm1d):
                            bn.sync = self.world
        return model


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_layout(n_data: int, n_cv: int, data_per_process: int = 1) -> Layout:
    """This rank's Layout in the initialised default process group of
    n_data * n_cv ranks. Every rank creates every group, in one order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_data * n_cv:
        raise ValueError(f"layout {n_data}x{n_cv} != {world} ranks")
    data = cv = None
    for c in range(n_cv):
        ranks = [d * n_cv + c for d in range(n_data)]
        pg = dist.new_group(ranks)
        if rank in ranks:
            data = Group(pg, ranks, ranks.index(rank))
    for d in range(n_data):
        ranks = [d * n_cv + c for c in range(n_cv)]
        pg = dist.new_group(ranks)
        if rank in ranks:
            cv = Group(pg, ranks, ranks.index(rank))
    return Layout(n_data, n_cv, rank, data_per_process, data, cv,
                  Group(dist.group.WORLD, range(world), rank))


def rank_device(local_rank: int, device_type: str = "cuda") -> torch.device:
    """cuda:{local_rank % device_count} (ranks share the cards round robin),
    or the CPU when asked."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device 'cpu' for CPU ranks")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device_type: str, local_ranks: int) -> str:
    """nccl when each rank of this process has a card of its own; gloo on
    the CPU or when ranks share a card (NCCL refuses two ranks on one
    device)."""
    if device_type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class RankContext:
    """What `launch` hands each rank's function."""
    rank: int
    local_rank: int
    world: int
    device: torch.device


def _rank_entry(local_rank, fn, args, spec, out_dir):
    rank = spec["process_id"] * spec["local_ranks"] + local_rank
    world = spec["num_processes"] * spec["local_ranks"]
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    device = rank_device(local_rank, spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(spec["backend"], init_method=f"tcp://{spec['coordinator']}",
                            world_size=world, rank=rank)
    try:
        result = fn(RankContext(rank, local_rank, world, device), *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, local_ranks: int, args: tuple = (), *, device: str = "cuda",
           num_processes: int = 1, process_id: int = 0, coordinator: Optional[str] = None,
           threads: Optional[int] = None) -> List:
    """Run fn(RankContext, *args) on `local_ranks` spawned processes, the
    ranks process_id * local_ranks ... of num_processes * local_ranks, in
    one default process group that rendezvous at `coordinator` (host:port;
    a free local port for a single process). `fn` must be importable by
    name and its result picklable (tensors on the CPU). The backend is
    decided here (backend_for) and logged; NCCL's failures raise, nothing
    falls back to gloo. With `threads`, each rank runs that
    many intra-op threads. Returns this process's ranks' results in rank
    order; a rank that raises fails the call."""
    if coordinator is None:
        if num_processes > 1:
            raise ValueError("several processes need a coordinator address (host:port)")
        coordinator = f"127.0.0.1:{free_port()}"
    if device == "cuda":
        from ..ops import cuda as kernels

        kernels.build_all()  # once, before the ranks load the libraries
    backend = backend_for(device, local_ranks)
    log.info("process %d of %d: %d %s rank(s) over %s, rendezvous at %s", process_id,
             num_processes, local_ranks, device, backend, coordinator)
    spec = dict(process_id=process_id, local_ranks=local_ranks, num_processes=num_processes,
                coordinator=coordinator, device=device, backend=backend, threads=threads)
    with tempfile.TemporaryDirectory(prefix="ranks_") as out_dir:
        torch.multiprocessing.spawn(_rank_entry, args=(fn, args, spec, out_dir),
                                    nprocs=local_ranks, join=True)
        first = process_id * local_ranks
        return [torch.load(Path(out_dir) / f"rank{first + i}.pt", weights_only=False)
                for i in range(local_ranks)]
