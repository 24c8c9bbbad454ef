"""The port's (data, cv) layout across CPU ranks against the JAX package's
mesh, on the JAX side's 8 virtual CPU devices (tests/conftest.py); the
ranks are gloo processes started by parallel.dist.launch, one intra-op
thread each.

- The data-parallel step: the tiny flagship at --mesh 2,1 (one sample per
  rank) against the JAX train step on a (2, 1) mesh with the batch sharded
  over `data`: per-stage losses, every gradient, the BatchNorm running
  statistics and the parameters after AdamW, at test_torch_train_step.py's
  tolerances. The two samples' masks keep different numbers of valid pixels,
  and the test shows that a mean of the per-rank means would miss the
  losses' tolerance.
- The view-sharded step: the tiny CasMVSNet with shard_views at --mesh 1,2
  (one source view per rank) and --mesh 2,2 against JAX shard_views=True
  on (1, 2) and (2, 2) meshes, with whole-stage remat (the cv sum and the
  visibility nets' world-wide BatchNorm sums replayed in the backward);
  the gradients before the view reduction (FPN, visibility nets) and after
  it (cost regularizers) are among those compared.
- The depth-sharded step: the tiny CasMVSNet with shard_depth at --mesh 1,2
  (half the hypotheses of every stage per rank) and --mesh 2,2, and the
  tiny flagship at --mesh 1,2, against JAX shard_depth=True on the same
  meshes; the entropy's distributed softmax over D, the gather of the
  volume's slices before the regularizer and its backward (n_cv times each
  slice's gradient into the layers before it, reduced by the step's mean
  over cv) are exercised, and the gradients before the gather (FPN,
  visibility nets) and after it (cost regularizers) are among those
  compared. A D that does not split over the cv ranks raises.
- The validation merge: ranks with 2 and 1 batches merge to the global
  means (Trainer._merge), not the mean of their means.
- TrainLoader at world 2 against the JAX TrainLoader (per-process indices,
  crop buckets, steps per epoch), its shards against the JAX Trainer's
  micro-batch split, and the micro-batch count against the JAX Trainer's.
- WorkQueue against the JAX WorkQueue on one directory: one pass without
  reclaim, a port and a JAX process racing for the same claims (one winner
  each), a stale claim stolen as g1 across the packages, heartbeat and
  pending.

Conditioning is test_torch_train_step.py's (testing.conditioned_train_batch
at B=2 and 3 views, a seed per model; the test asserts it). At two samples
the two frameworks' CPU gradients differ by a few times that file's
gradient tolerance on one device already, so the ranks' gradients are held
to the port's one-rank step at that tolerance, and to the JAX mesh step no
further from it than the one-rank step is (assert_step_matches).
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mvsformerplusplus_tpu.data.loader import TrainLoader as JaxTrainLoader
from mvsformerplusplus_tpu.models.casmvs import CasMVSNet as JaxCasMVSNet
from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.parallel.mesh import make_global_batch, make_mesh
from mvsformerplusplus_tpu.parallel.scheduler import WorkQueue as JaxWorkQueue
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState, make_train_step
from mvsformerplusplus_tpu.train.trainer import Trainer as JaxTrainer
from mvsformerplusplus_tpu_torch.convert import from_jax_variables
from mvsformerplusplus_tpu_torch.data.loader import TrainLoader, micro_count
from mvsformerplusplus_tpu_torch.models.casmvs import CasMVSNet
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.parallel.dist import launch, make_layout
from mvsformerplusplus_tpu_torch.parallel.scheduler import WorkQueue
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch, train_step_rank
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train.step import train_step
from mvsformerplusplus_tpu_torch.train.trainer import Trainer, to_device
from tests.test_torch_casmvs import TINY as TINY_CASMVS
from tests.test_torch_flagship import TINY
from tests.test_torch_train_step import LR, OPT, capture_grads
from tests.torch_parity import init_flax

REPO = Path(__file__).resolve().parents[1]
# batch seeds (testing.conditioned_train_batch at B=2) whose CE stages keep
# their argmax depths clear of ties for each tiny model (port_one_rank
# asserts it)
SEEDS = {"flagship": 5, "casmvs": 4}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unequal_masks(batch):
    """Sample 1 keeps the left half of its valid pixels only."""
    for m in batch["mask"].values():
        m[1, :, : m.shape[2] // 2] = 0
    return batch


def jax_mesh_step(jm, variables, batch, mesh_shape):
    """The JAX train step as the JAX Trainer jits it on a mesh: state
    replicated, the batch sharded over `data`; the gradients captured."""
    mesh = make_mesh(*mesh_shape, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    tx = optax.chain(capture_grads(), jax_make_optimizer(freeze_vit=True, **OPT))
    repl = NamedSharding(mesh, P())
    with jax.sharding.set_mesh(mesh):
        state = jax.device_put(TrainState.create(variables, tx), repl)
        step = jax.jit(make_train_step(jm, tx),
                       in_shardings=(repl, NamedSharding(mesh, P("data"))))
        new, logs = step(state, make_global_batch(mesh, batch))
        logs = {k: float(v) for k, v in logs.items() if k == "loss" or k.startswith("stage")}
    return dict(logs=logs, grads=from_jax_variables({"params": jax.device_get(new.opt_state[0])}),
                new=from_jax_variables({"params": jax.device_get(new.params),
                                        "batch_stats": jax.device_get(new.batch_stats)}))


def port_ranks(model_cls, kwargs, variables, batch, mesh_shape, probe=False):
    make = functools.partial(model_cls, **kwargs)
    state = None if variables is None else from_jax_variables(variables)
    return launch(train_step_rank, mesh_shape[0] * mesh_shape[1],
                  (make, batch, mesh_shape, state,
                   dict(freeze_vit=True, **OPT), None, 0, probe),
                  device="cpu", threads=1)


def port_one_rank(model_cls, kwargs, variables, batch):
    """The port's step on one rank, in this process, on the whole batch;
    asserts the batch's conditioning first (test_torch_train_step.py's: at
    stages 1-3 the two best hypotheses of a pixel tied exactly or at least
    1e-5 apart in probability)."""
    model = model_cls(**kwargs)
    model.load_state_dict(from_jax_variables(variables))
    model.train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    tb = to_device(batch, "cpu")
    with torch.no_grad():
        out = model(tb["imgs"], tb["cams"], tb["depth_values"])
    for i in range(1, 4):
        top2 = out[f"stage{i}"]["prob_volume"].topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        assert gap[gap > 0].min() > 1e-5, i
    model.load_state_dict(state)
    opt, sched = make_optimizer(model, freeze_vit=True, **OPT)
    train_step(model, opt, sched, tb)
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def assert_step_matches(want, one, ranks, n_grads):
    """Every rank against the JAX mesh step: per-stage losses at rtol 1e-5,
    the running statistics at rtol 1e-4 / atol 2e-5 (test_torch_train_step.py's
    tolerances). Gradients: every rank's within 1e-3 of its tensor's
    largest entry plus 5e-5 of the port's step on one rank (`one`, the same
    batch in one process): the ranks' step is the one-rank step. Against
    the JAX mesh step each gradient is held to that tolerance or, where
    larger, twice the one-rank port's own distance from it: at two samples
    the two frameworks' CPU rounding (the JAX side sums BatchNorm statistics
    in sequential fp32) moves some gradients by a few times that tolerance
    on one device already, and the ranks may add nothing to it. The
    parameters after AdamW: within 1e-6 where |g| is above that gradient
    tolerance, else within 2 lr. Every rank holds the same state."""
    grads, new = want["grads"], want["new"]
    for r in ranks:
        for k, v in want["logs"].items():
            np.testing.assert_allclose(r["logs"][k], v, rtol=1e-5, err_msg=k)
        assert set(r["grads"]) == set(one) and len(one) >= n_grads
        tol = {}
        for name, g in r["grads"].items():
            w, o = grads[name].numpy(), one[name].numpy()
            base = 1e-3 * np.abs(o).max() + 5e-5
            err = np.abs(g.numpy() - o).max()
            assert err <= base, (name, err, base)
            tol[name] = max(1e-3 * np.abs(w).max() + 5e-5, 2 * np.abs(o - w).max())
            err = np.abs(g.numpy() - w).max()
            assert err <= tol[name], (name, err, tol[name])
        for k, w in new.items():
            got, w = r["state"][k].numpy(), w.numpy()
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, w, rtol=1e-4, atol=2e-5, err_msg=k)
            elif k in grads:
                noisy = np.abs(grads[k].numpy()) < tol.get(k, 5e-5)
                np.testing.assert_allclose(got[~noisy], w[~noisy], rtol=0, atol=1e-6, err_msg=k)
                assert np.abs(got[noisy] - w[noisy]).max(initial=0) <= 2 * LR + 1e-6, k
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k


# ------------------------------------------------------------ data-parallel step

@pytest.fixture(scope="module")
def flagship_one_rank():
    batch = unequal_masks(conditioned_train_batch(seed=SEEDS["flagship"], b=2))
    assert all(m[0].sum() > 1.5 * m[1].sum() for m in batch["mask"].values())
    jm = JaxFlagship(**TINY, remat_stages=False)
    variables = init_flax(jm, batch["imgs"], batch["cams"], batch["depth_values"], train=False)
    one = port_one_rank(DINOv2MVSNet, dict(TINY, remat_granularity="cost_reg"), variables, batch)
    return batch, variables, one


@pytest.fixture(scope="module")
def data_parallel(flagship_one_rank):
    batch, variables, one = flagship_one_rank
    want = jax_mesh_step(JaxFlagship(**TINY, remat_stages=False), variables, batch, (2, 1))
    kwargs = dict(TINY, remat_granularity="cost_reg")
    ranks = port_ranks(DINOv2MVSNet, kwargs, variables, batch, (2, 1), probe=True)
    return want, one, ranks


def test_data_parallel_step_matches_the_jax_mesh(data_parallel):
    assert_step_matches(*data_parallel, 300)


def test_data_parallel_loss_is_the_global_masked_mean(data_parallel):
    """Each rank's losses are its share of the global batch's (they sum to
    the JAX mesh step's); the mean of the per-rank means misses the losses'
    tolerance at every stage, since the ranks' valid counts differ."""
    want, _, ranks = data_parallel
    for k, v in want["logs"].items():
        if k == "loss":
            continue
        shares = sum(r["shares"][k] for r in ranks)
        np.testing.assert_allclose(shares, v, rtol=1e-5, err_msg=k)
        mean_of_means = sum(r["local"][k] for r in ranks) / 2
        assert abs(mean_of_means - v) > 10 * 1e-5 * abs(v), (k, mean_of_means, v)


# ------------------------------------------------------------- view-sharded step

@pytest.fixture(scope="module")
def casmvs_one_rank():
    batch = unequal_masks(conditioned_train_batch(seed=SEEDS["casmvs"], b=2))
    jm = JaxCasMVSNet(**TINY_CASMVS, remat_stages=False)
    variables = init_flax(jm, batch["imgs"], batch["cams"], batch["depth_values"], train=False)
    one = port_one_rank(CasMVSNet, dict(TINY_CASMVS, remat_granularity="stage"), variables, batch)
    return batch, variables, one


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_view_sharded_step_matches_the_jax_mesh(casmvs_one_rank, mesh_shape):
    batch, variables, one = casmvs_one_rank
    jm = JaxCasMVSNet(**TINY_CASMVS, remat_stages=False, shard_views=True)
    want = jax_mesh_step(jm, variables, batch, mesh_shape)
    ranks = port_ranks(CasMVSNet, dict(TINY_CASMVS, remat_granularity="stage", shard_views=True),
                       variables, batch, mesh_shape)
    assert len(ranks) == mesh_shape[0] * mesh_shape[1]
    assert_step_matches(want, one, ranks, 100)
    moved = {n for n, g in ranks[0]["grads"].items() if g.abs().max() > 0}
    for part in ("encoder.", "decoder.", ".vis.", ".cost_reg."):
        assert any(part in n for n in moved), part


# ------------------------------------------------------------ depth-sharded step

def _sharded_parts_moved(ranks):
    moved = {n for n, g in ranks[0]["grads"].items() if g.abs().max() > 0}
    for part in ("encoder.", "decoder.", ".vis.", ".cost_reg."):
        assert any(part in n for n in moved), part


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_depth_sharded_step_matches_the_jax_mesh(casmvs_one_rank, mesh_shape):
    batch, variables, one = casmvs_one_rank
    jm = JaxCasMVSNet(**TINY_CASMVS, remat_stages=False, shard_depth=True)
    want = jax_mesh_step(jm, variables, batch, mesh_shape)
    ranks = port_ranks(CasMVSNet, dict(TINY_CASMVS, remat_granularity="stage", shard_depth=True),
                       variables, batch, mesh_shape)
    assert len(ranks) == mesh_shape[0] * mesh_shape[1]
    assert_step_matches(want, one, ranks, 100)
    _sharded_parts_moved(ranks)


def test_depth_sharded_flagship_step_matches_the_jax_mesh(flagship_one_rank):
    """The flagship at --mesh 1,2 with its regularizers checkpointed: the
    CTA regularizer of stage 1 runs on the gathered volume."""
    batch, variables, one = flagship_one_rank
    want = jax_mesh_step(JaxFlagship(**TINY, remat_stages=False, shard_depth=True), variables,
                         batch, (1, 2))
    ranks = port_ranks(DINOv2MVSNet, dict(TINY, remat_granularity="cost_reg", shard_depth=True),
                       variables, batch, (1, 2))
    assert_step_matches(want, one, ranks, 300)
    _sharded_parts_moved(ranks)


def test_depth_sharded_step_rejects_an_uneven_depth(casmvs_one_rank):
    batch, variables, _ = casmvs_one_rank
    uneven = dict(TINY_CASMVS, ndepths=(7, 4, 4, 4), shard_depth=True)
    with pytest.raises(Exception, match="shard_depth: 7 hypotheses do not split over 2 cv"):
        port_ranks(CasMVSNet, uneven, None, batch, (1, 2))


# ------------------------------------------------------------- validation merge

def merge_rank(ctx, batches):
    """Trainer._merge of this rank's `batches` metric dicts at (2, 1)."""
    layout = make_layout(2, 1, 2)
    mine = batches[ctx.rank]
    sums = {k: sum(b[k] for b in mine) for k in mine[0]}
    trainer = SimpleNamespace(layout=layout, device=torch.device("cpu"))
    return Trainer._merge(trainer, sums, len(mine))


def test_validation_merges_uneven_ranks_to_the_global_mean():
    batches = [[{"mean_error": 1.0, "thres2mm_error": 0.5}, {"mean_error": 3.0,
                                                            "thres2mm_error": 0.25}],
               [{"mean_error": 8.0, "thres2mm_error": 1.0}]]
    for sums, n in launch(merge_rank, 2, (batches,), device="cpu", threads=1):
        assert n == 3
        assert {k: v / n for k, v in sums.items()} == {"mean_error": 4.0,
                                                       "thres2mm_error": 0.5833333333333334}


# ------------------------------------------------------------------------ loader

class IndexDataset:
    """get_sample returns the index, the crop and the epoch it was asked."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_sample(self, idx, crop_hw, epoch=0):
        return {"idx": np.array(idx), "hw": np.array(crop_hw), "epoch": np.array(epoch)}


def _stream(loader, epoch):
    return [(b["idx"].tolist(), tuple(hw)) for b, hw in loader.epoch(epoch)]


def test_train_loader_at_world_2_is_the_jax_loader():
    scales = [(64, 96), (64, 64), (96, 128)]
    sbm = {"96": 2}
    ds = IndexDataset(37)
    for rank in (0, 1):
        jax_loader = JaxTrainLoader(ds, batch_size=4, scales=scales, scale_batch_map=sbm,
                                    rank=rank, world=2, num_workers=2)
        port = TrainLoader(ds, batch_size=4, scales=scales, scale_batch_map=sbm, rank=rank,
                           world=2, num_workers=2)
        assert port.steps_per_epoch() == jax_loader.steps_per_epoch() == 37 // 8
        for epoch in (0, 1):
            want = _stream(jax_loader, epoch)
            assert _stream(port, epoch) == want
            assert len({hw for _, hw in want}) > 1
            # the host batch split over 2 data ranks as the JAX Trainer splits it
            parts = [_stream(TrainLoader(ds, batch_size=4, scales=scales, scale_batch_map=sbm,
                                         rank=rank, world=2, num_workers=2, shard=(j, 2)), epoch)
                     for j in range(2)]
            for i, (idxs, hw) in enumerate(want):
                n_micro = micro_count(sbm, hw, 4, 2)
                split = np.asarray(idxs).reshape(n_micro, 2, -1)
                assert [p[i] for p in parts] == [(split[:, j].reshape(-1).tolist(), hw)
                                                  for j in range(2)]


@pytest.mark.parametrize("batch,ld,sbm", [(4, 1, {"64": 1}), (4, 2, {"64": 1}), (8, 4, {"64": 2}),
                                          (8, 2, {"64": 3}), (6, 2, {"64": 4}), (4, 2, {})])
def test_micro_count_is_the_jax_trainers(batch, ld, sbm):
    mesh = make_mesh(ld, 1, devices=jax.devices()[:ld])
    want = JaxTrainer._micro_count(SimpleNamespace(scale_batch_map=sbm, mesh=mesh), (64, 96),
                                   batch)
    port = Trainer._micro_count(SimpleNamespace(scale_batch_map=sbm,
                                                layout=SimpleNamespace(data_per_process=ld)),
                                (64, 96), batch // ld)
    assert port == micro_count(sbm, (64, 96), batch, ld) == want


# -------------------------------------------------------------------- work queue

def test_queue_one_pass_shares_a_directory_with_jax(tmp_path):
    tasks = [f"scan{i}" for i in range(6)]
    jq = JaxWorkQueue(tmp_path, tasks, worker="jax")
    it = iter(jq)
    first = [next(it), next(it)]
    pq = WorkQueue(tmp_path, tasks, worker="port")
    got = list(pq)
    assert first == tasks[:2] and got == tasks[2:]
    assert list(it) == []
    names = sorted(p.name for p in (tmp_path / ".claims").iterdir())
    assert names == sorted(f"{t}.claim.g0" for t in tasks)
    for t in got:
        pq.mark_done(t)
    assert jq.pending() == tasks[:2] and pq.pending() == tasks[:2]


RACER = """
import json, sys, time
sys.path.insert(0, {repo!r})
from {module} import WorkQueue
q = WorkQueue({root!r}, {tasks!r}, worker={worker!r})
while time.time() < {start}:
    pass
print(json.dumps([t for t in {tasks!r} if q._try_claim(t)]))
"""


def test_queue_port_and_jax_processes_race_to_one_winner(tmp_path):
    tasks = [f"t{i}" for i in range(40)]
    start = time.time() + 3.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACER.format(repo=str(REPO), module=module, root=str(tmp_path),
                                            tasks=tasks, worker=worker, start=start)],
        stdout=subprocess.PIPE, text=True)
        for module, worker in (("mvsformerplusplus_tpu_torch.parallel.scheduler", "port"),
                               ("mvsformerplusplus_tpu.parallel.scheduler", "jax"))]
    won = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert sorted(won[0] + won[1]) == sorted(tasks)
    for t in tasks:
        owner = (tmp_path / ".claims" / f"{t}.claim.g0").read_text()
        assert (t in won[0]) == (owner == "port") and (t in won[1]) == (owner == "jax")


@pytest.mark.parametrize("thief", ["port", "jax"])
def test_queue_steals_a_stale_claim_as_g1(tmp_path, thief):
    classes = {"port": WorkQueue, "jax": JaxWorkQueue}
    owner = "jax" if thief == "port" else "port"
    dead = classes[owner](tmp_path, ["a", "b"], worker=owner)
    assert next(iter(dead)) == "a"
    claim = tmp_path / ".claims" / "a.claim.g0"
    os.utime(claim, (time.time() - 100, time.time() - 100))
    q = classes[thief](tmp_path, ["a", "b"], worker=thief, reclaim_stale_s=50, poll_s=0.01)
    got = []
    for t in q:
        got.append(t)
        q.mark_done(t)
    assert got == ["a", "b"]
    assert (tmp_path / ".claims" / "a.claim.g1").read_text() == thief
    assert dead._highest_gen("a") == 1 and dead.pending() == []


def test_queue_heartbeat_and_pending(tmp_path):
    pq = WorkQueue(tmp_path, ["a", "b"], worker="port")
    assert next(iter(pq)) == "a"
    claim = tmp_path / ".claims" / "a.claim.g0"
    os.utime(claim, (time.time() - 100, time.time() - 100))
    pq.heartbeat("a")
    assert time.time() - claim.stat().st_mtime < 10
    jq = JaxWorkQueue(tmp_path, ["a", "b"], worker="jax", reclaim_stale_s=50, poll_s=0.01)
    assert jq._try_claim("a") is False  # the heartbeat keeps it
    pq.heartbeat("b")  # not ours: nothing happens
    assert not (tmp_path / ".claims" / "b.claim.g0").exists()
    pq.mark_done("a")
    assert jq.pending() == pq.pending() == ["b"]
