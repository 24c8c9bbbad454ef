"""The eval loop: depth inference as the eval CLI runs it (eval/cli.py's
per-map path), closed loop, one client, one map in flight behind the one
being written back.

Per map: the sample's float32 host arrays are uploaded (pageable, as the
CLI's loader hands them over), the model is called with the mix's
temperatures, the refined depth and the chosen confidence are queued into
pinned host buffers behind the forward, and the previous map is written
back (its copies waited for). A map's latency runs from its arrays being
handed to the upload until its depth and confidence are on the host.

Set-up: the program's model through config.build_model, its weights drawn
on the card from the seed, the seeded pool of samples rendered on the card
and brought to the host, and warm maps of the pool's one shape. After the
window: the first served answer of each of a seeded sample of the pool's
samples (its depth, confidence and every stage's logits) held to the plain
reference (check.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, scene, weights
from ..record import Run


def build_program(config: dict, dtype, device):
    from mvsformerplusplus_tpu_torch.config import Config, build_model

    return build_model(Config(config["config"]), dtype=dtype, device=device)


def make_pool(traffic: dict, seed: int, device) -> list:
    """The mix's pool of samples as host arrays: {"imgs" [1, V, H, W, 3],
    "cams" {stageN: [1, V, 2, 4, 4]}, "depth_values" [1, D]}, float32."""
    pool = []
    for i in range(traffic["pool"]):
        gen = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + i) % 2**63)
        s = scene.sample(traffic, gen, device)
        pool.append({"imgs": s["imgs"][None].cpu().numpy(),
                     "cams": {f"stage{k + 1}": s["cams"][k][None].cpu().numpy()
                              for k in range(4)},
                     "depth_values": s["depth_values"][None].cpu().numpy()})
    return pool


class Staged:
    """One map's outputs on their way to the host: copies into pinned
    buffers queued behind its forward, and an event after them."""

    def __init__(self, tensors, index, t_handed):
        self.index, self.t_handed = index, t_handed
        self.host, self.copied = [], None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.float()
            self.host.append(h)
        if tensors[0].is_cuda:
            self.copied = torch.cuda.Event()
            self.copied.record()

    def wait(self):
        if self.copied is not None:
            self.copied.synchronize()
        return [h[0].numpy() for h in self.host]


class Server:
    """The per-map path over one model."""

    def __init__(self, model, traffic: dict, device, run: Run, keep=()):
        self.model, self.device, self.run = model, device, run
        self.tmp = tuple(traffic["tmp"])
        self.conf = traffic["conf"]
        self.pending = None
        self.latencies, self.answers = [], {}
        self.keep = set(keep)  # pool indices whose first answer is kept for the check

    def issue(self, sample: dict, index: int) -> None:
        run, dev = self.run, self.device
        t_handed = time.perf_counter()
        with run.span("upload"):
            imgs = torch.from_numpy(sample["imgs"]).to(dev)
            cams = {k: torch.from_numpy(v).to(dev) for k, v in sample["cams"].items()}
            dv = torch.from_numpy(sample["depth_values"]).to(dev)
        with run.span("dispatch"):
            out = self.model(imgs, cams, dv, tmp=self.tmp)
            conf = (out["stage4"]["photometric_confidence"] if self.conf == "stage4"
                    else out["photometric_confidence"])
            served = [out["refined_depth"], conf]
            if index in self.keep:  # the first answer of a checked sample: its logits too
                self.keep.discard(index)
                served += [out[f"stage{k}"]["prob_volume_pre"] for k in range(1, 5)]
            staged = Staged(served, index, t_handed)
            del out, conf, served
        if self.pending is not None:
            self.write_back()
        self.pending = staged

    def write_back(self) -> float:
        with self.run.span("write-back"):
            arrays = self.pending.wait()
        done = time.perf_counter()
        self.latencies.append(done - self.pending.t_handed)
        if len(arrays) > 2:
            self.answers[self.pending.index] = arrays
        self.pending = None
        return done


def run(ctx) -> dict:
    traffic, config, device, seed = ctx.traffic, ctx.config, ctx.device, ctx.seed
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
    record = Run("eval", dtype_bytes=2 if dtype == torch.bfloat16 else 4)
    model = build_program(config, dtype, device)
    weights.draw_(model, seed)
    pool = make_pool(traffic, seed, device)
    order = np.random.default_rng(seed).permutation(len(pool))
    picked = check.picked(ctx, len(pool))
    server = Server(model, traffic, device, record)
    with torch.inference_mode():
        for i in range(traffic.get("warm", 2)):  # the pool's one shape, until steady
            server.issue(pool[order[i % len(pool)]], -1)
        server.write_back()
        ctx.warm_tracer(lambda: (server.issue(pool[order[0]], -1), server.write_back()))
        ctx.sync()
        server.latencies.clear()
        server.keep = set(picked)
        record.spans.clear()
        setup_s = ctx.setup_done()
        ctx.window_start()
        t0 = time.perf_counter()
        n = 0
        with ctx.tracing() as tracer:
            while time.perf_counter() - t0 < ctx.seconds:
                idx = int(order[n % len(pool)])
                server.issue(pool[idx], idx)
                n += 1
            t1 = server.write_back()
        peak = ctx.window_peak()
    record.units, record.window_s = n, t1 - t0
    record.latencies = list(server.latencies)
    record.tail_min = traffic.get("p90_min_maps", 100)
    e2e = {"maps_per_s": n / (t1 - t0), "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    if tracer is not None:
        record.trace = ctx.summarise(tracer, t0, t1, record.spans)
    answers = server.answers
    del model, server
    ctx.free()
    checks = check.eval_answers(ctx, answers, pool, picked)
    if tracer is not None:
        ctx.count(record)
    return {"e2e": e2e, "record": record, "checks": checks, "attempted": n, "failed": 0}
