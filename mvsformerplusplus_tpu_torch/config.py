"""Config loading and the model factory (counterpart of
mvsformerplusplus_tpu/config.py): reference-format nested JSON configs with
`a;b;c` path overrides, and `build_model`, the port's entry point."""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn


class Config(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def get_path(self, path: str, default=None):
        """The value at 'a;b;c' (or 'a.b.c'; numeric segments index into
        lists), or `default` where the path does not exist."""
        node: Any = self
        for k in path.replace(";", ".").split("."):
            if isinstance(node, list) and k.lstrip("-").isdigit():
                i = int(k)
                if not -len(node) <= i < len(node):
                    return default
                node = node[i]
            elif isinstance(node, dict) and k in node:
                node = node[k]
            else:
                return default
        return node

    def set_path(self, path: str, value):
        """Numeric segments index into lists ('data_loader;0;args;batch_size')."""
        keys = path.replace(";", ".").split(".")
        node = self
        for k in keys[:-1]:
            node = node[int(k)] if isinstance(node, list) else node.setdefault(k, {})
        if isinstance(node, list):
            node[int(keys[-1])] = value
        else:
            node[keys[-1]] = value


def load_config(path, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a JSON config and apply `{'a;b;c': value}` overrides."""
    with open(path) as f:
        cfg = Config(json.load(f))
    for k, v in (overrides or {}).items():
        if v is not None:
            cfg.set_path(k, v)
    return cfg


def parse_override(expr: str):
    """'optimizer;args;lr=1e-4' -> (path, value): the value as JSON where it
    parses, else the raw string."""
    path, raw = expr.split("=", 1)
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return path, value


def _to_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


WARP_MODES = ("auto", "banded", "pallas", "xgrouped", "grouped", "folded")


def _check_warp_keys(args: dict, n_stages: int) -> None:
    """The JAX package's warp plan keys: `warp_mode` (one of WARP_MODES or a
    per-stage list), `fold_depth` ("auto", a bool or a per-stage list),
    `warp_gy` ("auto", a positive int or a per-stage list) and `banded_bwd`
    (a bool). Anything else raises ValueError."""
    def per_stage(key, ok):
        v = args.get(key, "auto")
        vals = v if isinstance(v, (list, tuple)) else [v]
        if isinstance(v, (list, tuple)) and len(v) != n_stages:
            raise ValueError(f"arch.args.{key}: a per-stage list needs {n_stages} entries, "
                             f"got {v!r}")
        for x in vals:
            if not ok(x):
                raise ValueError(f"arch.args.{key}: unknown value {x!r}")

    per_stage("warp_mode", lambda x: isinstance(x, str) and x in WARP_MODES)
    per_stage("fold_depth", lambda x: x == "auto" or x in (True, False))
    per_stage("warp_gy", lambda x: x == "auto" or (isinstance(x, int) and not isinstance(x, bool)
                                                   and x > 0))
    if args.get("banded_bwd", True) not in (True, False):
        raise ValueError(f"arch.args.banded_bwd: unknown value {args['banded_bwd']!r}")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight matrix and kernel (the tensors of 2 or more dims)
    from N(0, 1/fan_in) with `generator`; pos_embed from N(0, 0.02²) and
    cls_token zero, as flax initializes them. Vectors and scalars keep their
    constant initial values."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "cls_token":
            p.zero_()
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif p.ndim >= 2:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)


def build_model(cfg: Config, dtype=torch.bfloat16, device="cuda", seed: int = 0,
                train: bool = False, **extra):
    """arch.args -> model on `device` with weights drawn from `seed`, in
    eval mode, or in train mode when `train` (the training entry point):
    DINOv2MVSNet for a "DINOv2..." model_type (the default), CasMVSNet for
    "casmvs".

    Both families take the JAX build_model's common arguments:
    `arch.args.remat_granularity` ("cost_reg", the default and the repo's
    train protocol, or "stage") chooses the gradient checkpointing of the
    cascade, and the caller's dtype the compute type. The flagship also
    reads `arch.args.remat_stages` (default true) and `arch.args.freeze_vit`
    (default true); CasMVSNet keeps its class's remat_stages, as in the JAX
    package. `extra` overrides any model argument. The model runs on the
    card unless the caller passes device="cpu"; without CUDA a CUDA device
    raises instead of falling back to the CPU.

    The JAX package's warp plan keys (`warp_mode`, `fold_depth`, `warp_gy`,
    `banded_bwd`) are read and checked: every value the JAX package accepts
    passes, anything else raises ValueError. The port serves every mode with
    its exact warp (`ops/cuda/warp.py`), which equals each windowed JAX mode
    wherever no sample escapes its window (README, "Warp-window safety").
    `arch.args.log_var` (bare, or a per-stage list) gives stages the
    CostRegNet3D uncertainty head (models/cascade.py). As the JAX
    build_model(**extra) takes them, `shard_views=True` or
    `shard_depth=True` (not both: that raises) splits each StageNet's source
    views or hypotheses over the cv ranks of parallel.dist.Layout.attach.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    args = cfg["arch"]["args"]
    model_type = args.get("model_type", "DINOv2-base")
    if "DINOv2" not in model_type and model_type != "casmvs":
        raise ValueError(f"unknown model_type {model_type}")
    ndepths = _to_tuple(args.get("ndepths", (32, 16, 8, 4)))
    _check_warp_keys(args, len(ndepths))
    common = dict(
        feat_chs=_to_tuple(args.get("feat_chs", (8, 16, 32, 64))),
        ndepths=ndepths,
        depth_intervals_ratio=_to_tuple(args.get("depth_interals_ratio", (4.0, 2.67, 1.5, 1.0))),
        inverse_depth=args.get("inverse_depth", True),
        depth_type=_to_tuple(args.get("depth_type", ("ce",) * 4)),
        groups=_to_tuple(args["base_ch"] if isinstance(args.get("base_ch"), list)
                         else [args.get("base_ch", 8)] * 4),
        cost_reg_type=_to_tuple(args.get("cost_reg_type", ("Normal",) * 4)),
        log_var=_to_tuple(args.get("log_var", False)),
        transformer_config=tuple(args.get("transformer_config", [])) or None,
        use_pe3d=args.get("use_pe3d", False),
        remat_granularity=args.get("remat_granularity", "cost_reg"),
        dtype=dtype,
    )
    if model_type == "casmvs":
        from .models.casmvs import CasMVSNet as cls

        kwargs = common
    else:
        from .models.mvsformer import DINOv2MVSNet as cls

        dino_cfg = args.get("dino_cfg", {})
        kwargs = dict(
            common,
            rescale=args.get("rescale", 0.4375),
            vit_ch=args.get("vit_ch", 768),
            out_ch=args.get("out_ch", 64),
            vit_patch=args.get("vit_patch", 14),
            vit_depth=args.get("vit_depth", 12),
            vit_num_heads=args.get("vit_num_heads", 12),
            cross_interval_layers=dino_cfg.get("cross_interval_layers", 3),
            decoder_cfg=dino_cfg.get("decoder_cfg"),
            fmt_config=args.get("FMT_config"),
            freeze_vit=args.get("freeze_vit", True),
            remat_stages=args.get("remat_stages", True),
        )
    kwargs.update(extra)
    model = cls(**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
