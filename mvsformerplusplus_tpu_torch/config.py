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


def _to_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


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
    eval mode, or in train mode when `train` (the training entry point).

    `arch.args.remat_stages` (default true) and `arch.args.remat_granularity`
    ("cost_reg", the default and the repo's train protocol, or "stage")
    choose the gradient checkpointing of the cascade, as the JAX package's
    build_model reads them; `arch.args.freeze_vit` (default true) freezes
    the ViT; `extra` overrides any model argument. The model runs on the
    card unless the caller passes device="cpu"; without CUDA a CUDA device
    raises instead of falling back to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    args = cfg["arch"]["args"]
    model_type = args.get("model_type", "DINOv2-base")
    if "DINOv2" not in model_type:
        if model_type == "casmvs":
            raise NotImplementedError("model_type 'casmvs' is not ported yet")
        raise ValueError(f"unknown model_type {model_type}")
    from .models.mvsformer import DINOv2MVSNet

    dino_cfg = args.get("dino_cfg", {})
    kwargs = dict(
        feat_chs=_to_tuple(args.get("feat_chs", (8, 16, 32, 64))),
        ndepths=_to_tuple(args.get("ndepths", (32, 16, 8, 4))),
        depth_intervals_ratio=_to_tuple(args.get("depth_interals_ratio", (4.0, 2.67, 1.5, 1.0))),
        inverse_depth=args.get("inverse_depth", True),
        depth_type=_to_tuple(args.get("depth_type", ("ce",) * 4)),
        groups=_to_tuple(args["base_ch"] if isinstance(args.get("base_ch"), list)
                         else [args.get("base_ch", 8)] * 4),
        cost_reg_type=_to_tuple(args.get("cost_reg_type", ("Normal",) * 4)),
        transformer_config=tuple(args.get("transformer_config", [])) or None,
        use_pe3d=args.get("use_pe3d", False),
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
        remat_granularity=args.get("remat_granularity", "cost_reg"),
        dtype=dtype,
    )
    kwargs.update(extra)
    model = DINOv2MVSNet(**kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
