"""Weights from a seed, drawn on the model's device in one call.

The distributions are those the configuration's model is initialised with:
every weight matrix and kernel (a tensor of two or more dimensions) from
N(0, 1/fan_in), pos_embed from N(0, 0.02²), cls_token zero; vectors and
scalars keep their constant initial values. One normal draw of every
element at once, split in the order of the sorted parameter names, so any
two models with the same parameter names and shapes (the program's and the
reference's) get the same weights from the same seed.
"""
from __future__ import annotations

import math

import torch


def _drawn(model: torch.nn.Module):
    out = []
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            out.append((p, 0.02))
        elif leaf != "cls_token" and p.ndim >= 2:
            out.append((p, math.prod(p.shape[1:]) ** -0.5))
    return out


@torch.no_grad()
def draw_(model: torch.nn.Module, seed: int) -> int:
    """Overwrite `model`'s weights with the draw of `seed`; returns the count
    of drawn elements."""
    params = _drawn(model)
    device = params[0][0].device
    total = sum(p.numel() for p, _ in params)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for p, std in params:
        p.copy_(flat[at:at + p.numel()].view(p.shape) * std)
        at += p.numel()
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "cls_token":
            p.zero_()
    return total
