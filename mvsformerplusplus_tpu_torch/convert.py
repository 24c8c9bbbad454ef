"""JAX (flax) variables -> this package's state_dict.

The port names its submodules after the flax path components, so conversion
is a walk over the flattened {"params", "batch_stats"} tree with per-leaf
layout rules:
- conv kernels [*k, in, out] -> [out, in, *k] (HWIO -> OIHW, DHWIO -> OIDHW);
- Dense kernels [in, out] -> [out, in];
- transposed-conv kernels (flax ConvTranspose) are flipped spatially and
  become torch's [in, out, *k];
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (plus num_batches_tracked); LayerNorm scale -> weight;
- everything else (biases, LayerScale and residual gammas, cls_token,
  pos_embed, prev_value_i) as it is.
Arrays arrive as numpy (or anything np.asarray takes). Every rule is linear
(transpose, flip, rename), so `from_jax_variables({"params": grads})` also
converts a flax gradient tree into the layout of the port's `.grad`s.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}
_TRANSPOSED = ("up0", "up1", "up")


def _flatten(tree, prefix=()) -> Iterator[Tuple[tuple, object]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _is_transposed(module: str) -> bool:
    return module.startswith("ConvTranspose") or module in _TRANSPOSED


def _kernel(module: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return a.T
    nd = a.ndim - 2
    spatial = tuple(range(nd))
    if _is_transposed(module):
        return np.flip(a, axis=spatial).transpose(nd, nd + 1, *spatial)
    return a.transpose(nd + 1, nd, *spatial)


def _unflatten(items) -> dict:
    """[('a/b/c', array), ...] -> the nested tree {'a': {'b': {'c': array}}}."""
    tree: dict = {}
    for key, value in items:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _load_checked(loaded: Dict[str, torch.Tensor], model: torch.nn.Module, path) -> int:
    """Load converted tensors into `model`: every one must name a tensor of
    the model of the same shape; the model's others keep their values."""
    target = model.state_dict()
    for k, v in loaded.items():
        if k not in target:
            raise KeyError(f"{path}: {k} is not a parameter of the model")
        if tuple(target[k].shape) != tuple(v.shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the model's "
                             f"{tuple(target[k].shape)}")
    model.load_state_dict(loaded, strict=False)
    return len(loaded)


def load_vit_npz(path, model: torch.nn.Module, prefix: str = "vit") -> int:
    """Load pretrained DINOv2 weights from the flattened flax .npz (keys
    'blocks_0/attn/qkv/kernel', ...; the converted checkpoint format of the
    JAX package) into `model`'s `prefix` submodule through
    from_jax_variables. Every key must map onto a parameter of the same
    shape; the model's other weights are left alone. Returns the number of
    tensors loaded."""
    with np.load(path) as data:
        tree = _unflatten((k, data[k]) for k in data.files)
    return _load_checked(from_jax_variables({"params": {prefix: tree}}), model, path)


def load_npz(path, model: torch.nn.Module) -> int:
    """Load a converted checkpoint, the npz tools/convert_reference.py
    writes (keys 'params:a/b/...' and 'batch_stats:a/b/...', the flattened
    flax variables), into `model` through from_jax_variables, as strictly
    as the JAX package's load_npz_variables(strict=True): a key the model
    lacks raises KeyError, a shape that differs ValueError; the model's
    tensors the file does not hold keep their values. Returns the number of
    tensors loaded."""
    flat: Dict[str, list] = {"params": [], "batch_stats": []}
    with np.load(path) as data:
        for key in data.files:
            coll, _, name = key.partition(":")
            if coll not in flat or not name:
                raise KeyError(f"{path}: {key!r} is not a 'params:' or 'batch_stats:' key")
            flat[coll].append((name, data[key]))
    variables = {coll: _unflatten(items) for coll, items in flat.items()}
    return _load_checked(from_jax_variables(variables), model, path)


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """flax variables {"params": ..., "batch_stats": ...} -> state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            *mods, name = path
            a = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                a = _kernel(mods[-1], a)
            sd[".".join(mods + [_LEAF_NAMES.get(name, name)])] = torch.from_numpy(a.copy())
            if coll == "batch_stats" and name == "mean":
                sd[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0)
    return sd
