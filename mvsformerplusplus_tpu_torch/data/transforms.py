"""Photometric augmentation and normalization (counterpart of
mvsformerplusplus_tpu/data/transforms.py), numpy only: the OpenCV calls of
the JAX package are data/image.py's numpy copies.

One set of jitter factors is drawn per sample and applied to every view, so
the views stay photometrically consistent with each other.
"""
from __future__ import annotations

import numpy as np

from .image import hsv_to_rgb_u8, resize_nearest, rgb_to_hsv_u8

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def sample_jitter_params(rng: np.random.RandomState, brightness=0.2, contrast=0.1,
                         saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1):
    """Draw one factor set (applied to every view of the sample); the draws
    and their order are the JAX package's."""
    return {
        "order": rng.permutation(4),
        "brightness": rng.uniform(max(0, 1 - brightness), 1 + brightness),
        "contrast": rng.uniform(max(0, 1 - contrast), 1 + contrast),
        "saturation": rng.uniform(max(0, 1 - saturation), 1 + saturation),
        "hue": rng.uniform(-hue, hue),
        "gamma": rng.uniform(min_gamma, max_gamma),
    }


def _adjust_brightness(img, f):
    return np.clip(img * f, 0, 1)


def _adjust_contrast(img, f):
    # torchvision: blend with the mean of the grayscale image
    mean = (img @ _GRAY).mean()
    return np.clip(img * f + mean * (1 - f), 0, 1)


def _adjust_saturation(img, f):
    gray = (img @ _GRAY)[..., None]
    return np.clip(img * f + gray * (1 - f), 0, 1)


def _adjust_hue(img, f):
    hsv = rgb_to_hsv_u8((img * 255).astype(np.uint8))
    # 8-bit hue is [0, 180); a shift of f (a fraction of the cycle)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(round(f * 180))) % 180
    return hsv_to_rgb_u8(hsv).astype(np.float32) / 255.0


def apply_color_jitter(img: np.ndarray, params: dict, include_gamma: bool = True) -> np.ndarray:
    """img [H, W, 3] in [0, 1]; params from sample_jitter_params.
    include_gamma=False leaves the gamma to the fused crop_normalize."""
    fns = [
        lambda x: _adjust_brightness(x, params["brightness"]),
        lambda x: _adjust_contrast(x, params["contrast"]),
        lambda x: _adjust_saturation(x, params["saturation"]),
        lambda x: _adjust_hue(x, params["hue"]),
    ]
    for i in params["order"]:
        img = fns[i](img)
    if include_gamma:
        img = np.clip(img, 0, 1) ** params["gamma"]
    return np.clip(img, 0, 1).astype(np.float32)


def crop_normalize(img: np.ndarray, oy: int, ox: int, crop_h: int, crop_w: int,
                   gamma: float = 0.0) -> np.ndarray:
    """float32 [H, W, 3] in [0, 1] -> cropped, gamma-corrected (when gamma
    is set and not 1) and ImageNet-normalized [crop_h, crop_w, 3]."""
    patch = np.ascontiguousarray(img, np.float32)[oy:oy + crop_h, ox:ox + crop_w]
    if gamma > 0 and abs(gamma - 1.0) > 1e-6:
        patch = np.clip(patch, 0, 1) ** gamma
    return ((patch - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def stage_pyramid(arr: np.ndarray, levels: int = 4) -> dict:
    """GT depth/mask -> {'stage1': 1/8, 'stage2': 1/4, 'stage3': 1/2,
    'stage4': 1/1} by nearest sampling."""
    h, w = arr.shape[:2]
    out = {}
    for i in range(levels):
        f = 2 ** (levels - 1 - i)
        out[f"stage{i + 1}"] = arr if f == 1 else resize_nearest(arr, h // f, w // f)
    return out
