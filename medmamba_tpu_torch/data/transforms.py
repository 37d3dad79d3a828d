"""Batched image preprocessing on the tensor's device (counterpart of
``medmamba_tpu/data/transforms.py``).

Eval pipeline: bilinear resize -> ``x / 127.5 - 1`` normalisation, on a uint8
NHWC batch. The resize reproduces ``jax.image.resize(..., "bilinear")``: a
triangle kernel with half-pixel centres that is widened by the scale factor
when it downsamples (antialiasing), applied as one weight matrix per spatial
axis. ``F.interpolate`` differs from it when it downsamples.

Augmentation (flip + rotation) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

MEAN = 0.5
STD = 0.5


def normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8/float [0, 255] -> float (x/255 - mean)/std."""
    return (x.float() / 255.0 - MEAN) / STD


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s bilinear
    (triangle) kernel with antialiasing."""
    inv_scale = np.float32(in_size / out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale
              - 0.5).astype(np.float32)
    x = np.abs(sample[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Bilinear resize of a float NHWC batch to (size, size)."""
    _, h, w, _ = x.shape
    if h != size:
        wh = torch.from_numpy(resize_weights(h, size)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != size:
        ww = torch.from_numpy(resize_weights(w, size)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def preprocess(images: torch.Tensor, *, size: int = 224,
               augment: bool = False) -> torch.Tensor:
    """uint8 NHWC batch -> normalised float32 (B, size, size, 3), on the
    batch's device."""
    if augment:
        raise NotImplementedError(
            "random flip/rotation (the training augmentation) is not ported")
    return normalize(resize(images.float(), size))
