"""Batched image preprocessing on the tensor's device (counterpart of
``medmamba_tpu/data/transforms.py``).

Eval pipeline: bilinear resize -> ``x / 127.5 - 1`` normalisation, on a uint8
NHWC batch. The resize reproduces ``jax.image.resize(..., "bilinear")``: a
triangle kernel with half-pixel centres that is widened by the scale factor
when it downsamples (antialiasing), applied as one weight matrix per spatial
axis. ``F.interpolate`` differs from it when it downsamples.

Train pipeline (``augment=True``): per image a random horizontal flip and a
random rotation within +/-10 degrees (nearest, zero fill) at the batch's own
resolution, drawn from an explicit ``torch.Generator``, then the resize and
the normalisation, in the JAX package's order. The flip and rotation run in
one kernel on the card (``ops/rotate.py``, K5).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from medmamba_tpu_torch.ops.rotate import rotate_flip, rotate_flip_ref

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


# resize matrices and normalisation constants by (what, device), made on
# their first use: a copy from host memory at every call would cost host
# time each step, and it is illegal inside a CUDA graph's capture
_DEVICE_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _on_device(key: tuple, device: torch.device, make) -> torch.Tensor:
    t = _DEVICE_CONSTANTS.get((key, device))
    if t is None:
        t = torch.from_numpy(make()).to(device)
        # made while torch.export traces, it is a fake tensor of that trace,
        # which later eager calls must not be handed
        if type(t) is torch.Tensor:
            _DEVICE_CONSTANTS[(key, device)] = t
    return t


def resize_matrix(in_size: int, out_size: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`resize_weights` as a tensor on ``device``, made once."""
    return _on_device(("resize", in_size, out_size), device,
                      lambda: resize_weights(in_size, out_size))


def resize(x: torch.Tensor, size=224) -> torch.Tensor:
    """Bilinear resize of a float NHWC batch to (size, size), or to
    (height, width) when ``size`` is a pair."""
    _, h, w, _ = x.shape
    out_h, out_w = (size, size) if isinstance(size, int) else size
    if h != out_h:
        x = torch.einsum("bhwc,hH->bHwc", x,
                         resize_matrix(h, out_h, x.device))
    if w != out_w:
        x = torch.einsum("bhwc,wW->bhWc", x,
                         resize_matrix(w, out_w, x.device))
    return x


def _rotate_nearest(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate one (H, W, C) image by ``angle`` radians about its centre:
    nearest neighbour with zero fill (the counterpart of the JAX package's
    ``_rotate_nearest``)."""
    angle = angle.float().reshape(1)
    return rotate_flip_ref(img[None].float(), torch.sin(angle),
                           torch.cos(angle),
                           torch.zeros(1, dtype=torch.bool))[0]


def global_rand(generator: torch.Generator, b: int,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``b`` uniform draws from ``generator`` (on its device). With ``rows``
    = (start, total) the draws are made for a global batch of ``total``
    rows and rows [start, start + b) are kept, so every rank of a
    data-parallel step draws what one process draws for the whole batch."""
    if rows is None:
        return torch.rand(b, generator=generator, device=generator.device)
    start, total = rows
    return torch.rand(total, generator=generator,
                      device=generator.device)[start:start + b]


def random_augment(x: torch.Tensor, generator: torch.Generator,
                   max_rotate_deg: float = 10.0,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per image RandomHorizontalFlip(p=0.5) then RandomRotation(+/-deg) of a
    float NHWC batch. The flips and angles are drawn from ``generator`` (on
    its device) and never from the global generator; ``rows`` places the
    batch in a global one (:func:`global_rand`)."""
    b = x.shape[0]
    flip = global_rand(generator, b, rows) < 0.5
    max_rad = math.radians(max_rotate_deg)
    angles = (2.0 * global_rand(generator, b, rows) - 1.0) * max_rad
    return rotate_flip(x, angles.to(x.device), flip.to(x.device))


def preprocess(images: torch.Tensor, *, size: int = 224,
               augment: bool = False,
               generator: Optional[torch.Generator] = None,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """uint8 NHWC batch -> normalised float32 (B, size, size, 3), on the
    batch's device. ``augment`` flips and rotates at the batch's own
    resolution before the resize, with draws from ``generator`` (for the
    global batch that ``rows`` names, see :func:`global_rand`)."""
    x = images.float()
    if augment:
        if generator is None:
            raise ValueError("augment=True needs a torch.Generator")
        x = random_augment(x, generator, rows=rows)
    return normalize(resize(x, size))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_imagenet(images: torch.Tensor, *,
                        size: int = 224) -> torch.Tensor:
    """uint8 NHWC batch -> Resize(256) + CenterCrop(size) + ImageNet
    mean/std, the reference ConfusionMatrix script's recipe, on the batch's
    device."""
    x = resize(images.float(), 256)
    off = (256 - size) // 2
    x = x[:, off:off + size, off:off + size, :]
    mean = _on_device(("imagenet_mean",), x.device,
                      lambda: np.array(IMAGENET_MEAN, np.float32))
    std = _on_device(("imagenet_std",), x.device,
                     lambda: np.array(IMAGENET_STD, np.float32))
    return (x / 255.0 - mean) / std
