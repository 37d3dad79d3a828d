"""The VSSM segmentation U-net in PyTorch (NHWC at the public interface).

Counterpart of ``medmamba_tpu/models/decoder.py``, whose parts come from
the reference's development file ``temp.py`` (``PatchExpand2D``
temp.py:212-227, ``Final_PatchExpand2D`` :230-245, ``VSSLayer_up``
:595-656). ``VSSMSeg`` is the port's ``PatchEmbed2D`` and encoder
``VSSLayer`` stages, a decoder of ``VSSLayerUp`` stages (upsample first,
then SS-Conv-SSM blocks) with the input of encoder stage j added after
decoder stage i = n - 1 - j > 0, ``FinalPatchExpand2D`` back to pixel
resolution and a 1x1 convolution with bias. Its scans take the
dispatcher's path (``ops/selective_scan.py``): K1 with K2 as its backward
on the card, K3/K4 under ``MEDMAMBA_SCAN_KERNEL=hillis``, the plain scan
on the CPU; 2 per SS-Conv-SSM block, so 40 a forward at the default depths.
As in the JAX module (its ``VSSLayerUp.dtype``, a plain class attribute),
the model is float32, and the decoder has no drop path.

``temp.py`` is not in the repository, so the decoder's state-dict names
are the port's (``utils/convert.py``): ``layers_up.{i}.upsample.expand``,
``layers_up.{i}.upsample.norm``, ``layers_up.{i}.blocks.{j}...`` (the
encoder's block names), ``final_up.expand``, ``final_up.norm`` and
``head``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from medmamba_tpu_torch.models.vssm import (PatchEmbed2D, VSSLayer,
                                            trunc_normal, trunc_normal_02)


class PatchExpand2D(nn.Module):
    """Channel to space (temp.py:212-227): Linear(dim, p * dim, no bias),
    then ``(p1 p2 c) -> (h p1) (w p2) c`` and LayerNorm; (B, H, W, dim) ->
    (B, pH, pW, dim / p). ``dim`` is the incoming channel count (the
    reference constructs its module with half of it)."""

    def __init__(self, dim: int, dim_scale: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        self.dim_scale = dim_scale
        self.expand = nn.Linear(dim, dim_scale * dim, bias=False)
        trunc_normal_02(self.expand.weight, generator)
        self.norm = nn.LayerNorm(dim // dim_scale, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.dim_scale
        x = self.expand(x)
        c = x.shape[-1] // (p * p)
        x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, h * p, w * p, c)
        return self.norm(x)


class FinalPatchExpand2D(PatchExpand2D):
    """The x4 expansion back to pixel resolution (temp.py:230-245):
    (B, H, W, dim) -> (B, 4H, 4W, dim / 4)."""

    def __init__(self, dim: int, dim_scale: int = 4, *,
                 generator: torch.Generator):
        super().__init__(dim, dim_scale, generator=generator)


class VSSLayerUp(VSSLayer):
    """Decoder stage: PatchExpand2D from 2 * dim channels (unless
    ``upsample`` is false), then ``depth`` SS-Conv-SSM blocks at ``dim``."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = (),
                 upsample: bool = True, use_checkpoint: bool = False,
                 scan_impl: str = "auto", *, generator: torch.Generator):
        super().__init__(dim, depth, d_state=d_state, attn_drop=attn_drop,
                         drop_path=drop_path, scan_impl=scan_impl,
                         use_checkpoint=use_checkpoint, generator=generator)
        self.upsample = (PatchExpand2D(2 * dim, generator=generator)
                         if upsample else None)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.upsample is not None:
            x = self.upsample(x)
        return super().forward(x, mask, generator)


class VSSMSeg(nn.Module):
    """U-shaped VSSM segmentation model: NHWC (B, H, W, 3) float input,
    float32 per-pixel logits (B, H, W, num_classes). Parameters are drawn
    from ``generator`` (seed 0 when none is given) on the CPU. ``mask`` and
    ``generator`` of ``forward`` are the encoder's, as in ``VSSM``."""

    def __init__(self, num_classes: int = 2,
                 depths: Sequence[int] = (2, 2, 4, 2),
                 depths_decoder: Sequence[int] = (2, 4, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: int = 16, drop_path_rate: float = 0.1,
                 scan_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        n = len(depths)
        self.patch_embed = PatchEmbed2D(embed_dim=dims[0], generator=gen)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], depths[i], d_state=d_state,
                     drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     downsample=i < n - 1, scan_impl=scan_impl,
                     generator=gen)
            for i in range(n))
        self.layers_up = nn.ModuleList(
            VSSLayerUp(dims[n - 1 - i], depths_decoder[i], d_state=d_state,
                       upsample=i > 0, scan_impl=scan_impl, generator=gen)
            for i in range(n))
        self.final_up = FinalPatchExpand2D(dims[0], generator=gen)
        self.head = nn.Conv2d(dims[0] // 4, num_classes, 1)
        # flax nn.Conv's default kernel init, lecun_normal
        trunc_normal(self.head.weight, math.sqrt(1.0 / (dims[0] // 4)), gen)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x.float())
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x, mask, generator)
        n = len(self.layers)
        for i, layer in enumerate(self.layers_up):
            x = layer(x, mask, generator)
            if i > 0:
                x = x + skips[n - 1 - i]
        x = self.final_up(x)
        return self.head(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
