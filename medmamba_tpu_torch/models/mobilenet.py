"""MobileNetV2 in PyTorch (NHWC at the public interface).

Counterpart of ``medmamba_tpu/models/mobilenet.py`` (itself the
reference's ``ConfusionMatrix/model.py``): convolutions padded
symmetrically by (k - 1) // 2, as torch pads (the JAX module pads so
explicitly; flax's "SAME" would shift a stride-2 grid by a pixel);
BatchNorm with flax's statistics (momentum 0.9 on the running values, which
is torch's momentum 0.1, the biased batch variance into the running one,
eps 1e-5: ``vssm.MaskedBatchNorm``); ReLU6; dropout 0.2 before the
classifier, whose weights are drawn from normal(0.01).

Names follow the reference state dict: ``features.0`` is the stem,
``features.{1..17}.conv`` the inverted residuals (``conv.0`` the expansion
ConvBNReLU where there is one, then the depthwise ConvBNReLU, the
projection conv and its BatchNorm), ``features.18`` the 1x1 head ConvBNReLU
and ``classifier.1`` the linear layer, so a reference ``.pth`` loads with
``strict=True``.

Grad-CAM reads ``head_conv.conv`` (the JAX module path ``cam_backbones``
targets): the head's 1x1 convolution's output, before its BatchNorm.
``cli.cam_backbones`` runs the model in eval mode, as the reference's
``grad_cam/main_cnn.py`` does (the JAX CLI passes ``True`` as the third
argument of ``apply``, which MobileNetV2 reads as ``train``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from medmamba_tpu_torch.models.vit import dropout
from medmamba_tpu_torch.models.vssm import (MaskedBatchNorm, _tap,
                                            kaiming_fan_out)

# t, c, n, s: expansion, output channels, repeats, first stride
CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _make_divisible(ch, divisor=8, min_ch=None):
    if min_ch is None:
        min_ch = divisor
    new_ch = max(min_ch, int(ch + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * ch:
        new_ch += divisor
    return new_ch


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, groups: int,
          gen: torch.Generator) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                     groups=groups, bias=False)
    kaiming_fan_out(conv.weight, gen)
    return conv


class ConvBNReLU(nn.Sequential):
    """conv (0) -> BatchNorm (1) -> ReLU6 (2), on NCHW. Grad-CAM tap
    "conv": the convolution's output."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, *,
                 generator: torch.Generator):
        super().__init__(_conv(in_ch, out_ch, kernel, stride, groups,
                               generator),
                         MaskedBatchNorm(out_ch), nn.ReLU6())
        self.taps = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        if self.taps:
            x = _tap(self.taps, "conv", x, nchw=True)
        return self[2](self[1](x))


class InvertedResidual(nn.Module):
    """[1x1 expand ConvBNReLU] -> depthwise 3x3 ConvBNReLU -> 1x1 project
    conv -> BatchNorm, plus the input where stride is 1 and the widths
    agree."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 expand_ratio: int, *, generator: torch.Generator):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.use_shortcut = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_ch, hidden, kernel=1,
                                     generator=generator))
        layers += [ConvBNReLU(hidden, hidden, stride=stride, groups=hidden,
                              generator=generator),
                   _conv(hidden, out_ch, 1, 1, 1, generator),
                   MaskedBatchNorm(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_shortcut else y


class MobileNetV2(nn.Module):
    """MobileNetV2 on NHWC (B, H, W, 3) float input; float32 logits (B,
    num_classes). Eval mode normalises with the running statistics; train
    mode with the batch's, updating the running ones as flax does, and
    draws its dropout from the ``generator`` passed to ``forward``."""

    def __init__(self, num_classes: int = 1000, alpha: float = 1.0,
                 dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.dropout = dropout
        in_ch = _make_divisible(32 * alpha)
        last = _make_divisible(1280 * alpha)
        features = [ConvBNReLU(3, in_ch, stride=2, generator=gen)]
        for t, c, n, s in CFG:
            out_ch = _make_divisible(c * alpha)
            for j in range(n):
                features.append(InvertedResidual(in_ch, out_ch,
                                                 s if j == 0 else 1, t,
                                                 generator=gen))
                in_ch = out_ch
        features.append(ConvBNReLU(in_ch, last, kernel=1, generator=gen))
        self.features = nn.Sequential(*features)
        linear = nn.Linear(last, num_classes)
        with torch.no_grad():
            linear.weight.normal_(0.0, 0.01, generator=gen)
        nn.init.zeros_(linear.bias)
        # the reference's Dropout is entry 0; here it is applied in forward,
        # with draws from the caller's generator
        self.classifier = nn.Sequential(nn.Identity(), linear)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.features(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        x = dropout(x, self.dropout, self.training, generator)
        return self.classifier(x)

    def tap_site(self, path: Union[str, Sequence[str]]
                 ) -> Tuple[nn.Module, str]:
        """(module, tap point) of ``head_conv.conv`` (the JAX module path;
        the port's ``features.18.0`` too): the head's 1x1 convolution's
        output before its BatchNorm, NHWC. Raises ValueError naming any
        other path."""
        name = path if isinstance(path, str) else ".".join(path)
        head = len(self.features) - 1
        if name in ("head_conv.conv", f"features.{head}.0"):
            return self.features[head], "conv"
        raise ValueError(f"target path {name!r} not found in model")
