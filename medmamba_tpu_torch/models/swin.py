"""Swin Transformer CAM backbone in PyTorch (NHWC at the public interface).

Counterpart of ``medmamba_tpu/models/swin.py`` (itself the reference's
``grad_cam/swin_model.py``). It keeps the reference quirk that the JAX
module keeps (its ``swin.py:95-98``): each block pads the map up to the
window and applies the cyclic shift even where the window covers the whole
map, so at 224^2 Swin-T's last stage (7 x 7, window 7, shift 3) runs a live
mask; official Swin would drop the shift there. Regions differ by -100 in
the mask, and the relative-position bias is gathered from its table by the
relative index; both index and mask are recomputed, never loaded.
Downsampling is the port's ``PatchMerging2D``, as the JAX module reuses
``vssm.PatchMerging2D``; the MLP is the ViT's; LayerNorm eps is 1e-5.

Names follow the reference state dict (``patch_embed.proj``,
``patch_embed.norm``, ``layers.{i}.blocks.{j}.attn.qkv``,
``layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``layers.{i}.downsample.reduction``, ``norm``, ``head``); a reference
``.pth``, which also holds each block's ``relative_position_index``
buffer, loads with ``strict=True``. Grad-CAM reads ``norm`` (NHWC, the
JAX module path ``cam_backbones`` targets) through the model's taps.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medmamba_tpu_torch.models.vit import Attention, Mlp, _dense, dropout
from medmamba_tpu_torch.models.vssm import (DropPath, PatchEmbed2D,
                                            PatchMerging2D, _tap,
                                            trunc_normal_02)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B*nW, ws, ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))  # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, n, n)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (n, n)


def _attn_mask(hp: int, wp: int, ws: int, ss: int) -> np.ndarray:
    """float32 (nW, ws^2, ws^2): -100 between the regions a shift by ``ss``
    brings into one window of the padded (hp, wp) map, 0 within one."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[:, hsl, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, hp // ws, ws, wp // ws, ws, 1) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(Attention):
    """Attention within a window plus the relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, generator: torch.Generator):
        super().__init__(dim, num_heads, qkv_bias, attn_drop, proj_drop,
                         generator=generator)
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, num_heads))
        trunc_normal_02(self.relative_position_bias_table, generator)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(ws).reshape(-1)),
            persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference keeps the index as a buffer; here it is recomputed
        state_dict.pop(prefix + "relative_position_index", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = x.shape[1]
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, -1).permute(2, 0, 1)
        return super().forward(x, bias[None], mask, generator)


class SwinBlock(nn.Module):
    """(Shifted-)window attention block on an NHWC map."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size,
                                    attn_drop=attn_drop, proj_drop=drop,
                                    generator=generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, generator=generator)
        self._masks = {}      # (hp, wp, device) -> the shift's mask

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_attn_mask(
                hp, wp, self.window_size, self.shift_size)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        pad_b = (ws - h % ws) % ws
        pad_r = (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        win = window_partition(x, ws).reshape(-1, ws * ws, c)
        win = self.attn(win, mask, generator)
        x = window_reverse(win.reshape(-1, ws, ws, c), ws, hp, wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        x = shortcut + self.drop_path(x, self.drop_path.sample(b, generator,
                                                               x.device))
        y = self.mlp(self.norm2(x), generator)
        return x + self.drop_path(y, self.drop_path.sample(b, generator,
                                                           x.device))


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks, every other one shifted by half a
    window, then PatchMerging2D except after the last stage."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, drop: float,
                 attn_drop: float, drop_path: Sequence[float],
                 downsample: bool, *, generator: torch.Generator):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if j % 2 == 0 else window_size // 2, mlp_ratio, drop,
                      attn_drop, drop_path[j], generator=generator)
            for j in range(depth))
        self.downsample = (PatchMerging2D(dim, generator=generator)
                           if downsample else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, generator)
        return self.downsample(x) if self.downsample is not None else x


class SwinTransformer(nn.Module):
    """Swin on NHWC (B, H, W, 3) float input; float32 logits (B,
    num_classes). Grad-CAM tap "norm": the final LayerNorm's NHWC output."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed2D(patch_size, embed_dim, generator=gen)
        trunc_normal_02(self.patch_embed.proj.weight, gen)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depth, num_heads[i], window_size,
                       mlp_ratio, drop_rate, attn_drop_rate,
                       dpr[sum(depths[:i]):sum(depths[:i + 1])],
                       downsample=i < len(depths) - 1, generator=gen)
            for i, depth in enumerate(depths))
        width = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(width, eps=1e-5)
        self.head = _dense(width, num_classes, gen)
        self.taps = {}

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.patch_embed(x), self.drop_rate, self.training,
                    generator)
        for layer in self.layers:
            x = layer(x, generator)
        x = self.norm(x)
        if self.taps:
            x = _tap(self.taps, "norm", x)
        return self.head(x.mean(dim=(1, 2)))

    def tap_site(self, path: Union[str, Sequence[str]]
                 ) -> Tuple[nn.Module, str]:
        """(module, tap point) of ``norm`` (the JAX module path, and the
        port's name): the final NHWC map. Raises ValueError naming any
        other path."""
        name = path if isinstance(path, str) else ".".join(path)
        if name == "norm":
            return self, "norm"
        raise ValueError(f"target path {name!r} not found in model")


# Factories mirroring grad_cam/swin_model.py:567-678
def swin_tiny_patch4_window7_224(num_classes=1000, **kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24),
                           num_classes=num_classes, **kw)


def swin_small_patch4_window7_224(num_classes=1000, **kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 18, 2),
                           num_heads=(3, 6, 12, 24),
                           num_classes=num_classes, **kw)


def swin_base_patch4_window7_224(num_classes=1000, **kw):
    return SwinTransformer(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32),
                           num_classes=num_classes, **kw)


def swin_large_patch4_window7_224(num_classes=1000, **kw):
    return SwinTransformer(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48),
                           num_classes=num_classes, **kw)
