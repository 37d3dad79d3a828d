"""Vision Transformer CAM backbone in PyTorch (NHWC at the public interface).

Counterpart of ``medmamba_tpu/models/vit.py`` (itself the reference's
``grad_cam/vit_model.py``): the same modules, factories and arithmetic --
qkv reshaped (b, n, 3, heads, hd), the plain product ``softmax(q k^T /
sqrt(hd)) v`` (not ``scaled_dot_product_attention``), exact-erf GELU,
LayerNorm eps 1e-6, the cls token before the patches, a tanh
``pre_logits`` when ``representation_size`` is set, and a head initialised
to zeros (so a randomly initialised ViT gives zero logits, and a CAM of all
zeros, in both packages).

Submodule names follow the reference state dict (``patch_embed.proj``,
``blocks.{i}.norm1``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1``,
``pre_logits.fc``, ``head`` ...), so a reference ``.pth`` loads with
``strict=True``. Parameters are drawn from an explicit ``torch.Generator``
(seed 0 when none is given), on the CPU. Dropout and drop path act only in
training, with draws from the ``generator`` passed to ``forward``.

Grad-CAM reads ``blocks_{i}.norm1`` (the JAX module path ``cam_backbones``
targets) through the block's taps (:meth:`VisionTransformer.tap_site`).
"""
from __future__ import annotations

import collections
import re
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from medmamba_tpu_torch.models.vssm import DropPath, _tap, trunc_normal_02


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` (drawn from ``generator``) and scaled by
    ``1 / (1 - rate)``; the identity in eval mode or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _dense(d_in: int, d_out: int, gen: torch.Generator,
           bias: bool = True) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=bias)
    trunc_normal_02(layer.weight, gen)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class PatchEmbed(nn.Module):
    """p x p patches, stride p, no padding: (B, H, W, 3) -> (B, n, C)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, *,
                 generator: torch.Generator):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        trunc_normal_02(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention as the plain product. ``bias`` is added to
    the scaled logits (broadcast over (B, heads, n, n)); ``mask`` (nW, n,
    n) is added per window, the batch holding B x nW windows (Swin's
    shifted windows)."""

    def __init__(self, dim: int, num_heads: int = 12, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = _dense(dim, 3 * dim, generator, bias=qkv_bias)
        self.proj = _dense(dim, dim, generator)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        if bias is not None:
            attn = attn + bias
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(b, h, n, n)
        attn = dropout(attn.softmax(-1), self.attn_drop, self.training,
                       generator)
        x = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return dropout(self.proj(x), self.proj_drop, self.training, generator)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout, back to ``dim``."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.drop = drop
        self.fc1 = _dense(dim, hidden, generator)
        self.fc2 = _dense(hidden, dim, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(F.gelu(self.fc1(x)), self.drop, self.training, generator)
        return dropout(self.fc2(x), self.drop, self.training, generator)


class Block(nn.Module):
    """Pre-norm transformer block. Grad-CAM tap "norm1": norm1's output."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, attn_drop=attn_drop,
                              proj_drop=drop, generator=generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, generator=generator)
        self.taps = {}

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.norm1(x)
        if self.taps:
            y = _tap(self.taps, "norm1", y)
        y = self.attn(y, generator=generator)
        x = x + self.drop_path(y, self.drop_path.sample(x.shape[0], generator,
                                                        x.device))
        y = self.mlp(self.norm2(x), generator)
        return x + self.drop_path(y, self.drop_path.sample(x.shape[0],
                                                           generator, x.device))


class VisionTransformer(nn.Module):
    """ViT on NHWC (B, img_size, img_size, 3) float input; float32 logits
    (B, num_classes), or the pooled features when ``num_classes`` is 0.
    ``img_size`` fixes the length of ``pos_embed`` (the JAX module takes it
    from its first input)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_classes: int = 1000,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 representation_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.depth = depth
        self.drop_rate = drop_rate
        n = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, generator=gen)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, embed_dim))
        trunc_normal_02(self.pos_embed, gen)
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, drop_rate, attn_drop_rate,
                  dpr[i], generator=gen) for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        width = embed_dim
        self.pre_logits = None
        if representation_size:
            self.pre_logits = nn.Sequential(collections.OrderedDict([
                ("fc", _dense(embed_dim, representation_size, gen)),
                ("act", nn.Tanh())]))
            width = representation_size
        self.head = None
        if num_classes > 0:
            self.head = nn.Linear(width, num_classes)
            nn.init.zeros_(self.head.weight)
            nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = dropout(x, self.drop_rate, self.training, generator)
        for blk in self.blocks:
            x = blk(x, generator)
        x = self.norm(x)[:, 0]
        if self.pre_logits is not None:
            x = self.pre_logits(x)
        return self.head(x) if self.head is not None else x

    def tap_site(self, path: Union[str, Sequence[str]]
                 ) -> Tuple[nn.Module, str]:
        """(module, tap point) of ``blocks_{i}.norm1`` (the JAX module path;
        the port's ``blocks.{i}.norm1`` too): the token activation (B,
        1 + n, C). Raises ValueError naming any other path."""
        name = path if isinstance(path, str) else ".".join(path)
        m = re.fullmatch(r"blocks[._](\d+)\.norm1", name)
        if m and int(m.group(1)) < len(self.blocks):
            return self.blocks[int(m.group(1))], "norm1"
        raise ValueError(f"target path {name!r} not found in model")


def vit_reshape_transform(tokens: torch.Tensor, grid: int = 14
                          ) -> torch.Tensor:
    """Drop the cls token and reshape to (B, grid, grid, C) for Grad-CAM
    (grad_cam/main_vit.py:11-30 analogue, NHWC)."""
    b, _, c = tokens.shape
    return tokens[:, 1:].reshape(b, grid, grid, c)


# Factories mirroring grad_cam/vit_model.py:290-409
def vit_base_patch16_224(num_classes=1000, **kw):
    return VisionTransformer(patch_size=16, embed_dim=768, depth=12,
                             num_heads=12, num_classes=num_classes, **kw)


def vit_base_patch32_224(num_classes=1000, **kw):
    return VisionTransformer(patch_size=32, embed_dim=768, depth=12,
                             num_heads=12, num_classes=num_classes, **kw)


def vit_large_patch16_224(num_classes=1000, **kw):
    return VisionTransformer(patch_size=16, embed_dim=1024, depth=24,
                             num_heads=16, num_classes=num_classes, **kw)


def vit_large_patch32_224(num_classes=1000, **kw):
    return VisionTransformer(patch_size=32, embed_dim=1024, depth=24,
                             num_heads=16, num_classes=num_classes, **kw)


def vit_huge_patch14_224(num_classes=1000, **kw):
    return VisionTransformer(patch_size=14, embed_dim=1280, depth=32,
                             num_heads=16, num_classes=num_classes, **kw)
