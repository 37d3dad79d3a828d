"""CrossScan / CrossMerge: the 4-direction sequence construction of SS2D.

Counterpart of ``medmamba_tpu/ops/cross_scan.py``, on NHWC input:

  direction 0: row-major raster          (H major, W minor)
  direction 1: column-major raster       (W major, H minor; spatial transpose)
  direction 2: reverse of direction 0
  direction 3: reverse of direction 1

CrossMerge re-aligns the four output sequences to row-major order and sums
them; ``cross_merge(cross_scan(x))`` per direction is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rasters(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B, 2, D, L): row-major and column-major rasters."""
    b, h, w, d = x.shape
    x_hw = x.permute(0, 3, 1, 2).reshape(b, d, h * w)
    x_wh = x.permute(0, 3, 2, 1).reshape(b, d, h * w)
    return torch.stack([x_hw, x_wh], dim=1)


def cross_scan(x: torch.Tensor, flip: bool = True) -> torch.Tensor:
    """(B, H, W, D) -> (B, 4, D, L) with the 4 scan orders above.

    ``flip=False`` leaves directions 2/3 as unflipped copies of 0/1, for a
    scan that runs them in reverse itself (``reverse_dirs``).
    """
    fwd = _rasters(x)
    bwd = fwd.flip(-1) if flip else fwd
    return torch.cat([fwd, bwd], dim=1)


def cross_scan_fwd(x: torch.Tensor, pad_to: int = 0) -> torch.Tensor:
    """(B, H, W, D) -> (B, 2, D, L): directions 0 and 1 only.

    Directions 2/3 hold the same data in reverse, so one forward and one
    reverse scan over this tensor cover all four. ``pad_to`` > L zero-pads
    the sequence axis (the scan then takes ``valid_len``).
    """
    xs = _rasters(x)
    l = xs.shape[-1]
    if pad_to > l:
        xs = F.pad(xs, (0, pad_to - l))
    return xs


def cross_merge_fr(yf: torch.Tensor, yr: torch.Tensor, h: int, w: int
                   ) -> torch.Tensor:
    """Merge (B, 2, D, Lp) forward-scan and reverse-scan outputs (both in
    buffer order) into (B, D, L): un-transpose the column-major pair and sum
    all four. Padding past L = h*w is sliced off."""
    b, _, d, _ = yf.shape
    l = h * w
    y02 = (yf[:, 0] + yr[:, 0])[..., :l]
    y13 = (yf[:, 1] + yr[:, 1])[..., :l]
    y13 = y13.reshape(b, d, w, h).transpose(2, 3).reshape(b, d, l)
    return y02 + y13


def cross_merge(ys: torch.Tensor, h: int, w: int,
                flipped: bool = True) -> torch.Tensor:
    """(B, 4, D, L) scan outputs -> (B, D, L) sum of the four re-aligned
    sequences. ``flipped=False``: directions 2/3 arrive in buffer order."""
    b, k, d, l = ys.shape
    if k != 4 or l != h * w:
        raise ValueError(f"expected (B, 4, D, {h * w}), got {tuple(ys.shape)}")
    inv = ys[:, 2:4].flip(-1) if flipped else ys[:, 2:4]
    y02 = ys[:, 0] + inv[:, 0]
    y13 = ys[:, 1] + inv[:, 1]
    y13 = y13.reshape(b, d, w, h).transpose(2, 3).reshape(b, d, l)
    return y02 + y13
