"""The benchmark's own count of work, and the card's peaks.

Copied from the program's analytic counts (``ops/flops.py:
flops_selective_scan``, ``flops_ss2d``; ``utils/profiling.py:
model_flops_report``), not imported, so a later change to the program
cannot move the yardstick. Those count a multiply-accumulate as one; here
:func:`model_macs` keeps that count and every FLOP figure is 2 per MAC.

A training step is counted as three forwards (the backward as two), the
usual convention of model FLOP utilisation; recomputed work is not counted.

The scan's work per launch (:func:`scan_launches`) comes from the shapes of
the scan op's operands: each input byte read once, each output byte
written once, whatever the kernel reads again.
"""
from __future__ import annotations

import math
from typing import Dict, List

# NVIDIA H100 SXM, published dense rates (data sheet), at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
TRAIN_FORWARDS = 3          # forward + backward counted as two forwards


def scan_macs(b: int, l: int, d: int, n: int) -> float:
    """MACs of one selective scan over (b, d, l), state size n, grouped
    B/C, with the D skip: exp(dt A), dt B u, the recurrence and C.h (one
    each per state), and D u."""
    return float(4 * b * d * l * n + b * d * l)


def ss2d_macs(h: int, w: int, d_model: int, d_state: int) -> float:
    """MACs of one SS2D forward on one image."""
    l = h * w
    d_inner = 2 * d_model
    r = math.ceil(d_model / 16)
    return (l * d_model * d_inner * 2                   # in_proj
            + l * d_inner * 9                           # depthwise 3x3
            + 4 * l * d_inner * (r + 2 * d_state)       # x_proj
            + 4 * l * r * d_inner                       # dt_proj
            + scan_macs(1, l, 4 * d_inner, d_state)
            + l * d_inner                               # out_norm
            + l * d_inner * d_model)                    # out_proj


def model_macs(cfg: dict) -> float:
    """MACs of one image's forward through the VSSM of ``cfg``."""
    h = w = cfg["image_size"] // cfg["patch_size"]
    dims = cfg["dims"]
    total = float(h * w * dims[0] * 3 * cfg["patch_size"] ** 2)
    for i, (depth, dim) in enumerate(zip(cfg["depths"], dims)):
        half = dim // 2
        total += depth * (ss2d_macs(h, w, half, cfg["d_state"])
                          + h * w * (half * half * 9 * 2 + half * half))
        if i < len(dims) - 1:
            total += (h // 2) * (w // 2) * (4 * dim) * (2 * dim)
            h, w = h // 2, w // 2
    return total + dims[-1] * cfg["num_classes"]


def step_flops(cfg: dict, images: int, train: bool) -> float:
    """FLOPs of a forward (or, with ``train``, a training step) over
    ``images`` images, 2 per MAC."""
    return 2.0 * model_macs(cfg) * images * (TRAIN_FORWARDS if train else 1)


def scan_launches(cfg: dict, batch: int, block_dtype: str
                  ) -> List[Dict[str, float]]:
    """Each scan launch of one forward: per block two (the row/column pair
    forward, then in reverse), with its operands' shapes. Returns, per
    launch, the forward's and the backward's bytes and FLOPs.

    Forward reads u, delta (b, 2 Di, L) and B, C (b, 2, N, L) in the block
    dtype, A (2 Di, N), D and the dt bias (2 Di) in float32, and writes y
    (b, 2 Di, L) in the block dtype. The backward reads those inputs and
    y's gradient and writes a gradient of each input; its FLOPs are
    counted as twice the forward's."""
    e = DTYPE_BYTES[block_dtype]
    n = cfg["d_state"]
    h = w = cfg["image_size"] // cfg["patch_size"]
    out = []
    for i, (depth, dim) in enumerate(zip(cfg["depths"], cfg["dims"])):
        l = h * w
        d2 = 2 * dim                       # two directions of d_inner = dim
        act = batch * d2 * l * e           # u, delta, y, and their grads
        bc = batch * 2 * n * l * e         # B, C
        params = (d2 * n + 2 * d2) * 4     # A, D, dt bias (float32)
        fwd_bytes = 2 * act + 2 * bc + params + act
        bwd_bytes = (2 * act + 2 * bc + params + act) + (2 * act + 2 * bc
                                                         + params)
        fwd_flops = 2.0 * scan_macs(batch, l, d2, n)
        for _ in range(2 * depth):
            out.append(dict(fwd_bytes=fwd_bytes, fwd_flops=fwd_flops,
                            bwd_bytes=bwd_bytes, bwd_flops=2 * fwd_flops))
        if i < len(cfg["depths"]) - 1:
            h, w = h // 2, w // 2
    return out


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
