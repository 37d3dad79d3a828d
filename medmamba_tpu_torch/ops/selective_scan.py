"""S6 selective scan: the plain PyTorch version and the public dispatcher.

Counterpart of ``medmamba_tpu/ops/selective_scan.py``, with the same layouts:

    u:      (B, KD, L)      float32 or bfloat16
    delta:  (B, KD, L)      (pre-bias, pre-softplus)
    A:      (KD, N)         float32, = -exp(A_logs)
    B, C:   (B, K, N, L)    grouped: channel d uses group d // (KD // K)
    D:      (KD,)           float32 skip connection
    delta_bias: (KD,)       float32

and the recurrence (per batch, channel d, state n):

    delta'_t = softplus(delta_t + delta_bias)
    h_t      = exp(delta'_t * A) * h_{t-1} + (delta'_t * B_t) * u_t
    y_t      = sum_n C_t[n] * h_t[n] + D * u_t

``selective_scan_ref`` is the plain version: a sequential float32 loop over L,
as ``selective_scan_seq`` is in the JAX package. ``selective_scan`` is the
entry point: on a CUDA tensor it launches the hand-written kernel
(``ops/scan_cuda.py``), on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from medmamba_tpu_torch.ops import scan_cuda


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       return_last_state: bool = False):
    """Sequential float32 scan (the numerical reference).

    Returns y (B, KD, L) float32 and, optionally, the last state (B, KD, N).
    """
    u = u.float()
    delta = delta.float()
    A = A.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    b, d, l = u.shape
    n = A.shape[1]
    g = B.shape[1]
    dpg = d // g
    # per-group views: the state is (B, G, dpg, N); B_t / C_t broadcast over dpg
    A4 = A.reshape(g, dpg, n)
    dt4 = delta.reshape(b, g, dpg, l)
    dtu4 = (delta * u).reshape(b, g, dpg, l)
    Bm = B.float()
    Cm = C.float()
    h = u.new_zeros((b, g, dpg, n))
    ys = []
    for t in range(l):
        dA = torch.exp(dt4[..., t, None] * A4)
        h = dA * h + dtu4[..., t, None] * Bm[:, :, None, :, t]
        ys.append((h * Cm[:, :, None, :, t]).sum(-1))
    y = torch.stack(ys, dim=-1).reshape(b, d, l)
    if D is not None:
        y = y + u * D.float()[None, :, None]
    if return_last_state:
        return y, h.reshape(b, d, n)
    return y


def _flip_groups(x: torch.Tensor, g: int, reverse_dirs) -> torch.Tensor:
    """Flip the flagged groups of a (B, G*per, L) or (B, G, N, L) tensor along L."""
    shape = x.shape
    x4 = x.reshape(shape[0], g, -1, shape[-1])
    parts = [x4[:, k:k + 1].flip(-1) if f else x4[:, k:k + 1]
             for k, f in enumerate(reverse_dirs)]
    return torch.cat(parts, dim=1).reshape(shape)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False,
                   impl: str = "auto",
                   reverse_dirs: Optional[Sequence[bool]] = None,
                   tau: Optional[int] = None,
                   u_tile: int = 1,
                   out_dtype=None,
                   valid_len: Optional[int] = None):
    """Selective scan with the JAX package's call-site contract.

    impl: "auto" launches the CUDA kernel on a CUDA tensor and runs the plain
    version on a CPU tensor; "ref" runs the plain version on any device.

    tau: accepted and ignored. It was the TPU kernel's segment length; both
    versions here compute the exact recurrence at any magnitude.

    reverse_dirs: per-group flags; a flagged group scans right to left and
    its y comes back in buffer order (the last state is then the state after
    position 0).

    u_tile: u carries ``G // u_tile`` groups of channels; scan group k reads u
    group ``k % (G // u_tile)``.

    out_dtype: y's dtype (float32 by default); the last state is float32.

    valid_len: positions >= valid_len are padding: dt = 0 there (decay 1,
    inject 0), so the state passes through them unchanged in either
    direction. Requires ``delta_softplus``.
    """
    if valid_len is not None and not delta_softplus:
        raise ValueError("valid_len requires delta_softplus semantics")
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown selective-scan impl {impl!r}")
    if impl == "auto" and u.is_cuda:
        return scan_cuda.selective_scan_fwd(
            u, delta, A, B, C, D, delta_bias, delta_softplus=delta_softplus,
            reverse_dirs=reverse_dirs, u_tile=u_tile, out_dtype=out_dtype,
            valid_len=valid_len, return_last_state=return_last_state)

    g = B.shape[1]
    if u_tile > 1:
        u = torch.cat([u] * u_tile, dim=1)
    if valid_len is not None and valid_len < u.shape[-1]:
        # softplus(-1e4 + bias) == 0 exactly in float32
        pos = torch.arange(u.shape[-1], device=u.device)
        delta = torch.where(pos < valid_len, delta,
                            torch.full_like(delta, -1e4))
    flip = reverse_dirs is not None and any(reverse_dirs)
    if flip:
        u, delta, B, C = (_flip_groups(x, g, reverse_dirs)
                          for x in (u, delta, B, C))
    y, last = selective_scan_ref(u, delta, A, B, C, D, delta_bias,
                                 delta_softplus, return_last_state=True)
    if flip:
        y = _flip_groups(y, g, reverse_dirs)
    y = y.to(out_dtype or torch.float32)
    return (y, last) if return_last_state else y
