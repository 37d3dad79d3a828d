"""Analytic FLOP accounting for the selective scan and the SS2D block.

The port's copy of ``medmamba_tpu/ops/flops.py`` (the port imports nothing
of the JAX package): closed-form multiply-accumulate counts, a
multiply-accumulate counted as one FLOP, as the reference's einsum-path
counter (``MedMamba.py:18-50``) halves ``np.einsum_path``'s figure.
``utils/profiling.py: model_flops_report`` sums them over a VSSM.
"""
from __future__ import annotations

import math


def flops_selective_scan(
    B: int = 1,
    L: int = 256,
    D: int = 768,
    N: int = 16,
    with_D: bool = True,
    with_Z: bool = False,
    with_Group: bool = True,
) -> float:
    """MAC count of one selective scan over (B, D, L) with state size N.

    Terms (cf. MedMamba.py:32-48):
      * discretization  exp(delta*A):        B*D*L*N
      * input injection delta*B*u:           B*D*L*N   (grouped;
                                             2x ungrouped)
      * recurrence h = dA*h + dBu:           B*D*L*N   per step fma
      * output contraction C.h:              B*D*L*N
      * D skip (+ optional z gate):          B*D*L each
    """
    flops = B * D * L * N                # delta * A
    flops += B * D * L * N * (1 if with_Group else 2)  # delta*B*u
    flops += L * (B * D * N + B * D * N)  # recurrence fma + C contraction
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L
    return float(flops)


def flops_ss2d(H: int, W: int, d_model: int, d_state: int = 16,
               expand: int = 2, dt_rank: int | None = None) -> float:
    """MACs of one SS2D block forward (projections + 4-direction scan),
    batch 1."""
    L = H * W
    d_inner = expand * d_model
    if dt_rank is None:
        dt_rank = math.ceil(d_model / 16)
    f = 0.0
    f += L * d_model * d_inner * 2                      # in_proj
    f += L * d_inner * 9                                # depthwise 3x3
    f += 4 * L * d_inner * (dt_rank + 2 * d_state)      # x_proj einsum
    f += 4 * L * dt_rank * d_inner                      # dt_proj einsum
    f += flops_selective_scan(1, L, 4 * d_inner, d_state)
    f += L * d_inner                                    # out_norm (approx)
    f += L * d_inner * d_model                          # out_proj
    return f
