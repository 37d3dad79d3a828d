"""Sequence-parallel selective scan: L split over the ranks of a group.

Counterpart of ``medmamba_tpu/ops/seq_parallel.py``. MedMamba itself never
needs it (its longest stage is L = 3136, and the scan's state is a small
(d_inner, d_state) carry), but it scales the scan to long sequences: a
1024^2 image gives L = 65536 a direction. Each rank holds a contiguous
slice of L, in rank order, and:

  1. scans its slice from state 0, keeping the last state:
         y_loc, h_last_r = scan(u_r, ...)        (K1 on the card)
  2. forms the per-position decay prefixes P_t = prod_{s<=t} exp(A dt_s) as
     a cumulative product of decays in (0, 1], which can only underflow to
     0 (a fully decayed incoming state, the right limit), never overflow;
  3. gathers every rank's (h_last, T = P at its slice's end) with one
     all-gather and forms its incoming state by the exclusive combine
         h_in_r = sum_{q<r} (prod_{q<s<r} T_s) h_last_q,
     looped over the ranks; the full combine gives the final state, the
     same on every rank;
  4. corrects its y by the rank-1 update y_t += sum_n C_t[n] P_t[n] h_in[n].

The stitch (steps 2-4) is plain PyTorch, as it is plain XLA in the JAX
module; no kernel of the TPU package does it. ``impl="auto"`` runs the
local scan through ``ops.selective_scan`` (K1 on a CUDA tensor, K3 under
``MEDMAMBA_SCAN_KERNEL=hillis``), which is forward-only here: the local
scan's last state feeds the stitch, and the kernels do not differentiate
it (a backward raises, as JAX's Pallas path cannot be differentiated).
``impl="ref"`` runs the plain scan, differentiable through the stitch and
the all-gather: the JAX module's ``"pallas"`` / ``"assoc"`` split.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from medmamba_tpu_torch.ops.selective_scan import selective_scan
from medmamba_tpu_torch.parallel.mesh import all_gather


def selective_scan_seq_parallel(u: torch.Tensor, delta: torch.Tensor,
                                A: torch.Tensor, B: torch.Tensor,
                                C: torch.Tensor,
                                D: Optional[torch.Tensor] = None,
                                delta_bias: Optional[torch.Tensor] = None,
                                delta_softplus: bool = False, *, mesh=None,
                                group=None, seq_dim: str = "data",
                                impl: str = "auto",
                                return_last_state: bool = False):
    """Selective scan (forward direction) with L split over ``group`` (or
    the ``seq_dim`` axis of ``mesh``).

    Arguments follow ``ops.selective_scan``, each rank passing its slice of
    L: ``u``/``delta`` (B, D, L_r), ``B``/``C`` (B, G, N, L_r), the slices
    in rank order. Returns this rank's y (B, D, L_r) in u's dtype and, with
    ``return_last_state``, the final state of the whole sequence (B, D, N),
    float32, the same on every rank.
    """
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown selective-scan impl {impl!r}")
    if group is None:
        if mesh is None:
            raise ValueError("selective_scan_seq_parallel needs a mesh or "
                             "a group")
        group = mesh.get_group(seq_dim)
    y_loc, h_last = selective_scan(u, delta, A, B, C, D, delta_bias,
                                   delta_softplus, return_last_state=True,
                                   impl=impl, out_dtype=u.dtype)

    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, :, None]
    if delta_softplus:
        dt = F.softplus(dt)
    # P_t as a linear-space cumulative product of per-step decays in (0, 1]
    prefix = torch.cumprod(torch.exp(A.float()[None, :, :, None]
                                     * dt[:, :, None, :]), dim=-1)
    # the boundary summaries, (S, b, d, n) each, in one all-gather
    summaries = all_gather(torch.stack([h_last.float(), prefix[..., -1]]),
                           group)
    h_all, t_all = summaries[:, 0], summaries[:, 1]

    n_ranks = dist.get_world_size(group)
    # every rank's summaries enter its graph (masked where they do not
    # count), so every rank runs the all-gathers' backward collectives
    before = torch.arange(n_ranks, device=h_all.device) < dist.get_rank(group)
    h_in = h_fin = torch.zeros_like(h_all[0])
    for r in range(n_ranks):
        h_in = torch.where(before[r], t_all[r] * h_in + h_all[r], h_in)
        h_fin = t_all[r] * h_fin + h_all[r]

    b, d, n, l = prefix.shape
    g = C.shape[1]
    corr = torch.einsum("bgnl,bgdnl,bgdn->bgdl", C.float(),
                        prefix.reshape(b, g, d // g, n, l),
                        h_in.reshape(b, g, d // g, n)).reshape(b, d, l)
    y = (y_loc.float() + corr).to(y_loc.dtype)
    return (y, h_fin) if return_last_state else y
