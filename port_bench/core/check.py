"""The numbers that decide ``correct``: the program against the plain
reference, each with the limit of the cell's ``limits/<cell>.json``.

Training (the first steps of the object the window drives, against the
reference's same steps from the same weights, batches and draws):

* ``loss_gap``: the largest relative gap of a step's loss.
* ``grad_median_gap``: the first gradient as the optimizer got it
  (AdamW's first moment after one step, over 1 - beta1), by the median
  leaf: per leaf, the gap between the program's norm and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger. Not the worst leaf: a few leaves' gradients
  are sums that all but cancel (the first BatchNorm of a conv branch,
  whose shift the next BatchNorm removes except at the borders), and
  bfloat16 blocks move them by 10-22% on every seed (PERF.md, §6).
* ``grad_ss2d_gap``: the same first gradient by the worst leaf of the
  SS2D modules (``.self_attention.``: in_proj, the depthwise conv, x_proj,
  dt_projs, A_logs, Ds, out_norm, out_proj), measured as above. The
  scan's backward (K2) writes the gradients of A_logs, Ds and the time-
  step bias itself and feeds the rest of them, a minority of all leaves
  that the median leaf does not see.
* ``grad_scan_gap``: the same first gradient by the worst of the counted
  leaves whose gradient K2 writes itself (A_logs, Ds, dt_projs_bias: its
  dA, dD and time-step-bias sums), each gap over that leaf's own
  reference norm: Ds is under a hundredth of the median leaf, so against
  the median leaf a fault in it reads below the rounding of bfloat16
  blocks elsewhere. At the initial weights the scan's state path is about
  a thousandth of its skip path (D u), so A_logs, dt_projs and x_proj get
  gradients of 1e-10 to 1e-7 of the median leaf and ``NOUGHT`` leaves
  them out: only Ds is counted here (PERF.md, §6).
* ``change_gap``: each parameter's change over the steps, by the worst
  leaf, measured as above.

Leaves whose reference gradient is under ``NOUGHT`` of the median leaf's
move under Adam by round-off alone (a convolution's bias in front of a
BatchNorm); both gaps leave them out.

Evaluation: ``prob_gap``, the largest gap of a log-probability between
what reached the host and the reference's, over every answer of the
sampled batches.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

NOUGHT = 1e-3
SS2D = ".self_attention."
SCAN_LEAVES = (".A_logs", ".Ds", ".dt_projs_bias")


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {n: float(g.norm()) for n, g in ref_grads.items()}
    floor = NOUGHT * statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= floor]


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    gn = {n: float(got[n].double().norm()) for n in names}
    wn = {n: float(want[n].double().norm()) for n in names}
    med = statistics.median(wn.values())
    return {n: abs(gn[n] - wn[n]) / max(wn[n], med) for n in names}


def own_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over its own reference norm."""
    out = {}
    for n in names:
        w = float(want[n].double().norm())
        out[n] = abs(float(got[n].double().norm()) - w) / w
    return out


def train_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Per leaf, the gradient's and the change's gap (``leaf_gaps``) of
    the counted leaves, and the gradient's over each leaf's own norm
    (``own_gaps``). ``prog`` and ``ref`` hold ``losses``, ``grads`` (the
    first step's, by leaf) and ``change`` (each leaf's change over the
    steps)."""
    names = counted_leaves(ref["grads"])
    return {"grad": leaf_gaps(prog["grads"], ref["grads"], names),
            "grad_own": own_gaps(prog["grads"], ref["grads"], names),
            "change": leaf_gaps(prog["change"], ref["change"], names)}


def train_checks(prog: dict, ref: dict,
                 gaps: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The numbers compared, from ``train_gaps(prog, ref)``."""
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_median_gap": statistics.median(gaps["grad"].values()),
            "grad_ss2d_gap": max(v for n, v in gaps["grad"].items()
                                 if SS2D in n),
            "grad_scan_gap": max(v for n, v in gaps["grad_own"].items()
                                 if n.endswith(SCAN_LEAVES)),
            "change_gap": max(gaps["change"].values())}


def prob_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double().log() - want.double().log()).abs().max())
