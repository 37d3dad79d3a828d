"""The numbers that decide a language-model training cell's ``correct``:
the program's first steps against the plain reference's
(``reference/jamba.py``), each with the limit of ``limits/<cell>.json``.
The per-leaf gaps are ``core/check.py``'s (``counted_leaves``,
``leaf_gaps``, ``own_gaps``), over each leaf's norm:

* ``loss_gap``: the largest relative gap of a step's loss.
* ``grad_median_gap``: the first gradient (AdamW's first moment after one
  step, over 1 - beta1) by the median counted leaf.
* ``grad_ss2d_gap``: the same first gradient by the worst leaf of the
  sequence mixers (``.mamba.`` and ``.self_attn.``), the place of SS2D in
  the VSSM cells: a fault in the attention's mask or in a mixer's norms
  moves a few leaves that the median does not see.
* ``grad_scan_gap``: the same first gradient by the worst of the leaves
  whose gradient the scan's backward (K2) writes itself (``A_log``, ``D``,
  ``dt_proj.bias``), each over its own norm.
* ``change_gap``: each parameter's change over the steps, by the worst
  leaf.

The program's side hands in norms, not tensors: ``grads`` and ``change``
map each leaf to a 0-dim tensor holding its norm, which is what the gaps
read, so the program never holds a second copy of its 1.6 billion
parameters.
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

from port_bench.core import check

MIXERS = (".mamba.", ".self_attn.")
SCAN_LEAVES = (".A_log", ".D", ".dt_proj.bias")


def norm(x: torch.Tensor) -> torch.Tensor:
    """The float64 norm of ``x``, a 0-dim tensor."""
    return torch.linalg.vector_norm(x, dtype=torch.float64)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: norm(t) for n, t in tensors.items()}


def train_checks(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared. ``prog`` and ``ref`` hold ``losses``,
    ``grads`` (the first step's, by leaf) and ``change`` (each leaf's
    change over the steps), as tensors or as norms (:func:`norms`)."""
    names = check.counted_leaves(ref["grads"])
    grad = check.leaf_gaps(prog["grads"], ref["grads"], names)
    own = check.own_gaps(prog["grads"], ref["grads"], names)
    change = check.leaf_gaps(prog["change"], ref["change"], names)
    return {"loss_gap": check.loss_gap(prog["losses"], ref["losses"]),
            "grad_median_gap": statistics.median(grad.values()),
            "grad_ss2d_gap": max(v for n, v in grad.items()
                                 if any(m in n for m in MIXERS)),
            "grad_scan_gap": max(v for n, v in own.items()
                                 if n.endswith(SCAN_LEAVES)),
            "change_gap": max(change.values())}
