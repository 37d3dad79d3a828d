"""The control of each cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the cell
states, and compared with the reference as the program is.

* Training with bfloat16 blocks: the reference in float8 training's
  rounding (``reference/vssm.py: FP8``): every operand of its matrix
  products and convolutions rounded to e4m3, and the gradient reaching
  each product's output to e5m2.
* Evaluation in float32 without TF32: the reference with TF32 on.

The benchmark's runs never run it; ``calibrate.py`` and
``tests/test_port_bench_control.py`` do, on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from port_bench.core import check
from port_bench.modes import common
from port_bench.reference import vssm as ref


def train_readings(cfg: dict, tr: dict, seed: int, device,
                   leaves: bool = False) -> Dict[str, float]:
    """The control's numbers; with ``leaves``, also its per-leaf gaps
    (``check.train_gaps``) under ``leaf_gaps``."""
    seeds = common.sub_seeds(seed)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    images, labels = common.pool(cfg, tr, seeds["data"], device)
    batches = [(images[i], labels[i]) for i in range(tr["check_steps"])]
    runs = []
    with common.tf32(False):
        for quant in (None, ref.FP8):
            gen = torch.Generator(device=device).manual_seed(seeds["draws"])
            losses, grads, params = ref.train_steps(
                weights, batches, cfg, gen=gen, lr=tr["lr"],
                weight_decay=tr["weight_decay"], quant=quant)
            runs.append(dict(losses=losses, grads=grads,
                             change={n: params[n] - weights[n]
                                     for n in params}))
            del grads, params
    gaps = check.train_gaps(runs[1], runs[0])
    out = check.train_checks(runs[1], runs[0], gaps)
    if leaves:
        out["leaf_gaps"] = gaps
    return out


def eval_readings(cfg: dict, tr: dict, seed: int, device,
                  leaves: bool = False) -> Dict[str, float]:
    """The control's number over the batches a run compares (``leaves``
    has nothing to add here)."""
    seeds = common.sub_seeds(seed)
    state = {**ref.make_weights(cfg, seeds["weights"], device),
             **ref.batch_norm_buffers(cfg, device)}
    images, _ = common.pool(cfg, tr, seeds["data"], device)
    gap = 0.0
    for i in common.compared_batches(tr, seeds):
        with common.tf32(False):
            want = ref.probabilities(state, images[i], cfg)
        with common.tf32(True):
            got = ref.probabilities(state, images[i], cfg)
        gap = max(gap, check.prob_gap(got, want))
    return {"prob_gap": gap}


READINGS = {"train": train_readings, "eval": eval_readings}
