"""Training traffic: the graphed train step, as ``cli/train.py`` runs it.

Set-up builds one training object (the model with the benchmark's
weights, AdamW and the step compiled by ``compile_train_step``) and drives
it through its first ``check_steps`` steps on distinct pool batches,
through the same call and feed as the window: the pool's pinned host
batches go to the card through ``device_prefetch`` with ``shard_batch``,
the loss is cloned and read two steps late. The first step's gradient (as
AdamW's first moment holds it) and every parameter's change after those
steps are kept. The window then drives the same object on: a closed loop
over the pool.

After the window, the program's state is freed and the plain reference
(``reference/vssm.py``) takes the same steps from the same weights,
batches and draws; ``core/check.py`` compares them.
"""
from __future__ import annotations

import collections
import itertools
import time

import torch

from port_bench.core import check, faults, harness
from port_bench.modes import common
from port_bench.reference import vssm as ref


def run(cell: harness.Cell) -> harness.Outcome:
    if cell.chips != 1:
        raise ValueError("the training traffic runs on one card")
    with faults.planted(cell.fault):
        return _run(cell)


def _run(cell: harness.Cell) -> harness.Outcome:
    from medmamba_tpu_torch.data.loader import device_prefetch
    from medmamba_tpu_torch.parallel.mesh import shard_batch
    from medmamba_tpu_torch.train.trainer import (compile_train_step,
                                                  make_optimizer)

    cfg, tr = cell.config, cell.traffic
    device = common.card()
    common.mark(cell.t0, "program imported, card up")
    seeds = common.sub_seeds(cell.seed)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    model = common.port_model(cfg, tr["block_dtype"], weights, device)
    common.mark(cell.t0, "weights made, model built")
    opt, _ = make_optimizer(model.parameters(), tr["lr"], npz_mode=False)
    if opt.param_groups[0]["weight_decay"] != tr["weight_decay"]:
        raise RuntimeError("the program's AdamW decay is not the recipe's")
    beta1 = opt.param_groups[0]["betas"][0]
    gen = torch.Generator(device=device).manual_seed(seeds["draws"])
    step = compile_train_step(model, opt, generator=gen)
    images, labels = common.pool(cfg, tr, seeds["data"], device)
    host = [(images[i].cpu().pin_memory(), labels[i].cpu().pin_memory())
            for i in range(tr["pool"])]
    del images, labels
    common.mark(cell.t0, "pool made")
    feed = device_prefetch(
        (host[i] for i in itertools.cycle(range(tr["pool"]))),
        lambda im, lb: shard_batch(None, im, lb, device=device),
        device=device)
    static = dict(augment=tr["augment"], image_size=cfg["image_size"])
    pending, losses = collections.deque(), []

    def one_step():
        im, lb = next(feed)
        pending.append(step(im, lb, **static).clone())
        if len(pending) > 2:
            losses.append(float(pending.popleft()))

    # the first steps, kept for the comparison
    first, grads = [], None
    for k in range(tr["check_steps"]):
        im, lb = next(feed)
        first.append(step(im, lb, **static).clone())
        if k == 0:
            torch.cuda.synchronize(device)
            common.mark(cell.t0, "step captured and run once")
            # a parameter the optimizer holds no moment of has not moved
            grads = {n: opt.state[p]["exp_avg"] / (1 - beta1)
                     if "exp_avg" in opt.state.get(p, {})
                     else torch.zeros_like(p)
                     for n, p in model.named_parameters()}
    change = {n: p.detach() - weights[n]
              for n, p in model.named_parameters()}
    torch.cuda.synchronize(device)
    setup_s = time.time() - cell.t0

    ctx = dict(config=cfg, traffic=tr, chips=cell.chips,
               batch=tr["batch"], block_dtype=tr["block_dtype"])
    e2e = {"setup_s": setup_s}
    if cell.trace:
        ctx["trace"], attempted = common.traced(one_step, tr["trace_steps"],
                                                device)
    else:
        attempted, window_s = common.timed(one_step, cell.seconds, device)
        e2e["train_img_per_s"] = attempted * tr["batch"] / window_s
    while pending:
        losses.append(float(pending.popleft()))
    dev = common.device_record(device, cell.chips, ctx.get("trace"))

    prog = dict(losses=[float(x) for x in first],
                grads={n: g.detach().clone() for n, g in grads.items()},
                change=change)
    step.free()
    del step, model, opt, feed, host, gen, grads, first
    torch.cuda.empty_cache()

    images, labels = common.pool(cfg, tr, seeds["data"], device)
    rgen = torch.Generator(device=device).manual_seed(seeds["draws"])
    with common.tf32(False):
        r_losses, r_grads, r_params = ref.train_steps(
            weights, [(images[i], labels[i])
                      for i in range(tr["check_steps"])],
            cfg, gen=rgen, lr=tr["lr"], weight_decay=tr["weight_decay"])
    reference = dict(losses=r_losses, grads=r_grads,
                     change={n: r_params[n] - weights[n] for n in r_params})
    ctx["leaf_gaps"] = check.train_gaps(prog, reference)
    gaps = check.train_checks(prog, reference, ctx["leaf_gaps"])
    bad = sum(1 for x in losses if x != x or abs(x) == float("inf"))
    checks = [(n, v, cell.limits[n]) for n, v in gaps.items()]
    checks.append(("nonfinite_losses", bad, 0))
    return harness.Outcome(e2e, checks, attempted, bad, dev, ctx)
