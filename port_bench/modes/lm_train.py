"""Language-model training traffic: the port's graphed token step
(``train/trainer.py: compile_lm_train_step``) on a causal LM that the
port's registry builds (``models/registry.py: create_lm``).

Set-up builds the model at the configuration's sizes, fills it with the
benchmark's weights (``reference/jamba.py: make_weights``, drawn on the
card from the seed), makes AdamW and the compiled step, and draws the pool:
``pool`` distinct batches of ``batch`` sequences of ``seq_len`` token ids,
uniform over the vocabulary, held pinned on the host and copied ahead to
the card through ``device_prefetch``. It drives the step through its first
``check_steps`` steps on distinct pool batches, through the same call and
feed as the window, and keeps the norms of the first gradient (as AdamW's
first moment holds it) and of every parameter's change over those steps.
The window then drives the same object on: a closed loop over the pool,
the host at most two steps ahead of the card (it waits on the event of
the step before last), the losses read after the window.
``train_img_per_s`` counts sequences.

After the window, the program's state is freed and the plain reference
takes the same steps from the same weights and batches
(``modes/extensions.py: lm_reference``); ``core/check_lm.py`` compares
them.
"""
from __future__ import annotations

import collections
import itertools
import time

import torch

from port_bench.core import check_lm, harness
from port_bench.modes import common, extensions
from port_bench.reference import jamba as ref

LEAD = 2           # steps the host may run ahead of the card


def run(cell: harness.Cell) -> harness.Outcome:
    if cell.chips != 1:
        raise ValueError("the language-model training traffic runs on one "
                         "card")
    with extensions.planted(cell.fault):
        return _run(cell)


def closed_loop(one, until, device):
    """Calls of ``one`` (which returns a device loss) until ``until()``
    says stop, the host at most LEAD steps ahead of the card. Returns
    (the device losses, the calls)."""
    events, losses = collections.deque(), []
    while not until(len(losses)):
        losses.append(one())
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        events.append(done)
        if len(events) > LEAD:
            events.popleft().synchronize()
    return losses, len(losses)


def _run(cell: harness.Cell) -> harness.Outcome:
    from medmamba_tpu_torch.data.loader import device_prefetch
    from medmamba_tpu_torch.models.registry import create_lm
    from medmamba_tpu_torch.train.trainer import (compile_lm_train_step,
                                                  make_optimizer)

    cfg, tr = cell.config, cell.traffic
    device = common.card()
    common.mark(cell.t0, "program imported, card up")
    seeds = common.sub_seeds(cell.seed)
    model = create_lm(cfg["name"], cfg,
                      dtype=common.DTYPES[tr["block_dtype"]], device=device,
                      init=False)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    model.load_state_dict(weights, strict=True)
    # the initial weights wait on the host for the parameters' changes
    initial = {n: w.cpu() for n, w in weights.items()}
    del weights
    common.mark(cell.t0, "weights made, model built")
    opt, _ = make_optimizer(model.parameters(), tr["lr"], npz_mode=False)
    if opt.param_groups[0]["weight_decay"] != tr["weight_decay"]:
        raise RuntimeError("the program's AdamW decay is not the recipe's")
    beta1 = opt.param_groups[0]["betas"][0]
    step = compile_lm_train_step(model, opt)
    ids = extensions.lm_batches(cfg, tr, cell.seed, device)
    host = [ids[i].cpu().pin_memory() for i in range(tr["pool"])]
    del ids
    common.mark(cell.t0, "pool made")
    feed = device_prefetch(
        ((host[i],) for i in itertools.cycle(range(tr["pool"]))),
        lambda x: (x.to(device, non_blocking=True),), device=device)

    def one_step():
        (x,) = next(feed)
        return step(x).clone()

    first, grads = [], None
    for k in range(tr["check_steps"]):
        first.append(one_step())
        if k == 0:
            torch.cuda.synchronize(device)
            common.mark(cell.t0, "step captured and run once")
            # a parameter the optimizer holds no moment of has not moved
            grads = {n: check_lm.norm(opt.state[p]["exp_avg"])
                     / (1 - beta1) if "exp_avg" in opt.state.get(p, {})
                     else torch.zeros((), dtype=torch.float64)
                     for n, p in model.named_parameters()}
    change = {n: check_lm.norm(p.detach() - initial[n].to(device))
              for n, p in model.named_parameters()}
    del initial
    torch.cuda.synchronize(device)
    setup_s = time.time() - cell.t0

    ctx = dict(config=cfg, traffic=tr, chips=cell.chips, batch=tr["batch"],
               seq_len=tr["seq_len"], block_dtype=tr["block_dtype"])
    e2e = {"setup_s": setup_s}
    if cell.trace:
        ctx["trace"], attempted = common.traced(one_step, tr["trace_steps"],
                                                device)
        losses = []
    else:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        losses, attempted = closed_loop(
            one_step, lambda n: time.perf_counter() - t0 >= cell.seconds,
            device)
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        e2e["train_img_per_s"] = attempted * tr["batch"] / window_s
    losses = [float(x) for x in losses]
    dev = common.device_record(device, cell.chips, ctx.get("trace"))

    prog = dict(losses=[float(x) for x in first], grads=grads,
                change=change)
    step.free()
    del step, model, opt, feed, host, first
    torch.cuda.empty_cache()

    reference = extensions.lm_reference(cfg, tr, cell.seed, device)
    gaps = check_lm.train_checks(prog, reference)
    bad = sum(1 for x in losses if x != x or abs(x) == float("inf"))
    checks = [(n, v, cell.limits[n]) for n, v in gaps.items()]
    checks.append(("nonfinite_losses", bad, 0))
    return harness.Outcome(e2e, checks, attempted, bad, dev, ctx)
