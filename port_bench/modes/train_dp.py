"""Data-parallel training traffic: ``cli/train.py``'s graphed step under
torchrun's layout, one NCCL rank a card, as ``modes/train.py`` runs it on
one card.

The run spawns ranks 1 to ``ranks - 1`` and is rank 0 itself; rank ``r``
steps on card ``r``. Each rank builds the training object of
``modes/train.py`` (the benchmark's weights, AdamW, the step compiled by
``compile_train_step``, the draws from the same seed) under the port's
mesh (``parallel/mesh.py``: its gradient all-reduce, ``sum_grads``, and
the global BatchNorm sums are captured in the step's graph), and feeds it
its contiguous ``batch / ranks`` rows of each global pool batch. The first
``check_steps`` steps are taken as in ``modes/train.py``; rank 0 keeps its
first gradient and its parameters' changes, which the exchange made the
global batch's.

The window: every rank runs the same steps, the host at most two steps
ahead of its card (``modes/lm_train.py: closed_loop``). Every
``stop_every`` steps, outside the graphs, rank 0 broadcasts whether its
window has run ``--seconds``; each rank reads the broadcast made
``stop_every`` steps before, so no step waits on the host, and all ranks
stop after the same step. The window ends with a barrier and a
synchronisation; ``train_img_per_s`` is the global images over rank 0's
window. Traced, every rank runs ``trace_steps`` steps, rank 0 under the
profiler.

After the window the ranks leave the group and rank 0 runs the plain
reference on the global batches (``reference/vssm.py``), compared by
``core/check.py`` as for the one-card cells. The per-layer readers see
the step this mode runs, the image train step: the traffic they are handed
has ``mode`` ``train``.
"""
from __future__ import annotations

import collections
import datetime
import itertools
import os
import socket
import time

import torch

from port_bench.core import check, harness
from port_bench.modes import common, extensions
from port_bench.modes.lm_train import closed_loop
from port_bench.reference import vssm as ref

TIMEOUT = datetime.timedelta(seconds=600)


def run(cell: harness.Cell) -> harness.Outcome:
    n = cell.traffic["ranks"]
    if cell.chips != n:
        raise ValueError(f"{cell.name}: {n} ranks on {cell.chips} cards")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards, "
                           f"{torch.cuda.device_count()} present")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spawn = torch.multiprocessing.get_context("spawn")
    others = [spawn.Process(target=_rank, args=(cell, r, port), daemon=True)
              for r in range(1, n)]
    for p in others:
        p.start()
    try:
        out = _rank(cell, 0, port)
    finally:
        for p in others:
            p.join(timeout=TIMEOUT.total_seconds())
            if p.is_alive():
                p.terminate()
    failed = [p.exitcode for p in others if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"a rank exited with {failed}")
    return out


def _rank(cell: harness.Cell, rank: int, port: int):
    with extensions.planted(cell.fault):
        return _run(cell, rank, port)


def _run(cell: harness.Cell, rank: int, port: int):
    import torch.distributed as dist

    from medmamba_tpu_torch.data.loader import device_prefetch
    from medmamba_tpu_torch.parallel.mesh import (destroy_mesh, make_mesh,
                                                  replicate_state,
                                                  shard_batch)
    from medmamba_tpu_torch.train.trainer import (compile_train_step,
                                                  make_optimizer)

    cfg, tr = cell.config, cell.traffic
    n = tr["ranks"]
    rows = slice(rank * tr["batch"] // n, (rank + 1) * tr["batch"] // n)
    torch.cuda.set_device(rank)
    common.card()
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n, timeout=TIMEOUT,
                            device_id=device)
    mesh = make_mesh(device=device)
    lead = rank == 0
    if lead:
        common.mark(cell.t0, f"program imported, {n} ranks up")
    seeds = common.sub_seeds(cell.seed)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    model = common.port_model(cfg, tr["block_dtype"], weights, device)
    opt, _ = make_optimizer(model.parameters(), tr["lr"], npz_mode=False)
    if opt.param_groups[0]["weight_decay"] != tr["weight_decay"]:
        raise RuntimeError("the program's AdamW decay is not the recipe's")
    replicate_state(model, opt, mesh)
    beta1 = opt.param_groups[0]["betas"][0]
    gen = torch.Generator(device=device).manual_seed(seeds["draws"])
    step = compile_train_step(model, opt, generator=gen)
    images, labels = common.pool(cfg, tr, seeds["data"], device)
    host = [(images[i, rows].cpu().pin_memory(),
             labels[i, rows].cpu().pin_memory()) for i in range(tr["pool"])]
    del images, labels
    feed = device_prefetch(
        (host[i] for i in itertools.cycle(range(tr["pool"]))),
        lambda im, lb: shard_batch(mesh, im, lb, device=device),
        device=device)
    static = dict(augment=tr["augment"], image_size=cfg["image_size"])

    def one_step():
        im, lb = next(feed)
        return step(im, lb, **static).clone()

    first, grads = [], None
    for k in range(tr["check_steps"]):
        first.append(one_step())
        if k == 0 and lead:
            torch.cuda.synchronize(device)
            common.mark(cell.t0, "step captured and run once")
            grads = {p_name: opt.state[p]["exp_avg"] / (1 - beta1)
                     if "exp_avg" in opt.state.get(p, {})
                     else torch.zeros_like(p)
                     for p_name, p in model.named_parameters()}
    change = {p_name: p.detach() - weights[p_name]
              for p_name, p in model.named_parameters()}
    del weights
    dist.barrier()
    torch.cuda.synchronize(device)
    setup_s = time.time() - cell.t0

    ctx = dict(config=cfg, traffic=dict(tr, mode="train"), chips=cell.chips,
               batch=tr["batch"], block_dtype=tr["block_dtype"])
    e2e = {"setup_s": setup_s}
    losses = []
    if cell.trace:
        if lead:
            ctx["trace"], attempted = common.traced(
                one_step, tr["trace_steps"], device)
        else:
            for _ in range(tr["trace_steps"]):
                one_step()
            attempted = tr["trace_steps"]
        dist.barrier()
        torch.cuda.synchronize(device)
    else:
        t0 = time.perf_counter()
        losses, attempted = closed_loop(
            one_step, _stop_rule(lead, t0, cell.seconds, tr["stop_every"],
                                 device), device)
        dist.barrier()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        e2e["train_img_per_s"] = attempted * tr["batch"] / window_s
    losses = [float(x) for x in losses]
    dev = common.device_record(device, cell.chips, ctx.get("trace"))
    prog = dict(losses=[float(x) for x in first], grads=grads, change=change)
    step.free()
    del step, model, opt, feed, host, gen, first
    torch.cuda.empty_cache()
    dist.barrier()
    destroy_mesh()
    if not lead:
        return None

    images, labels = common.pool(cfg, tr, seeds["data"], device)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    rgen = torch.Generator(device=device).manual_seed(seeds["draws"])
    with common.tf32(False):
        r_losses, r_grads, r_params = ref.train_steps(
            weights, [(images[i], labels[i])
                      for i in range(tr["check_steps"])],
            cfg, gen=rgen, lr=tr["lr"], weight_decay=tr["weight_decay"])
    reference = dict(losses=r_losses, grads=r_grads,
                     change={p: r_params[p] - weights[p] for p in r_params})
    ctx["leaf_gaps"] = check.train_gaps(prog, reference)
    gaps = check.train_checks(prog, reference, ctx["leaf_gaps"])
    bad = sum(1 for x in losses if x != x or abs(x) == float("inf"))
    checks = [(name, v, cell.limits[name]) for name, v in gaps.items()]
    checks.append(("nonfinite_losses", bad, 0))
    return harness.Outcome(e2e, checks, attempted, bad, dev, ctx)


def _stop_rule(lead: bool, t0: float, seconds: float, every: int, device):
    """``until(steps)`` for ``closed_loop``: every ``every`` steps, rank 0
    broadcasts whether ``seconds`` have passed since ``t0`` and every
    rank reads the broadcast of ``every`` steps before, from pinned host
    memory once its event has passed (no wait on the steps since)."""
    import torch.distributed as dist
    sent = collections.deque()

    def until(steps: int) -> bool:
        if steps == 0 or steps % every:
            return False
        out = torch.empty(1, pin_memory=True)
        out[0] = float(lead and time.perf_counter() - t0 >= seconds)
        flag = out.to(device, non_blocking=True)
        dist.broadcast(flag, src=0)
        back = torch.empty(1, pin_memory=True)
        back.copy_(flag, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        sent.append((back, done))
        if len(sent) < 2:
            return False
        back, done = sent.popleft()
        done.synchronize()
        return bool(back[0])
    return until
