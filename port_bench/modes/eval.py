"""Evaluation traffic: the graphed forward, as ``cli/evaluate.py`` runs it.

One closed-loop client: each call hands a host numpy uint8 batch of the
pool to the forward that ``compile_forward`` captured and takes its
softmax probabilities back to the host. A batch's latency runs from the
hand-over to the probabilities on the host. The answers of a sample of
the pool's batches, drawn from the seed, are kept; after the window every
one of them is compared with the plain reference's probabilities of its
batch.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from port_bench.core import check, faults, harness
from port_bench.modes import common
from port_bench.reference import vssm as ref


def run(cell: harness.Cell) -> harness.Outcome:
    with faults.planted(cell.fault):
        return _run(cell)


def _run(cell: harness.Cell) -> harness.Outcome:
    from medmamba_tpu_torch.train.trainer import compile_forward

    cfg, tr = cell.config, cell.traffic
    device = common.card()
    common.mark(cell.t0, "program imported, card up")
    seeds = common.sub_seeds(cell.seed)
    weights = ref.make_weights(cfg, seeds["weights"], device)
    model = common.port_model(cfg, tr["block_dtype"], weights, device)
    common.mark(cell.t0, "weights made, model built")
    forward = compile_forward(model)
    images, _ = common.pool(cfg, tr, seeds["data"], device)
    host = [images[i].cpu().numpy() for i in range(tr["pool"])]
    del images
    kept = {i: [] for i in common.compared_batches(tr, seeds)}
    order = itertools.cycle(range(tr["pool"]))
    static = dict(image_size=cfg["image_size"])
    latencies = []

    def one_batch():
        i = next(order)
        t = time.perf_counter()
        probs = forward(torch.from_numpy(host[i]), **static)[0].cpu()
        latencies.append(time.perf_counter() - t)
        if i in kept:
            kept[i].append(probs)

    for k in range(tr["warm_batches"]):
        one_batch()
        if k == 0:
            common.mark(cell.t0, "forward captured and run once")
    torch.cuda.synchronize(device)
    setup_s = time.time() - cell.t0
    latencies.clear()

    ctx = dict(config=cfg, traffic=tr, chips=cell.chips, batch=tr["batch"],
               block_dtype=tr["block_dtype"])
    e2e = {"setup_s": setup_s}
    if cell.trace:
        ctx["trace"], attempted = common.traced(one_batch,
                                                tr["trace_batches"], device)
    else:
        attempted, window_s = common.timed(one_batch, cell.seconds, device)
        e2e["eval_img_per_s"] = attempted * tr["batch"] / window_s
        e2e["eval_batch_ms_p95"] = float(np.percentile(latencies, 95)) * 1e3
    dev = common.device_record(device, cell.chips, ctx.get("trace"))
    forward.free()
    del forward, model
    torch.cuda.empty_cache()

    images, _ = common.pool(cfg, tr, seeds["data"], device)
    state = {**weights, **ref.batch_norm_buffers(cfg, device)}
    gap, failed = 0.0, 0
    with common.tf32(False):
        for i, answers in kept.items():
            want = ref.probabilities(state, images[i], cfg).cpu()
            for got in answers:
                if not torch.isfinite(got).all():
                    failed += 1
                gap = max(gap, check.prob_gap(got, want))
    checks = [("prob_gap", gap, cell.limits["prob_gap"]),
              ("nonfinite_answers", failed, 0)]
    return harness.Outcome(e2e, checks, attempted, failed, dev, ctx)
