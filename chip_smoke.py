#!/usr/bin/env python3
"""Smoke test of the PyTorch port (medmamba_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit;
  2. build: the kernels K1 (selective-scan forward), K2 (its backward), K3
     and K4 (the forward and backward of the scan MEDMAMBA_SCAN_KERNEL=hillis
     selects; K3 saves a state per 128-step chunk) and K5 (flip + rotation)
     from medmamba_tpu_torch/csrc/,
     one nvcc for each source, all started together; their registers,
     shared memory, spills; K1's layout at each stage shape (channels a
     block, dynamic shared memory, registers, blocks an SM);
  3. K1 against its plain PyTorch version on the card, at the four
     medmamba_t stage shapes (batch 64), forward and reverse, float32 and
     bfloat16 inputs, with valid_len and with the last state; times of the
     kernel and the plain version beside the kernel's bound; then at batch 1
     (the demo's and cli.test's shape, where K1 launches 8-channel blocks)
     against the plain version and timed, by events and by the profiler's
     device time; in the log the earlier design's times as timed at 385f291
     (K1_EARLIER_MS, constants this run does not measure);
  4. the serving path: ``medmamba_tpu_torch.cli.evaluate`` on a synthetic
     NPZ test split with a random medmamba_t ``.pth`` at 224^2, batch 64; K1
     must launch exactly 20 times per batch, and one batch's logits must
     match the same model with the plain scan;
  5. timing: medmamba_t eval-forward throughput at 224^2, batch 64, float32
     without TF32 (the precision the port's entry points fix), and the
     device time per forward by kernel family from ``torch.profiler``;
  6. K1's tile-entry states and K2 against their plain versions at the four
     stage shapes (batch 64): float32 and bfloat16 in and out, each forward
     and reverse, the two mixed types (float32 in with a bfloat16 gy,
     bfloat16 in with a float32 gy), and reverse at L 3200 with valid_len
     3136; two K2 launches on the same stage-0 inputs must give the same
     bits; K2's time per stage beside its bound and the plain version's,
     and in the log the earlier design's times as timed at a08c9a5
     (K2_EARLIER_MS, constants this run does not measure);
  7. K5 against its plain version at 28^2 and 224^2 (batch 64), exactly;
     its time per launch queued back to back and by the profiler's device
     time;
  8. the training path: ``medmamba_tpu_torch.cli.train`` on a synthetic 28^2
     NPZ train/val split, medmamba_t at 224^2, batch 64, one epoch, bfloat16
     blocks, augmentation; each step must make exactly 20 K1, 20 K2 and 1 K5
     launches (and each validation batch 20 K1); the loss is finite, the best
     and last ``.pth`` exist, and ``cli.evaluate`` serves the best one with
     20 K1 launches per batch;
  9. gradients: one float32 training forward of medmamba_t (224^2, batch
     8, drop path 0, TF32 off) through K1, its backward through K2 against
     the same backward through K2's plain version, per parameter; then the
     same model on the plain scan (K1 and K2 both replaced), read and
     held on the loss;
 10. timing: train-step throughput at 224^2, batch 64 on a resident uint8
     batch, bfloat16 blocks with augmentation (``bench.py``'s
     configuration) and float32 with augmentation, and the device time per
     step by kernel family from ``torch.profiler``;
 11. K3 against its plain version at the four stage shapes (batch 64),
     float32 and bfloat16 inputs (every length ends in a short 128-step
     chunk), and at batch 1 (8-channel blocks): y, the chunk-entry states
     and the last state; two K3 launches on the same stage-0 inputs must
     give the same bits; one reverse call with valid_len through the
     dispatcher under hillis against the plain sequential scan; K3's time
     per stage beside its bound and the plain version's, and in the log
     the doubling design's times (K3_EARLIER_MS, constants this run does
     not measure);
 12. K4 against its plain version at the same shapes, float32 and bfloat16
     inputs; two K4 launches on the same stage-0 inputs must give the same
     bits; its time per stage, and in the log the doubling design's times
     (K4_EARLIER_MS, constants this run does not measure);
 13. the serving path under hillis: ``cli.evaluate`` with exactly 20 K3
     launches per batch and no other scan kernel; one batch's logits
     against the same weights on the default (ssd) path;
 14. the training path under hillis: ``cli.train`` as in phase 8 with
     exactly 20 K3, 20 K4 and 1 K5 launches per step;
 15. model gradients under hillis: one float32 forward through K3, its
     backward through K4 against the same backward through K4's plain
     version, per parameter;
 16. timing under hillis: the eval forward and the bf16 and float32 train
     steps beside the ssd numbers, with the forward's and the bf16 step's
     device time by kernel family;
 17. P1 (``tools/probe_vpu.py``, the elementwise issue-rate probe) against
     its plain version in every mode, float32 and bfloat16, at the TPU
     probe's size; its time per call, el-op rate and bounds, failing any
     mode that runs above its issue bound;
 18. P2 (``tools/probe_mosaic.py``, the 14 relayout probes) against their
     plain versions, exactly; kernel, library and plain times per call
     queued back to back, the kernel's and the library call's device time
     from the profiler, and an empty kernel launched through the same
     ctypes path (the floor of a launch);
 19. the class-folder tree: ``cli.evaluate`` on a tree of 224^2 PNGs (no
     PIL on the card's machine) with a random medmamba_t ``.pth``, 20 K1
     launches for its one batch, the probabilities against the model's on
     the same pixels; then Grad-CAM: ``cli.test`` on the same tree,
     4 images at the default target (20 + 20 K1 and no
     K2 per image) and at two targets, the first upstream of 10 scans (20 +
     20 K1 and 10 K2 per image); each CAM against the same weights on the
     plain scan; one image under hillis (40 K3, 10 K4) against the ssd CAM;
 20. the demo server (``cli.demo``) in a thread: three POSTs (RGB with
     target -1 and 3, RGBA) and ``GET /random?mode=gt``, 40 K1 and no K2
     per request, the page's probabilities against the same model's
     softmax on the same pixels; the latency per request;
 21. serving export: ``python -m medmamba_tpu_torch.cli.export`` on phase
     4's medmamba_t checkpoint (224^2, symbolic batch), once as exported
     and once under MEDMAMBA_SCAN_KERNEL=hillis; each artifact loaded in a
     fresh process (``LOAD_ARTIFACT``, which imports
     ``medmamba_tpu_torch.utils.export`` and reads the launch counts) with
     the variable naming the other kernel, and called at batch 64, 3 and 1
     on uint8 frames from the seed: exactly 20 K1 and no K3 per call (20 K3
     and no K1 for the hillis artifact), the probabilities within 1e-5 of
     the live ``softmax(model(preprocess(x)))`` on the same kernel; the
     artifact's batch-64 and batch-1 forward against the live one (CUDA
     events, 10 back to back, median of 3), and again in this process in
     turns with their device time from the profiler, and the scan kernel's
     device time a batch-1 forward in each (its layout is chosen at each
     launch); K1's and K3's batch-1 host time per forward through the graph
     op against the call the live path made before it (the ctypes wrapper,
     ``_hillis_scan``); the analytic forward FLOPs an image
     (``utils/profiling.py: model_flops_report``) and the share of the
     card's float32 peak the artifact reaches;
 22. the bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE=bfloat16): K1-K4 in
     the mode against their plain versions in the mode at the four stage
     shapes (batch 64, float32 and bfloat16 inputs, and batch 1), each
     output relative to its largest entry; the mode moved each kernel's
     output off its float32 instantiation's; K2 and K4 give the same bits
     on every launch in the mode; each kernel's time per stage in the mode
     and in float32, in turns, beside the same bound; then ``cli.train``
     and ``cli.evaluate`` under the mode on K1/K2 and on K3/K4 with exact
     launch counts; medmamba_t's logits and its first training step's loss
     in the mode within 2e-2 of the float32 mode's, on both kernel pairs;
     and the eval forward and the bfloat16-block train step timed in the
     mode, on both pairs, with the device time by kernel family on K1/K2.
Each phase's header says when it started. The line before the last lists
every kernel of the port (K1, K2, K5, K3, K4, P1, P2) with its launches,
times and bound (K1-K4 with a ``bf16_compute`` object: phase 22's numbers),
and phase 21's; the last line is the JSON ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
IMAGE = 224
NUM_CLASSES = 9
N_IMAGES = 150                 # 3 batches of 64, the last one partial
N_VAL = 70                     # 2 validation batches in the training path
GRAD_BATCH = 8                 # the plain scan's autograd tape stays small
GROUPS, N_STATE = 2, 16
# medmamba_t at 224^2: per stage, channels per group (d_inner), sequence
# length (H*W after the 4x4 patch embed and each merge) and SS2D blocks
STAGES = [(96, 56 * 56, 2), (192, 28 * 28, 2), (384, 14 * 14, 4),
          (768, 7 * 7, 2)]
LAUNCHES_PER_FORWARD = sum(2 * blocks for _, _, blocks in STAGES)  # 20
TILE = 64                      # K1's tile: one saved state per tile
# H100 SXM data-sheet peaks: HBM3 bandwidth and dense float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
PROFILE_STEPS = 5
TOP_KERNELS = 12
# float32 kernel vs plain version: the same float32 arithmetic in another
# order (fused multiply-adds, y's sum over states taken across a channel's
# lanes): 1e-4 relative and absolute. bfloat16 output: its final rounding,
# 2^-8 relative: 1e-2.
TOL_FP32 = 1e-4
TOL_BF16_OUT = 1e-2
# K2 against its plain version: relative to each gradient's largest entry
# (its shuffles and partial sums add in another order than the plain
# version's loop); float32 1e-4, bfloat16 gradients 1e-2 (their last
# rounding).
# In the whole model (phase 9) K2 is held to the plain adjoint the same way:
# one forward through K1, its backward once through K2 and once through
# selective_scan_bwd_ref, every parameter's gradient within 1e-4 of its
# largest entry. Gradients below 1e-3 of the model's largest are zero in
# exact arithmetic (biases in front of a BatchNorm) and are held to 1e-4 of
# the model's largest gradient instead. The same model on the plain scan
# (K1 and K2 both replaced) is a reading and a loss gate only: at random init
# a few gradients are ill-conditioned (a convolution in front of a BatchNorm
# channel of near-zero variance turns K1's rounding-level differences from
# the plain loop into percent-level changes of its weight gradient), so
# phase 9 also prints how far the plain model's own gradients move when the
# input moves by a relative 2^-20.
TOL_GRAD_MODEL = 1e-4
INPUT_NUDGE = 2.0 ** -20
# K1 ms per launch at each stage in its earlier design (one thread per
# (b, d, n), 8-channel blocks, a 4-level shuffle tree per step; commit
# 385f291 and before), as PERF.md records it, timed beside the new design in
# one call on an NVIDIA H100 80GB HBM3 at 700 W: batch 64 by events, batch 1
# by the profiler's device time; printed beside this run's times
K1_EARLIER_MS = {64: (1.4460, 0.5978, 0.2922, 0.1593),
                 1: (0.6177, 0.1602, 0.0381, 0.0102)}
# K2 ms per launch at each stage in its earlier design (one thread per
# (b, d, n), dB/dC by shared and global atomics; commit 392b057 and before),
# as PERF.md records its run at commit a08c9a5 on an NVIDIA H100 80GB HBM3 at
# 700 W; printed beside this run's times
K2_EARLIER_MS = (8.9309, 4.5878, 2.4794, 1.2762)
# float32 operations the adjoint needs (a fused multiply-add counts 2), per
# (b, d, n, t): recompute h_t (dt*A, (dt*u)*B, one FMA: 4), dh = C*gy +
# carry (2), carry = a*dh (1), a*h_prev (1), q = dh*a*h_prev (1), and one
# FMA each into the sums of ddt (q*A), dA (q*dt), sum_n dh*B (shared by du
# and ddt), dB (dh*dt*u) and dC (h*gy) (10): 19, with one exponential. Per
# (b, d, t): delta + bias, dt*u, du = dt*S + D*gy (3), ddt = Q + u*S (2),
# ddelta, and the dD and dbias sums (3): 11. K2 as written does more (a
# second exponential, the shuffle trees); the bound counts only the need.
K2_OPS_DNT, K2_OPS_DT, K2_EXPS_DNT = 19, 11, 1
# K3 and K4 compute what K1 and K2 compute, so their bounds count the same
# need, with one saved state per 128-step chunk.
HILLIS_CHUNK = 128
# K3 ms per launch at each stage in its doubling design (one thread per step
# of a 128-step chunk, 7 Kogge-Stone levels of shuffles, the warps joined
# through shared memory; commit 959b3e2 and before), as PERF.md records its
# run at commit a08c9a5 on an NVIDIA H100 80GB HBM3 at 700 W; printed beside
# this run's times
K3_EARLIER_MS = (3.5310, 1.9299, 1.0978, 1.1097)
# K4 ms per launch at each stage in its doubling design (one thread per step
# of a 128-step chunk, two Kogge-Stone doublings, dB/dC/dA by float atomics;
# commit 6ede5d4 and before), as PERF.md records it on an NVIDIA H100 80GB
# HBM3 at 700 W; printed beside this run's times
K4_EARLIER_MS = (7.5073, 4.1517, 2.4880, 2.5834)
# phase 21: the batches an artifact is called at (the first is timed with
# the last); the artifact and the live forward run the same kernel on the
# same aten ops, so 1e-5 holds them to a few float32 roundings
EXPORT_BATCHES = (BATCH, 3, 1)
TOL_EXPORT = 1e-5
# phase 22: the bfloat16 compute mode's logits and first-step loss against
# the float32 mode's, relative to the largest logit and to the loss: the
# mode's own accuracy, as the JAX package's tests hold its mode
TOL_BF16_MODE = 2e-2
# a kernel in the mode must move its output off the float32 instantiation's
# by at least this share of its scale (the mode moves y by 2e-3 to 1e-2)
BF16_MOVES = 1e-3
# phase 21's loader, run in a fresh process: argv is the artifact, the
# frames (.npy), an output prefix and the batches; it writes each batch's
# probabilities to <prefix>_<batch>.npy and prints "result {...}" with the
# scan launches of each call (K1, K3) and the first and last batches' ms
# per call (CUDA events, 10 back to back, median of 3)
LOAD_ARTIFACT = r"""
import json, statistics, sys
import numpy as np
import torch
from medmamba_tpu_torch.utils.export import load_exported
from medmamba_tpu_torch.ops import scan_cuda, scan_hillis

art, frames, prefix, batches = sys.argv[1:5]
batches = [int(b) for b in batches.split(",")]
with open(art, "rb") as f:
    exp = load_exported(f.read())
x = torch.from_numpy(np.load(frames)).cuda()
counts = {}
for b in batches:
    scan_cuda.LAUNCHES = scan_hillis.HILLIS_LAUNCHES = 0
    probs = exp.call(x[:b])
    torch.cuda.synchronize()
    counts[b] = [scan_cuda.LAUNCHES, scan_hillis.HILLIS_LAUNCHES]
    np.save(f"{prefix}_{b}.npy", probs.cpu().numpy())


def ms(xb, reps=10, rounds=3):
    exp.call(xb)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            exp.call(xb)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


print("result " + json.dumps({"counts": counts, "ms": {
    b: ms(x[:b]) for b in (batches[0], batches[-1])}}))
"""


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def setenv(var: str, value: str):
    """Within the block the environment variable ``var`` is ``value``."""
    old = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(var)
        else:
            os.environ[var] = old


def scan_kernel(name: str):
    """Within the block ``MEDMAMBA_SCAN_KERNEL`` is ``name``: the port reads
    it at each scan call."""
    return setenv("MEDMAMBA_SCAN_KERNEL", name)


def scan_compute(name: str):
    """Within the block ``MEDMAMBA_SCAN_COMPUTE`` is ``name``: the port
    reads it at each scan call."""
    return setenv("MEDMAMBA_SCAN_COMPUTE", name)


def back_to_back_ms(fn, inputs: list, reps: int, rounds: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card: ``reps`` calls queued
    back to back between one CUDA event pair, cycling through ``inputs``
    (enough input sets that a set has left the L2 when it comes round
    again), after one warm-up call per set; the median of ``rounds``."""
    import torch

    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def scan_inputs(dpg: int, l: int, dtype, gen, batch: int = BATCH):
    """Scan operands at one stage shape, with the model's magnitudes: A near
    the S4D init -(1..16), the dt bias the inverse softplus of a log-uniform
    dt in [1e-3, 0.1]."""
    import torch

    d = GROUPS * dpg
    dev = gen.device

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    a_row = torch.arange(1, N_STATE + 1, dtype=torch.float32, device=dev)
    dt0 = torch.exp(math.log(1e-3) + math.log(100.0)
                    * torch.rand(d, generator=gen, device=dev))
    return dict(
        u=rnd(batch, d, l).to(dtype),
        delta=rnd(batch, d, l, scale=0.5).to(dtype),
        A=-(a_row * (1 + 0.1 * rnd(d, 1))).contiguous(),
        B=rnd(batch, GROUPS, N_STATE, l).to(dtype),
        C=rnd(batch, GROUPS, N_STATE, l).to(dtype), D=rnd(d),
        delta_bias=dt0 + torch.log(-torch.expm1(-dt0)))


def scan_costs(dpg: int, l: int):
    """Least times in ms of one float32 launch on the card: (bytes, float32
    operations, exp on the special-function units). Each input is read once
    and y written once; 7 operations per (b, d, n, t) and 6 per (b, d, t);
    one exp per (b, d, n, t) at 132 SMs x 16 per clock x 1.98 GHz."""
    d = GROUPS * dpg
    nbytes = 4 * (3 * BATCH * d * l + 2 * BATCH * GROUPS * N_STATE * l
                  + d * N_STATE + 2 * d)
    ops = 7 * BATCH * d * N_STATE * l + 6 * BATCH * d * l
    exps = BATCH * d * N_STATE * l
    return (nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_OPS_PER_S * 1e3,
            exps / (132 * 16 * 1.98e9) * 1e3)


def phase_kernel_vs_plain():
    import torch

    from medmamba_tpu_torch.ops.selective_scan import selective_scan
    from medmamba_tpu_torch.utils.profiling import device_ms_per_call

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [("fwd fp32", torch.float32, {}),
             ("rev fp32", torch.float32, {"reverse_dirs": (True, True)}),
             ("fwd bf16->fp32", torch.bfloat16, {}),
             ("rev bf16->bf16", torch.bfloat16,
              {"reverse_dirs": (True, True), "out_dtype": torch.bfloat16})]
    max_err = 0.0
    stages = []
    for si, (dpg, l, blocks) in enumerate(STAGES):
        for name, dtype, kw in cases:
            x = scan_inputs(dpg, l, dtype, gen)
            got = selective_scan(**x, delta_softplus=True, **kw)
            want = selective_scan(**x, delta_softplus=True, impl="ref", **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL_BF16_OUT if kw.get("out_dtype") else TOL_FP32
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            if not kw.get("out_dtype"):
                max_err = max(max_err, err)
            log(f"  stage {si} D={GROUPS * dpg} L={l} {name}: "
                f"max|err| {err:.3e} (rtol = atol = {tol:g})")
        bytes_ms, ops_ms, exp_ms = scan_costs(dpg, l)
        set_bytes = bytes_ms * 1e-3 * PEAK_BYTES_PER_S
        xs = [scan_inputs(dpg, l, torch.float32, gen)
              for _ in range(max(2, math.ceil(3 * L2_BYTES / set_bytes)))]
        k_ms = back_to_back_ms(
            lambda x: selective_scan(**x, delta_softplus=True), xs, 20)
        p_ms = back_to_back_ms(
            lambda x: selective_scan(**x, delta_softplus=True, impl="ref"),
            xs[:1], 1)
        del xs
        stages.append(dict(stage=si, D=GROUPS * dpg, L=l,
                           launches=2 * blocks, ms=k_ms,
                           plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                           bound_ms=max(bytes_ms, ops_ms), exp_ms=exp_ms))
        log(f"  stage {si} D={GROUPS * dpg} L={l}: kernel {k_ms:.4f} ms "
            f"(earlier design as timed at 385f291: "
            f"{K1_EARLIER_MS[BATCH][si]:.4f} ms), "
            f"plain {p_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"(bytes {bytes_ms:.4f}, fp32 ops {ops_ms:.4f}, exp units "
            f"{exp_ms:.4f}), x{2 * blocks} per forward")

    # batch 1, the demo's and cli.test's shape: 8-channel blocks
    for si, (dpg, l, blocks) in enumerate(STAGES):
        xs = [scan_inputs(dpg, l, torch.float32, gen, batch=1)
              for _ in range(8)]
        for kw in ({}, {"reverse_dirs": (True, True)}):
            got = selective_scan(**xs[0], delta_softplus=True, **kw)
            want = selective_scan(**xs[0], delta_softplus=True, impl="ref",
                                  **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=TOL_FP32,
                                       atol=TOL_FP32)
            max_err = max(max_err, (got - want).abs().max().item())

        def fwd1(x):
            return selective_scan(**x, delta_softplus=True)
        b1_ms = back_to_back_ms(fwd1, xs, 20)
        b1_dev = device_ms_per_call([(fwd1, xs)], r"scan_fwd_kernel")[0]
        stages[si].update(ms_batch1=b1_ms, device_ms_batch1=b1_dev)
        log(f"  stage {si} D={GROUPS * dpg} L={l} batch 1: kernel "
            f"{b1_ms:.4f} ms back to back through the wrapper, device "
            f"{b1_dev:.4f} ms (earlier design's device time as timed at "
            f"385f291: {K1_EARLIER_MS[1][si]:.4f} ms)")

    # the SS2D padding pattern (L 3136 -> 3200, valid_len 3136) with the last
    # state, in reverse; then a forward-prefix/reverse-suffix launch on a
    # shared u (u_tile 2)
    dpg = STAGES[0][0]
    x = scan_inputs(dpg, 3200, torch.float32, gen)
    x_tiled = dict(x, u=x["u"][:, :dpg].contiguous())
    for xx, kw in ((x, {"reverse_dirs": (True, True)}),
                   (x_tiled, {"reverse_dirs": (False, True), "u_tile": 2})):
        kw = dict(kw, valid_len=3136, return_last_state=True)
        y, last = selective_scan(**xx, delta_softplus=True, **kw)
        y_r, last_r = selective_scan(**xx, delta_softplus=True, impl="ref",
                                     **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_r, rtol=TOL_FP32, atol=TOL_FP32)
        torch.testing.assert_close(last, last_r, rtol=TOL_FP32, atol=TOL_FP32)
        err = max((y - y_r).abs().max().item(),
                  (last - last_r).abs().max().item())
        max_err = max(max_err, err)
        log(f"  L=3200 {kw}: max|err| {err:.3e}")
    return stages, max_err


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


def k2_costs(dpg: int, l: int, tile: int = TILE):
    """Least times in ms of one K2 launch on the card, float32: (bytes,
    float32 operations, exp on the special-function units). Read once: u,
    delta, gy (b, d, L), B and C (b, G, N, L), the states (one per
    ``tile`` steps), A, D, bias; written once: du and ddelta (b, d, L), dB
    and dC (b, G, N, L), dA, dD, dbias."""
    d = GROUPS * dpg
    n_tiles = -(-l // tile)
    nbytes = 4 * (5 * BATCH * d * l + 4 * BATCH * GROUPS * N_STATE * l
                  + BATCH * d * n_tiles * N_STATE + 2 * d * N_STATE + 4 * d)
    ops = K2_OPS_DNT * BATCH * d * N_STATE * l + K2_OPS_DT * BATCH * d * l
    exps = K2_EXPS_DNT * BATCH * d * N_STATE * l
    return (nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_OPS_PER_S * 1e3,
            exps / (132 * 16 * 1.98e9) * 1e3)


def phase_backward_vs_plain():
    """K1's states and K2 against their plain versions; K2 timed."""
    import torch

    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_ref, selective_scan_states_ref)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def operands(dpg, l, dtype, gy_dtype, kw):
        x = scan_inputs(dpg, l, dtype, gen)
        y, _, states = scan_cuda.selective_scan_fwd(
            **x, delta_softplus=True, return_states=True,
            out_dtype=gy_dtype, **kw)
        gy = torch.randn(y.shape, generator=gen, device="cuda").to(gy_dtype)
        return x, states, gy

    def check(label, dpg, l, dtype, gy_dtype, kw):
        x, states, gy = operands(dpg, l, dtype, gy_dtype, kw)
        want_states = selective_scan_states_ref(
            x["u"], x["delta"], x["A"], x["B"], x["C"], x["delta_bias"],
            True, kw.get("reverse_dirs"), 1, kw.get("valid_len"))
        got = scan_cuda.selective_scan_bwd(
            *(x[k] for k in names), states, gy, delta_softplus=True, **kw)
        want = selective_scan_bwd_ref(
            *(x[k] for k in names), want_states, gy, delta_softplus=True,
            **kw)
        torch.cuda.synchronize()
        st_err = (states - want_states).abs().max().item()
        torch.testing.assert_close(states, want_states, rtol=TOL_FP32,
                                   atol=TOL_FP32)
        rels, abss = {}, {}
        for name, g, w in zip(names, got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise SystemExit(f"K2 {name}: {g.dtype} {tuple(g.shape)}, "
                                 f"expected {w.dtype} {tuple(w.shape)}")
            rels[name] = rel_err(g, w)
            if g.dtype == torch.float32:
                abss[name] = (g - w).abs().max().item()
            tol = TOL_BF16_OUT if g.dtype == torch.bfloat16 else TOL_FP32
            if rels[name] > tol:
                raise SystemExit(f"K2 {label} d{name}: relative error "
                                 f"{rels[name]:.3e} above {tol:g}")
        worst = max(rels, key=rels.get)
        log(f"  {label}: states max|err| {st_err:.3e}; K2 worst d{worst} "
            f"{rels[worst]:.3e} of its scale; "
            + ", ".join(f"d{k} {v:.1e}" for k, v in rels.items()))
        return st_err, max(abss.values(), default=0.0)

    max_err = 0.0
    stages = []
    fwd, rev = {}, {"reverse_dirs": (True, True)}
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, input dtype, gy dtype, direction): every dtype instantiation of
    # K2; bf16 in both directions, as the bf16 training path runs it
    cases = (("fwd fp32", f32, f32, fwd), ("rev fp32", f32, f32, rev),
             ("fwd bf16", bf16, bf16, fwd), ("rev bf16", bf16, bf16, rev),
             ("fwd fp32 in, bf16 gy", f32, bf16, fwd),
             ("rev bf16 in, fp32 gy", bf16, f32, rev))
    for si, (dpg, l, blocks) in enumerate(STAGES):
        for name, dtype, gy_dtype, kw in cases:
            st_err, err = check(f"stage {si} D={GROUPS * dpg} L={l} {name}",
                                dpg, l, dtype, gy_dtype, kw)
            max_err = max(max_err, st_err, err)
        bytes_ms, ops_ms, exp_ms = k2_costs(dpg, l)
        set_bytes = bytes_ms * 1e-3 * PEAK_BYTES_PER_S
        sets = [operands(dpg, l, f32, f32, rev)
                for _ in range(max(2, math.ceil(3 * L2_BYTES / set_bytes)))]

        def bwd(s, impl=scan_cuda.selective_scan_bwd):
            x, states, gy = s
            return impl(*(x[k] for k in names), states, gy,
                        delta_softplus=True, **rev)
        if si == 0:
            # K2 adds its partial sums in a fixed order, with no atomics
            first, second = bwd(sets[0]), bwd(sets[0])
            torch.cuda.synchronize()
            for name, a, b in zip(names, first, second):
                if not torch.equal(a, b):
                    raise SystemExit(f"K2 d{name}: two launches on the same "
                                     "inputs differ")
            log(f"  stage 0: two K2 launches give the same bits in d"
                + ", d".join(names))
            del first, second
        k_ms = back_to_back_ms(bwd, sets, 20)
        p_ms = back_to_back_ms(
            lambda s: bwd(s, selective_scan_bwd_ref), sets[:1], 1, rounds=1)
        del sets
        stages.append(dict(stage=si, D=GROUPS * dpg, L=l,
                           launches=2 * blocks, ms=k_ms,
                           plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                           bound_ms=max(bytes_ms, ops_ms), exp_ms=exp_ms))
        log(f"  stage {si} D={GROUPS * dpg} L={l}: K2 {k_ms:.4f} ms (earlier "
            f"design as timed at a08c9a5: {K2_EARLIER_MS[si]:.4f} ms), plain "
            f"{p_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
            f"{bytes_ms:.4f}, fp32 ops {ops_ms:.4f}, exp units "
            f"{exp_ms:.4f}), x{2 * blocks} per step")
    st_err, err = check("L=3200 valid_len 3136 rev fp32", STAGES[0][0], 3200,
                        f32, f32, dict(rev, valid_len=3136))
    return stages, max(max_err, st_err, err)


def phase_rotate_vs_plain():
    """K5 against its plain version, exactly; its time per launch queued
    back to back and by the profiler's device time (one session for both
    sizes)."""
    import torch

    from medmamba_tpu_torch.ops import rotate
    from medmamba_tpu_torch.utils.profiling import device_ms_per_call

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def operands(size):
        x = 255 * torch.rand(BATCH, size, size, 3, generator=gen,
                             device="cuda")
        angles = (2 * torch.rand(BATCH, generator=gen, device="cuda") - 1) \
            * math.radians(10)
        flip = torch.rand(BATCH, generator=gen, device="cuda") < 0.5
        return x, torch.sin(angles), torch.cos(angles), flip

    out, timed = {}, {}
    for size in (28, IMAGE):
        x, sin, cos, flip = operands(size)
        got = rotate.rotate_flip_cuda(x, sin, cos, flip)
        want = rotate.rotate_flip_ref(x, sin, cos, flip)
        torch.cuda.synchronize()
        n_diff = (got != want).sum().item()
        err = (got - want).abs().max().item()
        if n_diff:
            raise SystemExit(f"K5 at {size}^2: {n_diff} values differ from "
                             f"the plain version (max|err| {err:.3e})")
        nbytes = 2 * 4 * BATCH * size * size * 3 + 9 * BATCH
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        sets = [operands(size) for _ in range(
            max(2, math.ceil(3 * L2_BYTES / nbytes)))]
        k_ms = back_to_back_ms(lambda s: rotate.rotate_flip_cuda(*s), sets,
                               20)
        p_ms = back_to_back_ms(lambda s: rotate.rotate_flip_ref(*s), sets,
                               20)
        timed[size] = sets
        out[size] = dict(size=size, ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound_ms, max_abs_err=err)
    device = device_ms_per_call(
        [(lambda s: rotate.rotate_flip_cuda(*s), sets)
         for sets in timed.values()], r"rotate_flip_kernel")
    del timed
    for (size, row), dev_ms in zip(out.items(), device):
        row["device_ms"] = dev_ms
        log(f"  {size}^2 batch {BATCH}: max|err| {row['max_abs_err']:.3e}; "
            f"K5 {row['ms']:.4f} ms a launch back to back, device "
            f"{dev_ms:.4f} ms ({100 * row['bound_ms'] / dev_ms:.0f}% of its "
            f"bound), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms (bytes)")
    return out


def write_train_split(root: str) -> None:
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    for split, n in (("train", N_IMAGES), ("val", N_VAL)):
        labels = rng.integers(0, NUM_CLASSES, (n, 1)).astype(np.int64)
        labels[:NUM_CLASSES, 0] = np.arange(NUM_CLASSES)   # every class
        np.save(os.path.join(root, f"{split}_images.npy"),
                rng.integers(0, 256, (n, 28, 28, 3), dtype=np.uint8))
        np.save(os.path.join(root, f"{split}_labels.npy"), labels)


def expected_counts(**launches) -> dict:
    """Launch counts with every kernel not named at 0."""
    return {k: launches.get(k, 0)
            for k in ("K1", "K2", "K3", "K4", "K5", "P1", "P2")}


def phase_train_path(root: str, fwd: str = "K1", bwd: str = "K2"):
    """cli.train end to end, then cli.evaluate on its best checkpoint; the
    launch counts of each. ``fwd``/``bwd``: the scan kernels the path must
    launch, 20 per forward and per backward, and no other scan kernel."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import evaluate, train

    write_train_split(root)
    steps = -(-N_IMAGES // BATCH)
    val_batches = -(-N_VAL // BATCH)
    save = os.path.join(root, "run")
    reset_counts()
    t0 = time.perf_counter()
    out = train.main(["--train_dir", root, "--val_dir", root,
                      "--medmb_size", "T", "--image_size", str(IMAGE),
                      "--batch_size", str(BATCH), "--epochs", "1",
                      "--augmentation", "--dtype", "bfloat16",
                      "--device", "cuda", "--save_dir", save,
                      "--log_every", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = expected_counts(**{
        fwd: LAUNCHES_PER_FORWARD * (steps + val_batches),
        bwd: LAUNCHES_PER_FORWARD * steps, "K5": steps})
    log(f"  cli.train: {steps} steps + {val_batches} validation batches in "
        f"{wall:.2f} s wall, launches {counts}, loss {out['train_loss']}, "
        f"val acc {out['best_acc']}, {out['img_s']:.1f} img/s (first epoch, "
        f"build and warm-up included)")
    if counts != want:
        raise SystemExit(f"training path launches {counts}, expected {want}")
    if not (out["train_loss"] is not None and math.isfinite(out["train_loss"])):
        raise SystemExit(f"training loss {out['train_loss']}")
    for key in ("best_path", "last_path"):
        if not (out[key] and os.path.isfile(out[key])):
            raise SystemExit(f"{key} {out[key]} was not written")

    reset_counts()
    cm, probs = evaluate.main(["--checkpoint_path", out["best_path"],
                               "--data_dir", root, "--split", "val",
                               "--batch_size", str(BATCH), "--image_size",
                               str(IMAGE), "--device", "cuda"])
    torch.cuda.synchronize()
    ev_counts = read_counts()
    log(f"  cli.evaluate on {os.path.basename(out['best_path'])}: launches "
        f"{ev_counts}")
    if ev_counts != expected_counts(**{fwd: LAUNCHES_PER_FORWARD
                                       * val_batches}):
        raise SystemExit(f"evaluate launches {ev_counts}")
    if probs.shape != (N_VAL, NUM_CLASSES) or not np.isfinite(probs).all():
        raise SystemExit(f"bad probabilities: shape {probs.shape}")
    return counts, steps


def phase_gradients():
    """One float32 training forward through K1 with its backward once
    through K2 and once through K2's plain version, per parameter; then the
    same model on the plain scan (autograd through its loop) as a reading,
    held on the loss. Returns the worst relative gradient error of each
    comparison."""
    import torch

    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS
    from medmamba_tpu_torch.models.vssm import VSSM
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.selective_scan import selective_scan_bwd_ref
    from medmamba_tpu_torch.train.trainer import cross_entropy

    cfg = MODEL_CONFIGS["T"]
    kw = dict(num_classes=NUM_CLASSES, depths=cfg.depths, dims=cfg.dims,
              drop_path_rate=0.0)
    model = VSSM(**kw, generator=torch.Generator().manual_seed(SEED))
    ref = VSSM(**kw, scan_impl="ref")
    ref.load_state_dict(model.state_dict())
    model, ref = model.cuda().train(), ref.cuda().train()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(GRAD_BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    labels = torch.randint(0, NUM_CLASSES, (GRAD_BATCH,), generator=gen,
                           device="cuda")
    labels[-1] = -1                       # one padded row, as the loader's
    sign = torch.randint(0, 2, x.shape, generator=gen, device="cuda") * 2 - 1
    nudged = x * (1 + INPUT_NUDGE * sign)
    state = {k: v.clone() for k, v in ref.state_dict().items()}

    def grads(m, inp):
        m.load_state_dict(state)
        m.zero_grad()
        loss = cross_entropy(m(inp, labels >= 0), labels)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in m.named_parameters()}
    loss_k, got = grads(model, x)
    # the same K1 forward; _KernelScan's backward calls the plain adjoint
    kernel_bwd = scan_cuda.selective_scan_bwd
    scan_cuda.selective_scan_bwd = selective_scan_bwd_ref
    try:
        loss_p, want = grads(model, x)
    finally:
        scan_cuda.selective_scan_bwd = kernel_bwd
    loss_r, plain = grads(ref, x)
    _, moved = grads(ref, nudged)
    torch.cuda.synchronize()
    del model, ref
    rows = check_model_grads("K1 forward, K2", got, want, loss_k, loss_p)

    # reading: K1 + K2 against the plain scan, beside how far the plain
    # model's own gradient moves when the input moves by a relative 2^-20
    top_r = max(g.abs().max().item() for g in plain.values())
    reading = []
    for name, w in plain.items():
        scale = w.abs().max().item()
        if scale >= 1e-3 * top_r:
            reading.append(((got[name] - w).abs().max().item() / scale,
                            (moved[name] - w).abs().max().item() / scale,
                            name))
    reading.sort()
    log(f"  K1 + K2 against the plain scan: loss {loss_k:.7f} and "
        f"{loss_r:.7f}; median gradient error "
        f"{reading[len(reading) // 2][0]:.3e} of its scale, largest:")
    for err, sens, name in reading[::-1][:3]:
        log(f"    {name}: {err:.3e} of its scale; the plain model's own "
            f"gradient moves {sens:.3e} under the input nudge")
    if abs(loss_k - loss_r) > TOL_FP32 * max(1.0, loss_r):
        raise SystemExit("the loss through K1 disagrees with the plain scan")
    return rows[-1][0], reading[-1][0]


def check_model_grads(label: str, got: dict, want: dict, loss_k: float,
                      loss_p: float) -> list:
    """Each parameter's gradient through the kernel backward (``got``)
    within TOL_GRAD_MODEL of its scale of the gradient through the plain
    backward (``want``), under one forward; gradients below 1e-3 of the
    model's largest (zero in exact arithmetic) within TOL_FP32 of that
    largest. Returns the sorted (error, name) rows; exits on a failure."""
    top = max(g.abs().max().item() for g in want.values())
    rows, zero_worst = [], 0.0
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale >= 1e-3 * top:
            rows.append(((got[name] - w).abs().max().item() / scale, name))
        else:
            zero_worst = max(zero_worst,
                             (got[name] - w).abs().max().item() / top)
    rows.sort()
    log(f"  {label} against its plain version in the backward: "
        f"{len(rows)} gradients, median error {rows[len(rows) // 2][0]:.3e} "
        f"of their scale, largest {rows[-1][0]:.3e} ({rows[-1][1]}; limit "
        f"{TOL_GRAD_MODEL:g}); gradients zero in exact arithmetic "
        f"{zero_worst:.3e} of the largest (limit {TOL_FP32:g}); loss "
        f"{loss_k:.7f} and {loss_p:.7f}")
    if rows[-1][0] > TOL_GRAD_MODEL or zero_worst > TOL_FP32 \
            or abs(loss_k - loss_p) > TOL_FP32 * max(1.0, loss_p):
        raise SystemExit(f"gradients through {label} disagree with the "
                         "plain backward")
    return rows


def phase_train_timing():
    """Train-step throughput on a resident uint8 batch (bf16 + augmentation,
    then float32 + augmentation) and the bf16 step's device time by kernel
    family."""
    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    images = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen,
                           device="cuda")
    out = {}
    for name, dtype in (("bf16+aug", torch.bfloat16),
                        ("fp32+aug", torch.float32)):
        model = create_model("T", NUM_CLASSES, dtype=dtype, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        torch.cuda.reset_peak_memory_stats()

        def step(_):
            return trainer.train_step(model, opt, images, labels,
                                      generator=gen, augment=True,
                                      image_size=IMAGE)
        ms = back_to_back_ms(step, [None], 5)
        out[name] = dict(ms=ms, img_s=BATCH / ms * 1e3,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  train step {name}: {ms:.3f} ms, {BATCH / ms * 1e3:.1f} img/s")
        if name == "bf16+aug":
            prof_line = profile_families(lambda: step(None), "step")
        del model, opt
        torch.cuda.empty_cache()
    return out, prof_line


def k3_costs(dpg: int, l: int) -> dict:
    """Least times in ms of one float32 K3 launch on the card. Bytes: u,
    delta and y (b, d, L), B and C (b, G, N, L), the chunk-entry and last
    states, A, D and bias, each once; operations: the need K1 counts (7 per
    (b, d, n, t), 6 per (b, d, t))."""
    d = GROUPS * dpg
    bytes_ms, ops_ms, exp_ms = scan_costs(dpg, l)
    states = 4 * BATCH * d * N_STATE * (-(-l // HILLIS_CHUNK) + 1)
    return dict(bytes_ms=bytes_ms + states / PEAK_BYTES_PER_S * 1e3,
                ops_ms=ops_ms, exp_ms=exp_ms)


def k4_costs(dpg: int, l: int) -> dict:
    """Least times in ms of one float32 K4 launch: K2's bytes and need with
    128-step chunk states."""
    bytes_ms, ops_ms, exp_ms = k2_costs(dpg, l, HILLIS_CHUNK)
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms, exp_ms=exp_ms)


def stage_row(si, dpg, l, blocks, k_ms, p_ms, costs) -> dict:
    row = dict(stage=si, D=GROUPS * dpg, L=l, launches=2 * blocks, ms=k_ms,
               plain_ms=p_ms, **costs)
    row["bound_ms"] = max(costs["bytes_ms"], costs["ops_ms"])
    log(f"  stage {si} D={GROUPS * dpg} L={l}: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.2f} ms, bound {row['bound_ms']:.4f} ms (bytes "
        f"{costs['bytes_ms']:.4f}, fp32 ops needed {costs['ops_ms']:.4f}, "
        f"exp units {costs['exp_ms']:.4f}), x{2 * blocks}")
    return row


def per_pass(stages: list) -> dict:
    """Stage rows summed over the 20 launches of a forward or a step."""
    out = {k: sum(s[k] * s["launches"] for s in stages)
           for k in ("ms", "plain_ms", "bytes_ms", "ops_ms", "exp_ms")}
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                       else "operations")
    return out


def phase_hillis_fwd_vs_plain():
    """K3 against its plain version at the stage shapes, float32 and
    bfloat16 inputs, and at batch 1; two launches on the same stage-0
    inputs give the same bits; one reverse call with valid_len through the
    dispatcher against the plain sequential scan; K3 timed per stage."""
    import torch

    from medmamba_tpu_torch.ops import scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan, selective_scan_hillis_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    kernel = scan_hillis.selective_scan_hillis_fwd
    max_err, stages = 0.0, []
    for si, (dpg, l, blocks) in enumerate(STAGES):
        for label, dtype, batch in (("fp32", torch.float32, BATCH),
                                    ("bf16 in", torch.bfloat16, BATCH),
                                    ("fp32 batch 1", torch.float32, 1)):
            x = scan_inputs(dpg, l, dtype, gen, batch)
            got = kernel(**x, delta_softplus=True)
            want = selective_scan_hillis_ref(**x, delta_softplus=True)
            torch.cuda.synchronize()
            errs = {}
            for part, g, w in zip(("y", "states", "last"), got, want):
                torch.testing.assert_close(g, w, rtol=TOL_FP32,
                                           atol=TOL_FP32)
                errs[part] = (g - w).abs().max().item()
            max_err = max(max_err, *errs.values())
            log(f"  stage {si} D={GROUPS * dpg} L={l} {label}: max|err| "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (rtol = atol = {TOL_FP32:g})")
        costs = k3_costs(dpg, l)
        set_bytes = costs["bytes_ms"] * 1e-3 * PEAK_BYTES_PER_S
        xs = [scan_inputs(dpg, l, torch.float32, gen)
              for _ in range(max(2, math.ceil(3 * L2_BYTES / set_bytes)))]
        if si == 0:
            # K3 writes no output with an atomic
            first = kernel(**xs[0], delta_softplus=True)
            second = kernel(**xs[0], delta_softplus=True)
            torch.cuda.synchronize()
            for part, a, b in zip(("y", "states", "last"), first, second):
                if not torch.equal(a, b):
                    raise SystemExit(f"K3 {part}: two launches on the same "
                                     "inputs differ")
            log("  stage 0: two K3 launches give the same bits in y, states "
                "and last")
            del first, second
        k_ms = back_to_back_ms(lambda x: kernel(**x, delta_softplus=True),
                               xs, 20)
        p_ms = back_to_back_ms(
            lambda x: selective_scan_hillis_ref(**x, delta_softplus=True),
            xs[:1], 1, rounds=1)
        del xs
        stages.append(stage_row(si, dpg, l, blocks, k_ms, p_ms, costs))
        log(f"  stage {si}: K3's doubling design as timed at a08c9a5: "
            f"{K3_EARLIER_MS[si]:.4f} ms")

    # the SS2D padding pattern in reverse through the dispatcher: flipped
    # around K3, valid_len as delta = -1e4 at the pad, y in float32
    x = scan_inputs(STAGES[0][0], 3200, torch.float32, gen)
    kw = dict(reverse_dirs=(True, True), valid_len=3136,
              return_last_state=True)
    reset_counts()
    with scan_kernel("hillis"):
        y, last = selective_scan(**x, delta_softplus=True,
                                 out_dtype=torch.bfloat16, **kw)
    counts = read_counts()
    y_r, last_r = selective_scan(**x, delta_softplus=True, impl="ref", **kw)
    torch.cuda.synchronize()
    if counts != expected_counts(K3=1) or y.dtype != torch.float32:
        raise SystemExit(f"the hillis dispatcher launched {counts} and gave "
                         f"y in {y.dtype}")
    torch.testing.assert_close(y, y_r, rtol=TOL_FP32, atol=TOL_FP32)
    torch.testing.assert_close(last, last_r, rtol=TOL_FP32, atol=TOL_FP32)
    err = max((y - y_r).abs().max().item(),
              (last - last_r).abs().max().item())
    log(f"  L=3200 {kw} through the dispatcher against the sequential "
        f"scan: max|err| {err:.3e}, launches {counts}")
    return stages, max(max_err, err)


def phase_hillis_bwd_vs_plain():
    """K4 against its plain version at the stage shapes (float32 and
    bfloat16 inputs, K3's states), each gradient relative to its scale; two
    launches on the same stage-0 inputs give the same bits; K4 timed per
    stage beside its doubling design's times."""
    import torch

    from medmamba_tpu_torch.ops import scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan_hillis_bwd_ref)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def operands(dpg, l, dtype):
        x = scan_inputs(dpg, l, dtype, gen)
        y, states, _ = scan_hillis.selective_scan_hillis_fwd(
            **x, delta_softplus=True)
        gy = torch.randn(y.shape, generator=gen, device="cuda")
        return [x[k] for k in names], states, gy

    def bwd(s, impl=scan_hillis.selective_scan_hillis_bwd):
        args, states, gy = s
        return impl(*args, states, gy, delta_softplus=True)

    max_err, stages = 0.0, []
    for si, (dpg, l, blocks) in enumerate(STAGES):
        for label, dtype in (("fp32", torch.float32),
                             ("bf16 in", torch.bfloat16)):
            s = operands(dpg, l, dtype)
            got = bwd(s)
            want = bwd(s, selective_scan_hillis_bwd_ref)
            torch.cuda.synchronize()
            rels = {}
            for name, g, w in zip(names, got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise SystemExit(f"K4 {name}: {g.dtype} "
                                     f"{tuple(g.shape)}, expected {w.dtype} "
                                     f"{tuple(w.shape)}")
                rels[name] = rel_err(g, w)
                tol = TOL_FP32
                if g.dtype == torch.bfloat16:
                    tol = TOL_BF16_OUT
                else:
                    max_err = max(max_err, (g - w).abs().max().item())
                if rels[name] > tol:
                    raise SystemExit(f"K4 stage {si} {label} d{name}: "
                                     f"relative error {rels[name]:.3e} "
                                     f"above {tol:g}")
            log(f"  stage {si} D={GROUPS * dpg} L={l} {label}: K4 "
                + ", ".join(f"d{k} {v:.1e}" for k, v in rels.items())
                + " of their scale")
        costs = k4_costs(dpg, l)
        set_bytes = costs["bytes_ms"] * 1e-3 * PEAK_BYTES_PER_S
        sets = [operands(dpg, l, torch.float32)
                for _ in range(max(2, math.ceil(3 * L2_BYTES / set_bytes)))]
        if si == 0:
            # K4 adds its partial sums in a fixed order, with no atomics
            first, second = bwd(sets[0]), bwd(sets[0])
            torch.cuda.synchronize()
            for name, a, b in zip(names, first, second):
                if not torch.equal(a, b):
                    raise SystemExit(f"K4 d{name}: two launches on the same "
                                     "inputs differ")
            log(f"  stage 0: two K4 launches give the same bits in d"
                + ", d".join(names))
            del first, second
        k_ms = back_to_back_ms(bwd, sets, 20)
        p_ms = back_to_back_ms(
            lambda s: bwd(s, selective_scan_hillis_bwd_ref), sets[:1], 1,
            rounds=1)
        del sets
        stages.append(stage_row(si, dpg, l, blocks, k_ms, p_ms, costs))
        log(f"  stage {si}: K4's doubling design as timed at 6ede5d4: "
            f"{K4_EARLIER_MS[si]:.4f} ms")
    return stages, max_err


def write_model_pth(model, path: str) -> None:
    import torch

    torch.save({"model_state_dict": {k: v.cpu() for k, v in
                                     model.state_dict().items()},
                "num_classes": NUM_CLASSES, "epoch": 0, "best_acc": 0.0,
                "class_indices": {f"class_{i}": i
                                  for i in range(NUM_CLASSES)}}, path)


def phase_hillis_serving(root: str):
    """cli.evaluate under hillis with exactly 20 K3 launches per batch and
    no other scan kernel; one batch's float32 logits against the same
    weights on the ssd path (both compute the exact recurrence)."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import evaluate
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import create_model

    write_split(root)
    model = create_model("T", NUM_CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    pth = os.path.join(root, "medmamba_t.pth")
    write_model_pth(model, pth)
    n_batches = -(-N_IMAGES // BATCH)
    with scan_kernel("hillis"):
        reset_counts()
        t0 = time.perf_counter()
        cm, probs = evaluate.main(["--checkpoint_path", pth, "--data_dir",
                                   root, "--batch_size", str(BATCH),
                                   "--image_size", str(IMAGE), "--device",
                                   "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    log(f"  evaluate under hillis: {N_IMAGES} images in {n_batches} batches, "
        f"{wall:.2f} s wall, launches {counts}")
    if counts != expected_counts(K3=LAUNCHES_PER_FORWARD * n_batches):
        raise SystemExit(f"evaluate under hillis launched {counts}")
    if probs.shape != (N_IMAGES, NUM_CLASSES) or not np.isfinite(probs).all() \
            or cm.matrix.sum() != N_IMAGES:
        raise SystemExit(f"bad probabilities: shape {probs.shape}")

    images = np.load(os.path.join(root, "test_images.npy"))[:BATCH]
    x = preprocess(torch.from_numpy(images).cuda(), size=IMAGE)
    model.eval()
    with torch.inference_mode():
        with scan_kernel("hillis"):
            got = model(x)
        with scan_kernel("ssd"):
            want = model(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  logits under hillis vs ssd (batch {BATCH}, float32, TF32 off): "
        f"max|err| {err:.3e} (rtol = atol = {TOL_FP32:g})")
    torch.testing.assert_close(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    return model, counts


def phase_hillis_gradients():
    """One float32 training forward of medmamba_t through K3, its backward
    once through K4 and once through K4's plain version, per parameter."""
    import torch

    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS
    from medmamba_tpu_torch.models.vssm import VSSM
    from medmamba_tpu_torch.ops import scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan_hillis_bwd_ref)
    from medmamba_tpu_torch.train.trainer import cross_entropy

    cfg = MODEL_CONFIGS["T"]
    model = VSSM(num_classes=NUM_CLASSES, depths=cfg.depths, dims=cfg.dims,
                 drop_path_rate=0.0,
                 generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().train()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    x = torch.randn(GRAD_BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    labels = torch.randint(0, NUM_CLASSES, (GRAD_BATCH,), generator=gen,
                           device="cuda")
    labels[-1] = -1
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def grads():
        model.load_state_dict(state)
        model.zero_grad()
        loss = cross_entropy(model(x, labels >= 0), labels)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    with scan_kernel("hillis"):
        reset_counts()
        loss_k, got = grads()
        counts = read_counts()
        # the same K3 forward; _HillisScan's backward calls the plain adjoint
        kernel_bwd = scan_hillis.selective_scan_hillis_bwd
        scan_hillis.selective_scan_hillis_bwd = selective_scan_hillis_bwd_ref
        try:
            loss_p, want = grads()
        finally:
            scan_hillis.selective_scan_hillis_bwd = kernel_bwd
    torch.cuda.synchronize()
    del model
    if counts != expected_counts(K3=LAUNCHES_PER_FORWARD,
                                 K4=LAUNCHES_PER_FORWARD):
        raise SystemExit(f"the hillis training forward launched {counts}")
    return check_model_grads("K3 forward, K4", got, want, loss_k,
                             loss_p)[-1][0]


def phase_probe_vpu():
    """P1 against its plain version for every mode, dtype and k at the TPU
    probe's size, in float32 also the share of the chain's effect it
    carries (``probe_vpu.run`` raises beyond their limits), then its time
    per call, rate and bounds; fails a mode whose rate exceeds 1.05x its
    issue bound (work removed; the only check that sees skipped steps in
    exp, whose output forgets its input after two steps)."""
    from medmamba_tpu_torch.tools import probe_vpu

    reset_counts()
    rows = probe_vpu.run(probe_vpu.MODES)
    counts = read_counts()
    for r in rows:
        log(f"  {r['mode']:5s} {r['dtype']:8s} k={r['k']:3d}: "
            f"{r['ms']:.4f} ms/call, {r['tera_el_ops_s']:.2f} T el-ops/s; "
            f"issue bound {r['issue_tera_el_ops_s']:.2f}, bytes bound "
            f"{r['bytes_tera_el_ops_s']:.2f} T el-ops/s (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}); plain "
            f"{r['plain_ms']:.3f} ms; {r['max_rel_err']:.2e} of the largest "
            f"entry from the plain version"
            + ("" if r["work_share"] is None else
               f", {r['work_share']:.6f} of the chain's effect"))
        if r["tera_el_ops_s"] > 1.05 * r["issue_tera_el_ops_s"]:
            raise SystemExit(f"P1 {r['mode']} {r['dtype']} k={r['k']} runs "
                             "above its issue bound: work was removed")
    if counts != expected_counts(P1=counts["P1"]) or not counts["P1"]:
        raise SystemExit(f"phase 17 launched {counts}")
    return rows, counts["P1"]


def phase_probe_mosaic():
    """P2's 14 probes against their plain versions, exactly; per probe the
    kernel's, library call's and plain version's ms per call queued back to
    back and the kernel's and library call's device time, beside the bytes
    bound; an empty kernel through the same ctypes path."""
    from medmamba_tpu_torch.tools import probe_mosaic

    reset_counts()
    rows = probe_mosaic.run()
    counts = read_counts()
    floor = probe_mosaic.launch_floor()
    for r in rows:
        log(f"  {r['name']}: per call kernel {r['ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms (max|err| "
            f"{r['library_max_abs_err']:.1e}), plain {r['plain_ms']:.4f} ms; "
            f"device kernel {r['device_ms']:.5f} ms, library "
            f"{r['library_device_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms "
            "(bytes)")
    log(f"  an empty kernel through the same ctypes path: {floor['ms']:.4f} "
        f"ms per call, device {floor['device_ms']:.5f} ms")
    if counts != expected_counts(P2=counts["P2"]) or not counts["P2"]:
        raise SystemExit(f"phase 18 launched {counts}")
    return rows, counts["P2"], floor


def write_image_tree(root: str) -> str:
    """A class-folder tree of 3 classes x 3 random 224^2 RGB PNGs."""
    import numpy as np

    from medmamba_tpu_torch.utils import png

    rng = np.random.default_rng(SEED + 9)
    tree = os.path.join(root, "images")
    for c in range(3):
        os.makedirs(os.path.join(tree, f"class_{c}"))
        for i in range(3):
            with open(os.path.join(tree, f"class_{c}", f"{i}.png"),
                      "wb") as f:
                f.write(png.encode(rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                                dtype=np.uint8)))
    return tree


def load_image(path: str):
    """A PNG of the tree as the CLIs take it: preprocessed, on the card."""
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.utils import png

    with open(path, "rb") as f:
        img = png.load_rgb(f.read(), IMAGE)
    return preprocess(torch.from_numpy(img[None]).cuda(), size=IMAGE)


def cam_sites(model, paths: list) -> list:
    """The CAM's targets and every block's output: where check_cam
    substitutes the program's activations."""
    from medmamba_tpu_torch.eval.gradcam import block_paths

    return [*paths, *block_paths(model)]


def check_cam(label: str, got, acts: list, other, x, target_class,
              paths: list):
    """A CAM ``got`` of the program against the CAM of the ``other`` model
    on the same image and class, computed at the program's activations
    ``acts`` (at ``cam_sites``, from the program's forward) substituted
    into the other's forward, so every ReLU masks the same elements in
    both. A CAM is discontinuous where an activation before a ReLU crosses
    zero, and rounding-level differences of the forward cross it at some
    images: about 1 in 8 at ``layers_2.blocks_0.conv1x1`` of medmamba_t
    without the substitution (my chip runs). Within TOL_FP32; and the other
    forward's own activations at ``paths`` within TOL_FP32 of their scale
    of the program's. Returns the CAM's error; exits otherwise."""
    import numpy as np

    from medmamba_tpu_torch.eval.gradcam import grad_cam, target_activations

    want = grad_cam(other, x, target_class=target_class, target_paths=paths,
                    substitute=dict(zip(cam_sites(other, paths), acts)))[0]
    err = float(np.abs(got - want).max())
    act_err = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(acts, target_activations(other, x, paths)))
    note = (f"max|err| {err:.2e}; target activations {act_err:.2e} of "
            "their scale")
    if not (err <= TOL_FP32 and act_err <= TOL_FP32):
        raise SystemExit(f"{label}: the CAMs disagree ({note})")
    log(f"    {label}: {note}")
    return err


CAM_IMAGES = 4
UPSTREAM_TARGETS = ["layers_2.blocks_0.conv1x1", "layers_3.blocks_1.conv1x1"]
DEFAULT_TARGET = ["layers_3.blocks_1.conv1x1"]
# scans downstream of layers_2.blocks_0's conv branch: the SS2Ds of
# layers_2.blocks_1-3 and layers_3.blocks_0-1, two calls each
UPSTREAM_BWD = 10


def check_folder_eval(tree: str, pth: str, model) -> dict:
    """cli.evaluate on the class-folder PNG tree: 20 K1 launches for its
    one batch, and each image's probabilities within 1e-5 of the model's
    softmax on the same pixels."""
    import torch

    from medmamba_tpu_torch.cli import evaluate
    from medmamba_tpu_torch.data.datasets import FolderDataset

    paths = [p for p, _ in FolderDataset(tree, load_size=IMAGE).samples]
    reset_counts()
    t0 = time.perf_counter()
    cm, probs = evaluate.main(["--checkpoint_path", pth, "--data_dir", tree,
                               "--batch_size", str(BATCH), "--image_size",
                               str(IMAGE), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  cli.evaluate on the PNG tree: {len(paths)} images in {wall:.2f} "
        f"s with the model's load, launches {counts}")
    if counts != expected_counts(K1=LAUNCHES_PER_FORWARD):
        raise SystemExit(f"cli.evaluate on the tree launched {counts}, "
                         f"expected {LAUNCHES_PER_FORWARD} K1 only")
    if cm.matrix.sum() != len(paths) or probs.shape != (len(paths),
                                                        NUM_CLASSES):
        raise SystemExit(f"cli.evaluate on the tree counted "
                         f"{cm.matrix.sum()} images, probabilities "
                         f"{probs.shape}")
    with torch.inference_mode():
        x = torch.cat([load_image(p) for p in paths])
        want = torch.softmax(model(x), -1).cpu().numpy()
    err = float(abs(probs - want).max())
    log(f"  probabilities against the model's on the same pixels: max|err| "
        f"{err:.3e} (1e-5)")
    if not err <= 1e-5:
        raise SystemExit("cli.evaluate's probabilities on the tree differ "
                         "from the model's")
    return dict(wall_s=wall, prob_err=err)


def phase_gradcam(root: str):
    """cli.test at the default target and at two targets, the first
    upstream of 10 scans: exact launch counts per image, each CAM against
    the same weights on the plain scan (check_cam) and non-degenerate; one
    image under hillis against the ssd CAM."""
    import torch

    from medmamba_tpu_torch.cli import test as test_cli
    from medmamba_tpu_torch.eval.gradcam import target_activations
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.utils import png

    tree = write_image_tree(root)
    model = create_model("T", NUM_CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    pth = os.path.join(root, "medmamba_t.pth")
    write_model_pth(model, pth)
    model.eval()
    folder = check_folder_eval(tree, pth, model)
    ref = create_model("T", NUM_CLASSES, device="cuda", scan_impl="ref")
    ref.load_state_dict(model.state_dict())
    ref.eval()

    def run_cli(tag, n_images, targets, fwd, bwd, n_bwd):
        argv = ["--checkpoint_path", pth, "--test_dir", tree,
                "--num_classes", str(NUM_CLASSES), "--num_images",
                str(n_images), "--image_size", str(IMAGE), "--device", "cuda",
                "--output_dir", os.path.join(root, tag)]
        if targets:
            argv += ["--target_layers", *targets]
        reset_counts()
        t0 = time.perf_counter()
        out = test_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = expected_counts(**{fwd: 2 * LAUNCHES_PER_FORWARD * n_images,
                                  bwd: n_bwd * n_images})
        per_image = [r["seconds"] for r in out]
        log(f"  cli.test {tag}: {n_images} images in {wall:.2f} s with the "
            f"model's load; per image {', '.join(f'{t:.4f}' for t in per_image)}"
            f" s, launches {counts}")
        if counts != want or len(out) != n_images:
            raise SystemExit(f"cli.test {tag} launched {counts} for "
                             f"{len(out)} images, expected {want}")
        for r in out:
            with open(r["out"], "rb") as f:
                if png.decode(f.read()).shape != (IMAGE, 2 * IMAGE, 3):
                    raise SystemExit(f"{r['out']} is not the side-by-side "
                                     "pair")
        return out, wall

    results = {}
    for tag, targets, n_bwd in (("default", None, 0),
                                ("upstream", UPSTREAM_TARGETS, UPSTREAM_BWD)):
        out, wall = run_cli(tag, CAM_IMAGES, targets, "K1", "K2", n_bwd)
        paths = targets or DEFAULT_TARGET
        worst = 0.0
        for r in out:
            x = load_image(r["path"])
            spread = float(r["cam"].max() - r["cam"].min())
            label = (f"{os.path.relpath(r['path'], tree)} (class "
                     f"{r['pred']}, conf {r['conf']:.4f}, CAM max - min "
                     f"{spread:.4f}) against the plain scan")
            worst = max(worst, check_cam(
                label, r["cam"], target_activations(
                    model, x, cam_sites(model, paths)),
                ref, x, [r["pred"]], paths))
            if spread <= 0.5:
                raise SystemExit(f"cli.test {tag}: the CAM of {r['path']} "
                                 "is degenerate")
        results[tag] = dict(out=out, wall=wall, cam_err=worst,
                            s_per_image=statistics.median(
                                r["seconds"] for r in out[1:]))

    with scan_kernel("hillis"):
        out, _ = run_cli("hillis", 1, UPSTREAM_TARGETS, "K3", "K4",
                         UPSTREAM_BWD)
        x = load_image(out[0]["path"])
        acts = target_activations(model, x,
                                  cam_sites(model, UPSTREAM_TARGETS))
    if out[0]["path"] not in {r["path"] for r in results["upstream"]["out"]}:
        raise SystemExit("the hillis run picked another image")
    results["hillis_err"] = check_cam(
        "hillis CAM against the ssd CAM", out[0]["cam"], acts, model, x,
        [out[0]["pred"]], UPSTREAM_TARGETS)
    results["folder_eval"] = folder
    return tree, pth, results


def phase_demo(tree: str, pth: str):
    """cli.demo's server in a thread: two POSTs of an RGB PNG (target -1
    and 3), a POST of an RGBA PNG and GET /random?mode=gt; per request 20
    K1 for the prediction and 20 for the CAM, no K2; the page's two PNGs,
    and its probabilities against the same model's softmax on the same
    pixels."""
    import base64
    import threading
    import urllib.request

    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import demo
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.utils import png

    rng = np.random.default_rng(SEED + 10)
    rgb = rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (IMAGE, IMAGE, 4), dtype=np.uint8)
    check = create_model("T", NUM_CLASSES, device="cuda")
    check.load_state_dict(restore_params(pth)[0], strict=True)
    check.eval()

    def multipart(data: bytes, target: int):
        b = "medmambaBoundary7"
        body = (f"--{b}\r\nContent-Disposition: form-data; name=\"image\"; "
                f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n"
                ).encode() + data + (
            f"\r\n--{b}\r\nContent-Disposition: form-data; name=\"target\""
            f"\r\n\r\n{target}\r\n--{b}--\r\n").encode()
        return body, {"Content-Type": f"multipart/form-data; boundary={b}"}

    srv = demo.make_server(demo.parse_args(
        ["--checkpoint_path", pth, "--port", "0", "--image_size",
         str(IMAGE), "--device", "cuda", "--test_dir", tree]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = [("POST rgb target -1", rgb, -1), ("POST rgb target 3", rgb, 3),
                ("POST rgba target -1", rgba, -1),
                ("GET /random?mode=gt", None, None)]
    latencies, worst = [], 0.0
    try:
        for label, img, target in requests:
            if img is None:
                req = urllib.request.Request(url + "/random?mode=gt")
            else:
                body, headers = multipart(png.encode(img), target)
                req = urllib.request.Request(url, data=body, headers=headers)
            reset_counts()
            t0 = time.perf_counter()
            page = urllib.request.urlopen(req, timeout=300).read().decode()
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            counts = read_counts()
            if counts != expected_counts(K1=2 * LAUNCHES_PER_FORWARD):
                raise SystemExit(f"demo {label} launched {counts}")
            if "Prediction:" not in page:
                raise SystemExit(f"demo {label}: no prediction in the page: "
                                 f"{page[-400:]}")
            pngs = [png.decode(base64.b64decode(s)) for s in re.findall(
                r"data:image/png;base64,([A-Za-z0-9+/=]+)", page)]
            if len(pngs) != 2 or any(p.shape != (IMAGE, IMAGE, 3)
                                     for p in pngs):
                raise SystemExit(f"demo {label}: page images "
                                 f"{[p.shape for p in pngs]}")
            if img is None:
                path = re.search(r"random pick: <code>([^<]+)</code>",
                                 page).group(1)
                with open(path, "rb") as f:
                    pixels = png.decode(f.read())
            else:
                pixels = img[..., :3]
            if not np.array_equal(pngs[0], pixels):
                raise SystemExit(f"demo {label}: the page's input image is "
                                 "not the pixels sent")
            probs = np.array(json.loads(re.search(r"data-probs='([^']+)'",
                                                  page).group(1)))
            with torch.no_grad():
                want = torch.softmax(check(preprocess(torch.from_numpy(
                    pixels[None]).cuda(), size=IMAGE)), -1)[0].cpu().numpy()
            err = float(np.abs(probs - want).max())
            worst = max(worst, err)
            log(f"  {label}: {latencies[-1] * 1e3:.1f} ms, launches {counts}, "
                f"probabilities sum {probs.sum():.7f}, against the model's "
                f"softmax max|err| {err:.2e}")
            if abs(probs.sum() - 1) > 1e-4 or err > 1e-5:
                raise SystemExit(f"demo {label}: probabilities disagree")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    median_ms = statistics.median(latencies[1:]) * 1e3
    log(f"  median latency per request after the first: {median_ms:.1f} ms "
        f"(first {latencies[0] * 1e3:.1f} ms)")

    return dict(latency_ms=[t * 1e3 for t in latencies],
                median_ms=median_ms, prob_err=worst)


def run(argv: list, env: dict, what: str) -> str:
    """Run ``argv`` from the checkout with ``env`` added to the environment;
    its standard output, or exit non-zero with its output if it fails."""
    proc = subprocess.run(argv, cwd=REPO, env=dict(os.environ, **env),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"{what} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout


def batch1_op_vs_direct(kernel: str) -> dict:
    """The scan's host time per batch-1 forward (20 launches of ``kernel``,
    K1 or K3, reverse groups), queued back to back through the graph op
    (``ops.selective_scan``'s no-grad path) and called as the live path
    called it before the op (K1's ctypes wrapper; ``_hillis_scan`` around
    K3's), in turns (direct, op, op, direct)."""
    import torch

    from medmamba_tpu_torch.ops import scan_cuda, scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (_hillis_scan,
                                                       selective_scan)

    rev = (True, True)
    if kernel == "K1":
        def direct(x):
            return scan_cuda.selective_scan_fwd(**x, delta_softplus=True,
                                                reverse_dirs=rev)
    else:
        def direct(x):
            return _hillis_scan(
                *(x[k] for k in ("u", "delta", "A", "B", "C", "D",
                                 "delta_bias")), True, False, rev, 1, None,
                scan_hillis.selective_scan_hillis_fwd,
                scan_hillis.selective_scan_hillis_bwd)
    paths = {"direct": direct, "op": lambda x: selective_scan(
        **x, delta_softplus=True, reverse_dirs=rev)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_fwd = dict.fromkeys(paths, 0.0)
    with scan_kernel("ssd" if kernel == "K1" else "hillis"):
        for dpg, l, blocks in STAGES:
            xs = [scan_inputs(dpg, l, torch.float32, gen, batch=1)
                  for _ in range(8)]
            # each path runs twice, and each block launches the kernel twice
            for name in ("direct", "op", "op", "direct"):
                per_fwd[name] += blocks * back_to_back_ms(paths[name], xs, 20)
    return per_fwd


def phase_export(root: str, pth: str) -> dict:
    """Phase 21 (see the docstring): ``root`` holds phase 4's checkpoint
    ``pth``; the artifacts, frames and probabilities go there too."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS, create_model
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.utils.export import load_exported
    from medmamba_tpu_torch.utils.profiling import model_flops_report

    log(f"  torch {torch.__version__}")
    frames = np.random.default_rng(SEED + 21).integers(
        0, 256, (max(EXPORT_BATCHES), IMAGE, IMAGE, 3), dtype=np.uint8)
    frames_path = os.path.join(root, "frames.npy")
    np.save(frames_path, frames)
    x = torch.from_numpy(frames).cuda()
    model = create_model("T", NUM_CLASSES, device="cuda")
    model.load_state_dict(restore_params(pth)[0], strict=True)
    model.eval()

    def live(xb):
        with torch.no_grad():
            return torch.softmax(model(preprocess(xb, size=IMAGE)), -1)

    macs = model_flops_report(MODEL_CONFIGS["T"].depths,
                              MODEL_CONFIGS["T"].dims, IMAGE,
                              num_classes=NUM_CLASSES)["total_macs"]
    out = {"gflop_per_image": 2 * macs / 1e9}
    for scan, other in (("ssd", "hillis"), ("hillis", "ssd")):
        kernel = "K1" if scan == "ssd" else "K3"
        art = os.path.join(root, f"medmamba_t_{scan}.pt2")
        t0 = time.perf_counter()
        line = run([sys.executable, "-m", "medmamba_tpu_torch.cli.export",
                    "--checkpoint_path", pth, "--out", art, "--image_size",
                    str(IMAGE)], {"MEDMAMBA_SCAN_KERNEL": scan},
                   f"cli.export under {scan}").strip().splitlines()[-1]
        export_s = time.perf_counter() - t0
        log(f"  cli.export under MEDMAMBA_SCAN_KERNEL={scan}: {line} "
            f"({export_s:.1f} s wall)")
        if f"scan kernel {kernel}" not in line:
            raise SystemExit(f"cli.export under {scan} did not bake {kernel}")
        t0 = time.perf_counter()
        res = run([sys.executable, "-c", LOAD_ARTIFACT, art, frames_path,
                   os.path.join(root, scan),
                   ",".join(map(str, EXPORT_BATCHES))],
                  {"MEDMAMBA_SCAN_KERNEL": other},
                  f"loading the {scan} artifact")
        load_s = time.perf_counter() - t0
        res = json.loads(next(ln for ln in res.splitlines()
                              if ln.startswith("result "))[len("result "):])
        want_counts = ([LAUNCHES_PER_FORWARD, 0] if scan == "ssd"
                       else [0, LAUNCHES_PER_FORWARD])
        worst = 0.0
        with scan_kernel(scan):
            for b in EXPORT_BATCHES:
                got = np.load(os.path.join(root, f"{scan}_{b}.npy"))
                want = live(x[:b]).cpu().numpy()
                if got.shape != (b, NUM_CLASSES) \
                        or not np.isfinite(got).all():
                    raise SystemExit(f"{scan} artifact at batch {b}: "
                                     f"probabilities of shape {got.shape}")
                err = float(np.abs(got - want).max())
                worst = max(worst, err)
                counts = res["counts"][str(b)]
                log(f"  {scan} artifact at batch {b}: K1 {counts[0]}, K3 "
                    f"{counts[1]} launches a call (loaded with "
                    f"MEDMAMBA_SCAN_KERNEL={other}); against the live "
                    f"forward max|err| {err:.3e} (atol {TOL_EXPORT:g})")
                if counts != want_counts:
                    raise SystemExit(f"the {scan} artifact launched "
                                     f"{counts} (K1, K3) at batch {b}, "
                                     f"expected {want_counts}")
                if err > TOL_EXPORT:
                    raise SystemExit(f"the {scan} artifact's probabilities "
                                     f"are {err:.3e} off the live forward's")
            live_ms = back_to_back_ms(live, [x[:BATCH]], 10)
            live_ms1 = back_to_back_ms(live, [x[:1]], 10)
            # the artifact beside the live forward in this process: in
            # turns, then the profiler's device time of each at batch 64,
            # and its scan kernel's at batch 1 (the kernel's layout is
            # chosen at each launch: the artifact's batch-1 launches take
            # the narrow blocks as the live ones do)
            with open(art, "rb") as f:
                fns = {"live": live, "artifact": load_exported(f.read()).call}
            turns = {name: [] for name in fns}
            for name in ("live", "artifact", "artifact", "live"):
                turns[name].append(back_to_back_ms(fns[name], [x[:BATCH]],
                                                   10))
            device, scan_b1 = {}, {}
            for name, fn in fns.items():
                device[name] = profile_families(
                    lambda: fn(x[:BATCH]), "forward")["kernel_ms_per_forward"]
                scan_b1[name] = profile_families(
                    lambda: fn(x[:1]), "forward")[
                        "family_ms_per_forward"].get(FAMILY[kernel], 0.0)
            del fns
        art_ms, art_ms1 = res["ms"][str(BATCH)], res["ms"]["1"]
        out[scan] = dict(
            artifact_mb=os.path.getsize(art) / 1e6, export_s=export_s,
            load_and_call_s=load_s, launches_per_call=want_counts,
            max_abs_err=worst, artifact_ms=art_ms,
            artifact_img_s=BATCH / art_ms * 1e3, live_ms=live_ms,
            live_img_s=BATCH / live_ms * 1e3, artifact_ms_batch1=art_ms1,
            live_ms_batch1=live_ms1, in_turns_ms=turns,
            device_ms=device, scan_device_ms_batch1=scan_b1,
            fp32_peak_share=2 * macs * BATCH / art_ms * 1e3
            / PEAK_FP32_OPS_PER_S)
        log(f"  {scan} batch {BATCH}: artifact {art_ms:.3f} ms, "
            f"{out[scan]['artifact_img_s']:.1f} img/s; live {live_ms:.3f} "
            f"ms, {out[scan]['live_img_s']:.1f} img/s; batch 1: artifact "
            f"{art_ms1:.3f} ms, live {live_ms1:.3f} ms")
        log(f"  {scan} batch {BATCH} in this process, in turns (live, "
            f"artifact, artifact, live): live {turns['live']} ms, artifact "
            f"{turns['artifact']} ms; device time a forward (profiler, "
            f"{PROFILE_STEPS} forwards): "
            f"live {device['live']:.3f} ms, artifact "
            f"{device['artifact']:.3f} ms; {kernel}'s device time a batch-1 "
            f"forward: live {scan_b1['live']:.4f} ms, artifact "
            f"{scan_b1['artifact']:.4f} ms")
        log(f"  {scan}: analytic forward {out['gflop_per_image']:.3f} GFLOP "
            f"an image (model_flops_report, 2 FLOPs a MAC): at the "
            f"artifact's rate {100 * out[scan]['fp32_peak_share']:.2f}% of "
            f"the float32 peak ({PEAK_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    for kernel, before in (("K1", "the ctypes wrapper"),
                           ("K3", "_hillis_scan")):
        out[f"{kernel}_batch1_ms_per_forward"] = t = batch1_op_vs_direct(
            kernel)
        log(f"  {kernel} per batch-1 forward ({LAUNCHES_PER_FORWARD} "
            f"launches, queued back to back): through the graph op "
            f"{t['op']:.4f} ms, through {before} {t['direct']:.4f} ms; "
            f"{1e3 * (t['op'] - t['direct']) / LAUNCHES_PER_FORWARD:.1f} "
            "us more a launch")
    return out


def phase_bf16_kernels():
    """K1-K4 in the bfloat16 compute mode against their plain versions in
    the mode at the stage shapes (batch 64 float32 and bfloat16 inputs,
    batch 1 float32), each output relative to its largest entry: float32
    outputs 1e-4 (the roundings fall on the same float32 values; the sums
    run in another order), bfloat16 outputs 1e-2 (their last rounding).
    K2 and K4 run on the states their forward kernel wrote, so each is held
    alone. On the float32 batch-64 inputs each kernel's output moves by at
    least BF16_MOVES of its scale off the float32 instantiation's (dD, which
    no rounding reaches, keeps its bits); K2 and K4 give the same bits on
    two launches at stage 0; each kernel's time per stage, float32 inputs,
    in the mode and in float32 in turns (float32, mode, mode, float32),
    beside the float32 bound (the mode moves the same bytes). Returns
    {kernel: stage rows} and {kernel: max abs error of float32 outputs}."""
    import torch

    from medmamba_tpu_torch.ops import scan_cuda, scan_hillis
    from medmamba_tpu_torch.ops import selective_scan as ss

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    b16, f32, mixed = "bfloat16", torch.float32, (False, True)

    def args(x):
        return [x[k] for k in names]

    def k1(x, compute, out_dtype=None):
        return scan_cuda.selective_scan_fwd(
            **x, delta_softplus=True, reverse_dirs=mixed,
            out_dtype=out_dtype, return_last_state=True, return_states=True,
            compute=compute)

    def k1_plain(x, out_dtype=None):
        y, last = ss._plain_scan(*args(x), True, True, mixed, 1, out_dtype,
                                 None, b16)
        return y, last, ss.selective_scan_states_ref(
            *args(x)[:5], x["delta_bias"], True, mixed, compute=b16)

    def k2(s, compute, impl=scan_cuda.selective_scan_bwd):
        x, states, gy = s
        return impl(*args(x), states, gy, delta_softplus=True,
                    reverse_dirs=mixed, compute=compute)

    def k3(x, compute, impl=scan_hillis.selective_scan_hillis_fwd):
        return impl(*args(x), delta_softplus=True, compute=compute)

    def k4(s, compute, impl=scan_hillis.selective_scan_hillis_bwd):
        x, states, gy = s
        return impl(*args(x), states, gy, delta_softplus=True,
                    compute=compute)

    def timed(fn):
        """fn's result and its time in ms on the card (one call)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    max_abs = dict.fromkeys(("K1", "K2", "K3", "K4"), 0.0)

    def check(kernel, label, parts, got, want):
        errs = {}
        for part, g, w in zip(parts, got, want):
            if w is None:
                continue
            if g.dtype != w.dtype or g.shape != w.shape:
                raise SystemExit(f"{kernel} in the bfloat16 mode, {part}: "
                                 f"{g.dtype} {tuple(g.shape)}, expected "
                                 f"{w.dtype} {tuple(w.shape)}")
            errs[part] = rel_err(g, w)
            tol = TOL_BF16_OUT if g.dtype == torch.bfloat16 else TOL_FP32
            if errs[part] > tol:
                raise SystemExit(f"{kernel} in the bfloat16 mode {label} "
                                 f"{part}: relative error {errs[part]:.3e} "
                                 f"above {tol:g}")
            if g.dtype == torch.float32:
                max_abs[kernel] = max(max_abs[kernel],
                                      (g - w).abs().max().item())
        log(f"  {kernel} {label}: " + ", ".join(
            f"{k} {v:.1e}" for k, v in errs.items()) + " of their scale")

    def moved(kernel, got, f32_out, parts):
        out = {}
        for part, g, w in zip(parts, got, f32_out):
            if w is None or not w.any():
                continue      # the states of a one-tile scan: zero in both
            out[part] = rel_err(g, w)
            if part == "dD":
                if not torch.equal(g, w):
                    raise SystemExit(f"{kernel}: dD moved in the mode")
            elif out[part] < BF16_MOVES:
                raise SystemExit(f"{kernel} in the bfloat16 mode: {part} "
                                 f"moved {out[part]:.2e} of its scale off "
                                 f"float32, under {BF16_MOVES:g}")
        log(f"  {kernel} moved off float32: " + ", ".join(
            f"{k} {v:.1e}" for k, v in out.items()))

    fwd_parts = ("y", "last", "states")
    grad_parts = tuple("d" + n for n in names)
    rows = {k: [] for k in max_abs}
    for si, (dpg, l, blocks) in enumerate(STAGES):
        plain = {}
        for label, dtype, batch in (("fp32", f32, BATCH),
                                    ("bf16 in", torch.bfloat16, BATCH),
                                    ("fp32 batch 1", f32, 1)):
            x = scan_inputs(dpg, l, dtype, gen, batch)
            tag = f"stage {si} D={GROUPS * dpg} L={l} {label}"
            got1 = k1(x, b16, dtype)
            want1, plain["K1"] = timed(lambda: k1_plain(x, dtype))
            check("K1", tag, fwd_parts, got1, want1)
            gy = torch.randn(got1[0].shape, generator=gen,
                             device="cuda").to(dtype)
            s2 = (x, got1[2], gy)
            want2, plain["K2"] = timed(
                lambda: k2(s2, b16, ss.selective_scan_bwd_ref))
            check("K2", tag, grad_parts, k2(s2, b16), want2)
            got3 = k3(x, b16)
            want3, plain["K3"] = timed(
                lambda: k3(x, b16, ss.selective_scan_hillis_ref))
            check("K3", tag, ("y", "states", "last"), got3, want3)
            s4 = (x, got3[1], torch.randn(got3[0].shape, generator=gen,
                                          device="cuda"))
            want4, plain["K4"] = timed(
                lambda: k4(s4, b16, ss.selective_scan_hillis_bwd_ref))
            check("K4", tag, grad_parts, k4(s4, b16), want4)
            if label == "fp32":
                plain_ms = dict(plain)
                moved("K1", got1, k1(x, "float32"), fwd_parts)
                moved("K2", k2(s2, b16), k2(s2, "float32"), grad_parts)
                moved("K3", got3, k3(x, "float32"), ("y", "states", "last"))
                moved("K4", k4(s4, b16), k4(s4, "float32"), grad_parts)
                if si == 0:
                    for kernel, fn, s in (("K2", k2, s2), ("K4", k4, s4)):
                        first, second = fn(s, b16), fn(s, b16)
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b) for a, b in
                                   zip(first, second) if a is not None):
                            raise SystemExit(f"{kernel} in the bfloat16 "
                                             "mode: two launches differ")
                    log("  stage 0: two K2 and two K4 launches in the mode "
                        "give the same bits in every gradient")
            del x, gy, s2, s4, got1, got3
        # time per launch, float32 inputs, float32 and the mode in turns
        costs = {"K1": dict(zip(("bytes_ms", "ops_ms", "exp_ms"),
                                scan_costs(dpg, l))),
                 "K2": dict(zip(("bytes_ms", "ops_ms", "exp_ms"),
                                k2_costs(dpg, l))),
                 "K3": k3_costs(dpg, l), "K4": k4_costs(dpg, l)}
        n_sets = max(2, math.ceil(3 * L2_BYTES / (
            costs["K2"]["bytes_ms"] * 1e-3 * PEAK_BYTES_PER_S)))
        xs = [scan_inputs(dpg, l, f32, gen) for _ in range(n_sets)]
        work = {"K1": (k1, xs), "K3": (k3, xs),
                "K2": (k2, [(x, k1(x, "float32")[2],
                             torch.randn(x["delta"].shape, generator=gen,
                                         device="cuda")) for x in xs]),
                "K4": (k4, [(x, k3(x, "float32")[1],
                             torch.randn(x["delta"].shape, generator=gen,
                                         device="cuda")) for x in xs])}
        for kernel, (fn, sets) in work.items():
            t = [back_to_back_ms(lambda s, c=c: fn(s, c), sets, 20)
                 for c in ("float32", b16, b16, "float32")]
            row = dict(stage=si, D=GROUPS * dpg, L=l, launches=2 * blocks,
                       ms=(t[1] + t[2]) / 2, ms_fp32=(t[0] + t[3]) / 2,
                       in_turns=t, plain_ms=plain_ms[kernel],
                       **costs[kernel])
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            rows[kernel].append(row)
            log(f"  stage {si} D={GROUPS * dpg} L={l}: {kernel} in the mode "
                f"{row['ms']:.4f} ms, float32 {row['ms_fp32']:.4f} ms (in "
                f"turns {' '.join(f'{v:.4f}' for v in t)}), bound "
                f"{row['bound_ms']:.4f} ms, plain in the mode "
                f"{row['plain_ms']:.1f} ms, x{2 * blocks}")
        del work, xs
    return rows, max_abs


def phase_bf16_model(root: str):
    """The main paths under the bfloat16 compute mode on both kernel
    pairs: cli.train and cli.evaluate with exact launch counts; the
    logits of medmamba_t at batch 64 and its first training step's loss
    (bfloat16 blocks, augmentation, the same generator) against the float32
    mode's; the eval forward (10 back to back) and the bfloat16-block train
    step with augmentation on a resident uint8 batch (5 back to back), each
    timed in the float32 mode and in the bfloat16 mode in turns (float32,
    mode, mode, float32: the steps are host-bound and swing between
    calls), and on K1/K2 their device time by kernel family in the
    mode."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    out = {}
    images = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, 256, (BATCH, 28, 28, 3), dtype=np.uint8)).cuda()
    labels = torch.arange(BATCH, device="cuda") % NUM_CLASSES
    for scan, fwd, bwd in (("ssd", "K1", "K2"), ("hillis", "K3", "K4")):
        res = out[scan] = {}
        with scan_kernel(scan), scan_compute("bfloat16"):
            path = os.path.join(root, scan)
            os.makedirs(path)
            res["train_counts"], _ = phase_train_path(path, fwd, bwd)
        model = create_model("T", NUM_CLASSES, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        model.eval()
        x = preprocess(images, size=IMAGE)
        logits, loss = {}, {}
        for compute in ("float32", "bfloat16"):
            with scan_kernel(scan), scan_compute(compute):
                with torch.inference_mode():
                    logits[compute] = model(x)
                net = create_model(
                    "T", NUM_CLASSES, dtype=torch.bfloat16, device="cuda",
                    generator=torch.Generator().manual_seed(SEED))
                opt, _ = trainer.make_optimizer(net.parameters(), 1e-3, True)
                loss[compute] = trainer.train_step(
                    net, opt, images, labels, augment=True, image_size=IMAGE,
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED)).item()
                del net, opt
        res["logits_rel_err"] = rel_err(logits["bfloat16"],
                                        logits["float32"])
        res["loss"] = loss
        loss_err = abs(loss["bfloat16"] - loss["float32"]) / max(
            1.0, abs(loss["float32"]))
        log(f"  {scan} in the mode against float32: logits (batch {BATCH}) "
            f"{res['logits_rel_err']:.3e} of their scale, first-step loss "
            f"{loss['bfloat16']:.6f} against {loss['float32']:.6f} "
            f"({loss_err:.3e}; limit {TOL_BF16_MODE:g} for both)")
        if not (math.isfinite(loss["bfloat16"]) and torch.isfinite(
                logits["bfloat16"]).all()):
            raise SystemExit(f"{scan} in the bfloat16 mode: not finite")
        if res["logits_rel_err"] > TOL_BF16_MODE or loss_err > TOL_BF16_MODE:
            raise SystemExit(f"{scan} in the bfloat16 mode strays from "
                             "float32")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
        big = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=gen,
                            device="cuda", dtype=torch.uint8)
        net = create_model("T", NUM_CLASSES, dtype=torch.bfloat16,
                           device="cuda",
                           generator=torch.Generator().manual_seed(SEED))
        opt, _ = trainer.make_optimizer(net.parameters(), 1e-3, True)

        def step(_):
            return trainer.train_step(net, opt, big, labels, generator=gen,
                                      augment=True, image_size=IMAGE)
        turns = {"eval": [], "train": []}
        with scan_kernel(scan), torch.inference_mode():
            for compute in ("float32", "bfloat16", "bfloat16", "float32"):
                with scan_compute(compute):
                    turns["eval"].append(back_to_back_ms(model, [x], 10))
        with scan_kernel(scan):
            for compute in ("float32", "bfloat16", "bfloat16", "float32"):
                with scan_compute(compute):
                    turns["train"].append(back_to_back_ms(step, [None], 5))
        for name, t in turns.items():
            ms, ms32 = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            res.update({f"{name}_ms": ms, f"{name}_img_s": BATCH / ms * 1e3,
                        f"{name}_ms_fp32": ms32,
                        f"{name}_img_s_fp32": BATCH / ms32 * 1e3,
                        f"{name}_in_turns_ms": t})
            what = ("eval forward" if name == "eval"
                    else "bf16-block train step")
            log(f"  {scan} {what}: in the mode {ms:.3f} ms, "
                f"{BATCH / ms * 1e3:.1f} img/s; float32 {ms32:.3f} ms, "
                f"{BATCH / ms32 * 1e3:.1f} img/s (in turns "
                f"{' '.join(f'{v:.3f}' for v in t)})")
        res["eval_profile"] = res["train_profile"] = None
        if scan == "ssd":
            with scan_kernel(scan), scan_compute("bfloat16"):
                with torch.inference_mode():
                    res["eval_profile"] = profile_families(
                        lambda: model(x), "forward")
                res["train_profile"] = profile_families(lambda: step(None),
                                                        "step")
        del model, logits, net, opt
        torch.cuda.empty_cache()
    return out


def sum_rows(rows: list) -> dict:
    """Probe rows summed: one call of each case or probe."""
    out = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "device_ms",
                     "library_device_ms") if k in rows[0]}
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    out["bound_by"] = ("operations" if by_ops > out["bound_ms"] / 2
                       else "bytes")
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    if all("library_ms" in r for r in rows):
        out["library_ms"] = sum(r["library_ms"] for r in rows)
    return out


def reset_counts() -> None:
    from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis
    from medmamba_tpu_torch.tools import probe_mosaic, probe_vpu

    scan_cuda.LAUNCHES = scan_cuda.BWD_LAUNCHES = rotate.LAUNCHES = 0
    scan_hillis.HILLIS_LAUNCHES = scan_hillis.HILLIS_BWD_LAUNCHES = 0
    probe_vpu.LAUNCHES = probe_mosaic.LAUNCHES = 0


def read_counts() -> dict:
    from medmamba_tpu_torch.ops import rotate, scan_cuda, scan_hillis
    from medmamba_tpu_torch.tools import probe_mosaic, probe_vpu

    return {"K1": scan_cuda.LAUNCHES, "K2": scan_cuda.BWD_LAUNCHES,
            "K3": scan_hillis.HILLIS_LAUNCHES,
            "K4": scan_hillis.HILLIS_BWD_LAUNCHES, "K5": rotate.LAUNCHES,
            "P1": probe_vpu.LAUNCHES, "P2": probe_mosaic.LAUNCHES}


def write_split(root: str) -> None:
    import numpy as np

    rng = np.random.default_rng(SEED)
    np.save(os.path.join(root, "test_images.npy"),
            rng.integers(0, 256, (N_IMAGES, 28, 28, 3), dtype=np.uint8))
    np.save(os.path.join(root, "test_labels.npy"),
            rng.integers(0, NUM_CLASSES, (N_IMAGES, 1)).astype(np.int64))


def phase_main_path(root: str):
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import evaluate
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import create_model

    write_split(root)
    model = create_model("T", NUM_CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    pth = os.path.join(root, "medmamba_t.pth")
    torch.save({"model_state_dict": {k: v.cpu() for k, v in
                                     model.state_dict().items()},
                "num_classes": NUM_CLASSES, "epoch": 0, "best_acc": 0.0,
                "class_indices": {f"class_{i}": i
                                  for i in range(NUM_CLASSES)}}, pth)

    n_batches = -(-N_IMAGES // BATCH)
    reset_counts()
    t0 = time.perf_counter()
    cm, probs = evaluate.main(["--checkpoint_path", pth, "--data_dir", root,
                               "--batch_size", str(BATCH), "--image_size",
                               str(IMAGE), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["K1"]
    log(f"  evaluate: {N_IMAGES} images in {n_batches} batches, "
        f"{wall:.2f} s wall, launches {counts}")
    if counts != expected_counts(K1=LAUNCHES_PER_FORWARD * n_batches):
        raise SystemExit(f"evaluate launched {counts}, expected "
                         f"{LAUNCHES_PER_FORWARD * n_batches} K1 only")
    if probs.shape != (N_IMAGES, NUM_CLASSES) or not np.isfinite(probs).all():
        raise SystemExit(f"bad probabilities: shape {probs.shape}")
    if not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise SystemExit("probabilities do not sum to 1")
    if cm.matrix.sum() != N_IMAGES:
        raise SystemExit(f"confusion matrix holds {cm.matrix.sum()} rows")

    # one batch through the kernel path and the plain scan, at the precision
    # the port's entry points fix: float32 without TF32, which the timing
    # below runs under too
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise SystemExit("TF32 is on after the port's entry points ran")
    ref = create_model("T", NUM_CLASSES, device="cuda", scan_impl="ref")
    ref.load_state_dict(model.state_dict())
    model.eval()
    ref.eval()
    images = np.load(os.path.join(root, "test_images.npy"))[:BATCH]
    x = preprocess(torch.from_numpy(images).cuda(), size=IMAGE)
    with torch.inference_mode():
        got = model(x)
        want = ref(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  logits kernel vs plain scan (batch {BATCH}): max|err| {err:.3e} "
        f"(rtol = atol = {TOL_FP32:g}), "
        f"|logits| max {want.abs().max().item():.3e}")
    torch.testing.assert_close(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    return model, launches, wall


# kernel families of the profile; the first match wins. cuDNN's convolution
# kernels also carry "gemm" in their names, so convolution is tried first.
FAMILY = {"K1": "selective_scan_fwd (K1)", "K2": "selective_scan_bwd (K2)",
          "K3": "selective_scan_hillis_fwd (K3)",
          "K4": "selective_scan_hillis_bwd (K4)", "K5": "rotate_flip (K5)"}
FAMILIES = (
    (FAMILY["K3"], r"hillis_fwd_kernel"),
    (FAMILY["K4"], r"hillis_bwd_(states_|reduce_)?kernel"),
    (FAMILY["K1"], r"scan_fwd_kernel"),
    (FAMILY["K2"], r"scan_bwd_(reduce_)?kernel"),
    (FAMILY["K5"], r"rotate_flip_kernel"),
    ("convolution", r"conv|cudnn|fprop|winograd|implicit|nchw|nhwc"),
    ("matmul", r"gemm|gemv|cutlass|xmma|cublas|splitK"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("reduction", r"reduce"),
    ("concat", r"[Cc]at"),
    ("elementwise/copy", r"elementwise|vectorized|unrolled|copy"),
)


def family(name: str) -> str:
    return next((fam for fam, pattern in FAMILIES
                 if re.search(pattern, name)), "other")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_families(fn, unit: str) -> dict:
    """Device time per call of ``fn`` by kernel family, from
    ``torch.profiler`` over PROFILE_STEPS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    by_family, by_name = {}, {}
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3 / PROFILE_STEPS
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + dur
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    return {
        f"host_wall_ms_per_{unit}": wall_ms / PROFILE_STEPS,
        f"kernel_ms_per_{unit}": sum(by_family.values()),
        "busy_share_of_kernel_window": busy_us(spans) / window,
        f"family_ms_per_{unit}": dict(
            sorted(by_family.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:120],
                         f"launches_per_{unit}": n / PROFILE_STEPS,
                         f"ms_per_{unit}": t} for k, (n, t) in top]}


def phase_timing(model):
    """Forward throughput (back-to-back forwards between one event pair)
    and the device time per forward by kernel family."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    model.eval()
    with torch.inference_mode():
        fwd_ms = back_to_back_ms(model, [x], 10)
        prof_line = profile_families(lambda: model(x), "forward")
    return fwd_ms, BATCH / fwd_ms * 1e3, prof_line


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "medmamba_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(medmamba_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from medmamba_tpu_torch.ops import (cuda_build, rotate, scan_cuda,
                                        scan_hillis)
    from medmamba_tpu_torch.tools import probe_mosaic, probe_vpu

    t_start = time.perf_counter()

    def header(msg: str) -> None:
        log(f"{msg} [at {time.perf_counter() - t_start:.1f} s]")

    header("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    header("phase 2: build")
    t0 = time.perf_counter()
    sources = (scan_cuda.FWD_SOURCE, scan_cuda.BWD_SOURCE, rotate.SOURCE,
               scan_hillis.FWD_SOURCE, scan_hillis.BWD_SOURCE,
               probe_vpu.SOURCE, probe_mosaic.SOURCE)
    libs = cuda_build.build(*sources)
    log(f"  built {', '.join(os.path.relpath(p, REPO) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        with open(lib[:-3] + ".log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling entry" in line:
                    log(f"  ptxas {os.path.basename(lib)}: {line.strip()}")

    for batch in (BATCH, 1):
        for si, (dpg, l, _) in enumerate(STAGES):
            cfg = scan_cuda.selective_scan_fwd_config(batch, GROUPS, dpg)
            log(f"  K1 at batch {batch} stage {si}: "
                f"{cfg['channels_per_block']} channels a block, "
                f"{cfg['smem_bytes']} B of dynamic shared memory, "
                f"{cfg['registers']} registers, {cfg['blocks_per_sm']} "
                "blocks an SM")

    header("phase 3: K1 against its plain version")
    stages, max_err = phase_kernel_vs_plain()

    header("phase 4: serving path (cli.evaluate, medmamba_t 224^2 batch 64)")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    # kept to phase 21, which exports its checkpoint
    serve_dir = tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR)
    model, launches, eval_wall = phase_main_path(serve_dir.name)

    header("phase 5: timing")
    fwd_ms, img_s, prof_line = phase_timing(model)
    del model
    k1_device_ms = prof_line["family_ms_per_forward"].get(FAMILY["K1"], 0.0)
    per_fwd = per_pass(stages)
    log(f"  medmamba_t eval forward, 224^2, batch {BATCH}, float32 "
        f"without TF32: "
        f"{fwd_ms:.3f} ms, {img_s:.1f} img/s")
    k1_earlier = {b: sum(ms[s["stage"]] * s["launches"] for s in stages)
                  for b, ms in K1_EARLIER_MS.items()}
    k1_b1 = {k: sum(s[k] * s["launches"] for s in stages)
             for k in ("ms_batch1", "device_ms_batch1")}
    log(f"  K1 per forward ({LAUNCHES_PER_FORWARD} launches): "
        f"{per_fwd['ms']:.4f} ms = {100 * per_fwd['ms'] / fwd_ms:.1f}% of "
        f"the forward (earlier design as timed at 385f291: "
        f"{k1_earlier[BATCH]:.4f} ms); bound {per_fwd['bound_ms']:.4f} ms; "
        f"exp units {per_fwd['exp_ms']:.4f} ms; plain "
        f"{per_fwd['plain_ms']:.1f} ms; profiler device time "
        f"{k1_device_ms:.4f} ms")
    log(f"  K1 per batch-1 forward: {k1_b1['ms_batch1']:.4f} ms back to "
        f"back, device {k1_b1['device_ms_batch1']:.4f} ms (earlier design's "
        f"device time as timed at 385f291: {k1_earlier[1]:.4f} ms)")
    log("stages " + json.dumps(stages))
    log("profile " + json.dumps(prof_line))

    header("phase 6: K1 states and K2 against their plain versions")
    bwd_stages, k2_err = phase_backward_vs_plain()
    per_step = per_pass(bwd_stages)
    earlier_ms = sum(K2_EARLIER_MS[s["stage"]] * s["launches"]
                     for s in bwd_stages)
    log(f"  K2 per step ({LAUNCHES_PER_FORWARD} launches): "
        f"{per_step['ms']:.4f} ms (earlier design as timed at a08c9a5: "
        f"{earlier_ms:.4f} ms); bound {per_step['bound_ms']:.4f} ms "
        f"(bytes {per_step['bytes_ms']:.4f}, fp32 ops "
        f"{per_step['ops_ms']:.4f}); exp units {per_step['exp_ms']:.4f} ms; "
        f"plain {per_step['plain_ms']:.1f} ms")

    header("phase 7: K5 against its plain version")
    rot = phase_rotate_vs_plain()

    header("phase 8: training path (cli.train, medmamba_t 224^2 batch 64, "
        "bf16 blocks, augmentation)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        train_counts, train_steps = phase_train_path(root)

    header("phase 9: model gradients through K2 against its plain version, "
        "and through K1 + K2 against the plain scan")
    grad_err, grad_err_plain_scan = phase_gradients()

    header("phase 10: train-step timing")
    train_timing, train_prof = phase_train_timing()
    fam = train_prof["family_ms_per_step"]
    log("train_steps " + json.dumps(train_timing))
    log("train_profile " + json.dumps(train_prof))
    log("k2_stages " + json.dumps(bwd_stages))
    log("k5 " + json.dumps(rot))

    header("phase 11: K3 (hillis forward) against its plain version")
    k3_stages, k3_err = phase_hillis_fwd_vs_plain()
    k3 = per_pass(k3_stages)
    k3_earlier = sum(K3_EARLIER_MS[s["stage"]] * s["launches"]
                     for s in k3_stages)
    log(f"  K3 per forward ({LAUNCHES_PER_FORWARD} launches): "
        f"{k3['ms']:.4f} ms (doubling design as timed at a08c9a5: "
        f"{k3_earlier:.4f} ms); bound {k3['bound_ms']:.4f} ms (bytes "
        f"{k3['bytes_ms']:.4f}, fp32 ops needed {k3['ops_ms']:.4f}); exp "
        f"units {k3['exp_ms']:.4f} ms; plain {k3['plain_ms']:.1f} ms")

    header("phase 12: K4 (hillis backward) against its plain version")
    k4_stages, k4_err = phase_hillis_bwd_vs_plain()
    k4 = per_pass(k4_stages)
    k4_earlier = sum(K4_EARLIER_MS[s["stage"]] * s["launches"]
                     for s in k4_stages)
    log(f"  K4 per step ({LAUNCHES_PER_FORWARD} launches): "
        f"{k4['ms']:.4f} ms (doubling design as timed at 6ede5d4: "
        f"{k4_earlier:.4f} ms); bound {k4['bound_ms']:.4f} ms (bytes "
        f"{k4['bytes_ms']:.4f}, fp32 ops needed {k4['ops_ms']:.4f}); exp "
        f"units {k4['exp_ms']:.4f} ms; plain {k4['plain_ms']:.1f} ms")

    header("phase 13: serving path under MEDMAMBA_SCAN_KERNEL=hillis "
        "(cli.evaluate, medmamba_t 224^2 batch 64)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        model, hillis_eval_counts = phase_hillis_serving(root)

    header("phase 14: training path under hillis (cli.train, medmamba_t 224^2 "
        "batch 64, bf16 blocks, augmentation)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root, \
            scan_kernel("hillis"):
        hillis_counts, _ = phase_train_path(root, "K3", "K4")

    header("phase 15: model gradients through K4 against its plain version")
    hillis_grad_err = phase_hillis_gradients()

    header("phase 16: timing under hillis")
    with scan_kernel("hillis"):
        h_fwd_ms, h_img_s, h_prof = phase_timing(model)
        del model
        h_train, h_train_prof = phase_train_timing()
    h_fam = h_train_prof["family_ms_per_step"]
    log(f"  eval forward, float32 without TF32: hillis {h_fwd_ms:.3f} ms, "
        f"{h_img_s:.1f} img/s; ssd {fwd_ms:.3f} ms, {img_s:.1f} img/s")
    for name in ("bf16+aug", "fp32+aug"):
        log(f"  train step {name}: hillis {h_train[name]['ms']:.3f} ms, "
            f"{h_train[name]['img_s']:.1f} img/s; ssd "
            f"{train_timing[name]['ms']:.3f} ms, "
            f"{train_timing[name]['img_s']:.1f} img/s")
    log("hillis_profile " + json.dumps(h_prof))
    log("hillis_train_profile " + json.dumps(h_train_prof))
    log("k3_stages " + json.dumps(k3_stages))
    log("k4_stages " + json.dumps(k4_stages))

    header("phase 17: P1 (issue-rate probe) against its plain version, timed")
    p1_rows, p1_launches = phase_probe_vpu()
    p1 = sum_rows(p1_rows)
    log("p1 " + json.dumps(p1_rows))

    header("phase 18: P2 (relayout probes) against their plain versions")
    p2_rows, p2_launches, p2_floor = phase_probe_mosaic()
    p2 = sum_rows(p2_rows)
    log("p2 " + json.dumps(p2_rows))

    header("phase 19: cli.evaluate on a class-folder PNG tree, and Grad-CAM "
        "through cli.test (medmamba_t 224^2)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        tree, pth, cams = phase_gradcam(root)

        header("phase 20: the demo server (cli.demo, medmamba_t 224^2)")
        demo_out = phase_demo(tree, pth)

    header("phase 21: serving export (cli.export, medmamba_t 224^2, symbolic "
        "batch), loaded in a fresh process")
    export_out = phase_export(serve_dir.name, os.path.join(
        serve_dir.name, "medmamba_t.pth"))
    serve_dir.cleanup()

    header("phase 22: the bfloat16 compute mode (MEDMAMBA_SCAN_COMPUTE="
           "bfloat16): K1-K4 against their plain versions in the mode")
    bf16_rows, bf16_err = phase_bf16_kernels()
    bf16 = {}
    for k, rows in bf16_rows.items():
        bf16[k] = dict(per_pass(rows), ms_fp32=sum(
            r["ms_fp32"] * r["launches"] for r in rows))
        bf16[k]["max_abs_err"] = bf16_err[k]
        log(f"  {k} per {'forward' if k in ('K1', 'K3') else 'step'} "
            f"({LAUNCHES_PER_FORWARD} launches) in the mode: "
            f"{bf16[k]['ms']:.4f} ms, float32 {bf16[k]['ms_fp32']:.4f} ms "
            f"in turns; bound {bf16[k]['bound_ms']:.4f} ms; plain "
            f"{bf16[k]['plain_ms']:.1f} ms")
    log("bf16_stages " + json.dumps(bf16_rows))
    header("phase 22: the main paths in the bfloat16 compute mode (cli.train, "
           "cli.evaluate, logits and loss against float32, timing)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        bf16_model = phase_bf16_model(root)
    bf16["K1"]["launches"] = bf16_model["ssd"]["train_counts"]["K1"]
    bf16["K2"]["launches"] = bf16_model["ssd"]["train_counts"]["K2"]
    bf16["K3"]["launches"] = bf16_model["hillis"]["train_counts"]["K3"]
    bf16["K4"]["launches"] = bf16_model["hillis"]["train_counts"]["K4"]
    log("bf16_profiles " + json.dumps(
        {k: {"eval": v["eval_profile"], "train": v["train_profile"]}
         for k, v in bf16_model.items()}))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": [{
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "medmamba_tpu/ops/pallas_scan.py:787",
        "launches": train_counts["K1"],
        "launches_per_forward": launches / -(-N_IMAGES // BATCH),
        "launches_serving_path": launches,
        "max_abs_err": max_err,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"], "bound_by": per_fwd["bound_by"],
        "library_ms": None,
        "profiled_ms_per_forward": k1_device_ms,
        "profiled_ms_per_train_step": fam.get(FAMILY["K1"], 0.0),
        "ms_per_forward_batch1": k1_b1["ms_batch1"],
        "device_ms_per_forward_batch1": k1_b1["device_ms_batch1"],
        "eval_img_s": img_s, "bf16_compute": bf16["K1"]}, {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "medmamba_tpu/ops/pallas_scan.py:1139",
        "launches": train_counts["K2"],
        "launches_per_step": train_counts["K2"] / train_steps,
        "max_abs_err": k2_err,
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"], "bound_by": per_step["bound_by"],
        "library_ms": None,
        "profiled_ms_per_train_step": fam.get(FAMILY["K2"], 0.0),
        "model_grad_rel_err": grad_err,
        "model_grad_rel_err_vs_plain_scan": grad_err_plain_scan,
        "bf16_compute": bf16["K2"]}, {
        "name": "rotate_flip", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/rotate_flip.cu",
        "replaces": "medmamba_tpu/ops/rotate_pallas.py:65",
        "launches": train_counts["K5"],
        "launches_per_step": train_counts["K5"] / train_steps,
        "max_abs_err": max(r["max_abs_err"] for r in rot.values()),
        "ms": rot[IMAGE]["ms"], "plain_ms": rot[IMAGE]["plain_ms"],
        "bound_ms": rot[IMAGE]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "ms_28": rot[28]["ms"], "device_ms": rot[IMAGE]["device_ms"],
        "device_ms_28": rot[28]["device_ms"],
        "profiled_ms_per_train_step": fam.get(FAMILY["K5"], 0.0)}, {
        "name": "selective_scan_hillis_fwd", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/selective_scan_hillis_fwd.cu",
        "replaces": "medmamba_tpu/ops/pallas_scan.py:877",
        "launches": hillis_counts["K3"],
        "launches_serving_path": hillis_eval_counts["K3"],
        "max_abs_err": k3_err,
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None,
        "profiled_ms_per_forward": h_prof["family_ms_per_forward"].get(
            FAMILY["K3"], 0.0),
        "profiled_ms_per_train_step": h_fam.get(FAMILY["K3"], 0.0),
        "eval_img_s": h_img_s, "bf16_compute": bf16["K3"]}, {
        "name": "selective_scan_hillis_bwd", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/selective_scan_hillis_bwd.cu",
        "replaces": "medmamba_tpu/ops/pallas_scan.py:1275",
        "launches": hillis_counts["K4"],
        "max_abs_err": k4_err,
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
        "profiled_ms_per_train_step": h_fam.get(FAMILY["K4"], 0.0),
        "model_grad_rel_err": hillis_grad_err,
        "bf16_compute": bf16["K4"]}, {
        "name": "probe_vpu", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/probe_vpu.cu",
        "replaces": "tools/probe_vpu.py:21",
        "launches": p1_launches,
        "max_abs_err": p1["max_abs_err"],
        "ms": p1["ms"], "plain_ms": p1["plain_ms"],
        "bound_ms": p1["bound_ms"], "bound_by": p1["bound_by"],
        "library_ms": None, "cases": len(p1_rows)}, {
        "name": "probe_mosaic", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/probe_mosaic.cu",
        "replaces": "tools/probe_mosaic.py:20",
        "launches": p2_launches,
        "max_abs_err": p2["max_abs_err"],
        "ms": p2["ms"], "plain_ms": p2["plain_ms"],
        "bound_ms": p2["bound_ms"], "bound_by": p2["bound_by"],
        "library_ms": p2["library_ms"], "cases": len(p2_rows),
        "device_ms": p2["device_ms"],
        "library_device_ms": p2["library_device_ms"],
        "ctypes_floor_ms": p2_floor["ms"],
        "ctypes_floor_device_ms": p2_floor["device_ms"]}],
        "gradcam": {"s_per_image_after_first": {
            k: cams[k]["s_per_image"] for k in ("default", "upstream")},
            "cam_err_vs_plain_scan": max(cams["default"]["cam_err"],
                                         cams["upstream"]["cam_err"]),
            "hillis_cam_err": cams["hillis_err"],
            "folder_eval": cams["folder_eval"]},
        "demo": demo_out,
        "export": export_out,
        "train_img_s": {k: v["img_s"] for k, v in train_timing.items()},
        "hillis_train_img_s": {k: v["img_s"] for k, v in h_train.items()},
        "bf16_compute": {scan: {k: v[k] for k in (
            "eval_ms", "eval_img_s", "eval_ms_fp32", "eval_img_s_fp32",
            "train_ms", "train_img_s", "train_ms_fp32", "train_img_s_fp32",
            "logits_rel_err", "loss")} for scan, v in bf16_model.items()}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
