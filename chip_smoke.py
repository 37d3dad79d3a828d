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
     stage shapes (batch 64): float32 and bfloat16 in and out, each in one
     launch of a forward and a reverse group, the two mixed types
     (float32 in with a bfloat16 gy, bfloat16 in with a float32 gy), and
     reverse at L 3200 with valid_len 3136; two K2 launches on the same
     stage-0 inputs must give the same bits; K2's time per stage beside
     its bound and the plain version's, and in the log the earlier
     design's times as timed at a08c9a5 (K2_EARLIER_MS, constants this run
     does not measure);
  7. K5 against its plain version at 28^2 and 224^2 (batch 64), exactly;
     its time per launch queued back to back and by the profiler's device
     time;
  8. the training path: ``medmamba_tpu_torch.cli.train`` on a synthetic 28^2
     NPZ train/val split, medmamba_t at 224^2, batch 64, one epoch, bfloat16
     blocks, augmentation; each step must make exactly 20 K1, 20 K2 and 1 K5
     launches (and each validation batch 20 K1); the loss is finite, the best
     and last ``.pth`` exist, and ``cli.evaluate`` serves the best one with
     20 K1 launches per batch;
  9. gradients: one float32 training forward of medmamba_t's widths at
     one block a stage (GRAD_DEPTHS, cut from medmamba_t's depths: every
     stage shape still runs; 224^2, batch 8, drop path 0, TF32 off) through
     K1, its backward through K2 against the same backward through K2's
     plain version, per parameter; then the same model on the plain scan
     (K1 and K2 both replaced), read and held on the loss;
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
     the same pixels; then Grad-CAM, graphed: ``cli.test`` on the same
     tree, 4 images at the default target (20 + 20 K1 and no
     K2 per image) and at two targets, the first upstream of 10 scans (20 +
     20 K1 and 10 K2 per image); each CAM against the same weights on the
     plain scan; at the default target the seconds an image in turns with
     the CLI on the eager CAM (``eager_cam``); one image under hillis (40
     K3, 10 K4) against the ssd CAM;
 20. the demo server (``cli.demo``, forward and CAM graphed) in a thread:
     three POSTs (RGB with target -1 and 3, RGBA) and ``GET
     /random?mode=gt``, 40 K1 and no K2 per request, the page's
     probabilities against the same model's softmax on the same pixels;
     the latency per request; then POSTs in turns with a second server on
     the eager CAM;
 21. serving export: ``python -m medmamba_tpu_torch.cli.export`` on phase
     4's medmamba_t checkpoint (224^2, symbolic batch), and under
     MEDMAMBA_SCAN_KERNEL=hillis ``export_forward`` of medmamba_t's widths
     at one block a stage (HILLIS_EXPORT_DEPTHS, cut from medmamba_t's
     depths; every stage shape) in this process; both artifacts loaded in
     one fresh process (``LOAD_ARTIFACT``, which imports
     ``medmamba_tpu_torch.utils.export`` and reads the launch counts) with
     the variable naming the other kernel, and called, as CUDA graphs, at
     batch 64, 3 and 1 on uint8 frames from the seed: exactly 20 K1 and no
     K3 per call (8 K3 and no K1 for the hillis artifact), the
     probabilities within 1e-5 of the live ``softmax(model(preprocess(x)))``
     on the same kernel; the graphed artifact's batch-64 and batch-1 call
     there (CUDA events, 10 back to back, median of 3), and in turns with
     the loaded module's eager call (the live graphed forward: phase 23);
     K1's and K3's batch-1 host time per forward through the graph op
     against the call the live path made before it (the ctypes wrapper,
     ``_hillis_scan``); the analytic forward FLOPs an image
     (``utils/profiling.py: model_flops_report``) and the share of the
     card's float32 peak the graphed artifact reaches;
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
     mode, on both pairs, with the device time by kernel family on K1/K2;
 23. the compiled steps (``utils/graphs.py``, ``train/trainer.py:
     compile_forward``, ``compile_train_step``), which the CLIs of phases
     4, 8, 13, 14, 19, 20 and 22 already ran: the graphed softmax forward
     of medmamba_t at batch 64 and 1 on ssd and hillis equals the eager
     forward bit for bit, and a replay makes exactly 20 K1 (K3) launches
     by the counters and by the profiler (one replay of each graph, in a
     fresh process: ``profile_graphs``); both timed in turns
     (eager, graphed, graphed, eager); the graphed train step (bf16 blocks
     and float32, augmentation, 224^2, batch 64, ssd and hillis): 5 steps
     from one state dict and one generator seed eagerly twice and graphed
     once, the graph bit for bit where the eager runs agree; where they do
     not (float32), the parameters whose first-step gradients differ are
     named, with and without cuDNN's deterministic algorithms, and the
     three runs made again under ``cudnn.deterministic``, where the graph
     is held to the eager bits (else each loss within 1e-4 of its scale);
     exact launches per replay (20 K1, 20 K2, 1 K5; hillis 20 K3, 20 K4,
     1 K5) by the counters and the profiler; the step timed in turns with
     the eager one, its busy share, each step's wall with a sync after
     it; each graph's capture seconds and pool bytes; the state guard's
     cost and its raise after ``opt.load_state_dict``; the graphed
     Grad-CAM (``eval/gradcam.py: compile_cam``) of medmamba_t at batch 1
     against the eager one: bit for bit where two eager runs agree (else
     under ``cudnn.deterministic``) at the default target with the class
     given and taken on the card, at the two upstream targets, there with
     every block's output substituted, and under hillis; exact launches a
     replay (20 K1; 20 K1 + 10 K2; 20 K3 + 10 K4); the default and
     upstream CAMs timed in turns with eager; at most CAM_GRAPHS graphs;
     the demo request of phase 20 split into its graphed forward, its
     graphed Grad-CAM and the rest; ``BatchLoader.epoch``'s host time per
     batch on phase 8's NPZ split and phase 19's PNG tree (the artifact's
     graph against its eager call: phase 21);
 24. the other models at 224^2: ``cli.cam_backbones`` for ViT-B/16, Swin-T
     and MobileNetV2 (1000 classes) from random ``.pth`` files the phase
     writes (the ViT's zero head drawn from normal(0.02)) on a random PNG,
     each in a process of its own on the card (exit 0, the side-by-side PNG,
     a CAM in [0, 1] that is not all zero) and in this
     process on the CPU: logits within 1e-4 of their scale, the card's CAM
     within TOL_CAM of the CPU's given the card's activation at the target;
     each backbone's eager forward at batch 64 timed and profiled by kernel
     family; then ``VSSMSeg`` at its defaults (2 classes, float32): a forward
     at batch 8 with exactly 40 K1 launches, the backward of a per-pixel
     cross-entropy with exactly 40 K2, and at one block a stage
     (SEG_PLAIN_DEPTHS, cut from its defaults; every stage shape) the
     forward against the plain scan and the backward against K2's plain
     version per parameter (phase 9's method, deterministic forward);
     40 K3 and no other scan kernel under hillis against the ssd output,
     the forward at batch 64 timed and profiled (40 K1 by the profiler, K1's
     share of the device time); 40 K1 a forward by the profiler at both
     batches. The phase runs in a fresh process (``other_models_process``);
 25. distribution (``parallel/mesh.py``, ``ops/seq_parallel.py``), each
     group in processes of its own started by ``torch.distributed.run``:
     (a) ``cli.train`` as in phase 8 in this process without a group and
     under torchrun at world 1 on NCCL with its graphed steps: the same
     per-step losses and last ``.pth`` bit for bit (again both under
     ``cudnn.deterministic`` if they differ), 20 K1 + 20 K2 + 1 K5 a step;
     then in the torchrun process the graphed bf16 step captured with and
     without the group, timed in turns, one replay of each profiled
     (launches, the collectives' device time); (b) two ranks on the card
     over gloo (NCCL refuses two ranks on one card), eager steps with
     augmentation under ``cudnn.deterministic``, float32 blocks and then
     bf16 blocks, 32 rows a rank, 3 random batches and one of 37 real rows
     padded to 64, each step against one process's step on the whole
     batch from the same state (loss, gradient, BatchNorm statistics,
     parameters; see PAIR_*), the ranks' parameters the same bits, 20 K1
     + 20 K2 + 1 K5 a rank a step; (c) on
     the same ranks the sequence-parallel scan, L split in two, at
     medmamba_t's stage 0 (batch 64, L 3136) and a 1024^2 image's (batch
     1, L 65536): one K1 launch a rank, y and the final state against K1
     over the whole sequence and the plain scan, K1's share of the split
     call, and the kernel path's backward raising;
 26. tensor parallelism (the mesh's model axis): two gloo ranks on the
     card as a 1x2 mesh under torchrun, medmamba_t partitioned
     (``partition_params``) at full widths, 224^2, a global batch of 8,
     float32 blocks under ``cudnn.deterministic``, augmentation: three
     eager train steps and one under hillis, each against one process's
     step from the same state (loss, gathered gradient, BatchNorm
     statistics, parameters; see TP_*), the model ranks' replicated
     tensors the same bits, exactly 20 K1 + 20 K2 + 1 K5 a rank a step (20
     K3 + 20 K4 + 1 K5 under hillis), each scan launch on 4 rows; an
     ``eval_step`` and ``predict`` against one process; the gathered
     ``.pth`` one process's bit for bit, served by ``cli.evaluate`` in this
     process against the ranks' probabilities; K1-K4 on a rank's 4 rows
     at every stage shape against their plain versions (TOL_FP32, as in
     phases 1, 2, 11 and 12); K1 on half the rows against the whole
     batch's rows at every stage (TOL_FP32);
 27. the VSSM sizes, in a fresh process (``sizes_process``): K1's layout
     at medmamba_b's stage shapes (d_inner 128-1024 a group; 2, 2, 12 and 2
     blocks) at batch 64 and 1; K1-K4 against their plain versions there
     with phases 3's, 6's, 11's and 12's functions (float32 and bfloat16
     inputs, K1/K2 in launches of a forward and a reverse group, batch 64
     and 1; the mixed types,
     the padding pattern and the plain versions' times stay at
     medmamba_t's shapes), each kernel's time a stage beside its bound;
     then medmamba_s, _b and _te: ``cli.train`` as in phase 8 with
     ``--medmb_size`` (28/36/20 K1 + as many K2 + 1 K5 a step) and
     ``cli.evaluate`` on its best ``.pth`` (28/36/20 K1 a batch); the
     eager logits at batch 8 against the same weights on the plain scan
     (TOL_FP32); medmamba_b under hillis (36 K3 and no other scan kernel,
     against its ssd logits); the graphed float32 eval forward and the
     graphed bf16 train step at batch 64, each timed in turns with the
     eager one, one replay profiled (launches, busy share), capture
     seconds and pool bytes.
On the card every CLI runs its steps as CUDA graphs (phase 23), its
Grad-CAM too (``cli.test``, ``cli.demo``), except ``cli.cam_backbones``,
which serves one image a process eagerly; the timing phases 5, 10, 16, 22
and 24 time the eager functions.
To keep the run within its 1200 s, earlier paths run cut: phase 9
at one block a stage (GRAD_DEPTHS; every stage shape of K1 and K2 still
held to the plain versions in the model); phase 21's hillis artifact at
one block a stage (HILLIS_EXPORT_DEPTHS, through ``export_forward``;
``cli.export`` still runs on medmamba_t, and K3 still runs every stage
shape in the artifact), both artifacts loaded in one fresh process, which
also times each artifact's graph against its eager call; phase 6's
float32 and bfloat16 cases and phase 27's K1/K2 cases launch one forward
and one reverse group together (MIXED); phase 19 times ``cli.test``
against the eager CAM at the default target only; phase 23 runs
COMPILED_STEPS = 5 steps a run and times each train step in turns one
call a round; phase 24 holds VSSMSeg against the
plain scan and K2's plain adjoint at one block a stage
(SEG_PLAIN_DEPTHS; the launch counts and the timing stay at its
defaults); the eager timings of phases 5, 10, 16 and 22 queue fewer calls
a round (5 forwards, 2 steps).
Each phase's header says when it started. The line before the last lists
every kernel of the port (K1, K2, K5, K3, K4, P1, P2) with its launches,
times and bound (K1-K4 with a ``bf16_compute`` object: phase 22's numbers;
K1-K3 with ``VSSMSeg``'s launches, K1, K2 and K5 with phase 25's, K1-K5
with phase 26's launches and K1-K4 with its error on a rank's rows; K1-K4
with ``medmamba_b_shapes``, phase 27's errors and times, and K1-K3 and K5
with the sizes' launches), and phases 21's, 24's and 27's; the last line
is the JSON ``{"ok": true, "device": {...}}``.
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
# phase 9 runs medmamba_t's widths at one block a stage: every stage shape,
# at half the plain versions' loops over L (they take most of the phase)
GRAD_DEPTHS = (1, 1, 1, 1)
GROUPS, N_STATE = 2, 16
# medmamba_t at 224^2: per stage, channels per group (d_inner), sequence
# length (H*W after the 4x4 patch embed and each merge) and SS2D blocks
STAGES = [(96, 56 * 56, 2), (192, 28 * 28, 2), (384, 14 * 14, 4),
          (768, 7 * 7, 2)]
LAUNCHES_PER_FORWARD = sum(2 * blocks for _, _, blocks in STAGES)  # 20
TILE = 64                      # K1's tile: one saved state per tile
# one launch, both directions: group 0 forward, group 1 in reverse
MIXED = (False, True)
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
# phase 21's loader, run in a fresh process: argv is the frames (.npy),
# the batches, then for each artifact its path, an output prefix and the
# scan kernel to name in MEDMAMBA_SCAN_KERNEL while it runs (the other
# one); it writes each batch's probabilities to <prefix>_<batch>.npy and
# prints "result {...}" with, for each artifact, the scan launches of each
# call (K1, K3), and at the first and last batches the graphed call's ms
# (CUDA events, 10 back to back, median of 3) and its ms in turns with
# the eager call of the loaded module (eager, graphed, graphed, eager)
LOAD_ARTIFACT = r"""
import json, os, statistics, sys
import numpy as np
import torch
from medmamba_tpu_torch.utils.export import load_exported
from medmamba_tpu_torch.ops import scan_cuda, scan_hillis

frames, batches = sys.argv[1:3]
batches = [int(b) for b in batches.split(",")]
x = torch.from_numpy(np.load(frames)).cuda()


def ms(fn, xb, reps=10, rounds=3):
    fn(xb)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(xb)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


out = {}
args = sys.argv[3:]
for art, prefix, other in zip(args[::3], args[1::3], args[2::3]):
    os.environ["MEDMAMBA_SCAN_KERNEL"] = other
    with open(art, "rb") as f:
        exp = load_exported(f.read())
    counts = {}
    for b in batches:
        scan_cuda.LAUNCHES = scan_hillis.HILLIS_LAUNCHES = 0
        probs = exp.call(x[:b])
        torch.cuda.synchronize()
        counts[b] = [scan_cuda.LAUNCHES, scan_hillis.HILLIS_LAUNCHES]
        np.save(f"{prefix}_{b}.npy", probs.cpu().numpy())
    def eager(xb):
        with torch.no_grad():
            return exp._module(xb)
    ends = (batches[0], batches[-1])
    out[art] = {"counts": counts,
                "ms": {b: ms(exp.call, x[:b]) for b in ends},
                "turns": {b: [ms(fn, x[:b]) for fn in (
                    eager, exp.call, exp.call, eager)] for b in ends}}
    exp.graphs.free()
print("result " + json.dumps(out))
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


def phase_kernel_vs_plain(stage_list=STAGES):
    """K1 against its plain version at ``stage_list``'s shapes (phase 3 at
    medmamba_t's, phase 27 at medmamba_b's), at batch 64 and 1, timed at
    each beside its bound; at medmamba_t's also the earlier design's times,
    the plain version's and the SS2D padding pattern."""
    import torch

    from medmamba_tpu_torch.ops.selective_scan import selective_scan
    from medmamba_tpu_torch.utils.profiling import device_ms_per_call

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [("fwd fp32", torch.float32, {}),
             ("rev fp32", torch.float32, {"reverse_dirs": (True, True)}),
             ("fwd bf16->fp32", torch.bfloat16, {}),
             ("rev bf16->bf16", torch.bfloat16,
              {"reverse_dirs": (True, True), "out_dtype": torch.bfloat16})]
    t_shapes = stage_list is STAGES
    directions = ({}, {"reverse_dirs": (True, True)})
    if not t_shapes:
        # one launch a dtype runs group 0 forward and group 1 in reverse:
        # both directions' code at half the plain version's loops
        cases = [("fwd+rev fp32", torch.float32, {"reverse_dirs": MIXED}),
                 ("fwd+rev bf16->bf16", torch.bfloat16,
                  {"reverse_dirs": MIXED, "out_dtype": torch.bfloat16})]
        directions = ({"reverse_dirs": MIXED},)
    max_err = 0.0
    stages = []
    for si, (dpg, l, blocks) in enumerate(stage_list):
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
        row = dict(stage=si, D=GROUPS * dpg, L=l, launches=2 * blocks,
                   ms=k_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_ms=max(bytes_ms, ops_ms), exp_ms=exp_ms)
        if t_shapes:
            row["plain_ms"] = back_to_back_ms(
                lambda x: selective_scan(**x, delta_softplus=True,
                                         impl="ref"), xs[:1], 1)
        del xs
        stages.append(row)
        log(f"  stage {si} D={GROUPS * dpg} L={l}: kernel {k_ms:.4f} ms"
            + (f" (earlier design as timed at 385f291: "
               f"{K1_EARLIER_MS[BATCH][si]:.4f} ms), plain "
               f"{row['plain_ms']:.2f} ms" if t_shapes else "")
            + f", bound {max(bytes_ms, ops_ms):.4f} ms "
            f"(bytes {bytes_ms:.4f}, fp32 ops {ops_ms:.4f}, exp units "
            f"{exp_ms:.4f}), x{2 * blocks} per forward")

    # batch 1, the demo's and cli.test's shape: 8-channel blocks
    for si, (dpg, l, blocks) in enumerate(stage_list):
        xs = [scan_inputs(dpg, l, torch.float32, gen, batch=1)
              for _ in range(8)]
        for kw in directions:
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
            f"{b1_dev:.4f} ms" + (
                f" (earlier design's device time as timed at 385f291: "
                f"{K1_EARLIER_MS[1][si]:.4f} ms)" if t_shapes else ""))
    if not t_shapes:
        return stages, max_err

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


def phase_backward_vs_plain(stage_list=STAGES):
    """K1's states and K2 against their plain versions at ``stage_list``'s
    shapes; K2 timed. At medmamba_t's (phase 6) every dtype instantiation
    at batch 64, the padding pattern, the plain version's time and the
    earlier design's; at medmamba_b's (phase 27) float32 and bfloat16 in
    both directions at batch 64 and 1."""
    import torch

    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_ref, selective_scan_states_ref)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def operands(dpg, l, dtype, gy_dtype, kw, batch=BATCH):
        x = scan_inputs(dpg, l, dtype, gen, batch)
        y, _, states = scan_cuda.selective_scan_fwd(
            **x, delta_softplus=True, return_states=True,
            out_dtype=gy_dtype, **kw)
        gy = torch.randn(y.shape, generator=gen, device="cuda").to(gy_dtype)
        return x, states, gy

    def check(label, dpg, l, dtype, gy_dtype, kw, batch=BATCH):
        x, states, gy = operands(dpg, l, dtype, gy_dtype, kw, batch)
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
    t_shapes = stage_list is STAGES
    # one launch a case runs group 0 forward and group 1 in reverse: both
    # directions' code at half the plain version's loops over L
    mixed = {"reverse_dirs": MIXED}
    cases = [("fwd+rev fp32", f32, f32, mixed, BATCH),
             ("fwd+rev bf16", bf16, bf16, mixed, BATCH)]
    if t_shapes:
        cases += [("fwd fp32 in, bf16 gy", f32, bf16, fwd, BATCH),
                  ("rev bf16 in, fp32 gy", bf16, f32, rev, BATCH)]
    else:
        cases += [(f"{c[0]} batch 1", *c[1:4], 1) for c in cases]
    for si, (dpg, l, blocks) in enumerate(stage_list):
        for name, dtype, gy_dtype, kw, batch in cases:
            st_err, err = check(f"stage {si} D={GROUPS * dpg} L={l} {name}",
                                dpg, l, dtype, gy_dtype, kw, batch)
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
        row = dict(stage=si, D=GROUPS * dpg, L=l, launches=2 * blocks,
                   ms=k_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_ms=max(bytes_ms, ops_ms), exp_ms=exp_ms)
        if t_shapes:
            row["plain_ms"] = back_to_back_ms(
                lambda s: bwd(s, selective_scan_bwd_ref), sets[:1], 1,
                rounds=1)
        del sets
        stages.append(row)
        log(f"  stage {si} D={GROUPS * dpg} L={l}: K2 {k_ms:.4f} ms"
            + (f" (earlier design as timed at a08c9a5: "
               f"{K2_EARLIER_MS[si]:.4f} ms), plain {row['plain_ms']:.2f} ms"
               if t_shapes else "")
            + f", bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
            f"{bytes_ms:.4f}, fp32 ops {ops_ms:.4f}, exp units "
            f"{exp_ms:.4f}), x{2 * blocks} per step")
    if not t_shapes:
        return stages, max_err
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


def phase_train_path(root: str, fwd: str = "K1", bwd: str = "K2",
                     size: str = "T"):
    """cli.train end to end with ``--medmb_size size``, then cli.evaluate
    on its best checkpoint; the launch counts of each. ``fwd``/``bwd``: the
    scan kernels the path must launch, two per block per forward and per
    backward (20 for medmamba_t), and no other scan kernel."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import evaluate, train
    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS

    per_fwd = 2 * sum(MODEL_CONFIGS[size].depths)
    write_train_split(root)
    steps = -(-N_IMAGES // BATCH)
    val_batches = -(-N_VAL // BATCH)
    save = os.path.join(root, "run")
    reset_counts()
    t0 = time.perf_counter()
    out = train.main(["--train_dir", root, "--val_dir", root,
                      "--medmb_size", size, "--image_size", str(IMAGE),
                      "--batch_size", str(BATCH), "--epochs", "1",
                      "--augmentation", "--dtype", "bfloat16",
                      "--device", "cuda", "--save_dir", save,
                      "--log_every", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = expected_counts(**{
        fwd: per_fwd * (steps + val_batches),
        bwd: per_fwd * steps, "K5": steps})
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
                               "--medmb_size", size,
                               "--batch_size", str(BATCH), "--image_size",
                               str(IMAGE), "--device", "cuda"])
    torch.cuda.synchronize()
    ev_counts = read_counts()
    log(f"  cli.evaluate on {os.path.basename(out['best_path'])}: launches "
        f"{ev_counts}")
    if ev_counts != expected_counts(**{fwd: per_fwd * val_batches}):
        raise SystemExit(f"evaluate launches {ev_counts}")
    if probs.shape != (N_VAL, NUM_CLASSES) or not np.isfinite(probs).all():
        raise SystemExit(f"bad probabilities: shape {probs.shape}")
    return counts, steps


def phase_gradients():
    """One float32 training forward of medmamba_t's widths at GRAD_DEPTHS
    through K1 with its backward once through K2 and once through K2's
    plain version, per parameter; then the same model on the plain scan
    (autograd through its loop) as a reading, held on the loss. Returns
    the worst relative gradient error of each comparison."""
    import torch

    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS
    from medmamba_tpu_torch.models.vssm import VSSM
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.selective_scan import selective_scan_bwd_ref
    from medmamba_tpu_torch.train.trainer import cross_entropy

    kw = dict(num_classes=NUM_CLASSES, depths=GRAD_DEPTHS,
              dims=MODEL_CONFIGS["T"].dims, drop_path_rate=0.0)
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
        ms = back_to_back_ms(step, [None], 2)
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
    """One stage's row; ``p_ms`` None where the plain version is not
    timed."""
    row = dict(stage=si, D=GROUPS * dpg, L=l, launches=2 * blocks, ms=k_ms,
               **costs)
    if p_ms is not None:
        row["plain_ms"] = p_ms
    row["bound_ms"] = max(costs["bytes_ms"], costs["ops_ms"])
    log(f"  stage {si} D={GROUPS * dpg} L={l}: kernel {k_ms:.4f} ms, "
        + ("" if p_ms is None else f"plain {p_ms:.2f} ms, ")
        + f"bound {row['bound_ms']:.4f} ms (bytes "
        f"{costs['bytes_ms']:.4f}, fp32 ops needed {costs['ops_ms']:.4f}, "
        f"exp units {costs['exp_ms']:.4f}), x{2 * blocks}")
    return row


def per_pass(stages: list) -> dict:
    """Stage rows summed over the launches of a forward or a step (20 for
    medmamba_t); ``plain_ms`` where the rows time the plain version."""
    out = {k: sum(s[k] * s["launches"] for s in stages)
           for k in ("ms", "plain_ms", "bytes_ms", "ops_ms", "exp_ms")
           if k in stages[0]}
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                       else "operations")
    return out


def phase_hillis_fwd_vs_plain(stage_list=STAGES):
    """K3 against its plain version at ``stage_list``'s shapes (medmamba_t's
    in phase 11, medmamba_b's in phase 27), float32 and bfloat16 inputs, and
    at batch 1; two launches on the same stage-0 inputs give the same bits;
    K3 timed per stage. At medmamba_t's also one reverse call with
    valid_len through the dispatcher against the plain sequential scan, and
    the plain version's and the doubling design's times."""
    import torch

    from medmamba_tpu_torch.ops import scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan, selective_scan_hillis_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    kernel = scan_hillis.selective_scan_hillis_fwd
    t_shapes = stage_list is STAGES
    cases = [("fp32", torch.float32, BATCH),
             ("bf16 in", torch.bfloat16, BATCH),
             ("fp32 batch 1", torch.float32, 1)]
    if not t_shapes:
        cases.append(("bf16 in batch 1", torch.bfloat16, 1))
    max_err, stages = 0.0, []
    for si, (dpg, l, blocks) in enumerate(stage_list):
        for label, dtype, batch in cases:
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
            xs[:1], 1, rounds=1) if t_shapes else None
        del xs
        stages.append(stage_row(si, dpg, l, blocks, k_ms, p_ms, costs))
        if t_shapes:
            log(f"  stage {si}: K3's doubling design as timed at a08c9a5: "
                f"{K3_EARLIER_MS[si]:.4f} ms")
    if not t_shapes:
        return stages, max_err

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


def phase_hillis_bwd_vs_plain(stage_list=STAGES):
    """K4 against its plain version at ``stage_list``'s shapes (float32 and
    bfloat16 inputs, K3's states; at medmamba_b's in phase 27 also at batch
    1), each gradient relative to its scale; two launches on the same
    stage-0 inputs give the same bits; K4 timed per stage, at medmamba_t's
    beside the plain version's and its doubling design's times."""
    import torch

    from medmamba_tpu_torch.ops import scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan_hillis_bwd_ref)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def operands(dpg, l, dtype, batch=BATCH):
        x = scan_inputs(dpg, l, dtype, gen, batch)
        y, states, _ = scan_hillis.selective_scan_hillis_fwd(
            **x, delta_softplus=True)
        gy = torch.randn(y.shape, generator=gen, device="cuda")
        return [x[k] for k in names], states, gy

    def bwd(s, impl=scan_hillis.selective_scan_hillis_bwd):
        args, states, gy = s
        return impl(*args, states, gy, delta_softplus=True)

    t_shapes = stage_list is STAGES
    cases = [("fp32", torch.float32, BATCH),
             ("bf16 in", torch.bfloat16, BATCH)]
    if not t_shapes:
        cases += [(f"{c[0]} batch 1", c[1], 1) for c in cases]
    max_err, stages = 0.0, []
    for si, (dpg, l, blocks) in enumerate(stage_list):
        for label, dtype, batch in cases:
            s = operands(dpg, l, dtype, batch)
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
            rounds=1) if t_shapes else None
        del sets
        stages.append(stage_row(si, dpg, l, blocks, k_ms, p_ms, costs))
        if t_shapes:
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


@contextlib.contextmanager
def eager_cam():
    """Within the block the CLIs' Grad-CAM (``gradcam.cam_fn``, which
    ``cli.test`` and ``cli.demo`` look up when they start) is the eager
    ``grad_cam`` on the card too: what they ran before the CAM's graphs,
    timed in turns with them."""
    import functools

    from medmamba_tpu_torch.eval import gradcam

    graphed = gradcam.cam_fn
    gradcam.cam_fn = lambda model, device: functools.partial(
        gradcam.grad_cam, model)
    try:
        yield
    finally:
        gradcam.cam_fn = graphed


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
DEMO_TURNS = 5
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
    """cli.test (its CAM graphed) at the default target and at two targets,
    the first upstream of 10 scans: exact launch counts per image, each CAM
    against the same weights on the plain scan (check_cam) and
    non-degenerate; at the default target its seconds an image in turns
    with the CLI on the eager CAM (graphed, eager, eager, graphed); one
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
        turns = {"graphed": [statistics.median(
            r["seconds"] for r in out[1:])], "eager": []}
        kinds = ("eager", "eager", "graphed") if tag == "default" else ()
        for kind in kinds:
            with eager_cam() if kind == "eager" else contextlib.nullcontext():
                again, _ = run_cli(f"{tag}_{kind}", CAM_IMAGES, targets,
                                   "K1", "K2", n_bwd)
            turns[kind].append(statistics.median(
                r["seconds"] for r in again[1:]))
            if kind == "eager":
                diff = max(float(abs(a["cam"] - b["cam"]).max())
                           for a, b in zip(out, again))
                log(f"    the eager CAMs against the graphed: max|diff| "
                    f"{diff:.2e}")
        if turns["eager"]:
            log(f"  cli.test {tag}, s an image after the first, in turns: "
                f"graphed {turns['graphed']}, eager {turns['eager']}")
        results[tag] = dict(out=out, wall=wall, cam_err=worst,
                            s_per_image=statistics.mean(turns["graphed"]),
                            in_turns_s=turns)
        if turns["eager"]:
            results[tag]["s_per_image_eager"] = statistics.mean(
                turns["eager"])

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
    """cli.demo's server in a thread (its forward and its CAM graphed): two
    POSTs of an RGB PNG (target -1 and 3), a POST of an RGBA PNG and GET
    /random?mode=gt; per request 20 K1 for the prediction and 20 for the
    CAM, no K2; the page's two PNGs, and its probabilities against the
    same model's softmax on the same pixels. Then DEMO_TURNS POSTs to it in
    turns with as many to a second server on the eager CAM (graphed,
    eager, eager, graphed)."""
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

    def serve():
        srv = demo.make_server(demo.parse_args(
            ["--checkpoint_path", pth, "--port", "0", "--image_size",
             str(IMAGE), "--device", "cuda", "--test_dir", tree]))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"
    srv, thread, url = serve()
    with eager_cam():
        srv_eager, thread_eager, url_eager = serve()
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
        body, headers = multipart(png.encode(rgb), -1)
        turns = {"graphed": [], "eager": []}
        for kind in ("graphed", "eager", "eager", "graphed"):
            for _ in range(DEMO_TURNS):
                reset_counts()
                t0 = time.perf_counter()
                urllib.request.urlopen(urllib.request.Request(
                    url if kind == "graphed" else url_eager, data=body,
                    headers=headers), timeout=300).read()
                torch.cuda.synchronize()
                turns[kind].append((time.perf_counter() - t0) * 1e3)
                if read_counts() != expected_counts(
                        K1=2 * LAUNCHES_PER_FORWARD):
                    raise SystemExit(f"demo ({kind} CAM) launched "
                                     f"{read_counts()}")
    finally:
        for server, t in ((srv, thread), (srv_eager, thread_eager)):
            server.shutdown()
            server.server_close()
            t.join()
    median_ms = statistics.median(latencies[1:]) * 1e3
    log(f"  median latency per request after the first: {median_ms:.1f} ms "
        f"(first {latencies[0] * 1e3:.1f} ms)")
    # the eager server's first request captures nothing but builds its
    # tapes: the turns' first request of each kind is left out
    in_turns = {k: statistics.median(v[1:]) for k, v in turns.items()}
    log(f"  POST rgb target -1 in turns ({DEMO_TURNS} a turn), median ms: "
        f"graphed CAM {in_turns['graphed']:.2f}, eager CAM "
        f"{in_turns['eager']:.2f}")

    return dict(latency_ms=[t * 1e3 for t in latencies],
                median_ms=median_ms, prob_err=worst,
                in_turns_ms=turns, graphed_ms=in_turns["graphed"],
                eager_ms=in_turns["eager"])


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


# phase 21: the hillis artifact is exported through the library API, in
# this process, from medmamba_t's widths at one block a stage (every stage
# shape, 8 K3 a call), cut from medmamba_t's depths; both artifacts are
# loaded in one fresh process
HILLIS_EXPORT_DEPTHS = (1, 1, 1, 1)


def phase_export(root: str, pth: str) -> dict:
    """Phase 21 (see the docstring): ``root`` holds phase 4's checkpoint
    ``pth``; the artifacts, frames and probabilities go there too."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS, create_model
    from medmamba_tpu_torch.models.vssm import VSSM
    from medmamba_tpu_torch.train.checkpoint import restore_params
    from medmamba_tpu_torch.utils.export import export_forward
    from medmamba_tpu_torch.utils.profiling import model_flops_report

    log(f"  torch {torch.__version__}")
    frames = np.random.default_rng(SEED + 21).integers(
        0, 256, (max(EXPORT_BATCHES), IMAGE, IMAGE, 3), dtype=np.uint8)
    frames_path = os.path.join(root, "frames.npy")
    np.save(frames_path, frames)
    x = torch.from_numpy(frames).cuda()
    cfg = MODEL_CONFIGS["T"]
    models = {"ssd": create_model("T", NUM_CLASSES, device="cuda"),
              "hillis": VSSM(num_classes=NUM_CLASSES,
                             depths=HILLIS_EXPORT_DEPTHS, dims=cfg.dims,
                             generator=torch.Generator().manual_seed(
                                 SEED + 21)).cuda().eval()}
    models["ssd"].load_state_dict(restore_params(pth)[0], strict=True)
    models["ssd"].eval()
    launches = {"ssd": LAUNCHES_PER_FORWARD,
                "hillis": 2 * sum(HILLIS_EXPORT_DEPTHS)}
    arts = {scan: os.path.join(root, f"medmamba_t_{scan}.pt2")
            for scan in models}
    export_s = {}
    t0 = time.perf_counter()
    line = run([sys.executable, "-m", "medmamba_tpu_torch.cli.export",
                "--checkpoint_path", pth, "--out", arts["ssd"],
                "--image_size", str(IMAGE)], {"MEDMAMBA_SCAN_KERNEL": "ssd"},
               "cli.export under ssd").strip().splitlines()[-1]
    export_s["ssd"] = time.perf_counter() - t0
    log(f"  cli.export under MEDMAMBA_SCAN_KERNEL=ssd: {line} "
        f"({export_s['ssd']:.1f} s wall)")
    if "scan kernel K1" not in line:
        raise SystemExit("cli.export under ssd did not bake K1")
    t0 = time.perf_counter()
    with scan_kernel("hillis"), open(arts["hillis"], "wb") as f:
        f.write(export_forward(models["hillis"], image_size=IMAGE))
    export_s["hillis"] = time.perf_counter() - t0
    log(f"  export_forward under MEDMAMBA_SCAN_KERNEL=hillis at depths "
        f"{HILLIS_EXPORT_DEPTHS}: {os.path.getsize(arts['hillis']) / 1e6:.1f}"
        f" MB ({export_s['hillis']:.1f} s wall)")
    t0 = time.perf_counter()
    res = run([sys.executable, "-c", LOAD_ARTIFACT, frames_path,
               ",".join(map(str, EXPORT_BATCHES)),
               arts["ssd"], os.path.join(root, "ssd"), "hillis",
               arts["hillis"], os.path.join(root, "hillis"), "ssd"], {},
              "loading the artifacts")
    load_s = time.perf_counter() - t0
    res = json.loads(next(ln for ln in res.splitlines()
                          if ln.startswith("result "))[len("result "):])
    log(f"  both artifacts loaded and called in a fresh process in "
        f"{load_s:.1f} s")

    macs = model_flops_report(cfg.depths, cfg.dims, IMAGE,
                              num_classes=NUM_CLASSES)["total_macs"]
    out = {"gflop_per_image": 2 * macs / 1e9, "load_and_call_s": load_s}
    for scan, other in (("ssd", "hillis"), ("hillis", "ssd")):
        model, art, r = models[scan], arts[scan], res[arts[scan]]

        def live(xb):
            with torch.no_grad():
                return torch.softmax(model(preprocess(xb, size=IMAGE)), -1)
        want_counts = ([launches[scan], 0] if scan == "ssd"
                       else [0, launches[scan]])
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
                counts = r["counts"][str(b)]
                log(f"  {scan} artifact at batch {b}, graphed in the fresh "
                    f"process: K1 {counts[0]}, K3 {counts[1]} launches a "
                    f"call (MEDMAMBA_SCAN_KERNEL={other}); against the live "
                    f"forward max|err| {err:.3e} (atol {TOL_EXPORT:g})")
                if counts != want_counts:
                    raise SystemExit(f"the {scan} artifact launched "
                                     f"{counts} (K1, K3) at batch {b}, "
                                     f"expected {want_counts}")
                if err > TOL_EXPORT:
                    raise SystemExit(f"the {scan} artifact's probabilities "
                                     f"are {err:.3e} off the live forward's")
            art_ms, art_ms1 = r["ms"][str(BATCH)], r["ms"]["1"]
            out[scan] = dict(
                artifact_mb=os.path.getsize(art) / 1e6,
                export_s=export_s[scan], launches_per_call=want_counts,
                max_abs_err=worst, artifact_ms=art_ms,
                artifact_img_s=BATCH / art_ms * 1e3,
                artifact_ms_batch1=art_ms1)
            log(f"  {scan} artifact graphed in the fresh process: batch "
                f"{BATCH} {art_ms:.3f} ms ({out[scan]['artifact_img_s']:.1f} "
                f"img/s), batch 1 {art_ms1:.3f} ms")
            for b in (BATCH, 1):
                t = r["turns"][str(b)]
                out[scan][f"in_turns_ms_batch{b}"] = t
                out[scan][f"graph_ms_batch{b}"] = (t[1] + t[2]) / 2
                out[scan][f"eager_ms_batch{b}"] = (t[0] + t[3]) / 2
                log(f"  {scan} artifact at batch {b} in the fresh process, "
                    f"in turns (eager, graphed, graphed, eager): "
                    f"{' '.join(f'{v:.3f}' for v in t)} ms")
            if scan == "hillis":
                continue
            out[scan]["fp32_peak_share"] = (2 * macs * BATCH / art_ms * 1e3
                                            / PEAK_FP32_OPS_PER_S)
            log(f"  {scan}: analytic forward {out['gflop_per_image']:.3f} "
                f"GFLOP an image (model_flops_report, 2 FLOPs a MAC): at the "
                f"graphed artifact's rate "
                f"{100 * out[scan]['fp32_peak_share']:.2f}% of the float32 "
                f"peak ({PEAK_FP32_OPS_PER_S / 1e12:.0f} TFLOP/s)")
    del models
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
                    turns["eval"].append(back_to_back_ms(model, [x], 5))
        with scan_kernel(scan):
            for compute in ("float32", "bfloat16", "bfloat16", "float32"):
                with scan_compute(compute):
                    turns["train"].append(back_to_back_ms(step, [None], 2))
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


# phase 23: kernels a launch of each family makes (K2 is a walk and a
# reduction, K4 an expansion, a walk and a reduction); the steps held eager
# against graphed; where two eager runs themselves disagree, each step's
# loss within this share of its scale
KERNELS_PER_LAUNCH = {"K1": 1, "K2": 2, "K3": 1, "K4": 3, "K5": 1}
COMPILED_STEPS = 5
TOL_COMPILED_LOSS = 1e-4
LOADER_EPOCHS = 5


def check_profiled_launches(label: str, prof: dict, unit: str,
                            **launches) -> dict:
    """The profiler's kernels per call of each family against the launches
    the counters give: exactly, and none of the other scan families."""
    got = {k: prof[f"family_kernels_per_{unit}"].get(FAMILY[k], 0)
           / KERNELS_PER_LAUNCH[k] for k in FAMILY}
    want = {k: launches.get(k, 0) for k in FAMILY}
    log(f"  {label}: the profiler's launches per {unit} {got}")
    if got != want:
        raise SystemExit(f"{label}: the profiler counts {got} launches per "
                         f"{unit}, expected {want}")
    return got


def in_turns(eager, graphed, reps: int) -> dict:
    """ms per call of ``eager`` and ``graphed`` timed in turns (eager,
    graphed, graphed, eager; each ``back_to_back_ms``)."""
    t = [back_to_back_ms(fn, [None], reps)
         for fn in (eager, graphed, graphed, eager)]
    return dict(eager_ms=(t[0] + t[3]) / 2, graph_ms=(t[1] + t[2]) / 2,
                in_turns_ms=t)


def compiled_forward(scan: str, frames, profiles: dict):
    """The graphed softmax forward of medmamba_t at batch 64 and 1 under
    ``scan``: the eager forward's bits, 20 launches of its scan kernel per
    replay by the counters and by the profiler (``profiles``, from
    ``profile_graphs``), timed in turns with the eager forward. Returns the
    numbers and, for ssd, the batch-1 CAM's graphs against eager
    (``compiled_cam``; the demo request's other part)."""
    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    k = {"ssd": "K1", "hillis": "K3"}[scan]
    model = create_model("T", NUM_CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    out = {}
    with scan_kernel(scan):
        forward = trainer.compile_forward(model)
        for batch in (BATCH, 1):
            x = frames[:batch]
            want = trainer.predict(model, x)[0]
            got = forward(x, image_size=IMAGE)[0]
            graph = list(forward.graphs.values())[-1]
            equal = torch.equal(got, want)
            log(f"  {scan} forward at batch {batch}: graphed against eager "
                f"bit for bit {equal} (max|err| "
                f"{(got - want).abs().max().item():.3e}); capture "
                f"{graph.capture_s:.3f} s, pool {graph.pool_bytes} B")
            if not equal:
                raise SystemExit(f"the graphed {scan} forward at batch "
                                 f"{batch} differs from the eager one")
            reset_counts()
            forward(x, image_size=IMAGE)
            torch.cuda.synchronize()
            if read_counts() != expected_counts(**{k: LAUNCHES_PER_FORWARD}):
                raise SystemExit(f"a {scan} forward replay counted "
                                 f"{read_counts()}")
            res = out[batch] = in_turns(
                lambda _: trainer.predict(model, x),
                lambda _: forward(x, image_size=IMAGE),
                10)
            prof = profiles[f"{scan} forward {batch}"]
            check_profiled_launches(f"{scan} forward replay at batch "
                                    f"{batch}", prof, "call",
                                    **{k: LAUNCHES_PER_FORWARD})
            res.update(capture_s=graph.capture_s, pool_bytes=graph.pool_bytes,
                       img_s=batch / res["graph_ms"] * 1e3,
                       eager_img_s=batch / res["eager_ms"] * 1e3,
                       busy_share=prof["busy_share_of_kernel_window"],
                       kernel_ms=prof["kernel_ms_per_call"],
                       host_wall_ms=prof["host_wall_ms_per_call"])
            log(f"  {scan} forward at batch {batch}: graphed "
                f"{res['graph_ms']:.3f} ms ({res['img_s']:.1f} img/s), eager "
                f"{res['eager_ms']:.3f} ms ({res['eager_img_s']:.1f} img/s); "
                f"in turns {' '.join(f'{t:.3f}' for t in res['in_turns_ms'])}"
                f"; graphed busy {100 * res['busy_share']:.1f}%, kernels "
                f"{res['kernel_ms']:.3f} ms")
        if scan == "ssd":
            x = forward(frames[:1], image_size=IMAGE)[1].clone()
            out["cam"] = compiled_cam(model, x, int(got.argmax()))
        forward.free()
    return out


def cam_case(cam, model, x, label: str, kw: dict, launches: dict) -> dict:
    """One signature of the graphed CAM ``cam`` against the eager
    ``grad_cam``: bit for bit where two eager CAMs agree, else again with
    a graph captured under ``cudnn.deterministic`` (the bits there); the
    eager launches per replay."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.eval.gradcam import compile_cam, grad_cam

    want, again = grad_cam(model, x, **kw), grad_cam(model, x, **kw)
    got = cam(x, **kw)
    graph = list(cam.step.graphs.values())[-1]
    res = dict(eager_bitwise=bool(np.array_equal(want, again)),
               graph_bitwise=bool(np.array_equal(got, want)),
               max_abs_diff=float(np.abs(got - want).max()),
               capture_s=graph.capture_s, pool_bytes=graph.pool_bytes)
    if res["eager_bitwise"] and not res["graph_bitwise"]:
        raise SystemExit(f"graphed CAM {label}: {res['max_abs_diff']:.3e} "
                         "off the eager CAM, whose two runs agree")
    if not res["eager_bitwise"]:
        old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det = compile_cam(model)
            want = grad_cam(model, x, **kw)
            res["deterministic_graph_bitwise"] = bool(np.array_equal(
                det(x, **kw), want))
            res["deterministic_eager_bitwise"] = bool(np.array_equal(
                grad_cam(model, x, **kw), want))
            det.step.free()
        finally:
            torch.backends.cudnn.deterministic = old
        if not (res["deterministic_graph_bitwise"]
                and res["deterministic_eager_bitwise"]):
            raise SystemExit(f"graphed CAM {label} under "
                             f"cudnn.deterministic: {res}")
    reset_counts()
    cam(x, **kw)
    torch.cuda.synchronize()
    res["launches"] = read_counts()
    if res["launches"] != expected_counts(**launches):
        raise SystemExit(f"graphed CAM {label}: a replay counted "
                         f"{res['launches']}, expected {launches}")
    log(f"  Grad-CAM {label}: two eager runs bit for bit "
        f"{res['eager_bitwise']}, graphed against eager bit for bit "
        f"{res['graph_bitwise']} (max|diff| {res['max_abs_diff']:.2e})"
        + ("" if res["eager_bitwise"] else
           "; under cudnn.deterministic graphed against eager bit for bit "
           f"{res['deterministic_graph_bitwise']}")
        + f"; launches a replay {launches}; capture {graph.capture_s:.3f} "
        f"s, pool {graph.pool_bytes} B")
    return res


def compiled_cam(model, x, pred: int) -> dict:
    """The graphed Grad-CAM (``eval/gradcam.py: compile_cam``) of
    medmamba_t at batch 1 against the eager ``grad_cam`` (``cam_case``):
    at the default target with the class given (20 K1, no K2) and taken on
    the card, at UPSTREAM_TARGETS (20 K1, 10 K2), there with every block's
    output and the targets substituted, and at UPSTREAM_TARGETS under
    hillis (20 K3, 10 K4); the default and upstream CAMs timed in turns
    with the eager ones (each call ending in the host copy); the bound on
    its graphs."""
    from medmamba_tpu_torch.eval.gradcam import (CAM_GRAPHS, compile_cam,
                                                 grad_cam,
                                                 target_activations)

    cam = compile_cam(model)
    sites = cam_sites(model, UPSTREAM_TARGETS)
    up = dict(target_class=[pred], target_paths=UPSTREAM_TARGETS)
    cases = {
        "default": (dict(target_class=[pred]),
                    {"K1": LAUNCHES_PER_FORWARD}, "ssd"),
        "default, class on the card": (dict(), {"K1": LAUNCHES_PER_FORWARD},
                                       "ssd"),
        "upstream": (up, {"K1": LAUNCHES_PER_FORWARD, "K2": UPSTREAM_BWD},
                     "ssd"),
        "upstream, substituted": (
            dict(up, substitute=dict(zip(sites, target_activations(
                model, x, sites)))),
            {"K1": LAUNCHES_PER_FORWARD, "K2": UPSTREAM_BWD}, "ssd"),
        "upstream, hillis": (up, {"K3": LAUNCHES_PER_FORWARD,
                                  "K4": UPSTREAM_BWD}, "hillis")}
    out = {}
    for label, (kw, launches, scan) in cases.items():
        with scan_kernel(scan):
            out[label] = cam_case(cam, model, x, label, kw, launches)
    for label in ("default", "upstream"):
        kw = cases[label][0]
        res = in_turns(lambda _: grad_cam(model, x, **kw),
                       lambda _: cam(x, **kw), 10)
        out[label].update(res)
        log(f"  Grad-CAM {label} at batch 1, ms a CAM in turns (eager, "
            f"graphed, graphed, eager): "
            f"{' '.join(f'{t:.3f}' for t in res['in_turns_ms'])}; graphed "
            f"{res['graph_ms']:.3f} against eager {res['eager_ms']:.3f}")
    out["graphs"] = len(cam.step.graphs)
    if cam.step.maxsize != CAM_GRAPHS or out["graphs"] > CAM_GRAPHS:
        raise SystemExit(f"the CAM keeps {out['graphs']} graphs, bound "
                         f"{cam.step.maxsize}")
    cam.step.free()
    return out


def nondeterministic_grads(model, state: dict, images, labels,
                           seed: int) -> dict:
    """The parameters whose first-step gradient bits differ between two
    eager runs from one state and one generator seed, as (module type,
    parameter) names; again with cuDNN's deterministic algorithms."""
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.train.trainer import cross_entropy

    def grads():
        model.load_state_dict(state)
        model.train()
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = preprocess(images, size=IMAGE, augment=True, generator=gen)
        cross_entropy(model(x, labels >= 0, generator=gen), labels).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    def differing():
        a, b = grads(), grads()
        return sorted({f"{type(model.get_submodule(n.rsplit('.', 1)[0])).__name__}"
                       f".{n.rsplit('.', 1)[1]}"
                       for n in a if not torch.equal(a[n], b[n])})
    out = {"default": differing()}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out["cudnn_deterministic"] = differing()
    finally:
        torch.backends.cudnn.deterministic = old
    return out


def three_runs(label: str, model, state: dict, images, labels,
               per_step: dict) -> dict:
    """COMPILED_STEPS train steps of ``model`` from ``state`` and one
    generator seed, eagerly twice and graphed once: exact launch counts in
    each run; the graph bit for bit where the eager runs agree (exits
    otherwise); each graphed loss's error and eager run 2's, of the loss's
    scale. The result keeps the graphed step's (compiled step, optimizer,
    generator, call) under ``graphed``."""
    import torch

    from medmamba_tpu_torch.train import trainer

    runs = []
    for graphed in (False, False, True):
        model.load_state_dict(state)
        opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
        gen = torch.Generator(device="cuda")
        if graphed:
            step = trainer.compile_train_step(model, opt, generator=gen)

            def call(_=None):
                return step(images, labels, augment=True, image_size=IMAGE)
        else:
            def call(_=None):
                return trainer.train_step(model, opt, images, labels,
                                          generator=gen, augment=True,
                                          image_size=IMAGE)
        gen.manual_seed(SEED + 13)
        reset_counts()
        losses, walls = [], []
        for _ in range(COMPILED_STEPS):
            t0 = time.perf_counter()
            losses.append(call().clone())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        if counts != expected_counts(**{
                k: COMPILED_STEPS * n for k, n in per_step.items()}):
            raise SystemExit(f"{label}: {COMPILED_STEPS} "
                             f"{'graphed' if graphed else 'eager'} steps "
                             f"counted {counts}")
        runs.append(dict(losses=torch.stack(losses).cpu(), walls=walls,
                         params={k: v.clone() for k, v in
                                 model.state_dict().items()}))

    def same(a, b):
        return torch.equal(a["losses"], b["losses"]) and all(
            torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    e1, e2, g = runs
    res = dict(eager_bitwise=same(e1, e2), graph_bitwise=same(e1, g),
               losses_eager=e1["losses"].tolist(),
               losses_graph=g["losses"].tolist(),
               graphed=(step, opt, gen, call))
    scale = e1["losses"].abs().clamp_min(1.0)
    res["loss_err"] = ((g["losses"] - e1["losses"]).abs()
                       / scale).max().item()
    res["loss_err_eager"] = ((e2["losses"] - e1["losses"]).abs()
                             / scale).max().item()
    for key, run in (("eager", e1), ("graph", g)):
        w = sorted(run["walls"][1:])
        res[f"step_wall_ms_{key}"] = dict(median=w[len(w) // 2], min=w[0],
                                          max=w[-1])
    log(f"  {label}: {COMPILED_STEPS} steps; two eager runs bit for bit "
        f"{res['eager_bitwise']}, graphed against eager bit for bit "
        f"{res['graph_bitwise']}; losses of their scale: graphed "
        f"{res['loss_err']:.3e}, eager run 2 {res['loss_err_eager']:.3e}; "
        f"losses {' '.join(f'{v:.6f}' for v in res['losses_graph'])}")
    if res["eager_bitwise"] and not res["graph_bitwise"]:
        raise SystemExit(f"{label}: the graphed steps differ from the eager "
                         "ones, which agree bit for bit")
    return res


def compiled_train(scan: str, name: str, dtype, images, labels,
                   profiles: dict, guard_check: bool = False) -> dict:
    """The graphed train step of medmamba_t under ``scan``
    (``three_runs``). Where the two eager runs disagree, the parameters
    whose first-step gradients differ are named (with and without cuDNN's
    deterministic algorithms), and the three runs are made again under
    ``torch.backends.cudnn.deterministic``: the graph is held to the eager
    bits where the eager runs agree there, else each loss within
    TOL_COMPILED_LOSS of its scale. Then, at the default settings: exact
    launches per replay by the profiler and its busy share of one graphed
    step (``profiles``, from ``profile_graphs``); timed in turns with the
    eager step on the same model; the state guard after
    ``opt.load_state_dict`` (``guard_check``)."""
    import copy

    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    fwd, bwd = {"ssd": ("K1", "K2"), "hillis": ("K3", "K4")}[scan]
    per_step = {fwd: LAUNCHES_PER_FORWARD, bwd: LAUNCHES_PER_FORWARD,
                "K5": 1}
    label = f"{scan} {name} train step"
    with scan_kernel(scan):
        model = create_model("T", NUM_CLASSES, dtype=dtype, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        res = three_runs(label, model, state, images, labels, per_step)
        if not res["eager_bitwise"]:
            res["nondeterministic"] = nondeterministic_grads(
                model, state, images, labels, SEED + 13)
            log(f"  {label}: first-step gradients whose bits differ between "
                f"eager runs: {res['nondeterministic']['default']}; with "
                "torch.backends.cudnn.deterministic: "
                f"{res['nondeterministic']['cudnn_deterministic']}")
            # again with cuDNN's deterministic algorithms, where the eager
            # runs can agree bit for bit and the graph is held to their bits
            torch.backends.cudnn.deterministic = True
            try:
                res["cudnn_deterministic"] = three_runs(
                    label + " (cudnn.deterministic)", model, state, images,
                    labels, per_step)
            finally:
                torch.backends.cudnn.deterministic = False
            det = res["cudnn_deterministic"]
            det.pop("graphed")[0].free()
            held = det if det["eager_bitwise"] else res
            if not held["eager_bitwise"] and \
                    held["loss_err"] > TOL_COMPILED_LOSS:
                raise SystemExit(f"{label}: graphed losses stray "
                                 f"{held['loss_err']:.3e} from eager (limit "
                                 f"{TOL_COMPILED_LOSS:g})")
        step, opt, gen, call = res.pop("graphed")
        graph = list(step.graphs.values())[0]
        res.update(capture_s=graph.capture_s, pool_bytes=graph.pool_bytes)
        res.update(in_turns(
            lambda _: trainer.train_step(model, opt, images, labels,
                                         generator=gen, augment=True,
                                         image_size=IMAGE), call, 1))
        res.update(img_s=BATCH / res["graph_ms"] * 1e3,
                   eager_img_s=BATCH / res["eager_ms"] * 1e3)
        prof = profiles[label]
        check_profiled_launches(f"{label} replay", prof, "call", **per_step)
        res.update(busy_share=prof["busy_share_of_kernel_window"],
                   kernel_ms=prof["kernel_ms_per_call"],
                   host_wall_ms=prof["host_wall_ms_per_call"],
                   family_ms=prof["family_ms_per_call"])
        log(f"  {label}: graphed {res['graph_ms']:.3f} ms "
            f"({res['img_s']:.1f} img/s), eager {res['eager_ms']:.3f} ms "
            f"({res['eager_img_s']:.1f} img/s); in turns "
            f"{' '.join(f'{t:.3f}' for t in res['in_turns_ms'])}; graphed "
            f"busy {100 * res['busy_share']:.1f}%, kernels "
            f"{res['kernel_ms']:.3f} ms; capture {res['capture_s']:.3f} s, "
            f"pool {res['pool_bytes']} B; a step with a sync after it: "
            f"graphed {res['step_wall_ms_graph']}, eager "
            f"{res['step_wall_ms_eager']} ms")
        if guard_check:
            t0 = time.perf_counter()
            for _ in range(100):
                graph.guard.check()
            res["guard_us"] = (time.perf_counter() - t0) * 1e4
            opt.load_state_dict(copy.deepcopy(opt.state_dict()))
            try:
                call()
            except RuntimeError as e:
                res["guard"] = str(e)
            else:
                raise SystemExit("a replay after opt.load_state_dict did not "
                                 "raise")
            log(f"  state guard: {res['guard_us']:.1f} us a check; after "
                f"opt.load_state_dict a replay raises: {res['guard']}")
        step.free()
        del model, opt, step
        torch.cuda.empty_cache()
    return res


def loader_ms(root: str) -> dict:
    """Host ms per batch of ``BatchLoader.epoch`` on phase 8's NPZ split
    and phase 19's PNG tree (batch 64, as the CLIs load them), over
    LOADER_EPOCHS epochs, nothing consumed on the card."""
    from medmamba_tpu_torch.data.datasets import open_dataset
    from medmamba_tpu_torch.data.loader import BatchLoader

    write_train_split(root)
    tree = write_image_tree(root)
    out = {}
    for label, data in (("npz_28", root), ("png_224", tree)):
        ds, _ = open_dataset(data, "train", load_size=IMAGE)
        loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED)
        t0 = time.perf_counter()
        n = sum(1 for e in range(LOADER_EPOCHS) for _ in loader.epoch(e))
        out[label] = dict(ms_per_batch=(time.perf_counter() - t0) * 1e3 / n,
                          batches=n, images=len(ds))
    log(f"  BatchLoader.epoch, host ms per batch of {BATCH}: NPZ 28^2 "
        f"{out['npz_28']['ms_per_batch']:.3f} ({out['npz_28']['batches']} "
        f"batches), PNG 224^2 tree {out['png_224']['ms_per_batch']:.3f} "
        f"({out['png_224']['images']} images a batch)")
    return out


def compiled_inputs():
    """Phase 23's inputs on the card: uint8 frames for the forward, and a
    uint8 batch and its labels for the train step."""
    import numpy as np
    import torch

    frames = torch.from_numpy(np.random.default_rng(SEED + 12).integers(
        0, 256, (BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    images = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen,
                           device="cuda")
    return frames, images, labels


TRAIN_CONFIGS = (("bf16+aug", "bfloat16"), ("fp32+aug", "float32"))


def profile_graphs() -> dict:
    """One replay of each graph of phase 23 under ``torch.profiler``
    (``profile_families``, by kernel family), one session of one replay
    each, in the process that calls it: phase 23 runs it in a fresh
    process, since the tracer of a process that has opened many sessions
    drops events. Keys: "<scan> forward <batch>" and "<scan> <config>
    train step"."""
    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    frames, images, labels = compiled_inputs()
    out = {}
    for scan in ("ssd", "hillis"):
        with scan_kernel(scan):
            model = create_model("T", NUM_CLASSES, device="cuda",
                                 generator=torch.Generator().manual_seed(SEED))
            forward = trainer.compile_forward(model)
            for batch in (BATCH, 1):
                x = frames[:batch]
                forward(x, image_size=IMAGE)
                out[f"{scan} forward {batch}"] = profile_families(
                    lambda: forward(x, image_size=IMAGE), "call", steps=1)
            forward.free()
            for name, dtype in TRAIN_CONFIGS:
                model = create_model(
                    "T", NUM_CLASSES, dtype=getattr(torch, dtype),
                    device="cuda",
                    generator=torch.Generator().manual_seed(SEED))
                opt, _ = trainer.make_optimizer(model.parameters(), 1e-3,
                                                True)
                step = trainer.compile_train_step(
                    model, opt, generator=torch.Generator(
                        device="cuda").manual_seed(SEED + 13))
                step(images, labels, augment=True, image_size=IMAGE)
                out[f"{scan} {name} train step"] = profile_families(
                    lambda: step(images, labels, augment=True,
                                 image_size=IMAGE), "call", steps=1)
                step.free()
    return out


def phase_compiled(root: str, demo_ms: float) -> dict:
    """Phase 23 (see the docstring)."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    profiles = json.loads(run(
        [sys.executable, "-c", "import json, chip_smoke; print('result ' + "
         "json.dumps(chip_smoke.profile_graphs()))"], {},
        "phase 23's profiler process").split("result ", 1)[1])
    log(f"  one replay of each graph under the profiler, in a fresh process "
        f"({time.perf_counter() - t0:.1f} s)")
    frames, images, labels = compiled_inputs()
    out = {"forward": {scan: compiled_forward(scan, frames, profiles)
                       for scan in ("ssd", "hillis")}}
    out["train"] = {}
    for scan in ("ssd", "hillis"):
        for name, dtype in TRAIN_CONFIGS:
            out["train"][f"{scan} {name}"] = compiled_train(
                scan, name, getattr(torch, dtype), images, labels, profiles,
                guard_check=(scan, name) == ("hillis", "fp32+aug"))
    b1 = out["forward"]["ssd"][1]
    cam = out["forward"]["ssd"]["cam"]["default"]
    out["demo"] = dict(request_ms=demo_ms, forward_ms=b1["graph_ms"],
                       forward_eager_ms=b1["eager_ms"],
                       cam_ms=cam["graph_ms"], cam_eager_ms=cam["eager_ms"],
                       rest_ms=demo_ms - b1["graph_ms"] - cam["graph_ms"])
    log(f"  demo request (phase 20, graphed forward and CAM) {demo_ms:.1f} "
        f"ms: the batch-1 forward {b1['graph_ms']:.3f} ms graphed (eager "
        f"{b1['eager_ms']:.3f}), the Grad-CAM {cam['graph_ms']:.3f} ms "
        f"graphed (eager {cam['eager_ms']:.3f}), the rest (decode, PNGs, "
        f"HTTP) {out['demo']['rest_ms']:.3f} ms")
    out["loader"] = loader_ms(root)
    step = out["train"]["ssd bf16+aug"]["graph_ms"]
    log(f"  the loader beside the graphed ssd bf16 step ({step:.3f} ms): NPZ "
        f"{out['loader']['npz_28']['ms_per_batch']:.3f} ms a batch, PNG "
        f"{out['loader']['png_224']['ms_per_batch']:.3f} ms")
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
    ("collective", r"nccl|Nccl"),
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


def profile_families(fn, unit: str, steps: int = PROFILE_STEPS) -> dict:
    """Device time per call of ``fn`` by kernel family, from
    ``torch.profiler`` over ``steps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    by_family, by_name, launches = {}, {}, {}
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3 / steps
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + dur
        launches[fam] = launches.get(fam, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    return {
        f"host_wall_ms_per_{unit}": wall_ms / steps,
        f"kernel_ms_per_{unit}": sum(by_family.values()),
        "busy_share_of_kernel_window": busy_us(spans) / window,
        f"family_ms_per_{unit}": dict(
            sorted(by_family.items(), key=lambda kv: -kv[1])),
        f"family_kernels_per_{unit}": {
            fam: n / steps for fam, n in launches.items()},
        "top_kernels": [{"name": k[:120],
                         f"launches_per_{unit}": n / steps,
                         f"ms_per_{unit}": t} for k, (n, t) in top]}


# phase 24: the CAM backbones at full width (1000 classes) and VSSMSeg at its
# defaults (2 classes), 224^2
CAM_ARCHS = ("vit", "swin", "mobilenet")
CAM_CLASSES = 1000
# the card's CAM against the CPU's given the card's activation at the target
# (check_cam's method): a CAM jumps where an activation downstream of its
# target crosses a kink (MobileNetV2's head ReLU6), and given the target's
# activation what is left is float32 arithmetic in another order; 1e-4
# absolute, the CPU parity tests' CAM tolerance against the JAX package
TOL_CAM = 1e-4
SEG_CLASSES = 2
SEG_BATCH = GRAD_BATCH         # the plain scan's autograd tape stays small
SEG_LAUNCHES = 40              # 20 SS-Conv-SSM blocks, 2 scans each
# phase 24 holds VSSMSeg against the plain scan and K2's plain adjoint at
# one block a stage in the encoder and the decoder (every stage shape, at
# half the plain versions' loops), cut from its default depths
SEG_PLAIN_DEPTHS = (1, 1, 1, 1)
# cli.cam_backbones' main() in a process of its own: argv is an .npz to
# write and the CLI's arguments; it saves what main() returns and its wall
CAM_RUNNER = r"""
import sys, time
import numpy as np
from medmamba_tpu_torch.cli import cam_backbones

t0 = time.perf_counter()
out = cam_backbones.main(sys.argv[2:])
np.savez(sys.argv[1], logits=out["logits"], cam=out["cam"], pred=out["pred"],
         seconds=time.perf_counter() - t0)
"""


def write_cam_inputs(root: str) -> tuple:
    """A random 224^2 PNG and each backbone's random .pth (seed SEED; the
    ViT's zero-initialised head drawn from normal(0.02), since a zero head
    gives zero logits and a zero CAM)."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli.cam_backbones import build
    from medmamba_tpu_torch.utils import png

    image = os.path.join(root, "cam.png")
    rng = np.random.default_rng(SEED + 11)
    with open(image, "wb") as f:
        f.write(png.encode(rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                        dtype=np.uint8)))
    pths = {}
    for arch in CAM_ARCHS:
        model, _, _ = build(arch, CAM_CLASSES, IMAGE,
                            torch.Generator().manual_seed(SEED))
        if arch == "vit":
            with torch.no_grad():
                model.head.weight.normal_(
                    0.0, 0.02, generator=torch.Generator().manual_seed(SEED))
        pths[arch] = os.path.join(root, f"{arch}.pth")
        torch.save({"model_state_dict": model.state_dict()}, pths[arch])
    return image, pths


def phase_cam_backbone(arch: str, root: str, image: str, pth: str) -> dict:
    """``cli.cam_backbones`` on the card in a process of its own and on the
    CPU in this one, the same weights and image: the PNG, the CAM's range,
    logits within TOL_FP32 of their scale, the card's CAM against the CPU's
    given the card's activation at the target (TOL_CAM); then the eager
    forward at batch 64, timed and profiled."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import cam_backbones
    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.eval.gradcam import grad_cam, target_activations
    from medmamba_tpu_torch.utils import png

    args = ["--arch", arch, "--image", image, "--checkpoint_path", pth,
            "--image_size", str(IMAGE), "--num_classes", str(CAM_CLASSES)]
    out_png = os.path.join(root, f"{arch}_cam.png")
    npz = os.path.join(root, f"{arch}.npz")
    t0 = time.perf_counter()
    run([sys.executable, "-c", CAM_RUNNER, npz, *args, "--output", out_png,
         "--device", "cuda"], {}, f"cli.cam_backbones --arch {arch}")
    process_s = time.perf_counter() - t0
    card = dict(np.load(npz))
    with open(out_png, "rb") as f:
        shape = png.decode(f.read()).shape
    cam = card["cam"]
    if shape != (IMAGE, 2 * IMAGE, 3) or cam.shape != (IMAGE, IMAGE) \
            or not np.isfinite(cam).all() or cam.min() < 0 \
            or cam.max() > 1 or not cam.any():
        raise SystemExit(f"{arch}: PNG {shape}, CAM {cam.shape} in "
                         f"[{cam.min()}, {cam.max()}]")
    t0 = time.perf_counter()
    cpu = cam_backbones.main([*args, "--output", out_png, "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(cpu["logits"]).max())
    logits_err = float(np.abs(card["logits"] - cpu["logits"]).max()) / scale

    model, path, reshape = cam_backbones.build(arch, CAM_CLASSES, IMAGE)
    model.load_state_dict(torch.load(pth, weights_only=True)[
        "model_state_dict"])
    model.eval()
    with open(image, "rb") as f:
        img = torch.from_numpy(png.load_rgb(f.read(), IMAGE)[None])
    target = np.array([int(card["pred"])])
    act = target_activations(model.cuda(), preprocess(img.cuda(), size=IMAGE),
                             [path])[0]
    want = grad_cam(model.cpu(), preprocess(img, size=IMAGE),
                    target_class=target, target_paths=[path],
                    reshape_transform=reshape,
                    substitute={path: act.cpu()})[0]
    cam_err = float(np.abs(cam - want).max())
    cli_cam_err = float(np.abs(cam - cpu["cam"]).max())
    log(f"  {arch}: process {process_s:.2f} s (main() {card['seconds']:.2f} "
        f"s), on the CPU {cpu_s:.2f} s; pred {int(card['pred'])} (CPU "
        f"{cpu['pred']}); logits {logits_err:.2e} of their scale {scale:.3e} "
        f"(limit {TOL_FP32:g}); CAM against the CPU's at the card's "
        f"activation {cam_err:.2e} (limit {TOL_CAM:g}), against the CPU "
        f"CLI's own {cli_cam_err:.2e}")
    if logits_err > TOL_FP32 or cam_err > TOL_CAM:
        raise SystemExit(f"{arch}: the card disagrees with the CPU")

    model.cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    with torch.inference_mode():
        fwd_ms = back_to_back_ms(model, [x], 10)
        prof = profile_families(lambda: model(x), "forward")
    log(f"  {arch} forward, 224^2, batch {BATCH}, float32 without TF32: "
        f"{fwd_ms:.3f} ms, {BATCH / fwd_ms * 1e3:.1f} img/s; device "
        f"{prof['kernel_ms_per_forward']:.3f} ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    prof["family_ms_per_forward"].items()))
    del model, x
    torch.cuda.empty_cache()
    return dict(process_s=process_s, main_s=float(card["seconds"]),
                cpu_s=cpu_s, logits_rel_err=logits_err, cam_err=cam_err,
                cli_cam_err=cli_cam_err, forward_ms=fwd_ms,
                img_s=BATCH / fwd_ms * 1e3, profile=prof)


def phase_seg() -> dict:
    """VSSMSeg at its defaults: a forward at batch SEG_BATCH with exactly
    40 K1 launches (counters and profiler); the backward of a per-pixel
    cross-entropy with exactly 40 K2 launches; under hillis 40 K3 and no
    other scan kernel, against the ssd output; the forward at batch 64
    timed and profiled, 40 K1 a forward by the profiler. At
    SEG_PLAIN_DEPTHS in the encoder and the decoder (cut from the
    defaults): the forward against the same model on the plain scan, and
    each parameter's gradient against the same backward through K2's
    plain version (phase 9's method, deterministic forward)."""
    import torch
    import torch.nn.functional as F

    from medmamba_tpu_torch.models.decoder import VSSMSeg
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.ops.selective_scan import selective_scan_bwd_ref

    model = VSSMSeg(SEG_CLASSES, generator=torch.Generator().manual_seed(SEED))
    cut = dict(depths=SEG_PLAIN_DEPTHS, depths_decoder=SEG_PLAIN_DEPTHS)
    small = VSSMSeg(SEG_CLASSES, **cut,
                    generator=torch.Generator().manual_seed(SEED))
    ref = VSSMSeg(SEG_CLASSES, **cut, scan_impl="ref")
    ref.load_state_dict(small.state_dict())
    model, small = model.cuda().eval(), small.cuda().eval()
    ref = ref.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x = torch.randn(SEG_BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    labels = torch.randint(0, SEG_CLASSES, (SEG_BATCH, IMAGE, IMAGE),
                           generator=gen, device="cuda")

    launches = {}

    def forward(m, kernel=None):
        reset_counts()
        with torch.inference_mode():
            out = m(x)
        torch.cuda.synchronize()
        counts = read_counts()
        if kernel is not None:
            if counts != expected_counts(**{kernel: SEG_LAUNCHES}):
                raise SystemExit(f"VSSMSeg's forward launched {counts}, "
                                 f"expected {SEG_LAUNCHES} {kernel} only")
            launches[kernel] = counts[kernel]
        return out

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    out = forward(model, "K1")
    with torch.inference_mode():
        k1_profiled = profile_families(lambda: model(x), "forward", steps=1)[
            "family_kernels_per_forward"].get(FAMILY["K1"], 0)
    if k1_profiled != SEG_LAUNCHES:
        raise SystemExit(f"the profiler saw {k1_profiled} K1 a forward at "
                         f"batch {SEG_BATCH}")
    fwd_err = rel(forward(small), forward(ref))
    del ref
    with scan_kernel("hillis"):
        hillis_err = rel(forward(model, "K3"), out)
    log(f"  forward, batch {SEG_BATCH}: {SEG_LAUNCHES} K1 by the counters and "
        f"the profiler, output {tuple(out.shape)}; at depths "
        f"{SEG_PLAIN_DEPTHS} {fwd_err:.2e} of its scale off the plain "
        f"scan's; under hillis {SEG_LAUNCHES} K3, {hillis_err:.2e} off the "
        f"ssd output (limits {TOL_FP32:g})")
    if out.shape != (SEG_BATCH, IMAGE, IMAGE, SEG_CLASSES) \
            or fwd_err > TOL_FP32 or hillis_err > TOL_FP32:
        raise SystemExit("VSSMSeg's forward disagrees")

    def grads(m):
        m.zero_grad()
        loss = F.cross_entropy(m(x).permute(0, 3, 1, 2), labels)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in m.named_parameters()}
    reset_counts()
    grads(model)
    torch.cuda.synchronize()
    bwd_counts = read_counts()
    if bwd_counts != expected_counts(K1=SEG_LAUNCHES, K2=SEG_LAUNCHES):
        raise SystemExit(f"VSSMSeg's training pass launched {bwd_counts}")
    model.zero_grad(set_to_none=True)
    loss_k, got = grads(small)
    kernel_bwd = scan_cuda.selective_scan_bwd
    scan_cuda.selective_scan_bwd = selective_scan_bwd_ref
    try:
        loss_p, plain = grads(small)
    finally:
        scan_cuda.selective_scan_bwd = kernel_bwd
    del small
    rows = check_model_grads("VSSMSeg: K1 forward, K2", got, plain, loss_k,
                             loss_p)
    del got, plain

    x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    with torch.inference_mode():
        fwd_ms = back_to_back_ms(model, [x], 10)
        prof = profile_families(lambda: model(x), "forward")
    k1_ms = prof["family_ms_per_forward"].get(FAMILY["K1"], 0.0)
    k1_profiled = prof["family_kernels_per_forward"].get(FAMILY["K1"], 0)
    log(f"  forward, 224^2, batch {BATCH}, float32 without TF32: "
        f"{fwd_ms:.3f} ms, {BATCH / fwd_ms * 1e3:.1f} img/s; device "
        f"{prof['kernel_ms_per_forward']:.3f} ms, K1 {k1_ms:.3f} ms "
        f"({100 * k1_ms / prof['kernel_ms_per_forward']:.1f}%, "
        f"{k1_profiled:g} launches by the profiler)")
    if k1_profiled != SEG_LAUNCHES:
        raise SystemExit(f"the profiler saw {k1_profiled} K1 a forward at "
                         f"batch {BATCH}")
    del model, x
    torch.cuda.empty_cache()
    return dict(launches_forward=launches, launches_backward=bwd_counts,
                forward_rel_err=fwd_err, hillis_rel_err=hillis_err,
                grad_rel_err=rows[-1][0], loss=loss_k, forward_ms=fwd_ms,
                img_s=BATCH / fwd_ms * 1e3, k1_ms=k1_ms,
                k1_share=k1_ms / prof["kernel_ms_per_forward"], profile=prof)


def other_models_process(root: str) -> dict:
    """Phase 24 in a fresh process, whose log it prints: after phases 1-23
    this process's profiler drops kernel events (198 of 200 K1 in five
    VSSMSeg forwards on an H100), as phase 23 found, and the phase profiles
    every forward it times."""
    out = run([sys.executable, "-c", "import json, sys, chip_smoke; "
               "print('result ' + json.dumps(chip_smoke.phase_other_models("
               "sys.argv[1])))", root], {}, "phase 24's process")
    text, result = out.rsplit("\nresult ", 1)
    for line in text.splitlines():
        log(line)
    return json.loads(result)


def phase_other_models(root: str) -> dict:
    """Phase 24 (see the docstring), at the precision the port's entry
    points fix: float32 without TF32."""
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    t0 = time.perf_counter()
    image, pths = write_cam_inputs(root)
    log(f"  wrote the image and the .pth files in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for arch in CAM_ARCHS:
        t0 = time.perf_counter()
        out[arch] = phase_cam_backbone(arch, root, image, pths[arch])
        log(f"  ({arch}: {time.perf_counter() - t0:.1f} s)")
    log("other_models " + json.dumps(out))
    t0 = time.perf_counter()
    out["vssmseg"] = phase_seg()
    log(f"  (VSSMSeg: {time.perf_counter() - t0:.1f} s)")
    log("vssmseg " + json.dumps(out["vssmseg"]))
    return out


# phase 25: data parallelism and the sequence-parallel scan, each group in
# processes of its own started by torchrun (a process holds one default
# group, and after phases 1-23 this process's profiler drops events). The
# kernels are built by phase 2, so no child builds them. One host and no
# network: NCCL and gloo bootstrap over the loopback interface.
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone")
DIST_ENV = {"NCCL_SOCKET_IFNAME": "lo", "GLOO_SOCKET_IFNAME": "lo",
            "PYTHONPATH": REPO}
DIST_RUNNER = r"""
import sys
import chip_smoke

getattr(chip_smoke, sys.argv[1])(*sys.argv[2:])
"""
# (a) the graphed step with and without a world-1 group, timed in turns:
# back-to-back replays per turn
DIST_TIMING_REPS = 5
# (b) two gloo ranks on the card against one process, each step from the
# same state: steps on random batches, then a final batch of PAIR_REAL real
# rows padded to BATCH (32 rows a rank: 32 and 5 valid); eager steps under
# cudnn.deterministic, once with float32 blocks and once with bfloat16
# blocks. Float32 blocks: the ranks and one process differ only in the
# order of float32 sums (the collectives; cuDNN's and cuBLAS's kernels at
# batch 32 against 64), so the loss is held within TOL_PAIR_F32_LOSS of its
# value, the BatchNorm running statistics within TOL_PAIR_F32_STATS of the
# largest statistic, the summed gradient AdamW is given within
# TOL_PAIR_F32_GRAD of one process's in L2 norm, and the parameters after
# AdamW within TOL_PAIR_F32_UPDATE of one process's update in L2 norm (a
# parameter whose gradient is zero in exact arithmetic, a convolution bias
# in front of a BatchNorm, steps by up to lr either way on rounding noise:
# these limits hold that share, and a gradient that is not the global
# batch's moves every parameter). Each limit is about three times the
# largest reading of PR 14's chip calls (PERF.md §6); the parameter whose
# gradient parts most is a reading beside it. Bfloat16 blocks, what
# the CLI trains: the halves' kernels round their bfloat16 outputs apart by
# up to 2^-8; the loss, a mean of 64 rows, within TOL_PAIR_LOSS of its
# value (about one such rounding), the statistics within TOL_PAIR_STATS,
# the gradient within PAIR_GRAD_FACTOR times the same step's float32-block
# gradient off it (at random init a few of medmamba_t's gradients are
# ill-conditioned, so kernels that round apart move them by percents);
# the parameters are a reading there. The two ranks' parameters the same
# bits.
PAIR_STEPS = 3
PAIR_REAL = 37
PAIR_LR = 1e-3
PAIR_DTYPES = ("float32", "bfloat16")
TOL_PAIR_F32_LOSS = 5e-7
TOL_PAIR_F32_STATS = 1e-6
TOL_PAIR_F32_GRAD = 5e-3
TOL_PAIR_F32_UPDATE = 0.15
TOL_PAIR_LOSS = 5e-3
TOL_PAIR_STATS = 1e-2
PAIR_GRAD_FACTOR = 2.0
# (c) the split scan against K1 over the whole sequence and against the
# plain scan: the stitch (a cumulative product of decays, then a rank-1
# correction) rounds in another order than the sequential walk; y and the
# final state within TOL_FP32 of their scale. The shapes: medmamba_t's
# stage 0 at batch 64, and a 1024^2 image's stage 0 (L 65536) at batch 1.
SEQ_SHAPES = ((BATCH, STAGES[0][1]), (1, (1024 // 4) ** 2))


def dist_cli(out_path: str, deterministic: str, timing_path: str,
             *argv: str) -> None:
    """``cli.train.main(argv)``, cuDNN deterministic when
    ``deterministic`` is "1"; rank 0 (or the lone process) writes the
    per-step losses, the last ``.pth``, the launch counts and the wall to
    ``out_path``. Then, unless ``timing_path`` is "-", ``dist_timing`` in
    the same process (under torchrun), which saves a process start."""
    import torch

    from medmamba_tpu_torch.cli import train

    torch.backends.cudnn.deterministic = deterministic == "1"
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = train.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out_path, "w") as f:
            json.dump(dict(step_losses=out["step_losses"],
                           last_path=out["last_path"],
                           counts=read_counts(), main_s=wall), f)
    if timing_path != "-":
        dist_timing(timing_path)


def same_pth(a: str, b: str) -> bool:
    """Whether two training ``.pth`` files hold the same tensors, bit for
    bit: the model's state and the optimizer's."""
    import torch

    pa, pb = (torch.load(p, weights_only=True) for p in (a, b))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        if isinstance(tree, (list, tuple)):
            return flat(dict(enumerate(tree)), prefix)
        return {prefix: tree}
    fa, fb = (flat({k: p[k] for k in ("model_state_dict",
                                        "optimizer_state_dict")})
              for p in (pa, pb))
    return fa.keys() == fb.keys() and all(
        torch.equal(v, fb[k]) if torch.is_tensor(v) else v == fb[k]
        for k, v in fa.items())


def dist_timing(out_path: str) -> None:
    """Under torchrun, world 1 on NCCL: the graphed bf16 train step of
    medmamba_t (augmentation, 224^2, batch 64) captured without a group
    and with the world-1 group, on the same weights and generator seed;
    their first replays' losses, the two timed in turns, one replay of
    each under the profiler (launches and the collectives' device time)."""
    import torch
    t_start = time.perf_counter()

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.parallel import mesh
    from medmamba_tpu_torch.train import trainer
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    grid = mesh.make_mesh(device="cuda")
    try:
        _, images, labels = compiled_inputs()
        calls, first = {}, {}
        for name, active in (("no_group", None), ("group", grid)):
            mesh.set_active_mesh(active)
            model = create_model("T", NUM_CLASSES, dtype=torch.bfloat16,
                                 device="cuda", generator=torch.Generator()
                                 .manual_seed(SEED))
            opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
            step = trainer.compile_train_step(
                model, opt, generator=torch.Generator(device="cuda")
                .manual_seed(SEED + 13))

            def call(_=None, step=step):
                return step(images, labels, augment=True, image_size=IMAGE)
            reset_counts()
            first[name] = call().clone()
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != expected_counts(K1=LAUNCHES_PER_FORWARD,
                                         K2=LAUNCHES_PER_FORWARD, K5=1):
                raise SystemExit(f"graphed step ({name}): a replay counted "
                                 f"{counts}")
            calls[name] = call
        mesh.set_active_mesh(grid)
        backend = torch.distributed.get_backend(mesh.data_group(grid))
        turns = in_turns(calls["no_group"], calls["group"], DIST_TIMING_REPS)
        profiles = {name: profile_families(call, "call", steps=1)
                    for name, call in calls.items()}
        check_profiled_launches("graphed step with the group", profiles[
            "group"], "call", K1=LAUNCHES_PER_FORWARD,
            K2=LAUNCHES_PER_FORWARD, K5=1)
    finally:
        mesh.destroy_mesh()
    out = dict(backend=backend,
               first_loss_bitwise=bool(torch.equal(first["no_group"],
                                                   first["group"])),
               no_group_ms=turns["eager_ms"], group_ms=turns["graph_ms"],
               in_turns_ms=turns["in_turns_ms"],
               collective_ms={name: p["family_ms_per_call"].get(
                   "collective", 0.0) for name, p in profiles.items()},
               kernel_ms={name: p["kernel_ms_per_call"]
                          for name, p in profiles.items()},
               collective_kernels=[k["name"] for k in profiles["group"][
                   "top_kernels"] if family(k["name"]) == "collective"],
               families={name: p["family_ms_per_call"]
                         for name, p in profiles.items()},
               seconds=time.perf_counter() - t_start)
    with open(out_path, "w") as f:
        json.dump(out, f)


def pair_batches():
    """(b)'s global batches on the card, the same on every rank: PAIR_STEPS
    random uint8 batches and their labels, then one with PAIR_REAL real
    rows (label -1 after)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    out = []
    for i in range(PAIR_STEPS + 1):
        images = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3),
                               generator=gen, device="cuda",
                               dtype=torch.uint8)
        labels = torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen,
                               device="cuda")
        if i == PAIR_STEPS:
            labels[PAIR_REAL:] = -1
        out.append((images, labels))
    return out


def pair_model(dtype="bfloat16"):
    """medmamba_t with ``dtype`` blocks from seed SEED, and its AdamW."""
    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.train import trainer

    model = create_model("T", NUM_CLASSES, dtype=getattr(torch, dtype),
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    return model, trainer.make_optimizer(model.parameters(), PAIR_LR,
                                         True)[0]


def pair_steps(grid, rank: int) -> dict:
    """(b): eager steps on this rank's half of each global batch, with
    float32 and with bfloat16 blocks. Before each, rank 0 copies the ranks'
    state (model, optimizer, generator) into a model of its own, which
    takes one process's step on the whole batch (and, with bfloat16
    blocks, into a float32-block control); after it, the ranks' loss,
    gradient, BatchNorm statistics and parameters are held to that step's
    (see PAIR_*), so each step is compared from the same state."""
    import copy

    import torch

    from medmamba_tpu_torch.parallel import mesh
    from medmamba_tpu_torch.train import trainer

    group = mesh.data_group(grid)
    torch.backends.cudnn.deterministic = True
    try:
        batches = pair_batches()
        half = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
        grads = {}

        def keep_grads(opt, name):
            opt.register_step_pre_hook(lambda o, *_: grads.__setitem__(
                name, torch.cat([p.grad.reshape(-1) for g in o.param_groups
                                 for p in g["params"]])))
        runs = {}
        for dtype in PAIR_DTYPES:
            model, opt = pair_model(dtype)
            keep_grads(opt, "ranks")
            refs = {}
            if rank == 0:
                refs["one_process"] = pair_model(dtype)
                if dtype == "bfloat16":
                    refs["fp32_blocks"] = pair_model("float32")
                for name, (_, o) in refs.items():
                    keep_grads(o, name)
            runs[dtype] = dict(model=model, opt=opt, refs=refs, rows=[],
                               gen=torch.Generator(device="cuda")
                               .manual_seed(SEED + 23))
        ref_gen = torch.Generator(device="cuda")
        stats = [k for k, _ in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))]
        names = [k for k, _ in model.named_parameters()]
        sizes = [p.numel() for p in model.parameters()]
        counts, wall = {}, 0.0

        def flat_params(m):
            return torch.cat([p.detach().float().reshape(-1)
                              for p in m.parameters()])
        for images, labels in batches:
            for dtype, r in runs.items():
                model, opt, gen = r["model"], r["opt"], r["gen"]
                if rank == 0:
                    for m, o in r["refs"].values():
                        m.load_state_dict(model.state_dict())
                        o.load_state_dict(copy.deepcopy(opt.state_dict()))
                    gen_state = gen.get_state()
                    before = flat_params(model)
                reset_counts()
                t0 = time.perf_counter()
                loss = trainer.train_step(model, opt, images[half],
                                          labels[half], generator=gen,
                                          augment=True,
                                          image_size=IMAGE).item()
                wall += time.perf_counter() - t0
                counts = read_counts()
                if counts != expected_counts(K1=LAUNCHES_PER_FORWARD,
                                             K2=LAUNCHES_PER_FORWARD, K5=1):
                    raise SystemExit(f"rank {rank}: a {dtype} step counted "
                                     f"{counts}")
                if rank != 0:
                    continue
                mesh.set_active_mesh(None)
                try:
                    want = {}
                    for name, (m, o) in r["refs"].items():
                        ref_gen.set_state(gen_state)
                        want[name] = trainer.train_step(
                            m, o, images, labels, generator=ref_gen,
                            augment=True, image_size=IMAGE).item()
                finally:
                    mesh.set_active_mesh(grid)
                ref = r["refs"]["one_process"][0]
                got_s, want_s = model.state_dict(), ref.state_dict()
                scale = max(want_s[k].abs().max().item() for k in stats)
                p_got, p_want = flat_params(model), flat_params(ref)
                p_diff = (p_got - p_want).abs()
                g_ref = grads["one_process"]
                sq = [d.square().sum().item() for d in
                      (grads["ranks"] - g_ref).split(sizes)]
                worst = max(range(len(sq)), key=sq.__getitem__)
                row = dict(
                    grad_worst=names[worst],
                    grad_worst_share=sq[worst] / sum(sq),
                    loss=loss, loss_one_process=want["one_process"],
                    loss_rel_err=abs(loss - want["one_process"])
                    / abs(want["one_process"]),
                    grad_rel_err=((grads["ranks"] - g_ref).norm()
                                  / g_ref.norm()).item(),
                    stats_rel_err=max((got_s[k] - want_s[k]).abs().max()
                                      .item() for k in stats) / scale,
                    update_rel_err=((p_got - p_want).norm()
                                    / (p_want - before).norm()).item(),
                    param_max_abs_err=p_diff.max().item(),
                    param_share_over_lr_10=(p_diff > PAIR_LR / 10)
                    .float().mean().item())
                if "fp32_blocks" in want:
                    row["grad_rel_err_fp32_blocks"] = (
                        (grads["fp32_blocks"] - g_ref).norm()
                        / g_ref.norm()).item()
                r["rows"].append(row)
        same = {}
        for dtype, r in runs.items():
            both = mesh.all_gather(flat_params(r["model"]), group)
            same[dtype] = bool(torch.equal(both[0], both[1]))
        out = dict(steps={dtype: r["rows"] for dtype, r in runs.items()},
                   counts_a_step=counts, wall_s=wall, ranks_bitwise=same)
    finally:
        torch.backends.cudnn.deterministic = False
    torch.distributed.barrier(group)
    return out


def seq_checks(grid, rank: int) -> list:
    """(c): at each of SEQ_SHAPES, this rank's half of L through
    ``selective_scan_seq_parallel`` on K1 (one launch) against K1 over the
    whole sequence and the plain scan; the split call's wall with a sync
    and K1's time on the half (CUDA events); a backward through the kernel
    path raises."""
    import torch

    from medmamba_tpu_torch.ops.selective_scan import (LAST_STATE_GRAD_ERROR,
                                                       selective_scan)
    from medmamba_tpu_torch.ops.seq_parallel import \
        selective_scan_seq_parallel
    from medmamba_tpu_torch.parallel import mesh

    group = mesh.data_group(grid)
    out = []
    for batch, l in SEQ_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31 + l)
        x = scan_inputs(STAGES[0][0], l, torch.float32, gen, batch=batch)
        part = slice(rank * l // 2, (rank + 1) * l // 2)
        xs = {k: v[..., part].contiguous() if k in ("u", "delta", "B", "C")
              else v for k, v in x.items()}

        def split():
            return selective_scan_seq_parallel(
                **xs, delta_softplus=True, group=group,
                return_last_state=True)
        reset_counts()
        with torch.no_grad():
            y, h = split()
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected_counts(K1=1):
            raise SystemExit(f"rank {rank}: the split scan counted {counts}")
        row = dict(batch=batch, l=l, counts=counts)
        with torch.no_grad():
            for name, impl in (("k1", "auto"), ("plain", "ref")):
                y_w, h_w = selective_scan(**x, delta_softplus=True,
                                          return_last_state=True, impl=impl)
                y_w = y_w[..., part]
                row[f"y_err_vs_{name}"] = ((y - y_w).abs().max()
                                           / y_w.abs().max()).item()
                row[f"h_err_vs_{name}"] = ((h - h_w).abs().max()
                                           / h_w.abs().max()).item()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                split()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            row["split_ms"] = statistics.median(walls)
            row["k1_ms"] = back_to_back_ms(lambda _: selective_scan(
                **xs, delta_softplus=True, return_last_state=True), [None], 5)
        row["k1_share"] = row["k1_ms"] / row["split_ms"]
        worst = max(v for k, v in row.items() if k.endswith(
            ("_vs_k1", "_vs_plain")))
        if worst > TOL_FP32:
            raise SystemExit(f"rank {rank}: the split scan at batch {batch}, "
                             f"L {l} is {worst:.3e} of its scale off "
                             f"(limit {TOL_FP32:g}): {row}")
        out.append(row)
    # under autograd the kernel path raises in the backward (the local
    # scan's last state feeds the stitch); at the last shape
    leaf = xs["u"].clone().requires_grad_()
    try:
        selective_scan_seq_parallel(**dict(xs, u=leaf), delta_softplus=True,
                                    group=group).sum().backward()
    except RuntimeError as e:
        if LAST_STATE_GRAD_ERROR not in str(e):
            raise
        out.append(dict(raised=str(e)[:80]))
    else:
        raise SystemExit(f"rank {rank}: a backward through the split "
                         "kernel path did not raise")
    return out


def dist_pair(root: str) -> None:
    """Under torchrun, 2 ranks on card 0 over gloo (NCCL refuses two ranks
    on one card): (b) ``pair_steps`` and (c) ``seq_checks``; each rank
    writes ``pair_<rank>.json`` into ``root``."""
    import torch

    from medmamba_tpu_torch.parallel import mesh
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    rank = int(os.environ["RANK"])
    grid = mesh.make_mesh(device=torch.device("cuda", 0), backend="gloo")
    try:
        t0 = time.perf_counter()
        steps = pair_steps(grid, rank)
        t1 = time.perf_counter()
        seq = seq_checks(grid, rank)
        t2 = time.perf_counter()
    finally:
        mesh.destroy_mesh()
    with open(os.path.join(root, f"pair_{rank}.json"), "w") as f:
        json.dump(dict(steps=steps, seq=seq, steps_s=t1 - t0, seq_s=t2 - t1),
                  f)


def phase_distribution(root: str) -> dict:
    """Phase 25 (see the docstring)."""
    import torch

    runner = os.path.join(root, "dist_runner.py")
    with open(runner, "w") as f:
        f.write(DIST_RUNNER)
    write_train_split(root)
    steps = -(-N_IMAGES // BATCH)
    val_batches = -(-N_VAL // BATCH)
    want = expected_counts(K1=LAUNCHES_PER_FORWARD * (steps + val_batches),
                           K2=LAUNCHES_PER_FORWARD * steps, K5=steps)
    out = {}

    timing_path = os.path.join(root, "timing.json")

    def cli_runs(deterministic: str, timing: str) -> dict:
        runs = {}
        for name in ("no_group", "torchrun"):
            argv = ["--train_dir", root, "--val_dir", root, "--medmb_size",
                    "T", "--image_size", str(IMAGE), "--batch_size",
                    str(BATCH), "--epochs", "1", "--augmentation",
                    "--dtype", "bfloat16", "--device", "cuda", "--save_dir",
                    os.path.join(root, f"{name}_{deterministic}"),
                    "--log_every", "0"]
            path = os.path.join(root, f"{name}_{deterministic}.json")
            t0 = time.perf_counter()
            if name == "no_group":
                dist_cli(path, deterministic, "-", *argv)
            else:
                run([*TORCHRUN, "--nproc_per_node", "1", runner, "dist_cli",
                     path, deterministic, timing, *argv], DIST_ENV,
                    "cli.train under torchrun")
            with open(path) as f:
                runs[name] = json.load(f)
            runs[name]["wall_s"] = time.perf_counter() - t0
            if runs[name]["counts"] != want:
                raise SystemExit(f"cli.train ({name}) launched "
                                 f"{runs[name]['counts']}, expected {want}")
        a, b = runs["no_group"], runs["torchrun"]
        runs["bitwise"] = (a["step_losses"] == b["step_losses"]
                           and same_pth(a["last_path"], b["last_path"]))
        log(f"  cli.train without a group ({a['wall_s']:.1f} s, in this "
            f"process) and under torchrun world 1 on NCCL "
            f"({b['wall_s']:.1f} s, main() {b['main_s']:.1f} s, then the "
            f"timing below)"
            f"{' under cudnn.deterministic' if deterministic == '1' else ''}: "
            f"losses {a['step_losses']} and {b['step_losses']}; launches "
            f"{b['counts']}; losses and last .pth bit for bit: "
            f"{runs['bitwise']}")
        return runs

    out["cli"] = cli_runs("0", timing_path)
    if not out["cli"]["bitwise"]:
        out["cli_cudnn_deterministic"] = cli_runs("1", "-")
        if not out["cli_cudnn_deterministic"]["bitwise"]:
            raise SystemExit("cli.train under torchrun world 1 differs from "
                             "the run without a group, also under "
                             "cudnn.deterministic")
    torch.cuda.empty_cache()

    with open(timing_path) as f:
        out["timing"] = t = json.load(f)
    log(f"  graphed bf16 train step, world 1 on {t['backend']} "
        f"({t['seconds']:.1f} s): with the "
        f"group {t['group_ms']:.3f} ms, without {t['no_group_ms']:.3f} ms "
        f"in turns ({' '.join(f'{v:.3f}' for v in t['in_turns_ms'])}); "
        f"first losses bit for bit {t['first_loss_bitwise']}; collectives' "
        f"device time a step {t['collective_ms']['group']:.4f} ms "
        f"({t['collective_kernels']}); kernels a replay "
        f"{t['kernel_ms']['group']:.3f} ms with, "
        f"{t['kernel_ms']['no_group']:.3f} ms without; by family with "
        f"{t['families']['group']}, without {t['families']['no_group']}")
    if not t["first_loss_bitwise"]:
        raise SystemExit("the graphed step's first loss differs with the "
                         "world-1 group")

    t0 = time.perf_counter()
    run([*TORCHRUN, "--nproc_per_node", "2", runner, "dist_pair", root],
        DIST_ENV, "the two gloo ranks")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"pair_{r}.json")) as f:
            ranks.append(json.load(f))
    b = ranks[0]["steps"]
    log(f"  two gloo ranks on the card ({time.perf_counter() - t0:.1f} s, "
        f"steps {ranks[0]['steps_s']:.1f} s, seq {ranks[0]['seq_s']:.1f} "
        f"s; launches a rank a step {b['counts_a_step']}); ranks' "
        f"parameters bit for bit "
        f"{[r['steps']['ranks_bitwise'] for r in ranks]}")
    failed = []
    for dtype, rows in b["steps"].items():
        for i, row in enumerate(rows):
            if dtype == "float32":
                lim = dict(loss=TOL_PAIR_F32_LOSS, stats=TOL_PAIR_F32_STATS,
                           grad=TOL_PAIR_F32_GRAD, update=TOL_PAIR_F32_UPDATE)
                grad_lim = f"limit {lim['grad']:g}"
                update_lim = f" (limit {lim['update']:g})"
            else:
                lim = dict(loss=TOL_PAIR_LOSS, stats=TOL_PAIR_STATS,
                           grad=PAIR_GRAD_FACTOR
                           * row["grad_rel_err_fp32_blocks"],
                           update=float("inf"))
                grad_lim = (f"limit {PAIR_GRAD_FACTOR:g} x float32 blocks' "
                            f"{row['grad_rel_err_fp32_blocks']:.3e}")
                update_lim = ""
            padded = f" ({PAIR_REAL} of {BATCH} rows real)" \
                if i == PAIR_STEPS else ""
            log(f"    {dtype} step {i + 1}{padded}: loss {row['loss']:.6f}, "
                f"one process {row['loss_one_process']:.6f} "
                f"({row['loss_rel_err']:.3e} of it, limit {lim['loss']:g}); "
                f"BatchNorm statistics {row['stats_rel_err']:.3e} of their "
                f"scale (limit {lim['stats']:g}); gradient "
                f"{row['grad_rel_err']:.3e} in L2 ({grad_lim}; "
                f"{100 * row['grad_worst_share']:.1f}% of it in "
                f"{row['grad_worst']}); parameters "
                f"{row['update_rel_err']:.3e} of the update in L2"
                f"{update_lim}, at most {row['param_max_abs_err']:.3e} "
                f"apart, {100 * row['param_share_over_lr_10']:.3f}% over "
                f"lr/10")
            if any(row[f"{k}_rel_err"] > v for k, v in lim.items()):
                failed.append((dtype, i + 1))
    for r in ranks:
        for row in r["seq"][:-1]:
            log(f"  rank {ranks.index(r)} split scan, batch {row['batch']} "
                f"L {row['l']}: y {row['y_err_vs_k1']:.2e} of its scale off "
                f"K1 whole, {row['y_err_vs_plain']:.2e} off the plain scan; "
                f"final state {row['h_err_vs_k1']:.2e}, "
                f"{row['h_err_vs_plain']:.2e}; split call "
                f"{row['split_ms']:.3f} ms, K1 on the half "
                f"{row['k1_ms']:.4f} ms ({100 * row['k1_share']:.1f}%)")
    log(f"  the kernel path under autograd: {ranks[0]['seq'][-1]['raised']}")
    if not all(all(r["steps"]["ranks_bitwise"].values()) for r in ranks):
        raise SystemExit("the two ranks' parameters differ")
    if failed:
        raise SystemExit(f"two ranks against one process: over a limit at "
                         f"(blocks, step) {failed}")
    out["pair"] = dict(ranks[0]["steps"], seconds=time.perf_counter() - t0,
                       seq=[r["seq"][:-1] for r in ranks])
    return out


# phase 26: tensor parallelism over the mesh's model axis, two gloo ranks
# on the card as a 1x2 ("data", "model") mesh (NCCL refuses two ranks on
# one card), started by torchrun as phase 25's are. medmamba_t at full
# widths, 224^2, a global batch of TP_BATCH (every rank's scans take half of
# it), float32 blocks under cudnn.deterministic, augmentation: TP_STEPS
# eager train steps from one init, each against one process's step from the
# same state, then one under hillis (K3/K4), an eval_step and a predict.
# The gates, set from the prediction PERF.md §6 records for tensor
# parallelism, written before the first card call: the model ranks and one
# process differ only in the order of float32 sums (cuBLAS on half the
# output features, a column-parallel layer's input gradient summed over the
# ranks, the scan's parameter gradients summed over the halves), so the
# loss within TOL_TP_LOSS of itself, the BatchNorm running statistics
# within TOL_TP_STATS of the largest statistic, the gradient AdamW is given
# (shards gathered) within TOL_TP_GRAD of one process's in L2 norm, the
# parameters after AdamW within TOL_TP_UPDATE of one process's update in L2
# norm (PAIR_*'s reasons), the eval logits and served probabilities within
# TOL_TP_LOGITS of their scale; the model ranks' replicated parameters the
# same bits (their buffers, the BatchNorm statistics, are a reading); and
# the kernels the path launches, K1-K4, at its shapes (a rank's rows at
# each stage) against their plain versions to TOL_FP32.
TP_BATCH = 8
TP_STEPS = 3
TP_VAL = 16
TOL_TP_LOSS = 1e-6
TOL_TP_STATS = 1e-5
TOL_TP_GRAD = 1e-2
TOL_TP_UPDATE = 0.15
TOL_TP_LOGITS = 1e-5


@contextlib.contextmanager
def recorded_rows():
    """Within the block the scan kernels' wrappers record the rows (u's
    batch) of each launch: ``{"K1": [...], "K2": [...], ...}``."""
    from medmamba_tpu_torch.ops import scan_cuda, scan_hillis

    rows = {"K1": [], "K2": [], "K3": [], "K4": []}
    wrappers = ((scan_cuda, "selective_scan_fwd", "K1"),
                (scan_cuda, "selective_scan_bwd", "K2"),
                (scan_hillis, "selective_scan_hillis_fwd", "K3"),
                (scan_hillis, "selective_scan_hillis_bwd", "K4"))
    real = {name: getattr(m, name) for m, name, _ in wrappers}

    def recording(name, key):
        def call(u, *args, **kw):
            rows[key].append(int(u.shape[0]))
            return real[name](u, *args, **kw)
        return call
    for m, name, key in wrappers:
        setattr(m, name, recording(name, key))
    try:
        yield rows
    finally:
        for m, name, _ in wrappers:
            setattr(m, name, real[name])


def tp_batches():
    """TP_STEPS + 1 global uint8 batches (the last for the hillis step)
    and their labels on the card, the same on every rank."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    return [(torch.randint(0, 256, (TP_BATCH, IMAGE, IMAGE, 3),
                           generator=gen, device="cuda", dtype=torch.uint8),
             torch.randint(0, NUM_CLASSES, (TP_BATCH,), generator=gen,
                           device="cuda"))
            for _ in range(TP_STEPS + 1)]


def tp_ranks(root: str) -> None:
    """Under torchrun, 2 ranks on card 0 over gloo as a 1x2 mesh: phase
    26's steps, eval and predict (see TP_*); rank 0 also runs one process's
    step from each step's state. Both ranks write the checkpoint (rank 0
    writes the file) and ``tp_<rank>.json`` into ``root``."""
    import copy

    import numpy as np
    import torch

    from medmamba_tpu_torch.models.registry import create_model
    from medmamba_tpu_torch.parallel import mesh
    from medmamba_tpu_torch.train import checkpoint as ckpt
    from medmamba_tpu_torch.train import trainer
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    grid = mesh.make_mesh(n_model=2, device=torch.device("cuda", 0),
                          backend="gloo")
    group = mesh.model_group(grid)
    torch.backends.cudnn.deterministic = True

    def fresh(partitioned: bool):
        model = create_model("T", NUM_CLASSES, device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
        if partitioned:
            mesh.partition_params(model, grid)
        return model, trainer.make_optimizer(model.parameters(), PAIR_LR,
                                             True)[0]
    try:
        model, opt = fresh(True)
        names = [n for n, _ in model.named_parameters()]
        sharded = {n: mesh.model_shard(p) for n, p in
                   model.named_parameters() if mesh.model_shard(p)}
        ref, ref_opt = fresh(False) if rank == 0 else (None, None)
        grads = {}

        def keep_grads(o, key):
            o.register_step_pre_hook(lambda o, *_: grads.__setitem__(
                key, [p.grad.detach().clone() for g in o.param_groups
                      for p in g["params"]]))
        keep_grads(opt, "ranks")
        if ref_opt is not None:
            keep_grads(ref_opt, "one_process")
        stats = [k for k, _ in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
        ref_gen = torch.Generator(device="cuda")
        rows, counts, wall = [], [], []

        def whole_flat(state):
            return torch.cat([state[n].float().reshape(-1) for n in names])

        def replicated(named):
            """The names of this rank's replicated tensors among ``named``
            whose bits differ from the other model rank's."""
            named = [(n, t) for n, t in named if n not in sharded]
            both = mesh.all_gather(torch.cat([
                t.detach().double().reshape(-1) for _, t in named]), group)
            return [n for (n, _), a, b in zip(
                named, *(x.split([t.numel() for _, t in named])
                         for x in both)) if not torch.equal(a, b)]
        batches = tp_batches()
        for i, (images, labels) in enumerate(batches):
            hillis = i == TP_STEPS
            # copies: a replicated entry of a state dict is the live tensor
            state = {k: v.clone()
                     for k, v in mesh.full_state_dict(model).items()}
            opt_state = copy.deepcopy(ckpt.portable_optimizer_state(opt))
            gen_state = gen.get_state()
            reset_counts()
            with recorded_rows() as launched, \
                    scan_kernel("hillis" if hillis else "ssd"):
                t1 = time.perf_counter()
                loss = trainer.train_step(model, opt, images, labels,
                                          generator=gen, augment=True,
                                          image_size=IMAGE).item()
                wall.append(time.perf_counter() - t1)
            counts.append(dict(read_counts(), rows=launched))
            grad_whole = torch.cat([
                (mesh.unshard(g, sharded[n]) if n in sharded else g)
                .float().reshape(-1) for n, g in zip(names, grads["ranks"])])
            after = mesh.full_state_dict(model)
            params_apart = replicated(model.named_parameters())
            buffers_apart = replicated(model.named_buffers())
            row = dict(step=i + 1, hillis=hillis, loss=loss,
                       replicated_bitwise=not params_apart,
                       params_apart=params_apart,
                       buffers_apart=buffers_apart)
            if rank == 0:
                mesh.set_active_mesh(None)
                try:
                    ref.load_state_dict(state)
                    ckpt.load_optimizer_state(ref_opt, opt_state)
                    ref_gen.set_state(gen_state)
                    with scan_kernel("hillis" if hillis else "ssd"):
                        want = trainer.train_step(
                            ref, ref_opt, images, labels, generator=ref_gen,
                            augment=True, image_size=IMAGE).item()
                finally:
                    mesh.set_active_mesh(grid)
                want_s = ref.state_dict()
                scale = max(want_s[k].abs().max().item() for k in stats)
                g_ref = torch.cat([g.float().reshape(-1)
                                   for g in grads["one_process"]])
                p_before, p_want = whole_flat(state), whole_flat(want_s)
                p_got = whole_flat(after)
                sq = [d.square().sum().item() for d in (grad_whole - g_ref)
                      .split([state[n].numel() for n in names])]
                worst = max(range(len(sq)), key=sq.__getitem__)
                row.update(
                    loss_one_process=want,
                    loss_rel_err=abs(loss - want) / abs(want),
                    stats_rel_err=max((after[k] - want_s[k]).abs().max()
                                      .item() for k in stats) / scale,
                    grad_rel_err=((grad_whole - g_ref).norm()
                                  / g_ref.norm()).item(),
                    grad_worst=names[worst],
                    grad_worst_share=sq[worst] / max(sum(sq), 1e-30),
                    update_rel_err=((p_got - p_want).norm()
                                    / (p_want - p_before).norm()).item(),
                    param_max_abs_err=(p_got - p_want).abs().max().item())
            rows.append(row)

        # eval_step on the first batch, predict on the val split
        images, labels = batches[0]
        correct, logits = trainer.eval_step(model, images, labels,
                                            image_size=IMAGE)
        val = torch.from_numpy(np.load(os.path.join(
            root, "val_images.npy"))).cuda()
        reset_counts()
        with recorded_rows() as launched:
            probs = torch.cat([trainer.predict(model, val[j:j + TP_BATCH],
                                               image_size=IMAGE)[0]
                               for j in range(0, TP_VAL, TP_BATCH)])
        serve_counts = dict(read_counts(), rows=launched)
        np.save(os.path.join(root, f"tp_probs_{rank}.npy"),
                probs.cpu().numpy())
        out = dict(steps=rows, counts=counts, wall_s=wall,
                   serve_counts=serve_counts, correct=int(correct))
        final = mesh.full_state_dict(model)
        final_opt = ckpt.portable_optimizer_state(opt)
        pth = os.path.join(root, "tp.pth")
        ckpt.save_checkpoint(pth, model, opt, epoch=1, best_acc=0.0,
                             num_classes=NUM_CLASSES,
                             class_indices={str(k): k for k in
                                            range(NUM_CLASSES)})
        if rank == 0:
            mesh.set_active_mesh(None)
            try:
                ref.load_state_dict(final)
                ckpt.load_optimizer_state(ref_opt, final_opt)
                ckpt.save_checkpoint(
                    os.path.join(root, "one_process.pth"), ref, ref_opt,
                    epoch=1, best_acc=0.0, num_classes=NUM_CLASSES,
                    class_indices={str(k): k for k in range(NUM_CLASSES)})
                want_correct, want_logits = trainer.eval_step(
                    ref, images, labels, image_size=IMAGE)
                want_probs = torch.cat([
                    trainer.predict(ref, val[j:j + TP_BATCH],
                                    image_size=IMAGE)[0]
                    for j in range(0, TP_VAL, TP_BATCH)])
            finally:
                mesh.set_active_mesh(grid)
            out.update(
                correct_one_process=int(want_correct),
                logits_rel_err=((logits - want_logits).abs().max()
                                / want_logits.abs().max()).item(),
                probs_max_abs_err=(probs - want_probs).abs().max().item())
        torch.distributed.barrier()
    finally:
        torch.backends.cudnn.deterministic = False
        mesh.destroy_mesh()
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(root, f"tp_{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_rows_vs_plain(rows: int) -> dict:
    """K1-K4 on ``rows`` rows (a model rank's share of phase 26's batch) at
    each stage shape, float32, against their plain versions, as phases 1,
    2, 11 and 12 hold them at batch 64: K1's y within TOL_FP32 (relative
    and absolute) of the plain scan's in both directions, its tile-entry
    states within TOL_FP32 of the plain states; each of K2's gradients
    within TOL_FP32 of its scale of the plain adjoint's; K3's y, chunk
    states and last state within TOL_FP32; each of K4's gradients within
    TOL_FP32 of its scale. Returns ``{kernel: {"max_abs_err",
    "max_rel_err", "failed"}}``."""
    import torch

    from medmamba_tpu_torch.ops import scan_cuda, scan_hillis
    from medmamba_tpu_torch.ops.selective_scan import (
        selective_scan, selective_scan_bwd_ref, selective_scan_hillis_bwd_ref,
        selective_scan_hillis_ref, selective_scan_states_ref)

    names = ("u", "delta", "A", "B", "C", "D", "delta_bias")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, failed=[])
           for k in ("K1", "K2", "K3", "K4")}

    def hold(key, label, got, want, relative):
        """``relative``: max |err| over the plain value's largest entry
        (a gradient); else rtol = atol = TOL_FP32, elementwise."""
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = rel_err(got, want)
        row = out[key]
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        row["max_rel_err"] = max(row["max_rel_err"], rel)
        ok = rel <= TOL_FP32 if relative else bool(torch.isclose(
            got, want, rtol=TOL_FP32, atol=TOL_FP32).all())
        if not ok:
            row["failed"].append(f"{label} {abs_err:.3e} ({rel:.3e} of its "
                                 "scale)")

    for si, (dpg, l, _) in enumerate(STAGES):
        for rev in (False, True):
            kw = {"reverse_dirs": (rev, rev)}
            tag = f"stage {si} {'rev' if rev else 'fwd'}"
            x = scan_inputs(dpg, l, torch.float32, gen, batch=rows)
            y, _, states = scan_cuda.selective_scan_fwd(
                **x, delta_softplus=True, return_states=True, **kw)
            hold("K1", f"{tag} y", y, selective_scan(
                **x, delta_softplus=True, impl="ref", **kw), False)
            want_states = selective_scan_states_ref(
                x["u"], x["delta"], x["A"], x["B"], x["C"], x["delta_bias"],
                True, kw["reverse_dirs"], 1, None)
            hold("K1", f"{tag} states", states, want_states, False)
            gy = torch.randn(y.shape, generator=gen, device="cuda")
            got = scan_cuda.selective_scan_bwd(
                *(x[k] for k in names), states, gy, delta_softplus=True, **kw)
            want = selective_scan_bwd_ref(
                *(x[k] for k in names), want_states, gy, delta_softplus=True,
                **kw)
            for name, g, w in zip(names, got, want):
                hold("K2", f"{tag} d{name}", g, w, True)
        x = scan_inputs(dpg, l, torch.float32, gen, batch=rows)
        got = scan_hillis.selective_scan_hillis_fwd(**x, delta_softplus=True)
        want = selective_scan_hillis_ref(**x, delta_softplus=True)
        for part, g, w in zip(("y", "states", "last"), got, want):
            hold("K3", f"stage {si} {part}", g, w, False)
        gy = torch.randn(got[0].shape, generator=gen, device="cuda")
        args = [x[k] for k in names]
        got_g = scan_hillis.selective_scan_hillis_bwd(
            *args, got[1], gy, delta_softplus=True)
        want_g = selective_scan_hillis_bwd_ref(*args, got[1], gy,
                                               delta_softplus=True)
        for name, g, w in zip(names, got_g, want_g):
            hold("K4", f"stage {si} d{name}", g, w, True)
    torch.cuda.synchronize()
    for key, row in out.items():
        log(f"  {key} on {rows} rows against its plain version at the "
            f"stage shapes: max|err| {row['max_abs_err']:.3e}, "
            f"{row['max_rel_err']:.3e} of the scale (limit {TOL_FP32:g}"
            f"{', relative to each gradient' if key in ('K2', 'K4') else ''})"
            f"{'; over: ' + '; '.join(row['failed']) if row['failed'] else ''}")
    return out


def phase_tensor_parallel(root: str) -> dict:
    """Phase 26 (see the docstring)."""
    import numpy as np
    import torch

    from medmamba_tpu_torch.cli import evaluate
    from medmamba_tpu_torch.ops import scan_cuda

    t0 = time.perf_counter()
    runner = os.path.join(root, "dist_runner.py")
    with open(runner, "w") as f:
        f.write(DIST_RUNNER)
    rng = np.random.default_rng(SEED + 47)
    np.save(os.path.join(root, "val_images.npy"),
            rng.integers(0, 256, (TP_VAL, 28, 28, 3), dtype=np.uint8))
    np.save(os.path.join(root, "val_labels.npy"),
            (np.arange(TP_VAL) % NUM_CLASSES).reshape(-1, 1)
            .astype(np.int64))
    run([*TORCHRUN, "--nproc_per_node", "2", runner, "tp_ranks", root],
        DIST_ENV, "the two model ranks")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"tp_{r}.json")) as f:
            ranks.append(json.load(f))
    half = TP_BATCH // 2
    failed = []
    for r, got in enumerate(ranks):
        for step, c in zip(got["steps"], got["counts"]):
            fwd, bwd = ("K3", "K4") if step["hillis"] else ("K1", "K2")
            want = expected_counts(**{fwd: LAUNCHES_PER_FORWARD,
                                      bwd: LAUNCHES_PER_FORWARD, "K5": 1})
            got_counts = {k: v for k, v in c.items() if k != "rows"}
            if got_counts != want or c["rows"][fwd] != [half] * \
                    LAUNCHES_PER_FORWARD or c["rows"][bwd] != [half] * \
                    LAUNCHES_PER_FORWARD:
                failed.append(f"rank {r} step {step['step']} launched "
                              f"{got_counts}, rows {c['rows']}")
            if not step["replicated_bitwise"]:
                failed.append(f"rank {r} step {step['step']}: the model "
                              "ranks' replicated parameters differ: "
                              f"{step['params_apart']}")
        s = got["serve_counts"]
        if {k: v for k, v in s.items() if k != "rows"} != expected_counts(
                K1=LAUNCHES_PER_FORWARD * TP_VAL // TP_BATCH) \
                or set(s["rows"]["K1"]) != {half}:
            failed.append(f"rank {r} predict launched {s}")
    lim = dict(loss=TOL_TP_LOSS, stats=TOL_TP_STATS, grad=TOL_TP_GRAD,
               update=TOL_TP_UPDATE)
    for row in ranks[0]["steps"]:
        log(f"  {'hillis' if row['hillis'] else 'ssd'} step {row['step']} "
            f"(rank 0 {ranks[0]['wall_s'][row['step'] - 1]:.2f} s): loss "
            f"{row['loss']:.7f}, one process {row['loss_one_process']:.7f} "
            f"({row['loss_rel_err']:.3e} of it, limit {lim['loss']:g}); "
            f"BatchNorm statistics {row['stats_rel_err']:.3e} of their "
            f"scale (limit {lim['stats']:g}); gradient "
            f"{row['grad_rel_err']:.3e} in L2 (limit {lim['grad']:g}; "
            f"{100 * row['grad_worst_share']:.1f}% of it in "
            f"{row['grad_worst']}); parameters {row['update_rel_err']:.3e} "
            f"of the update in L2 (limit {lim['update']:g}), at most "
            f"{row['param_max_abs_err']:.3e} apart; the two ranks' "
            f"replicated parameters bit for bit "
            f"{row['replicated_bitwise']}, buffers apart "
            f"{row['buffers_apart'] or 'none'}")
        for k, v in lim.items():
            if row[f"{k}_rel_err"] > v:
                failed.append(f"step {row['step']}: {k} "
                              f"{row[f'{k}_rel_err']:.3e} over {v:g}")
    r0 = ranks[0]
    log(f"  eval_step: correct {r0['correct']} (one process "
        f"{r0['correct_one_process']}), logits {r0['logits_rel_err']:.3e} "
        f"of their scale; predict on {TP_VAL} images: probabilities "
        f"{r0['probs_max_abs_err']:.3e} off one process's; launches a rank "
        f"{ {k: v for k, v in r0['serve_counts'].items() if k != 'rows'} }")
    if r0["correct"] != r0["correct_one_process"] or max(
            r0["logits_rel_err"], r0["probs_max_abs_err"]) > TOL_TP_LOGITS:
        failed.append("eval_step or predict differs from one process")
    tp_pth = os.path.join(root, "tp.pth")
    one_pth = os.path.join(root, "one_process.pth")
    pth_same = same_pth(tp_pth, one_pth)
    if not pth_same:
        failed.append("the gathered .pth differs from one process's")
    # the gathered .pth served by cli.evaluate in this process
    reset_counts()
    _, cli_probs = evaluate.main([
        "--checkpoint_path", tp_pth, "--data_dir", root, "--split", "val",
        "--batch_size", str(TP_BATCH), "--image_size", str(IMAGE),
        "--device", "cuda"])
    torch.cuda.synchronize()
    cli_counts = read_counts()
    tp_probs = np.load(os.path.join(root, "tp_probs_0.npy"))
    cli_err = float(np.abs(cli_probs - tp_probs).max())
    log(f"  the gathered .pth: one process's bit for bit {pth_same}; "
        f"cli.evaluate on it: {cli_counts}, probabilities {cli_err:.3e} "
        f"off the ranks' predict")
    if cli_counts != expected_counts(
            K1=LAUNCHES_PER_FORWARD * TP_VAL // TP_BATCH) \
            or cli_err > TOL_TP_LOGITS:
        failed.append(f"cli.evaluate on the gathered .pth: {cli_counts}, "
                      f"{cli_err:.3e}")
    # the path's own kernel shapes: K1-K4 on a model rank's rows at each
    # stage shape against their plain versions
    plain = tp_rows_vs_plain(half)
    for key, row in plain.items():
        if row["failed"]:
            failed.append(f"{key} on {half} rows: {row['failed']}")
    # each scan row's value on half the rows against the whole batch: K1
    # at the stage shapes, the rows the model ranks take against the same
    # rows of one launch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 49)
    row_err, row_bitwise = [], []
    with torch.no_grad():
        for dpg, l, _ in STAGES:
            x = scan_inputs(dpg, l, torch.float32, gen, batch=TP_BATCH)
            whole = scan_cuda.selective_scan_fwd(
                **x, delta_softplus=True)[0]
            for r in range(2):
                part = slice(r * half, (r + 1) * half)
                y = scan_cuda.selective_scan_fwd(
                    **{k: v[part].contiguous() if k in ("u", "delta", "B",
                                                       "C") else v
                       for k, v in x.items()}, delta_softplus=True)[0]
                row_err.append(((y - whole[part]).abs().max()
                                / whole[part].abs().max()).item())
                row_bitwise.append(bool(torch.equal(y, whole[part])))
    log(f"  K1 on the half batch against the whole batch's rows, by stage "
        f"and half: {['%.2e' % e for e in row_err]}, bit for bit "
        f"{row_bitwise}")
    if max(row_err) > TOL_FP32:
        failed.append(f"K1 on half the rows {max(row_err):.3e} off")
    seconds = time.perf_counter() - t0
    log(f"  phase 26: {seconds:.1f} s (the ranks {r0['seconds']:.1f} s)")
    if failed:
        raise SystemExit("tensor parallelism: " + "; ".join(failed))
    return dict(steps=r0["steps"], wall_s=r0["wall_s"],
                launches=r0["counts"], serve_launches=r0["serve_counts"],
                logits_rel_err=r0["logits_rel_err"],
                probs_max_abs_err=r0["probs_max_abs_err"],
                cli_evaluate_probs_err=cli_err, pth_bitwise=pth_same,
                k1_half_rows_rel_err=row_err, k1_half_rows_bitwise=row_bitwise,
                rows_vs_plain=plain, seconds=seconds)


# phase 27: the other VSSM sizes at 224^2, in a process of its own (its
# graphs are profiled, and after phases 1-26 this process's profiler drops
# kernel events)
SIZES = ("S", "B", "Te")
SIZE_TIMING_REPS = 2


def size_stages(size: str) -> list:
    """A VSSM size's scan shapes at 224^2, as STAGES: per stage, channels
    per group (the stage's width), sequence length and SS2D blocks."""
    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[size]
    return [(dim, (IMAGE // 4 >> i) ** 2, depth)
            for i, (dim, depth) in enumerate(zip(cfg.dims, cfg.depths))]


def sizes_process(root: str) -> dict:
    """Phase 27 in a fresh process, whose log it prints."""
    out = run([sys.executable, "-c", "import json, sys, chip_smoke; "
               "print('result ' + json.dumps(chip_smoke.phase_sizes("
               "sys.argv[1])))", root], {}, "phase 27's process")
    text, result = out.rsplit("\nresult ", 1)
    for line in text.splitlines():
        log(line)
    return json.loads(result)


def phase_sizes(root: str) -> dict:
    """Phase 27 (see the docstring): K1-K4 at medmamba_b's shapes, then
    each of SIZES through its entry points (``size_path``)."""
    from medmamba_tpu_torch.ops import scan_cuda
    from medmamba_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    b_stages = size_stages("B")
    for batch in (BATCH, 1):
        for si, (dpg, l, _) in enumerate(b_stages):
            cfg = scan_cuda.selective_scan_fwd_config(batch, GROUPS, dpg)
            log(f"  K1 at medmamba_b's stage {si} (D={GROUPS * dpg}, L={l}), "
                f"batch {batch}: {cfg['channels_per_block']} channels a "
                f"block, {cfg['smem_bytes']} B of dynamic shared memory, "
                f"{cfg['registers']} registers, {cfg['blocks_per_sm']} blocks "
                "an SM")
    out = {"kernels": {}}
    for k, fn in (("K1", phase_kernel_vs_plain),
                  ("K2", phase_backward_vs_plain),
                  ("K3", phase_hillis_fwd_vs_plain),
                  ("K4", phase_hillis_bwd_vs_plain)):
        t0 = time.perf_counter()
        log(f"  {k} against its plain version at medmamba_b's shapes:")
        rows, err = fn(b_stages)
        out["kernels"][k] = dict(per_pass(rows), max_abs_err=err, stages=rows)
        res = out["kernels"][k]
        unit = "forward" if k in ("K1", "K3") else "step"
        log(f"  {k} per medmamba_b {unit} "
            f"({sum(r['launches'] for r in rows)} launches): "
            f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}); max|err| {err:.3e} "
            f"({time.perf_counter() - t0:.1f} s)")
    for size in SIZES:
        t0 = time.perf_counter()
        out[size] = size_path(root, size)
        log(f"  (medmamba_{size.lower()}: {time.perf_counter() - t0:.1f} s)")
    log("vssm_sizes " + json.dumps(out))
    return out


def size_path(root: str, size: str) -> dict:
    """One VSSM size at 224^2: ``cli.train`` and ``cli.evaluate``
    (``phase_train_path``) with exact launches; its eager logits at batch
    GRAD_BATCH against the same weights on the plain scan (TOL_FP32), and
    for B the same forward under hillis (K3 only, against the ssd logits);
    the graphed float32 eval forward and the graphed bf16 train step
    (augmentation) at batch 64, each timed in turns with the eager one,
    profiled one replay (busy share, kernels), with its capture seconds
    and pool bytes."""
    import torch

    from medmamba_tpu_torch.data.transforms import preprocess
    from medmamba_tpu_torch.models.registry import MODEL_CONFIGS, create_model
    from medmamba_tpu_torch.train import trainer

    per_fwd = 2 * sum(MODEL_CONFIGS[size].depths)
    name = f"medmamba_{size.lower()}"
    with tempfile.TemporaryDirectory(dir=root) as d:
        counts, steps = phase_train_path(d, size=size)
    res = dict(launches_per_forward=per_fwd, train_counts=counts,
               train_steps=steps)

    frames, images, labels = compiled_inputs()
    model = create_model(size, NUM_CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    ref = create_model(size, NUM_CLASSES, device="cuda", scan_impl="ref")
    ref.load_state_dict(model.state_dict())
    model.eval()
    ref.eval()
    x = preprocess(frames[:GRAD_BATCH], size=IMAGE)
    reset_counts()
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    if read_counts() != expected_counts(K1=per_fwd):
        raise SystemExit(f"{name} forward launched {read_counts()}")
    with torch.no_grad():
        want = ref(x)
    del ref
    res["logits_err"] = (got - want).abs().max().item()
    log(f"  {name} logits, K1 against the plain scan (batch {GRAD_BATCH}): "
        f"max|err| {res['logits_err']:.3e} (rtol = atol = {TOL_FP32:g}), "
        f"|logits| max {want.abs().max().item():.3e}, {per_fwd} K1")
    torch.testing.assert_close(got, want, rtol=TOL_FP32, atol=TOL_FP32)
    if size == "B":
        with scan_kernel("hillis"), torch.no_grad():
            reset_counts()
            hillis = model(x)
            torch.cuda.synchronize()
        if read_counts() != expected_counts(K3=per_fwd):
            raise SystemExit(f"{name} under hillis launched {read_counts()}")
        res["hillis_logits_err"] = (hillis - got).abs().max().item()
        log(f"  {name} under hillis: {per_fwd} K3 and no other scan kernel; "
            f"logits against ssd max|err| {res['hillis_logits_err']:.3e}")
        torch.testing.assert_close(hillis, got, rtol=TOL_FP32, atol=TOL_FP32)

    forward = trainer.compile_forward(model)

    def graphed_forward(_):
        return forward(frames, image_size=IMAGE)
    fwd = in_turns(lambda _: trainer.predict(model, frames), graphed_forward,
                   SIZE_TIMING_REPS)
    graph = list(forward.graphs.values())[0]
    prof = profile_families(lambda: graphed_forward(None), "call", steps=1)
    check_profiled_launches(f"{name} forward replay", prof, "call",
                            K1=per_fwd)
    fwd.update(img_s=BATCH / fwd["graph_ms"] * 1e3,
               eager_img_s=BATCH / fwd["eager_ms"] * 1e3,
               capture_s=graph.capture_s, pool_bytes=graph.pool_bytes,
               busy_share=prof["busy_share_of_kernel_window"],
               kernel_ms=prof["kernel_ms_per_call"])
    forward.free()
    del model, forward
    model = create_model(size, NUM_CLASSES, dtype=torch.bfloat16,
                         device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    opt, _ = trainer.make_optimizer(model.parameters(), 1e-3, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    step = trainer.compile_train_step(model, opt, generator=gen)

    def graphed_step(_):
        return step(images, labels, augment=True, image_size=IMAGE)
    train = in_turns(
        lambda _: trainer.train_step(model, opt, images, labels,
                                     generator=gen, augment=True,
                                     image_size=IMAGE),
        graphed_step, SIZE_TIMING_REPS)
    graph = list(step.graphs.values())[0]
    prof = profile_families(lambda: graphed_step(None), "call", steps=1)
    check_profiled_launches(f"{name} bf16 train step replay", prof, "call",
                            K1=per_fwd, K2=per_fwd, K5=1)
    train.update(img_s=BATCH / train["graph_ms"] * 1e3,
                 eager_img_s=BATCH / train["eager_ms"] * 1e3,
                 capture_s=graph.capture_s, pool_bytes=graph.pool_bytes,
                 busy_share=prof["busy_share_of_kernel_window"],
                 kernel_ms=prof["kernel_ms_per_call"],
                 family_ms=prof["family_ms_per_call"])
    step.free()
    del model, opt, step
    torch.cuda.empty_cache()
    for label, r in (("float32 eval forward", fwd),
                     ("bf16 train step", train)):
        log(f"  {name} {label}, batch {BATCH}: graphed {r['graph_ms']:.3f} "
            f"ms ({r['img_s']:.1f} img/s), eager {r['eager_ms']:.3f} ms "
            f"({r['eager_img_s']:.1f} img/s); in turns "
            f"{' '.join(f'{t:.3f}' for t in r['in_turns_ms'])}; graphed busy "
            f"{100 * r['busy_share']:.1f}%, kernels {r['kernel_ms']:.3f} ms; "
            f"capture {r['capture_s']:.3f} s, pool {r['pool_bytes']} B")
    res.update(forward=fwd, train=train)
    return res


def phase_timing(model):
    """Forward throughput (back-to-back forwards between one event pair)
    and the device time per forward by kernel family."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    model.eval()
    with torch.inference_mode():
        fwd_ms = back_to_back_ms(model, [x], 5)
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

    header("phase 23: compiled steps (CUDA graphs of the forward and the "
           "train step against eager, on both kernel pairs)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        compiled = phase_compiled(root, demo_out["median_ms"])

    header("phase 24: other models (cli.cam_backbones: ViT-B/16, Swin-T, "
           "MobileNetV2; VSSMSeg on K1/K2 and K3), 224^2")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        others = other_models_process(root)
    seg = others["vssmseg"]

    header("phase 25: distribution (cli.train under torchrun, world 1 on "
           "NCCL, against no group; two gloo ranks on the card against one "
           "process; the sequence-parallel scan on K1)")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        dist_out = phase_distribution(root)
    log("distribution " + json.dumps(dist_out))
    dist_launches = {
        k: {"cli_torchrun_world1": dist_out["cli"]["torchrun"]["counts"][k],
            "two_gloo_ranks_per_rank_step": dist_out["pair"][
                "counts_a_step"][k]}
        for k in ("K1", "K2", "K5")}
    dist_launches["K1"]["seq_parallel_per_rank_call"] = \
        dist_out["pair"]["seq"][0][0]["counts"]["K1"]

    header("phase 26: tensor parallelism (two gloo ranks on the card as a "
           "1x2 mesh: partitioned medmamba_t, column-parallel Dense layers, "
           "the scan's rows split over the model axis) against one process")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        tp_out = phase_tensor_parallel(root)
    log("tensor_parallel " + json.dumps(tp_out))
    tp_launches = {}
    for c in tp_out["launches"]:
        for k in ("K1", "K2", "K3", "K4", "K5"):
            if c[k]:
                tp_launches[k] = {"per_rank_step": c[k],
                                  "rows_per_launch": sorted(set(
                                      c["rows"].get(k, [TP_BATCH])))}
    tp_launches["K1"]["per_rank_predict"] = tp_out["serve_launches"]["K1"]

    header("phase 27: the VSSM sizes (K1-K4 at medmamba_b's stage shapes; "
           "medmamba_s, _b, _te through cli.train and cli.evaluate, against "
           "the plain scan, timed graphed), 224^2")
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as root:
        sizes = sizes_process(root)
    b_kernels = sizes["kernels"]
    size_launches = {
        k: {f"medmamba_{z.lower()}": {
            "per_forward" if k in ("K1", "K3") else "per_step":
                sizes[z]["launches_per_forward"],
            "cli_train": sizes[z]["train_counts"][k]} for z in SIZES}
        for k in ("K1", "K2")}
    size_launches["K3"] = {"medmamba_b_per_forward":
                           sizes["B"]["launches_per_forward"]}
    size_launches["K5"] = {f"medmamba_{z.lower()}_cli_train":
                           sizes[z]["train_counts"]["K5"] for z in SIZES}

    def at_b_shapes(k):
        """A kernel's readings at medmamba_b's stage shapes (phase 27)."""
        r = b_kernels[k]
        return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    launches=sum(s["launches"] for s in r["stages"]),
                    ms_per_stage=[s["ms"] for s in r["stages"]],
                    bound_ms_per_stage=[s["bound_ms"] for s in r["stages"]])

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
        "eval_img_s": img_s, "bf16_compute": bf16["K1"],
        "launches_vssmseg_forward": seg["launches_forward"]["K1"],
        "launches_distributed": dist_launches["K1"],
        "launches_tensor_parallel": tp_launches["K1"],
        "tensor_parallel_rows_max_abs_err":
            tp_out["rows_vs_plain"]["K1"]["max_abs_err"],
        "medmamba_b_shapes": at_b_shapes("K1"),
        "launches_vssm_sizes": size_launches["K1"]}, {
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
        "bf16_compute": bf16["K2"],
        "launches_vssmseg_backward": seg["launches_backward"]["K2"],
        "vssmseg_grad_rel_err": seg["grad_rel_err"],
        "launches_distributed": dist_launches["K2"],
        "launches_tensor_parallel": tp_launches["K2"],
        "tensor_parallel_rows_max_abs_err":
            tp_out["rows_vs_plain"]["K2"]["max_abs_err"],
        "medmamba_b_shapes": at_b_shapes("K2"),
        "launches_vssm_sizes": size_launches["K2"]}, {
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
        "profiled_ms_per_train_step": fam.get(FAMILY["K5"], 0.0),
        "launches_distributed": dist_launches["K5"],
        "launches_tensor_parallel": tp_launches["K5"],
        "launches_vssm_sizes": size_launches["K5"]}, {
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
        "eval_img_s": h_img_s, "bf16_compute": bf16["K3"],
        "launches_vssmseg_forward": seg["launches_forward"]["K3"],
        "launches_tensor_parallel": tp_launches["K3"],
        "tensor_parallel_rows_max_abs_err":
            tp_out["rows_vs_plain"]["K3"]["max_abs_err"],
        "medmamba_b_shapes": at_b_shapes("K3"),
        "launches_vssm_sizes": size_launches["K3"]}, {
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
        "bf16_compute": bf16["K4"],
        "launches_tensor_parallel": tp_launches["K4"],
        "tensor_parallel_rows_max_abs_err":
            tp_out["rows_vs_plain"]["K4"]["max_abs_err"],
        "medmamba_b_shapes": at_b_shapes("K4")}, {
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
            "s_per_image_after_first_eager": {
                "default": cams["default"]["s_per_image_eager"]},
            "cam_err_vs_plain_scan": max(cams["default"]["cam_err"],
                                         cams["upstream"]["cam_err"]),
            "hillis_cam_err": cams["hillis_err"],
            "folder_eval": cams["folder_eval"]},
        "demo": demo_out,
        "export": export_out,
        "compiled": compiled,
        "other_models": {
            **{arch: {k: others[arch][k] for k in (
                "forward_ms", "img_s", "process_s", "main_s", "cpu_s",
                "logits_rel_err", "cam_err", "cli_cam_err")}
               for arch in CAM_ARCHS},
            "vssmseg": {k: seg[k] for k in (
                "forward_ms", "img_s", "k1_ms", "k1_share",
                "forward_rel_err", "hillis_rel_err", "grad_rel_err")}},
        "train_img_s": {k: v["img_s"] for k, v in train_timing.items()},
        "hillis_train_img_s": {k: v["img_s"] for k, v in h_train.items()},
        "bf16_compute": {scan: {k: v[k] for k in (
            "eval_ms", "eval_img_s", "eval_ms_fp32", "eval_img_s_fp32",
            "train_ms", "train_img_s", "train_ms_fp32", "train_img_s_fp32",
            "logits_rel_err", "loss")} for scan, v in bf16_model.items()},
        "vssm_sizes": {f"medmamba_{z.lower()}": {
            k: sizes[z][k] for k in ("launches_per_forward", "logits_err")}
            | {f"{k}_{m}": sizes[z][k][m] for k in ("forward", "train")
               for m in ("graph_ms", "eager_ms", "img_s", "busy_share",
                         "pool_bytes")}
            for z in SIZES}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
