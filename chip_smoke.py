#!/usr/bin/env python3
"""Smoke test of the PyTorch port (medmamba_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit;
  2. build: the selective-scan forward kernel K1 from medmamba_tpu_torch/csrc/;
  3. K1 against its plain PyTorch version on the card, at the four
     medmamba_t stage shapes (batch 64), forward and reverse, float32 and
     bfloat16 inputs, with valid_len and with the last state; times of the
     kernel and the plain version beside the kernel's bound;
  4. the main path: ``medmamba_tpu_torch.cli.evaluate`` on a synthetic NPZ
     test split with a random medmamba_t ``.pth`` at 224^2, batch 64; K1 must
     launch exactly 20 times per batch, and one batch's logits must match the
     same model with the plain scan;
  5. timing: medmamba_t eval-forward throughput at 224^2, batch 64, float32
     without TF32 (the precision the port's entry points fix), and the
     device time per forward by kernel family from ``torch.profiler``.
The last line is the JSON ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
GROUPS, N_STATE = 2, 16
# medmamba_t at 224^2: per stage, channels per group (d_inner), sequence
# length (H*W after the 4x4 patch embed and each merge) and SS2D blocks
STAGES = [(96, 56 * 56, 2), (192, 28 * 28, 2), (384, 14 * 14, 4),
          (768, 7 * 7, 2)]
LAUNCHES_PER_FORWARD = sum(2 * blocks for _, _, blocks in STAGES)  # 20
# H100 SXM data-sheet peaks: HBM3 bandwidth and dense float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20
PROFILE_STEPS = 5
TOP_KERNELS = 12
# float32 kernel vs plain version: the same float32 arithmetic in another
# order (fused multiply-adds, the 16-lane shuffle reduction): 1e-4 relative
# and absolute. bfloat16 output: its final rounding, 2^-8 relative: 1e-2.
TOL_FP32 = 1e-4
TOL_BF16_OUT = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


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


def scan_inputs(dpg: int, l: int, dtype, gen):
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
        u=rnd(BATCH, d, l).to(dtype),
        delta=rnd(BATCH, d, l, scale=0.5).to(dtype),
        A=-(a_row * (1 + 0.1 * rnd(d, 1))).contiguous(),
        B=rnd(BATCH, GROUPS, N_STATE, l).to(dtype),
        C=rnd(BATCH, GROUPS, N_STATE, l).to(dtype), D=rnd(d),
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
                           launches_per_forward=2 * blocks, ms=k_ms,
                           plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                           bound_ms=max(bytes_ms, ops_ms), exp_ms=exp_ms))
        log(f"  stage {si} D={GROUPS * dpg} L={l}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"(bytes {bytes_ms:.4f}, fp32 ops {ops_ms:.4f}, exp units "
            f"{exp_ms:.4f}), x{2 * blocks} per forward")

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
    from medmamba_tpu_torch.ops import scan_cuda

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
    scan_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    cm, probs = evaluate.main(["--checkpoint_path", pth, "--data_dir", root,
                               "--batch_size", str(BATCH), "--image_size",
                               str(IMAGE), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scan_cuda.LAUNCHES
    log(f"  evaluate: {N_IMAGES} images in {n_batches} batches, "
        f"{wall:.2f} s wall, K1 launches {launches}")
    if launches != LAUNCHES_PER_FORWARD * n_batches:
        raise SystemExit(f"K1 launched {launches} times, expected "
                         f"{LAUNCHES_PER_FORWARD * n_batches}")
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
FAMILIES = (
    ("selective_scan_fwd (K1)", r"scan_fwd_kernel"),
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


def phase_timing(model):
    """Forward throughput (back-to-back forwards between one event pair)
    and the device time per forward by kernel family (``torch.profiler``
    over PROFILE_STEPS forwards)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    model.eval()
    with torch.inference_mode():
        fwd_ms = back_to_back_ms(model, [x], 10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                model(x)
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
    prof_line = {
        "host_wall_ms_per_forward": wall_ms / PROFILE_STEPS,
        "kernel_ms_per_forward": sum(by_family.values()),
        "busy_share_of_kernel_window": busy_us(spans) / window,
        "family_ms_per_forward": dict(
            sorted(by_family.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:120],
                         "launches_per_forward": n / PROFILE_STEPS,
                         "ms_per_forward": t} for k, (n, t) in top]}
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
    from medmamba_tpu_torch.ops import scan_cuda

    t_start = time.perf_counter()
    log("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = scan_cuda.build()
    log(f"  built {os.path.relpath(lib, REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")
    with open(lib[:-3] + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase 3: K1 against its plain version")
    stages, max_err = phase_kernel_vs_plain()

    log("phase 4: main path (cli.evaluate, medmamba_t 224^2 batch 64)")
    os.makedirs(scan_cuda.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scan_cuda.BUILD_DIR) as root:
        model, launches, eval_wall = phase_main_path(root)

    log("phase 5: timing")
    fwd_ms, img_s, prof_line = phase_timing(model)
    k1_device_ms = prof_line["family_ms_per_forward"].get(FAMILIES[0][0], 0.0)
    per_fwd = {k: sum(s[k] * s["launches_per_forward"] for s in stages)
               for k in ("ms", "plain_ms", "bytes_ms", "ops_ms", "exp_ms")}
    per_fwd["bound_ms"] = max(per_fwd["bytes_ms"], per_fwd["ops_ms"])
    log(f"  medmamba_t eval forward, 224^2, batch {BATCH}, float32 "
        f"without TF32: "
        f"{fwd_ms:.3f} ms, {img_s:.1f} img/s")
    log(f"  K1 per forward ({LAUNCHES_PER_FORWARD} launches): "
        f"{per_fwd['ms']:.4f} ms = {100 * per_fwd['ms'] / fwd_ms:.1f}% of "
        f"the forward; bound {per_fwd['bound_ms']:.4f} ms; exp units "
        f"{per_fwd['exp_ms']:.4f} ms; plain {per_fwd['plain_ms']:.1f} ms; "
        f"profiler device time {k1_device_ms:.4f} ms")
    log("stages " + json.dumps(stages))
    log("profile " + json.dumps(prof_line))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": [{
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "medmamba_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "medmamba_tpu/ops/pallas_scan.py:787",
        "launches": launches,
        "launches_per_forward": LAUNCHES_PER_FORWARD,
        "max_abs_err": max_err,
        "ms": per_fwd["ms"], "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": ("bytes" if per_fwd["bytes_ms"] >= per_fwd["ops_ms"]
                     else "operations"),
        "library_ms": None,
        "profiled_ms_per_forward": k1_device_ms,
        "eval_img_s": img_s}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
