"""K1 and K3 beside earlier sources of theirs, on the card.

K1's walk lives in ``csrc/scan_fwd_walk.cuh``, which K3 runs too. This
builds the earlier sources of both kernels, written beforehand into the
build directory (here those of commit 959b3e2, where K1's walk was inline
and K3 was the doubling kernel):

    for k in k1:selective_scan_fwd k3:selective_scan_hillis_fwd; do
      git show 959b3e2:medmamba_tpu_torch/csrc/${k#*:}.cu \\
          > medmamba_tpu_torch/_build/${k%%:*}_earlier.cu
    done
    python -m medmamba_tpu_torch.tools.time_k1_k3

Run it from the root of a checkout on a machine with a card: it takes
``chip_smoke.py``'s operands, timer and bounds. It prints each build's
registers and spills and fails where an instantiation of K1 takes other
registers than the earlier build's; holds K1 bit for bit against the
earlier build (y, the last state and the tile-entry states, in all four
dtype pairs, at the medmamba_t stage shapes at batch 64 and 1, both
directions, and with a shared u and valid_len); then times both, float32,
in turns (earlier, current, current, earlier): K1 per launch at batch 64
queued back to back and at batch 1 by the profiler's device time, and K3
per launch at batch 64. Exits non-zero on any difference.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from medmamba_tpu_torch.ops import cuda_build, scan_cuda, scan_hillis
from medmamba_tpu_torch.utils.profiling import device_ms_per_call

KERNELS = {"k1": (scan_cuda.FWD_SOURCE, scan_cuda._declare_fwd,
                  "scan_fwd_kernel"),
           "k3": (scan_hillis.FWD_SOURCE, scan_hillis._declare_fwd,
                  "hillis_fwd_kernel")}
DTYPES = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16))


def build_earlier() -> dict:
    """The earlier sources built with the current flags, one nvcc each,
    all started together: {kernel: library path}."""
    jobs = {}
    for k in KERNELS:
        src = os.path.join(cuda_build.BUILD_DIR, f"{k}_earlier.cu")
        out = os.path.join(cuda_build.BUILD_DIR, f"lib{k}_earlier.so")
        jobs[k] = out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    paths = {}
    for k, (out, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {k}_earlier.cu:\n{stdout}{stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(stdout + stderr)
        paths[k] = out
    return paths


def resources(log_path: str, kernel: str) -> dict:
    """{instantiation: (registers, spill line)} of ``kernel`` in a
    ``-Xptxas -v`` report."""
    out, entry, spill = {}, None, ""
    with open(log_path) as f:
        for line in f:
            m = re.search(rf"Compiling entry function '\w*{kernel}(\w*)'",
                          line)
            if m:
                entry = m.group(1)
            elif entry and "spill" in line:
                spill = line.strip()
            elif entry and (m := re.search(r"Used (\d+) registers", line)):
                out[entry] = (int(m.group(1)), spill)
                entry = None
    return out


def open_library(path: str, declare) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.medmamba_cuda_error_string.argtypes = [ctypes.c_int]
    lib.medmamba_cuda_error_string.restype = ctypes.c_char_p
    declare(lib)
    return lib


@contextlib.contextmanager
def library(source: str, lib: ctypes.CDLL):
    """Within the block the wrappers launch ``source``'s kernel from
    ``lib``."""
    saved = cuda_build._libs[source]
    cuda_build._libs[source] = lib
    try:
        yield
    finally:
        cuda_build._libs[source] = saved


def with_library(source, lib, fn):
    def run(x):
        with library(source, lib):
            return fn(x)
    return run


def k1(x, **kw):
    return scan_cuda.selective_scan_fwd(**x, delta_softplus=True, **kw)


def k3(x):
    return scan_hillis.selective_scan_hillis_fwd(**x, delta_softplus=True)


def check_k1_bits(libs: dict, gen) -> bool:
    ok = True
    src = scan_cuda.FWD_SOURCE
    for batch in (cs.BATCH, 1):
        for si, (dpg, l, _) in enumerate(cs.STAGES):
            cases = [(f"{tin} in, {tout} out", tin, dict(
                reverse_dirs=(False, True), out_dtype=tout))
                for tin, tout in DTYPES]
            cases.append(("float32, shared u, valid_len", torch.float32,
                          dict(reverse_dirs=(False, True), u_tile=2,
                               valid_len=l - 3)))
            for label, tin, kw in cases:
                x = cs.scan_inputs(dpg, l, tin, gen, batch)
                if kw.get("u_tile"):
                    x["u"] = x["u"][:, :dpg].contiguous()
                kw = dict(kw, return_last_state=True, return_states=True)
                got = k1(x, **kw)
                with library(src, libs["k1"]):
                    want = k1(x, **kw)
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(got, want)]
                ok = ok and all(same)
                cs.log(f"  K1 batch {batch} stage {si} {label}: y, last, "
                       f"states {'the same bits' if all(same) else same}")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("time_k1_k3: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    cs.log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    current = dict(zip(KERNELS, cuda_build.build(
        *(src for src, _, _ in KERNELS.values()))))
    earlier = build_earlier()
    ok = True
    for k, (_, _, kernel) in KERNELS.items():
        now = resources(current[k][:-3] + ".log", kernel)
        then = resources(earlier[k][:-3] + ".log", kernel)
        for name in sorted(set(now) | set(then)):
            cs.log(f"  {k} {name}: registers, spills {now.get(name)}; "
                   f"earlier {then.get(name)}")
        if k == "k1" and {n: r for n, (r, _) in now.items()} != \
                {n: r for n, (r, _) in then.items()}:
            cs.log("  K1's registers changed")
            ok = False
    libs = {k: open_library(earlier[k], KERNELS[k][1]) for k in KERNELS}
    for src, declare, _ in KERNELS.values():
        cuda_build.load(src, declare)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok = check_k1_bits(libs, gen) and ok

    # ms per launch, earlier and current: K1 at batch 64, K1's device time at
    # batch 1, K3 at batch 64; summed over a forward's launches
    total = {"k1": [0.0, 0.0], "k1 batch 1": [0.0, 0.0], "k3": [0.0, 0.0]}
    for si, (dpg, l, blocks) in enumerate(cs.STAGES):
        costs = cs.k3_costs(dpg, l)
        set_bytes = costs["bytes_ms"] * 1e-3 * cs.PEAK_BYTES_PER_S
        xs = [cs.scan_inputs(dpg, l, torch.float32, gen)
              for _ in range(max(2, math.ceil(3 * cs.L2_BYTES / set_bytes)))]
        row = {}
        for k, (src, _, _) in KERNELS.items():
            fn = k1 if k == "k1" else k3
            old = with_library(src, libs[k], fn)
            new = with_library(src, cuda_build._libs[src], fn)
            row[k] = [cs.back_to_back_ms(f, xs, 20) for f in (old, new, new,
                                                              old)]
        del xs
        b1 = [cs.scan_inputs(dpg, l, torch.float32, gen, batch=1)
              for _ in range(8)]
        src = scan_cuda.FWD_SOURCE
        row["k1 batch 1"] = device_ms_per_call(
            [(with_library(src, lib, k1), b1)
             for lib in (libs["k1"], cuda_build._libs[src],
                         cuda_build._libs[src], libs["k1"])],
            r"scan_fwd_kernel")
        parts = []
        for k, t in row.items():
            then, now = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            total[k][0] += 2 * blocks * then
            total[k][1] += 2 * blocks * now
            parts.append(f"{k} {now:.4f} ms, earlier {then:.4f} (in turns "
                         + " ".join(f"{v:.4f}" for v in t) + ")")
        cs.log(f"  stage {si} D={cs.GROUPS * dpg} L={l} x{2 * blocks}: "
               + "; ".join(parts) + f"; K3 bound {costs['bytes_ms']:.4f} ms")
    for k, (then, now) in total.items():
        cs.log(f"  per forward: {k} {now:.4f} ms, earlier {then:.4f} ms "
               f"({100 * (now / then - 1):+.2f}%)")
    cs.log(f"nvidia-smi: {smi}")
    cs.log("K1 the same bits and registers" if ok else "K1 CHANGED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
