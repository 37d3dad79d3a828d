"""K1-K4 beside the sources of an earlier commit, on the card.

Builds the scan kernels from an earlier commit's ``csrc/`` (the walks'
headers included), written beforehand into the build directory:

    mkdir -p medmamba_tpu_torch/_build/earlier
    git archive <commit> medmamba_tpu_torch/csrc \\
        | tar -x --strip-components=2 -C medmamba_tpu_torch/_build/earlier
    python -m medmamba_tpu_torch.tools.earlier_kernels

Run it from the root of a checkout on a machine with a card: it takes
``chip_smoke.py``'s operands, timer and bounds. It prints each build's
registers and spills, and fails where a float32 instantiation of a kernel
takes other registers than the earlier build's; holds each kernel's float32
mode bit for bit against the earlier build at the medmamba_t stage shapes,
in every dtype instantiation: K1 (y, the last state and the tile-entry
states, at batch 64 and 1, mixed directions, and with a shared u and
valid_len), K2 (the seven gradients, mixed directions), K3 (y, the chunk
states and the last state, batch 64 and 1) and K4 (the seven gradients);
then times both builds, float32, in turns (earlier, current, current,
earlier): each kernel per launch at batch 64 queued back to back, and K1 at
batch 1 by the profiler's device time. Exits non-zero on any difference.

An earlier build's entry points may lack the ``compute`` argument (before
the bfloat16 compute mode): ``Earlier`` drops it, float32 only.
"""
from __future__ import annotations

import argparse
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

# kernel: (source, declare, the walk kernel's name, every kernel's name)
KERNELS = {
    "K1": (scan_cuda.FWD_SOURCE, scan_cuda._declare_fwd,
           ("scan_fwd_kernel",)),
    "K2": (scan_cuda.BWD_SOURCE, scan_cuda._declare_bwd,
           ("scan_bwd_kernel", "scan_bwd_reduce_kernel")),
    "K3": (scan_hillis.FWD_SOURCE, scan_hillis._declare_fwd,
           ("hillis_fwd_kernel",)),
    "K4": (scan_hillis.BWD_SOURCE, scan_hillis._declare_bwd,
           ("hillis_bwd_states_kernel", "hillis_bwd_kernel",
            "hillis_bwd_reduce_kernel")),
}
# the entry points that took the compute mode as their last argument
# before the stream
WIDENED = ("medmamba_selective_scan_fwd", "medmamba_selective_scan_fwd_config",
           "medmamba_selective_scan_bwd", "medmamba_selective_scan_hillis_fwd",
           "medmamba_selective_scan_hillis_bwd")
NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")
F32, BF16 = torch.float32, torch.bfloat16


class Earlier:
    """An earlier build of a kernel, called as the current wrappers call
    the current one: where its entry point has no ``compute`` argument,
    the call's (the one before the last) is dropped, and must be 0."""

    def __init__(self, path: str, declare):
        self.lib = ctypes.CDLL(path)
        self.lib.medmamba_cuda_error_string.argtypes = [ctypes.c_int]
        self.lib.medmamba_cuda_error_string.restype = ctypes.c_char_p
        declare(self.lib)
        self.narrow = set()
        for name in WIDENED:
            if not hasattr(self.lib, name):
                continue
            fn = getattr(self.lib, name)
            if self.widened_in(path, name):
                continue
            fn.argtypes = fn.argtypes[:-2] + fn.argtypes[-1:]
            self.narrow.add(name)

    @staticmethod
    def widened_in(path: str, name: str) -> bool:
        """Whether the build's source gives ``name`` a compute argument."""
        with open(path[:-3] + ".src") as f:
            m = re.search(rf"{name}\(([^)]*)\)", f.read())
        return bool(m) and "int compute" in m.group(1)

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.narrow:
            return fn

        def call(*args):
            if args[-2] != 0:
                raise RuntimeError(f"{name} of the earlier build has no "
                                   "bfloat16 mode")
            return fn(*args[:-2], args[-1])
        return call


def build_earlier(src_dir: str) -> dict:
    """The earlier sources in ``src_dir`` built with the current flags, one
    nvcc each, all started together: {kernel: library path}. Each
    library's source is kept beside it as ``.src``."""
    jobs = {}
    for k, (source, _, _) in KERNELS.items():
        src = os.path.join(src_dir, source)
        out = os.path.join(cuda_build.BUILD_DIR, f"lib{k}_earlier.so")
        with open(src) as f, open(out[:-3] + ".src", "w") as g:
            g.write(f.read())
        jobs[k] = out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    paths = {}
    for k, (out, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {k} earlier:\n{stdout}{stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(stdout + stderr)
        paths[k] = out
    return paths


def resources(log_path: str, kernels) -> dict:
    """{instantiation: (registers, spill line)} of ``kernels`` in a
    ``-Xptxas -v`` report; an instantiation of a float32 compute mode is
    named as the earlier builds, which had no mode, name it."""
    out, entry, spill = {}, None, ""
    pattern = "|".join(kernels)
    with open(log_path) as f:
        for line in f:
            m = re.search(rf"Compiling entry function '\w*?({pattern})(\w*)'",
                          line)
            if m:
                entry = m.group(1) + m.group(2).replace("Li0EEEv", "EEv")
                spill = ""
            elif entry and "spill" in line:
                spill = line.strip()
            elif entry and (m := re.search(r"Used (\d+) registers", line)):
                out[entry] = (int(m.group(1)), spill)
                entry = None
    return out


@contextlib.contextmanager
def library(source: str, lib):
    """Within the block the wrappers launch ``source``'s kernels from
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


def k2(s, **kw):
    x, states, gy = s
    return scan_cuda.selective_scan_bwd(*(x[k] for k in NAMES), states, gy,
                                        delta_softplus=True, **kw)


def k3(x):
    return scan_hillis.selective_scan_hillis_fwd(**x, delta_softplus=True)


def k4(s):
    x, states, gy = s
    return scan_hillis.selective_scan_hillis_bwd(
        *(x[k] for k in NAMES), states, gy, delta_softplus=True)


def k2_operands(dpg, l, tin, tgy, gen, batch=cs.BATCH, **kw):
    x = cs.scan_inputs(dpg, l, tin, gen, batch)
    y, _, states = k1(x, return_states=True, out_dtype=tgy, **kw)
    return x, states, torch.randn(y.shape, generator=gen,
                                  device="cuda").to(tgy)


def k4_operands(dpg, l, tin, gen, batch=cs.BATCH):
    x = cs.scan_inputs(dpg, l, tin, gen, batch)
    y, states, _ = k3(x)
    return x, states, torch.randn(y.shape, generator=gen, device="cuda")


def same(label: str, got, want) -> bool:
    flags = [a is None and b is None or torch.equal(a, b)
             for a, b in zip(got, want)]
    cs.log(f"  {label}: {'the same bits' if all(flags) else flags}")
    return all(flags)


def check_bits(libs: dict, gen) -> bool:
    """Every kernel's float32 mode against the earlier build, bit for bit."""
    ok = True
    dtypes = ((F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16))
    mixed = dict(reverse_dirs=(False, True))
    for si, (dpg, l, _) in enumerate(cs.STAGES):
        for batch in (cs.BATCH, 1):
            for tin, tout in dtypes:
                x = cs.scan_inputs(dpg, l, tin, gen, batch)
                kw = dict(mixed, out_dtype=tout, return_last_state=True,
                          return_states=True)
                got = k1(x, **kw)
                with library(scan_cuda.FWD_SOURCE, libs["K1"]):
                    want = k1(x, **kw)
                ok &= same(f"K1 stage {si} batch {batch} {tin} in, {tout} "
                           "out: y, last, states", got, want)
        x = cs.scan_inputs(dpg, l, F32, gen)
        x["u"] = x["u"][:, :dpg].contiguous()
        kw = dict(mixed, u_tile=2, valid_len=l - 3, return_last_state=True,
                  return_states=True)
        got = k1(x, **kw)
        with library(scan_cuda.FWD_SOURCE, libs["K1"]):
            want = k1(x, **kw)
        ok &= same(f"K1 stage {si} shared u, valid_len", got, want)
        for tin, tgy in dtypes:
            s = k2_operands(dpg, l, tin, tgy, gen, **mixed)
            got = k2(s, **mixed)
            with library(scan_cuda.BWD_SOURCE, libs["K2"]):
                want = k2(s, **mixed)
            ok &= same(f"K2 stage {si} {tin} in, {tgy} gy: the seven "
                       "gradients", got, want)
        for tin in (F32, BF16):
            for batch in (cs.BATCH, 1):
                x = cs.scan_inputs(dpg, l, tin, gen, batch)
                got = k3(x)
                with library(scan_hillis.FWD_SOURCE, libs["K3"]):
                    want = k3(x)
                ok &= same(f"K3 stage {si} batch {batch} {tin}: y, states, "
                           "last", got, want)
            s = k4_operands(dpg, l, tin, gen)
            got = k4(s)
            with library(scan_hillis.BWD_SOURCE, libs["K4"]):
                want = k4(s)
            ok &= same(f"K4 stage {si} {tin}: the seven gradients", got,
                       want)
    torch.cuda.synchronize()
    return ok


def time_both(libs: dict, gen) -> None:
    """Each kernel per launch at batch 64, float32, earlier and current in
    turns; K1's device time at batch 1; summed over a pass's launches."""
    mixed = dict(reverse_dirs=(False, True))
    total = {}
    for si, (dpg, l, blocks) in enumerate(cs.STAGES):
        costs = cs.k4_costs(dpg, l)
        n_sets = max(2, math.ceil(3 * cs.L2_BYTES / (
            costs["bytes_ms"] * 1e-3 * cs.PEAK_BYTES_PER_S)))
        work = {
            "K1": (lambda x: k1(x, **mixed),
                   [cs.scan_inputs(dpg, l, F32, gen) for _ in range(n_sets)]),
            "K2": (lambda s: k2(s, **mixed),
                   [k2_operands(dpg, l, F32, F32, gen, **mixed)
                    for _ in range(n_sets)]),
            "K3": (k3, [cs.scan_inputs(dpg, l, F32, gen)
                        for _ in range(n_sets)]),
            "K4": (k4, [k4_operands(dpg, l, F32, gen)
                        for _ in range(n_sets)]),
        }
        row = {}
        for k, (fn, sets) in work.items():
            src = KERNELS[k][0]
            old = with_library(src, libs[k], fn)
            new = with_library(src, cuda_build._libs[src], fn)
            row[k] = [cs.back_to_back_ms(f, sets, 20)
                      for f in (old, new, new, old)]
        del work
        b1 = [cs.scan_inputs(dpg, l, F32, gen, batch=1) for _ in range(8)]
        src = scan_cuda.FWD_SOURCE
        row["K1 batch 1"] = device_ms_per_call(
            [(with_library(src, lib, k1), b1)
             for lib in (libs["K1"], cuda_build._libs[src],
                         cuda_build._libs[src], libs["K1"])],
            r"scan_fwd_kernel")
        parts = []
        for k, t in row.items():
            then, now = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            acc = total.setdefault(k, [0.0, 0.0])
            acc[0] += 2 * blocks * then
            acc[1] += 2 * blocks * now
            parts.append(f"{k} {now:.4f} ms, earlier {then:.4f} (in turns "
                         + " ".join(f"{v:.4f}" for v in t) + ")")
        cs.log(f"  stage {si} D={cs.GROUPS * dpg} L={l} x{2 * blocks}: "
               + "; ".join(parts))
    for k, (then, now) in total.items():
        cs.log(f"  per pass: {k} {now:.4f} ms, earlier {then:.4f} ms "
               f"({100 * (now / then - 1):+.2f}%)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=os.path.join(cuda_build.BUILD_DIR,
                                                  "earlier"),
                   help="the earlier commit's csrc/ (default: _build/earlier)")
    p.add_argument("--no_timing", action="store_true",
                   help="check registers and bits only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("earlier_kernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    cs.log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; earlier "
           f"sources {args.dir}")
    current = dict(zip(KERNELS, cuda_build.build(
        *(src for src, _, _ in KERNELS.values()))))
    earlier = build_earlier(args.dir)
    ok = True
    for k, (_, _, kernels) in KERNELS.items():
        now = resources(current[k][:-3] + ".log", kernels)
        then = resources(earlier[k][:-3] + ".log", kernels)
        for name in sorted(set(now) | set(then)):
            cs.log(f"  {k} {name}: registers, spills {now.get(name)}; "
                   f"earlier {then.get(name)}")
        regs = {n: r for n, (r, _) in now.items() if n in then}
        if len(regs) != len(then) or regs != {n: r for n, (r, _)
                                              in then.items()}:
            cs.log(f"  {k}: the float32 registers changed")
            ok = False
    libs = {k: Earlier(earlier[k], KERNELS[k][1]) for k in KERNELS}
    for src, declare, _ in KERNELS.values():
        cuda_build.load(src, declare)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok = check_bits(libs, gen) and ok
    if not args.no_timing:
        time_both(libs, gen)
    cs.log(f"nvidia-smi: {smi}")
    cs.log("float32: the same bits and registers" if ok
           else "float32 CHANGED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
