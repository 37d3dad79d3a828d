"""Time K3 and K4 with 1, 2 and 4 channels per block, on the card.

The kernels' channels per block (``kCh`` in
``csrc/selective_scan_hillis_*.cu``) is a compile-time constant. This builds
one variant of each source per value into a temporary directory under the
build directory, checks each variant against the plain versions, and times
it at the medmamba_t stage shapes (batch 64, float32 inputs): 20 launches
back to back over three input sets between one CUDA event pair, median of
three rounds. Run from the root of a checkout on a machine with a card:

    python -m medmamba_tpu_torch.tools.sweep_hillis_blocks
"""
from __future__ import annotations

import os
import re
import statistics
import subprocess
import tempfile

import torch

from medmamba_tpu_torch.ops import cuda_build, scan_hillis
from medmamba_tpu_torch.ops.selective_scan import (
    selective_scan_hillis_bwd_ref, selective_scan_hillis_ref)

# medmamba_t at 224^2: channels per group, L and SS2D blocks per stage
STAGES = ((96, 3136, 2), (192, 784, 2), (384, 196, 4), (768, 49, 2))
BATCH, GROUPS, N_STATE = 64, 2, 16
CHANNELS_PER_BLOCK = (1, 2, 4)


def _inputs(dpg: int, l: int, gen: torch.Generator) -> list:
    d = GROUPS * dpg

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    dt0 = torch.exp(-6.9 + 4.6 * torch.rand(d, generator=gen, device="cuda"))
    return [rnd(BATCH, d, l), rnd(BATCH, d, l, scale=0.5),
            -torch.arange(1, N_STATE + 1, device="cuda").float().repeat(d, 1),
            rnd(BATCH, GROUPS, N_STATE, l), rnd(BATCH, GROUPS, N_STATE, l),
            rnd(d), dt0 + torch.log(-torch.expm1(-dt0))]


def _ms_per_call(fn, sets: list, reps: int = 20) -> float:
    for s in sets:
        fn(s)
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(sets[i % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _build_variants(root: str) -> dict:
    """Sources with kCh replaced, written under ``root``; built with the
    port's flags. Returns {(kch, "fwd" | "bwd"): source name}."""
    names = {}
    for kch in CHANNELS_PER_BLOCK:
        for which, src in (("fwd", scan_hillis.FWD_SOURCE),
                           ("bwd", scan_hillis.BWD_SOURCE)):
            with open(os.path.join(cuda_build.CSRC, src)) as f:
                text = re.sub(r"constexpr int kCh = \d+;",
                              f"constexpr int kCh = {kch};", f.read())
            names[(kch, which)] = f"kch{kch}_{src}"
            with open(os.path.join(root, names[(kch, which)]), "w") as f:
                f.write(text)
    # cuda_build compiles sources from its CSRC directory
    cuda_build.CSRC = root
    cuda_build.build(*names.values())
    return names


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    names = _build_variants(tempfile.mkdtemp(dir=cuda_build.BUILD_DIR))
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {kch: [0.0, 0.0] for kch in CHANNELS_PER_BLOCK}
    for si, (dpg, l, blocks) in enumerate(STAGES):
        sets = []
        for _ in range(3):
            args = _inputs(dpg, l, gen)
            y, states, _ = selective_scan_hillis_ref(*args,
                                                     delta_softplus=True)
            sets.append((args, states, torch.randn(y.shape, generator=gen,
                                                   device="cuda")))
        args, states, gy = sets[0]
        want_fwd = selective_scan_hillis_ref(*args, delta_softplus=True)
        want_bwd = selective_scan_hillis_bwd_ref(*args, states, gy,
                                                 delta_softplus=True)
        for kch in CHANNELS_PER_BLOCK:
            scan_hillis.FWD_SOURCE = names[(kch, "fwd")]
            scan_hillis.BWD_SOURCE = names[(kch, "bwd")]
            got = scan_hillis.selective_scan_hillis_fwd(*args,
                                                        delta_softplus=True)
            for g, w in zip(got, want_fwd):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
            got = scan_hillis.selective_scan_hillis_bwd(
                *args, states, gy, delta_softplus=True)
            for g, w in zip(got, want_bwd):
                err = (g - w).abs().max() / w.abs().max()
                assert err <= 1e-4, err.item()
            fwd = scan_hillis.selective_scan_hillis_fwd
            bwd = scan_hillis.selective_scan_hillis_bwd
            f_ms = _ms_per_call(lambda s: fwd(*s[0], delta_softplus=True),
                                sets)
            b_ms = _ms_per_call(
                lambda s: bwd(*s[0], s[1], s[2], delta_softplus=True), sets)
            totals[kch][0] += 2 * blocks * f_ms
            totals[kch][1] += 2 * blocks * b_ms
            print(f"stage {si} L={l} channels per block {kch}: K3 "
                  f"{f_ms:.4f} ms, K4 {b_ms:.4f} ms", flush=True)
    for kch, (f_ms, b_ms) in totals.items():
        print(f"channels per block {kch}: K3 {f_ms:.3f} ms per forward, K4 "
              f"{b_ms:.3f} ms per step (20 launches each)")


if __name__ == "__main__":
    main()
