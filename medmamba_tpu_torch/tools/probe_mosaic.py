"""P2: the relayout and contraction probes of ``tools/probe_mosaic.py`` on
Hopper.

The TPU tool asked which small-tensor relayouts the Mosaic compiler accepts,
printing OK or FAIL per probe. Here each of its 14 probes is a function
with a plain PyTorch version (the TPU kernel's body, op by op) and a
hand-written kernel (``csrc/probe_mosaic.cu``), at the TPU tool's shapes:
x4 (8, 16, 16, 8) and xw (8, 16, 128), float32, from numpy seeds 0 and 1.
The kernel must equal the plain version bit for bit: relayouts copy, the
selection products add exact zeros, and 0.5 h is exact. On CUDA there is no
lowering question, so a mismatch or a launch error is a bug and ``main``
exits non-zero. Nothing runs at import.

On the card:

    python -m medmamba_tpu_torch.tools.probe_mosaic

``probe_mosaic`` launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import statistics
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from medmamba_tpu_torch.ops import cuda_build

SOURCE = "probe_mosaic.cu"
B, D, N, R = 8, 16, 16, 8
T = 128                                 # dg_kernel's output width
PEAK_BYTES_PER_S = 3.35e12

LAUNCHES = 0


def inputs(device="cpu") -> dict:
    """The TPU tool's operands: x4 (B, D, N, R) and xw (B, D, N*R)."""
    return {
        "x4": torch.from_numpy(np.random.default_rng(0).standard_normal(
            (B, D, N, R)).astype(np.float32)).to(device),
        "xw": torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, D, N * R)).astype(np.float32)).to(device)}


@functools.lru_cache(maxsize=None)
def _mm_select(dev) -> torch.Tensor:
    """mm_kernel's (R, N*R) 0/1 matrix: p[r, j] = (j % R == r)."""
    j = torch.arange(N * R, device=dev)
    return (j[None, :] % R == torch.arange(R, device=dev)[:, None]).float()


@functools.lru_cache(maxsize=None)
def _dg_pick(dev) -> torch.Tensor:
    """dg_kernel's (R, T) 0/1 matrix: pick[r, t] = (r == t // 16)."""
    t = torch.arange(T, device=dev)
    return (torch.arange(R, device=dev)[:, None] == t[None, :] // 16).float()


def _mm_plain(x):
    x2 = x.reshape(-1, R)
    return (x2[:, :, None] * _mm_select(x.device)[None]).sum(1) \
        .reshape(B, D, N, N * R)


def _dg_plain(x):
    stack = torch.movedim(x, -1, 0)                        # (R, B, D, N)
    return (stack[..., None] * _dg_pick(x.device)[:, None, None, None]
            ).sum(0)


def _stack_plain(x):
    return torch.stack([x[:, :, :, j] * (j + 1.0) for j in range(R)], 0)


def _seq_scan_plain(x):
    stack = torch.movedim(x, -1, 0)
    h = stack[0]
    outs = [h]
    for j in range(1, R):
        h = h * 0.5 + stack[j]
        outs.append(h)
    return torch.stack(outs, 0)


@functools.lru_cache(maxsize=None)
def _decay(dev) -> torch.Tensor:
    """(R, R): 0.5^(j-i) for i <= j, else 0."""
    i = torch.arange(R, device=dev)
    return torch.where(i[:, None] >= i[None, :],
                       0.5 ** (i[:, None] - i[None, :]).float(),
                       torch.zeros((), device=dev))


@functools.lru_cache(maxsize=None)
def _stack_scale(dev) -> torch.Tensor:
    return torch.arange(1.0, R + 1, device=dev)[:, None, None, None]


def _seq_scan_library(x):
    # one product with the decay matrix: the same function, summed in
    # another order (not bit-equal)
    return torch.matmul(_decay(x.device), x.movedim(-1, 0).reshape(R, -1)
                        ).reshape(R, B, D, N)


class Probe(NamedTuple):
    name: str                  # the TPU tool's label
    operand: str               # "x4" or "xw"
    out_shape: tuple
    plain: Callable            # the TPU kernel's body in PyTorch
    library: Callable          # one PyTorch call that computes it


PROBES = (
    Probe("merge (B,D,N,R)->(B,D,N*R)", "x4", (B, D, N * R),
          lambda x: x.reshape(B, D, N * R).clone(),
          lambda x: torch.clone(x).view(B, D, N * R)),
    Probe("split (B,D,N*R)->(B,D,N,R)", "xw", (B, D, N, R),
          lambda x: x.reshape(B, D, N, R).clone(),
          lambda x: torch.clone(x).view(B, D, N, R)),
    Probe("swapaxes minor (B,D,N,R)->(B,D,R,N)", "x4", (B, D, R, N),
          lambda x: torch.swapaxes(x, -1, -2).contiguous(),
          lambda x: x.transpose(-1, -2).contiguous()),
    Probe("leading collapse (B,D,N,R)->(B*D*N,R)", "x4", (B * D * N, R),
          lambda x: x.reshape(B * D * N, R).clone(),
          lambda x: torch.clone(x).view(B * D * N, R)),
    Probe("leading collapse to sublane (B,D,N,R)->(B,D*N,R)", "x4",
          (B, D * N, R),
          lambda x: x.reshape(B, D * N, R).clone(),
          lambda x: torch.clone(x).view(B, D * N, R)),
    Probe("matmul lhs minor-8 (.,R)@(R,128)", "x4", (B, D, N, N * R),
          _mm_plain,
          lambda x: torch.matmul(x, _mm_select(x.device))),
    Probe("strided lane slice (B,D,N*R)[..., R-1::R]", "xw", (B, D, N),
          lambda x: x[:, :, R - 1::R].contiguous(),
          lambda x: x[:, :, R - 1::R].contiguous()),
    Probe("lane slice+index (B,D,N*R)->reshape idx", "xw", (B, D, N),
          lambda x: x.reshape(B, D, N, R)[..., 0].contiguous(),
          lambda x: x.reshape(B, D, N, R)[..., 0].contiguous()),
    Probe("pltpu.repeat lanes (B,D,N)->(B,D,N*R)", "x4", (B, D, N * R),
          lambda x: torch.cat([x[:, :, :, 0]] * R, dim=2),
          lambda x: x[:, :, :, 0].repeat(1, 1, R)),
    Probe("broadcast+merge (B,D,N,1)->(B,D,N*R)", "x4", (B, D, N * R),
          lambda x: torch.broadcast_to(x[:, :, :, 0][..., None],
                                       (B, D, N, R)).reshape(B, D, N * R),
          lambda x: torch.repeat_interleave(x[:, :, :, 0], R, dim=2)),
    Probe("moveaxis minor->leading (B,D,N,R)->(R,B,D,N)", "x4", (R, B, D, N),
          lambda x: torch.movedim(x, -1, 0).contiguous(),
          lambda x: x.movedim(-1, 0).contiguous()),
    Probe("dot_general 4D-lhs contract leading (R,B,D,N)x(R,T)", "x4",
          (B, D, N, T), _dg_plain,
          lambda x: torch.matmul(x, _dg_pick(x.device))),
    Probe("minor-index slices + stack axis0", "x4", (R, B, D, N),
          _stack_plain,
          lambda x: x.movedim(-1, 0) * _stack_scale(x.device)),
    Probe("leading-indexed sequential recurrence", "x4", (R, B, D, N),
          _seq_scan_plain, _seq_scan_library),
)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_probe_mosaic
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def probe_mosaic_cuda(probe: int, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of probe ``probe`` (an index into PROBES) on its
    operand; raises on anything the kernel does not take."""
    global LAUNCHES
    p = PROBES[probe]
    want = (B, D, N, R) if p.operand == "x4" else (B, D, N * R)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or tuple(x.shape) != want or not x.is_contiguous():
        raise ValueError(f"probe {probe} takes a contiguous float32 CUDA "
                         f"tensor of shape {want}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    out = torch.empty(p.out_shape, dtype=torch.float32, device=x.device)
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.medmamba_probe_mosaic(probe, x.data_ptr(), out.data_ptr(),
                                       B, D, N, R, stream)
    cuda_build.check_launch(lib, rc, "probe_mosaic")
    LAUNCHES += 1
    return out


def probe_mosaic(probe: int, x: torch.Tensor) -> torch.Tensor:
    """Probe ``probe``: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.is_cuda:
        return probe_mosaic_cuda(probe, x)
    return PROBES[probe].plain(x)


def bytes_ms(probe: int) -> float:
    """Least time in ms: the operand read once and the output written once
    at 3.35 TB/s."""
    nbytes = 4 * (B * D * N * R + int(np.prod(PROBES[probe].out_shape)))
    return nbytes / PEAK_BYTES_PER_S * 1e3


def _ms_per_call(fn, x, reps: int = 200, rounds: int = 3) -> float:
    fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def run() -> list:
    """Each probe on the card against its plain version (raises on the
    first value that differs), then the kernel's, the library call's and
    the plain version's ms per call, queued back to back. Returns one dict
    per probe."""
    xs = inputs("cuda")
    rows = []
    for i, p in enumerate(PROBES):
        x = xs[p.operand]
        got = probe_mosaic_cuda(i, x)
        want = p.plain(x)
        lib_out = p.library(x)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            n_diff = (got != want).sum().item() if got.shape == want.shape \
                else got.numel()
            raise RuntimeError(f"{p.name}: FAIL, {n_diff} values differ from "
                               f"the plain version")
        rows.append(dict(
            probe=i, name=p.name, max_abs_err=0.0,
            library_max_abs_err=(lib_out - want).abs().max().item(),
            bound_ms=bytes_ms(i), bound_by="bytes",
            ms=_ms_per_call(lambda t: probe_mosaic_cuda(i, t), x),
            library_ms=_ms_per_call(p.library, x),
            plain_ms=_ms_per_call(p.plain, x)))
        print(f"{p.name}: OK", flush=True)
    return rows


def main(argv=None) -> int:
    del argv
    try:
        rows = run()
    except RuntimeError as e:
        print(e, flush=True)
        return 1
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms (bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
