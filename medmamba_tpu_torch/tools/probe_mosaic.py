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
version on a CPU tensor. ``LAUNCHES`` counts kernel launches. ``run``
times each probe per call queued back to back, and by the profiler's device
time; ``launch_floor`` times an empty kernel through the same ctypes path.
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
from medmamba_tpu_torch.utils.profiling import device_ms_per_call

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


_SHAPES = {"x4": (B, D, N, R), "xw": (B, D, N * R)}


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.medmamba_probe_mosaic
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    empty = lib.medmamba_empty_launch
    empty.argtypes = [ctypes.c_void_p]
    empty.restype = ctypes.c_int


def _launch(entry, x: torch.Tensor, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current stream of
    x's card, which it launches on; raise if the launch was refused.

    At 64 KiB a probe the host's cost of a call is its time, so this path is
    lean: the stream is read through torch's C binding (the handle that
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object), and the device context is entered only when x lies on
    another card than the current one. The launch's return code is checked
    on every call."""
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = entry(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        cuda_build.check_launch(cuda_build.load(SOURCE, _declare), rc,
                                "probe_mosaic")


def probe_mosaic_cuda(probe: int, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of probe ``probe`` (an index into PROBES) on its
    operand; raises on anything the kernel does not take."""
    global LAUNCHES
    p = PROBES[probe]
    want = _SHAPES[p.operand]
    if x.shape != want or x.dtype != torch.float32 or not x.is_cuda \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"probe {probe} takes a contiguous float32 CUDA "
                         f"tensor of shape {want} at a 16-byte aligned "
                         f"address (the kernels read float4s), got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device} at "
                         f"offset {x.storage_offset()}")
    out = x.new_empty(p.out_shape)
    lib = cuda_build.load(SOURCE, _declare)
    _launch(lib.medmamba_probe_mosaic, x, probe, x.data_ptr(),
            out.data_ptr())
    LAUNCHES += 1
    return out


def empty_launch(x: torch.Tensor) -> None:
    """An empty kernel launched through the same path as a probe, on x's
    card: the floor of a launch through ctypes. Not counted in LAUNCHES."""
    _launch(cuda_build.load(SOURCE, _declare).medmamba_empty_launch, x)


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


def launch_floor() -> dict:
    """An empty kernel through the probes' ctypes path: its ms per call
    queued back to back (the host's cost of a launch through ctypes) and
    its device time."""
    x = inputs("cuda")["x4"]
    return dict(ms=_ms_per_call(empty_launch, x),
                device_ms=device_ms_per_call([(empty_launch, [x])])[0])


def run() -> list:
    """Each probe on the card against its plain version (raises on the
    first value that differs), then per call the kernel's, the library
    call's and the plain version's ms queued back to back (``ms``,
    ``library_ms``, ``plain_ms``: at this size, the host's cost of a call)
    and the kernel's and library call's device time from the profiler
    (``device_ms``, ``library_device_ms``). Returns one dict per probe."""
    xs = inputs("cuda")
    rows, calls = [], []
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

        def kernel(t, i=i):
            return probe_mosaic_cuda(i, t)
        calls += [(kernel, [x]), (p.library, [x])]
        rows.append(dict(
            probe=i, name=p.name, max_abs_err=0.0,
            library_max_abs_err=(lib_out - want).abs().max().item(),
            bound_ms=bytes_ms(i), bound_by="bytes",
            ms=_ms_per_call(kernel, x),
            library_ms=_ms_per_call(p.library, x),
            plain_ms=_ms_per_call(p.plain, x)))
        print(f"{p.name}: OK", flush=True)
    device = device_ms_per_call(calls)
    for r, kernel_ms, library_ms in zip(rows, device[::2], device[1::2]):
        r.update(device_ms=kernel_ms, library_device_ms=library_ms)
    return rows


def main(argv=None) -> int:
    del argv
    try:
        rows = run()
        floor = launch_floor()
    except RuntimeError as e:
        print(e, flush=True)
        return 1
    for r in rows:
        print(f"  {r['name']}: per call kernel {r['ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
              f"device kernel {r['device_ms']:.5f} ms, library "
              f"{r['library_device_ms']:.5f} ms; bound {r['bound_ms']:.6f} "
              "ms (bytes)")
    print(f"  empty kernel through ctypes: {floor['ms']:.4f} ms per call, "
          f"device {floor['device_ms']:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
