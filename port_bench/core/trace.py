"""What the benchmark reads from a ``torch.profiler`` trace of the window.

The family patterns are copied from the program's smoke test
(``chip_smoke.py: FAMILIES``), with the copies between host and card as a
family of their own, tried first. The device's busy time is the union of
every kernel's and copy's interval, over the whole traced window (the
harness's ``WINDOW_RANGE`` on the host, which ends with a
synchronisation): idle time before the first kernel and after the last
counts.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

# kernel families; the first match wins. cuDNN's convolution kernels also
# carry "gemm" in their names, so convolution is tried first
FAMILIES = (
    ("memcpy", r"^Memcpy|^Memset|^memcpy|^memset"),
    ("collective", r"nccl|Nccl"),
    ("scan_fwd", r"scan_fwd_kernel|hillis_fwd_kernel"),
    ("scan_bwd", r"scan_bwd_(reduce_)?kernel|"
                 r"hillis_bwd_(states_|reduce_)?kernel"),
    ("rotate_flip", r"rotate_flip_kernel"),
    ("convolution", r"conv|cudnn|fprop|winograd|implicit|nchw|nhwc"),
    ("matmul", r"gemm|gemv|cutlass|xmma|cublas|splitK"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("reduction", r"reduce"),
    ("concat", r"[Cc]at"),
    ("elementwise/copy", r"elementwise|vectorized|unrolled|copy"),
)
_COMPILED = tuple((f, re.compile(p)) for f, p in FAMILIES)
WINDOW_RANGE = "port_bench.window"
STEP_RANGE = "port_bench.step"
RANGES = (WINDOW_RANGE, STEP_RANGE)
# host operations looked at, latest first, to name an idle gap
LOOK_BACK = 2000


def family(name: str) -> str:
    return next((f for f, p in _COMPILED if p.search(name)), "other")


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


class Trace:
    """The device and host events of one traced window, in seconds.

    ``device``: (name, start, end) of every kernel and copy on the card;
    ``host``: (name, start, end) of every host operation; ``window``:
    (start, end); ``steps``: the steps (or batches) the window holds."""

    def __init__(self, device, host, window: Tuple[float, float],
                 steps: int):
        self.device, self.host = device, host
        self.window, self.steps = window, steps

    @classmethod
    def from_profiler(cls, prof, steps: int) -> "Trace":
        """From a finished profiler whose window ran inside
        ``record_function(WINDOW_RANGE)``, ending with a synchronisation."""
        from torch.autograd import DeviceType

        device, host, window = [], [], None
        for e in prof.events():
            span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.name in RANGES:
                # the ranges show on the card's timeline too
                if (e.name == WINDOW_RANGE
                        and e.device_type != DeviceType.CUDA):
                    window = span
            elif e.device_type == DeviceType.CUDA:
                device.append((e.name,) + span)
            else:
                host.append((e.name,) + span)
        if window is None:
            raise RuntimeError("the trace holds no window")
        return cls(device, host, window, steps)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _inside(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self._inside()])

    def family_s(self) -> Dict[str, float]:
        """Device seconds by family over the window."""
        out: Dict[str, float] = {}
        for n, s, e in self._inside():
            f = family(n)
            out[f] = out.get(f, 0.0) + (e - s)
        return out

    def per_step_s(self, fam: str) -> Optional[float]:
        """Device seconds of a family per step; None where none ran."""
        t = self.family_s().get(fam)
        return None if not t else t / self.steps

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self._inside():
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:120], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[list]:
        """Idle time by what the host was doing: each gap is named by the
        innermost host operation that spans its middle; the names with the
        most idle time first."""
        gaps = idle_gaps([(s, e) for _, s, e in self._inside()],
                         *self.window)
        host = sorted(self.host, key=lambda x: x[1])
        starts = [s for _, s, _ in host]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            name = "no host operation"
            # the latest-starting host operation that still runs at mid
            first = bisect.bisect_right(starts, mid) - 1
            for i in range(first, max(first - LOOK_BACK, -1), -1):
                if host[i][2] >= mid:
                    name = host[i][0]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n[:120], t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]
