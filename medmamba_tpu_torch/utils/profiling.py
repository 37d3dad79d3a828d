"""Device time per call from ``torch.profiler``, and the analytic FLOPs of
a VSSM.

``device_ms_per_call`` times several functions on the card in one profiler
session: the tracer of a process that has opened many sessions can record
no device events at all, so a caller asks once for every function it times.
``model_flops_report`` is the port's copy of the JAX package's
(``medmamba_tpu/utils/profiling.py``); its ``trace`` (a ``jax.profiler``
region) has no counterpart here. Nothing runs at import.
"""
from __future__ import annotations

import re
import time
from typing import Dict

from medmamba_tpu_torch.ops.flops import flops_selective_scan, flops_ss2d

REPS = 50            # calls of each function in the session
_GAP_S = 0.01        # the card idles this long between two functions' calls
_TRIES = 3           # sessions before a function with too few events raises
_RANGE = "device_ms_per_call."


def per_call_ms(events, n_calls: int, pattern: str | None = None) -> list:
    """Each function's device time in ms per call from a session's
    ``events``: a device event belongs to the ``record_function`` range
    ``_RANGE + k`` its start falls in (widened by half the gap, for the skew
    of the two clocks), and only events whose name matches ``pattern``
    count, where given. A kernel's time a call is its mean duration times
    its launches a call, its events over REPS rounded and at least 1, since
    the tracer can drop events. None for a function that shows fewer than
    REPS / 2 events."""
    from torch.autograd import DeviceType

    spans = {}
    for e in events:
        if e.name.startswith(_RANGE) and e.device_type == DeviceType.CPU:
            spans[int(e.name[len(_RANGE):])] = (e.time_range.start,
                                                e.time_range.end)
    half = _GAP_S * 1e6 / 2
    by_call = [{} for _ in range(n_calls)]
    for e in events:
        # the ranges also show on the card's timeline: skip them there
        if e.device_type != DeviceType.CUDA or e.name.startswith(_RANGE) \
                or (pattern and not re.search(pattern, e.name)):
            continue
        t = e.time_range.start
        k = next((k for k, (lo, hi) in spans.items()
                  if lo - half <= t < hi + half), None)
        if k is not None:
            by_call[k].setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    return [sum(sum(t) / len(t) * max(1, round(len(t) / REPS))
                for t in names.values()) / 1e3
            if 2 * sum(map(len, names.values())) >= REPS else None
            for names in by_call]


def device_ms_per_call(calls: list, pattern: str | None = None) -> list:
    """The profiler's device time in ms per call of each ``(fn, inputs)``
    in ``calls``: REPS calls of ``fn`` cycling through the list ``inputs``,
    inside one ``record_function`` range a function, the card synchronised
    and left idle between two functions; one session for all (a short
    session first starts the tracer). See ``per_call_ms``; raises if a
    function shows too few events in each of _TRIES sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def session(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k, (fn, inputs) in enumerate(calls):
                with record_function(f"{_RANGE}{k}"):
                    for i in range(n):
                        fn(inputs[i % len(inputs)])
                    torch.cuda.synchronize()
                time.sleep(_GAP_S)
        return prof.events()

    session(2)
    for _ in range(_TRIES):
        ms = per_call_ms(session(REPS), len(calls), pattern)
        if None not in ms:
            return ms
    raise RuntimeError(f"the profiler saw too few device events of {REPS} "
                       f"calls each in {_TRIES} sessions: {ms}")


def model_flops_report(depths, dims, image_size: int = 224,
                       d_state: int = 16, num_classes: int = 1000) -> Dict:
    """Analytic MACs per image of a VSSM config's forward: per stage the
    SS2D blocks, the conv branch and the patch merging, plus the patch
    embedding and the head."""
    h = w = image_size // 4
    total = 0.0
    per_stage = []
    # patch embed: conv 4x4 s4, 3 -> dims[0]
    total += (image_size // 4) ** 2 * dims[0] * 3 * 16
    for i, (depth, dim) in enumerate(zip(depths, dims)):
        stage = 0.0
        half = dim // 2
        for _ in range(depth):
            stage += flops_ss2d(h, w, half, d_state)
            # conv branch: 2x conv3x3 + conv1x1 on half channels
            stage += h * w * (half * half * 9 * 2 + half * half)
        if i < len(depths) - 1:
            stage += (h // 2) * (w // 2) * (4 * dim) * (2 * dim)  # merging
            h, w = h // 2, w // 2
        per_stage.append(stage)
        total += stage
    total += dims[-1] * num_classes
    return {"total_macs": total, "per_stage_macs": per_stage,
            "scan_macs_stage0": flops_selective_scan(
                1, (image_size // 4) ** 2, 4 * dims[0], d_state)}
