"""Device time per call from ``torch.profiler``.

``device_ms_per_call`` times several functions on the card in one profiler
session: the tracer of a process that has opened many sessions can record
no device events at all, so a caller asks once for every function it times.
Nothing runs at import.
"""
from __future__ import annotations

import re
import time

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
