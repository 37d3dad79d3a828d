"""What the benchmark reads from the program's own marks in a traced
window: its step markers on the card and its spans on the host.

The program launches a one-thread marker kernel at each phase boundary of
its steps, captured into the step's CUDA graph
(``medmamba_tpu_torch/utils/tracing.py``); marker ``<group>.<phase>``
runs as the kernel ``medmamba_mark_<group>_<phase>``. Its spans are host
operations named ``medmamba.<name>``. Both lie on the profiler's one clock
with the kernels of ``Trace.device``. A program without them (an earlier
commit) leaves every function here with nothing to read: None.

A bracket runs from a ``<group>.begin`` marker's start to the end of the
next ``<group>.end`` marker: one replayed step or forward. A phase runs
from a marker's start to the next marker's start.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from port_bench.core.trace import Trace, family, idle_gaps, union_length

MARKER = re.compile(r"medmamba_mark_([a-z]+)_([a-z]+)")
SPAN_PREFIX = "medmamba."

Interval = Tuple[float, float]


def markers(tr: Trace) -> List[Tuple[str, float, float]]:
    """(marker name, start, end) of the program's markers inside the
    window, in order of start."""
    lo, hi = tr.window
    out = []
    for n, s, e in tr.device:
        m = MARKER.search(n)
        if m and lo <= s < hi:
            out.append((f"{m.group(1)}.{m.group(2)}", s, e))
    return sorted(out, key=lambda x: x[1])


def brackets(tr: Trace) -> List[Interval]:
    """[begin start, end end] of each replayed step or forward."""
    out, opened = [], {}
    for name, s, e in markers(tr):
        group, phase = name.split(".")
        if phase == "begin":
            opened[group] = s
        elif phase == "end" and group in opened:
            out.append((opened.pop(group), e))
    return out


def phases(tr: Trace, name: str) -> List[Interval]:
    """[start of marker ``name``, start of the marker after it] of each
    occurrence of ``name``."""
    seen = markers(tr)
    return [(s, seen[i + 1][1]) for i, (n, s, _) in enumerate(seen)
            if n == name and i + 1 < len(seen)]


def _clipped(tr: Trace, lo: float, hi: float) -> List[Tuple[str, float,
                                                              float]]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in tr.device
            if e > lo and s < hi]


def busy_s(tr: Trace, spans: Sequence[Interval]) -> float:
    """Seconds of ``spans`` in which a kernel or a copy runs (the union of
    their intervals, clipped to each span)."""
    return sum(union_length([(s, e) for _, s, e in _clipped(tr, lo, hi)])
               for lo, hi in spans)


def idle_s(tr: Trace, spans: Sequence[Interval]) -> float:
    """Seconds of ``spans`` in which nothing runs on the card."""
    total = 0.0
    for lo, hi in spans:
        total += sum(b - a for a, b in idle_gaps(
            [(s, e) for _, s, e in _clipped(tr, lo, hi)], lo, hi))
    return total


def family_s(tr: Trace, spans: Sequence[Interval], fam: str) -> float:
    """Device seconds of the kernels of family ``fam`` inside ``spans``."""
    return sum(e - s for lo, hi in spans
               for n, s, e in _clipped(tr, lo, hi) if family(n) == fam)


def outside(tr: Trace, spans: Sequence[Interval]) -> List[Interval]:
    """The stretches of the window that no span covers."""
    return idle_gaps(list(spans), *tr.window)


def span_s(tr: Trace, name: str) -> Optional[float]:
    """Host seconds in the program's spans ``medmamba.<name>`` that start
    inside the window; None where there are none."""
    lo, hi = tr.window
    full = SPAN_PREFIX + name
    found = [e - s for n, s, e in tr.host if n == full and lo <= s < hi]
    return sum(found) if found else None


def per_step_ms(tr: Trace, seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds / tr.steps * 1e3


def phase_ms(tr: Trace, name: str, fam: Optional[str] = None
             ) -> Optional[float]:
    """Busy ms a step in the phases that marker ``name`` opens (of family
    ``fam`` alone, summed, where given); None where it never ran."""
    spans = phases(tr, name)
    if not spans:
        return None
    return per_step_ms(tr, busy_s(tr, spans) if fam is None
                       else family_s(tr, spans, fam))

