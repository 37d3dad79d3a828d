"""Spans, counters and step markers of the port: its one tracing module.

* **Spans** (:class:`span`): a named host interval. Every span adds its
  duration to per-name totals (count and seconds) kept in memory. While a
  ``torch.profiler`` is recording, it is also a FUNCTION-scope record
  named ``medmamba.<name>`` on the profiler's host timeline, the clock of
  the device trace: a ``cpu_op``, not a ``user_annotation``, so the
  profiler does not mirror it onto the card's timeline. With no profiler
  recording a span is one profiler-enabled check and two clock reads.
* **Counters** (:func:`count`) and **gauges** (:func:`gauge`): numbers by
  name. The kernel wrappers' five launch counters stay where they are
  (``utils/graphs.py: COUNTERS``); :func:`snapshot` returns them with the
  span totals and these counters in one dict, :func:`reset` clears the
  totals and the counters. A graph replay adds the counts of its capture
  to the step counters (:data:`STEP_COUNTERS`), as it does to the launch
  counters.
* **Markers** (:func:`mark`): a one-thread kernel with no memory traffic,
  launched on the current stream of a CUDA tensor. Inside a captured step
  it becomes a node of the graph, so the phases of a replay, which runs
  no Python, show on the card's timeline between two markers. Each name
  of :data:`MARKERS` has a kernel of its own,
  ``medmamba_mark_<group>_<phase>`` (``csrc/marker.cu``), whose name
  matches no kernel family of the benchmark's trace reduction.

Where each span, counter and marker is placed, and what reads it:
``PERF.md`` §3.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional

import torch

from medmamba_tpu_torch.ops import cuda_build

PREFIX = "medmamba."
SOURCE = "marker.cu"
# the marker names, in the order of csrc/marker.cu's MEDMAMBA_MARKERS
MARKERS = ("step.begin", "step.forward", "step.backward", "step.exchange",
           "step.optimizer", "step.end",
           "forward.begin", "forward.model", "forward.end",
           "eval.begin", "eval.end", "cam.begin", "cam.end",
           "exported.begin", "exported.end")
_INDEX = {name: i for i, name in enumerate(MARKERS)}

_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_profiler_enabled = torch._C._autograd._profiler_enabled

_spans: Dict[str, list] = {}        # name -> [count, seconds]
_counters: Dict[str, float] = {}
# counters of work a step does, counted in Python where the work is set
# up, which a graph replay does not run: a captured graph keeps its
# capture's counts of these and adds them at each replay, as
# ``utils/graphs.py`` does with the launch counters. ``ss2d.proj_padded``:
# SS2D forwards whose dt rank was padded (``models/vssm.py:
# ss2d_projections``)
STEP_COUNTERS = ("ss2d.proj_padded",)


class span:
    """``with span(name) as s:`` times the block on the host; ``s.seconds``
    holds its duration after the block. Spans nest; each adds to its own
    name's totals."""

    __slots__ = ("name", "seconds", "_t0", "_record")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._record = None
        if _profiler_enabled():
            self._record = _RecordFunctionFast(PREFIX + self.name)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
        total = _spans.get(self.name)
        if total is None:
            _spans[self.name] = [1, self.seconds]
        else:
            total[0] += 1
            total[1] += self.seconds


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set the counter ``name`` to ``value``."""
    _counters[name] = value


def step_counts() -> Dict[str, float]:
    """The step counters (:data:`STEP_COUNTERS`) as they are now."""
    return {n: _counters.get(n, 0) for n in STEP_COUNTERS}


def add_step_counts(delta: Dict[str, float]) -> None:
    """Add ``delta``, a change of :func:`step_counts`, to the counters."""
    for name, n in delta.items():
        if n:
            count(name, n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "s"}}, "counters": {...}, "launches":
    graphs.read_counts()}``, copies of the totals as they are now."""
    from medmamba_tpu_torch.utils import graphs
    return {"spans": {n: {"count": c, "s": s}
                      for n, (c, s) in _spans.items()},
            "counters": dict(_counters),
            "launches": graphs.read_counts()}


def reset() -> None:
    """Clear the span totals and the counters (not the launch counters)."""
    _spans.clear()
    _counters.clear()


def summary(before: dict, after: dict, steps: int) -> str:
    """The operator's line for what ran between two snapshots: graph
    replays, captures and evictions, host ms a replay in ``graph.call``
    spans (less the captures' ``graph.capture``), where SS2D padded its
    projections their count a step (``ss2d.proj_padded``), and, where
    batches were prefetched, host ms a step in the prefetch's spans."""
    def delta(name, key):
        return (after["spans"].get(name, {}).get(key, 0)
                - before["spans"].get(name, {}).get(key, 0))

    def counter(name):
        return (after["counters"].get(name, 0)
                - before["counters"].get(name, 0))

    replays, captures = counter("graph.replays"), counter("graph.captures")
    call = delta("graph.call", "s") - delta("graph.capture", "s")
    line = (f"graphs: {replays} replays, {captures} captures, "
            f"{counter('graph.evictions')} evictions, "
            + (f"{1e3 * call / replays:.3f}" if replays else "-")
            + " host ms a replay")
    padded = counter("ss2d.proj_padded")
    if steps and padded:
        line += f"; ss2d.proj_padded {padded / steps:g} a step"
    prefetch = ("prefetch.put", "prefetch.hand")
    if steps and any(delta(n, "count") for n in prefetch):
        host = sum(delta(n, "s") for n in prefetch)
        line += f"; prefetch {1e3 * host / steps:.3f} host ms a step"
    return line


def kernel_name(marker: str) -> str:
    """The kernel of a marker, as the profiler names it."""
    return f"medmamba_mark_{marker.replace('.', '_')}()"


def _declare(lib: ctypes.CDLL) -> None:
    lib.medmamba_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.medmamba_mark.restype = ctypes.c_int
    lib.medmamba_marker_count.argtypes = []
    lib.medmamba_marker_count.restype = ctypes.c_int
    if lib.medmamba_marker_count() != len(MARKERS):
        raise RuntimeError(f"csrc/{SOURCE} holds "
                           f"{lib.medmamba_marker_count()} markers, "
                           f"tracing.MARKERS {len(MARKERS)}")


def _traced() -> bool:
    """Whether a trace is running that a ctypes launch cannot join:
    ``torch.compile``/``torch.export``, TorchScript or a proxy or fake
    tensor mode (FX's symbolic trace passes proxies, not tensors)."""
    if torch.compiler.is_compiling() or torch.jit.is_tracing():
        return True
    keys = torch._C._TorchDispatchModeKey
    return any(torch._C._get_dispatch_mode(k) is not None
               for k in (keys.PROXY, keys.FAKE))


def mark(name: str, like: Optional[torch.Tensor]) -> None:
    """Launch the marker ``name`` (one of :data:`MARKERS`) on the current
    stream of ``like``'s device when ``like`` is a plain CUDA tensor and no
    trace is running; else do nothing."""
    index = _INDEX[name]
    if (type(like) not in (torch.Tensor, torch.nn.Parameter)
            or like.device.type != "cuda" or _traced()):
        return
    lib = cuda_build.load(SOURCE, _declare)
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = lib.medmamba_mark(index, stream)
    cuda_build.check_launch(lib, rc, f"marker {name}")
