"""``utils/profiling.py: per_call_ms``, which assigns a profiler session's
device events to the functions timed in it, on hand-made events (the CPU
has no device timeline). Times in us as the profiler gives them, results
in ms, compared exactly up to float rounding."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from medmamba_tpu_torch.utils import profiling

REPS = profiling.REPS


def _event(name, device, start, length):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start,
                                                      end=start + length))


def _session(dropped=0):
    """Two functions: the first launches kernel "a" (2 us) once a call, the
    second "b" (1 us) twice and "c" (3 us) once; ``dropped`` of "a"'s events
    are missing. Each range also shows on the device, and one kernel runs
    outside both ranges."""
    ranges = [(0, 1000), (20000, 21000)]
    events = []
    for k, (lo, hi) in enumerate(ranges):
        name = f"{profiling._RANGE}{k}"
        events += [_event(name, DeviceType.CPU, lo, hi - lo),
                   _event(name, DeviceType.CUDA, lo + 5, hi - lo)]
    events += [_event("a", DeviceType.CUDA, 10 + 10 * i, 2)
               for i in range(REPS - dropped)]
    events += [_event("b", DeviceType.CUDA, 20010 + 10 * i, 1)
               for i in range(2 * REPS)]
    events += [_event("c", DeviceType.CUDA, 20005 + 10 * i, 3)
               for i in range(REPS)]
    events.append(_event("a", DeviceType.CUDA, 50000, 100))
    return events


@pytest.mark.parametrize("dropped", [0, REPS // 5])
def test_per_call_ms_assigns_device_events_to_their_ranges(dropped):
    got = profiling.per_call_ms(_session(dropped), 2)
    assert got == pytest.approx([0.002, 2 * 0.001 + 0.003], rel=1e-12)


def test_per_call_ms_filters_by_name_and_flags_too_few_events():
    got =profiling.per_call_ms(_session(), 2, r"^[bc]$")
    assert got[0] is None and got[1] == pytest.approx(0.005, rel=1e-12)
    assert profiling.per_call_ms(_session(REPS // 2 + 1), 2)[0] is None
