"""Device time of the elementwise and copy kernels (the family of
``core/trace.py``) inside a training step's backward phase (from the
``step.backward`` marker to the next), in ms a step."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.phase_ms(tr, "step.backward",
                                                   "elementwise/copy")
