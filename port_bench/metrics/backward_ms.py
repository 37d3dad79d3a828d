"""Card busy time of a training step's backward, in ms a step: from the
``step.backward`` marker to the next (``step.exchange`` under a data
group, else ``step.optimizer``)."""
from port_bench.core import phases


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else phases.phase_ms(tr, "step.backward")
